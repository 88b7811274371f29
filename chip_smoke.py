#!/usr/bin/env python3
"""Smoke run of deepsignal_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It prints the card and builds every CUDA kernel of the port from
``deepsignal_tpu_torch/csrc``, with ptxas's register and spill counts (a
spill in the fused encoder or in a resident scan kernel fails the run), and
beside them the host C++ code (the feature-TSV parser, the call-row
formatter and the featurizer) with the host compiler, whose version it
prints.  It
holds each kernel against its plain PyTorch version at the shapes of the
main paths (the fused encoder also at the call path's tail batch and at a
small ragged one; the scan at both train depths, a ragged tile, the call
path's small batch and two hidden sizes of its streaming variant, checking
which variant launched; both also at depth 3, the input of denoise's
RNN-only model), prints each kernel's launch plan, waves and the L2 weight
bytes it implies, and times the kernel, the plain version and one PyTorch
library call that computes the same function (the scan also in its parts
and through its streaming variant, at both train depths).
It checks the kernels' gradients against autograd through their plain
versions, and that a batch the fused encoder does not take runs through the
per-layer kernel.  Then it drives the main paths at full width:

- ``call_mods`` end to end through ``run_call_mods``, with random seeded
  weights, on a synthetic feature TSV, in bfloat16 and in float32: the TSV
  is parsed by the native parser in the background reader process and the
  calls formatted by the native formatter, each counted;
- the JAX package's library calls (``library``), after each dtype's
  ``call_mods`` run, on the TSV's first two device batches:
  ``parse_feature_lines`` at the given widths (equal to the probed parse),
  ``ModCaller.call_feature_batch`` (K1 once per device batch), ``collect``
  and ``collect_block`` on one handle (equal rows), the rows against the
  ``call_mods`` run's calls (labels equal, probabilities within
  DPROB_TOL), ``ModRecord.to_line`` on every row, ``batch_metrics``
  against the counts made on the card, and ``forward_with_loss`` on the
  card's logits against the CPU, both pos_weight forms; the per-row
  ``call_feature_batch`` timed beside ``dispatch_feature_batch`` +
  ``collect_block``;
- ``train`` through ``train()`` on a synthetic separable labelled set
  (written as TSV, converted to binary records by the port), in float32 for
  two epochs and in bfloat16 for one, after which ``run_call_mods`` scores
  the validation TSV with the best checkpoint; every scan launch of a train
  step must be of the resident variant.  One train step through the
  kernels is held against the same step through the plain versions;
- ``call_mods`` from reads: 120 seeded in-memory tombo-resquiggled reads
  are featurized by the native featurizer, which is
  first held against its plain version byte for byte on 8 of them and on
  the golden fixture's reads (``tests/golden/features_golden.tsv``); then
  ``run_extract``'s seam writes their feature TSV with 3 extract workers,
  and ``ModCaller`` + ``call_mods_on_batches`` over the seam of
  ``stream_fast5_feature_batches`` calls every site in bfloat16 and in
  float32, K1 launched once per device batch, the first batch held against
  the plain encoder, each run once more under ``torch.profiler`` for the
  device's idle share.  Then the same 120 reads as fast5 files, written
  and read by the port's own HDF5 code (``io/hdf5.py``, no h5py): ``extract
  -i <dir>`` through the CLI writes the in-memory reads' feature TSV, and
  ``call_mods -i <dir>`` through the CLI gives the in-memory reads' calls
  row for row in bfloat16 and in float32, K1 launched once per device
  batch; the committed fixtures (``tests/fixtures/fast5``) read as the JAX
  package's reader read them, and the reader's µs per file is timed; one
  read in HDF5's earliest and latest file formats (``tombo_like.fast5``
  and ``tombo_latest.fast5``: dense links and attributes, an
  extensible-array chunk index) gives equal rows and calls through
  ``extract -i`` and ``call_mods -i`` in both dtypes, K1 once a run, and
  the reader is timed on 120 copies of each;
- TF1 import: the published model's name space
  (``tests/fixtures/tf1_variables_bn17_sn360.json``) with seeded values and
  the Adam slots and bookkeeping of a ``tf.train.Saver`` checkpoint, as
  .npz, through ``import_tf1_npz`` and ``save_checkpoint`` (the state dict
  equal to the slot-free import's bit for bit), then ``run_call_mods`` on
  the feature TSV in bfloat16 (with ``profile_dir``: the Chrome trace must
  name K1's kernel once per launch) and float32, the first batch held
  against the plain encoder;
- the host tools through the port's CLI on the reads path's calls:
  ``call_freq`` (TSV and bedMethyl, prob_cf 0 and 0.2), ``combine_freq``,
  ``combine_strands`` against the contig the reads tile, ``runner
  --dry_run`` and ``runner``'s in-process ``call_mods`` stage alone on the
  feature TSV (K1 once per device batch); after training, ``evaluate`` on the scored validation calls
  split by their labels and ``visualize_log`` on the float32 logs (or the
  RuntimeError where matplotlib is missing);
- ``denoise`` through ``denoise()`` with ``DenoiseConfig``'s RNN-only model
  on a synthetic labelled set whose positives are 30% mislabelled, one
  iteration of one round of one epoch: every scan launch of a train step
  resident, one encoder launch per scoring batch, every line scored, and
  fewer mislabelled positives kept than true ones;
- the multi-GPU paths on the one card (``parallel``): ``call_mods``
  through the CLI under ``python -m torch.distributed.run`` with 2 ranks
  on cuda:0 in bfloat16 and float32 (each rank's stride shard of the read
  batches into its part file, K1 once per device batch of each rank; the
  merged calls equal the single run's), the reads path with
  ``host_shard=(k, 2)`` for both k in turn (the union equals the
  unsharded calls), ``train`` through the CLI at world size 1 under NCCL
  (per-step loss and counts within the spread of two non-distributed
  runs, its checkpoint scored by ``run_call_mods``, its ms per step beside
  the non-distributed one), and 2 ranks over gloo on cuda:0 (NCCL refuses
  two ranks on one card): 3 data-parallel steps and one fc1
  tensor-parallel step against one process, every K2 launch resident at
  the per-rank batch.  A rank runs this file with ``--rank <spec.json>``
  (``rank_worker``).

The bfloat16 call run is also timed stage by stage, and one forward batch of
4096 is profiled (its top device ops and the device's idle share).  The
native parser is held against its plain version array for array and bit for
bit on the call TSV, the native formatter against its plain version byte
for byte on the calls, and both are timed beside their plain versions, with
the background reader's start.

With ``--cards N`` on a machine with N cards it runs only the multi-GPU
paths, one rank per card under NCCL (``cards_main``): ``call_mods``
through the CLI, the data- and fc1 tensor-parallel steps, and ``train``
through the CLI at world size N and 1.

Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero at once.  Scratch files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the call path's shapes: batch 4096, k-mer 17, 128-wide embedding + 3
# features, hidden 256
B, T, D, H = 4096, 17, 131, 256
N_ROWS = 20000          # synthetic feature rows: 4 full device batches + tail
SITES_PER_READ = 40
READS_PER_BATCH = 50    # run_call_mods's f5_batch_num: 10 read batches
# the reads path: 120 in-memory reads of 8,000 bases (about 500 CpG sites
# each, 60,000 in all, 15 device batches); 8 reads a worker batch, 3
# workers (nproc 4); the native featurizer held against its plain version
# on 8 reads; the same reads as fast5 files through the port's reader
N_READS = 120
READ_BASES = 8000
READS_PER_WORKER_BATCH = 8
EXTRACT_NPROC = 4
FEATURIZE_READS = 8
READS_SEED = 606
FAST5_FIXTURES = ("synthetic", "tombo_like", "latest", "no_alignment",
                  "tombo_latest")
# one read in HDF5's earliest format and, from the same draws, in its latest
# (dense links and attributes, an extensible-array chunk index); the reader
# timed on this many copies of each
FORMAT_FIXTURES = ("tombo_like", "tombo_latest")
FORMAT_COPIES = 120
# the TF1 phase: the published name space (581 variables) with seeded
# values; evaluate's shuffle
TF1_VARIABLES = 581
TF1_SEED, EVAL_SEED = 7, 608
# the train path: batch 512 (TrainConfig's default), 12 train batches and 2
# validation batches (the second one padded), a sweep every 6 steps
TRAIN_B = 512
TRAIN_ROWS = 12 * TRAIN_B
VALID_ROWS = 1000
DISPLAY_STEP = 6
# denoise: the RNN-only model's encoder input is the 3 per-base features;
# 4000 rows split into halves of 2000, each 3 batches of 512 and a tail of
# 464 rows; 30% of the positives carry the signal of negatives
D_DENOISE = 3
DENOISE_ROWS = 4000
DENOISE_TAIL = DENOISE_ROWS // 2 % TRAIN_B
DENOISE_NOISY = 0.3
# a denoise round trains 4 steps a half; prob_1 of a true positive passes
# score_cf 0.5 only when the classes sit far apart: on the CPU, this
# configuration kept 98% of the true positives at a shift of 3 (unit noise),
# 39% at 2 and 1% at 1, and none of the mislabelled ones
DENOISE_SHIFT = 3.0
# kernel vs plain, max abs: float32 sums in another order; in bfloat16 the
# output may sit one bfloat16 rounding (2**-8 near 1) apart
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# one train step through the kernels vs the plain versions: the loss, and
# all gradients as one vector, |g_kernel - g_plain| / |g_plain| (2-norms).
# float32 layers pass on 1e-7 differences.  In bfloat16 some K2 outputs sit
# one rounding (2**-8) apart, and the bfloat16 forward and backward
# downstream round again at other places: a few 2**-8, with a margin.
STEP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# the parallel phase's steps against one process run at this learning
# rate, which only the loss of step 2 and later feels (step 1's gradients
# are held to GRAD_TOL below).  Adam's first step moves every weight by
# +-lr (a sign step), and the batch-norm gradients are ill-conditioned: in
# float32 some are 2% off their float64 values, so a reordered sum flips
# the step of some of them, and the next loss moves in proportion to lr.
# At TrainConfig's 1e-3 the 6032-wide head makes step 2's loss 20-40 and
# two non-distributed runs on an H100 read 2e-3 apart at step 2 and 7e-2
# at step 9, which resolves no fault; at 1e-5 two ranks read 5.7e-5
# (relative) from one process at step 2, too near STEP_TOL.  World size 1
# trains WORLD1_STEPS steps of the train set, a sweep every 2.
PARITY_LR = 2e-6
# the ranks' step 1 gradients against one process's, per parameter, the
# relative difference of their 2-norms.  Step 1's gradients are taken at
# the initial weights, so the learning rate does not reach them.  Batch
# norm's gradients are ill-conditioned and the max-pools' ties break on
# rounding, so a reordered sum moves some batch-norm parameter's gradient
# norm by far more than a rounding.  check_steps prints its readings: on
# an H100 80GB HBM3 at 700 W two one-process runs read 2.5e-8 apart, one
# on signals moved by 1e-7 (relative) 4.8e-3, two gloo ranks 4.6e-3
# (data-parallel) and 4.8e-7 (tensor-parallel).  The limit is 4x the
# perturbed reading; a gradient summed over the ranks wrongly (a backward
# left unsummed, a factor of the rank count) moves some norm by tens of
# percent.
GRAD_TOL = 2e-2
WORLD1_STEPS = 4
MARGIN = 1e-3           # label check skips sites with |p1 - p0| below this
# a device batch's calls vs the plain encoder, max |dprob|: on an H100 80GB
# HBM3 at 700 W the first batches read 2.6e-3 to 3.1e-3 in bfloat16 and
# 9.1e-7 to 1.2e-6 in float32; a broken encoder moves them by far more
DPROB_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the library phase: the TSV's first rows, two device batches of B
LIBRARY_ROWS = 2 * B
# forward_with_loss on the card against the CPU (a mean in another order)
LOSS_RTOL = 1e-6
# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# FLOP/s of float32 FMA outside the tensor cores and of bfloat16 tensor cores
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median over ``reps`` of one call, timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


# --------------------------------------------------------------------------
# K1: the fused BiLSTM encoder


def encoder_inputs(rng, dtype, device, shape=None):
    """Seeded encoder inputs at shape (batch, steps, depth, hidden), by
    default the call path's."""
    import torch

    b, t, d, h = shape or (B, T, D, H)

    def arr(a):
        return torch.from_numpy(a.astype("float32")).to(device).to(dtype)

    x = arr(rng.normal(0, 1, (b, t, d)))
    def kernels():
        return [arr(rng.uniform(-0.07, 0.07, (d_in + h, 4 * h)))
                for d_in in (d, h, h)]
    def biases():
        return [arr(rng.normal(0, 0.05, 4 * h)) for _ in range(3)]
    return x, kernels(), biases(), kernels(), biases()


# (batch, steps, depth, hidden) of the fused encoder's checks besides the
# call batch: the call path's tail batch, and a ragged small one at H 128
K1_CASES = ((3616, T, D, H), (8, 5, 7, 128))


def ptxas_report(log: str) -> dict:
    """{kernel entry: {registers, spill_stores, spill_loads, stack}} from
    ``nvcc -Xptxas -v`` output."""
    funcs, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w]+)", line)
        if m:
            name = m.group(1)
            funcs.setdefault(name, {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            funcs[name].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            funcs[name]["registers"] = int(m.group(1))
    return funcs


def encoder_instantiations(log: str) -> dict:
    """The fused encoder's kernels in ptxas's report, by dtype and H, each
    with its registers and spills; fails on a spill or a missing one."""
    found = {}
    for name, info in ptxas_report(log).items():
        if "lstm_encoder_kernel" not in name:
            continue
        dtype = "bf16" if "nv_bfloat16" in name else "f32"
        hidden = next((h for h in (128, 256) if f"Li{h}E" in name), None)
        found[f"{dtype}_H{hidden}"] = info
    for key in ("bf16_H256", "bf16_H128", "f32_H256", "f32_H128"):
        check(key in found and "registers" in found[key],
              f"K1 {key}: not in ptxas's report")
        info = found[key]
        print(f"K1 {key}: {info['registers']} registers, "
              f"{info['spill_stores']} bytes spill stores, "
              f"{info['spill_loads']} bytes spill loads, {info['stack']} "
              f"bytes stack", flush=True)
        check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
              f"K1 {key}: ptxas spills")
    return found


def cudnn_lstm(kernels, biases, d: int):
    """``nn.LSTM(d, H, len(kernels))`` holding the TF-layout weights: gates
    permuted from TF's i, j, f, o to PyTorch's i, f, g, o and the forget
    bias folded in.  A yardstick only."""
    import torch
    k0 = kernels[0]
    perm = torch.cat([torch.arange(g * H, (g + 1) * H) for g in (0, 2, 1, 3)])
    lstm = torch.nn.LSTM(d, H, num_layers=len(kernels), batch_first=True).to(
        device=k0.device, dtype=k0.dtype)
    with torch.no_grad():
        for layer, (k, b) in enumerate(zip(kernels, biases)):
            d_in = d if layer == 0 else H
            getattr(lstm, f"weight_ih_l{layer}").copy_(k[:d_in, perm].T)
            getattr(lstm, f"weight_hh_l{layer}").copy_(k[d_in:, perm].T)
            bias = getattr(lstm, f"bias_ih_l{layer}")
            bias.copy_(b[perm])
            bias[H:2 * H] += 1.0
            getattr(lstm, f"bias_hh_l{layer}").zero_()
    lstm.flatten_parameters()
    return lstm


def cudnn_encoder(args):
    """The same function as two cuDNN ``nn.LSTM(num_layers=3)`` calls (fw on
    x, bw on x reversed in time).  A yardstick only."""
    import torch
    x, kf, bf, kb, bb = args
    fw, bw = cudnn_lstm(kf, bf, x.shape[2]), cudnn_lstm(kb, bb, x.shape[2])
    xr = x.flip(1)

    def run():
        with torch.no_grad():
            return torch.cat([fw(x)[0][:, -1], bw(xr)[0][:, -1]], dim=1)
    return run


def encoder_bound_ms(dtype_name: str, elem: int, b: int = B,
                     d: int = D) -> tuple:
    """(bound_ms, bound_by) of the wrapper's work at batch b and depth d:
    layer-0 projection of both directions, then 17 steps x 3 layers x 2
    directions of products."""
    flops = (2 * b * T * d * 8 * H                       # projection
             + 2 * T * b * 2 * 4 * H * (H + 2 * H + 2 * H))  # recurrence
    weights = 2 * ((d + H) + 4 * H) * 4 * H + 2 * 3 * 4 * H
    nbytes = (b * T * d + weights + b * 2 * H) * elem
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_encoder(dtype_name: str, device) -> dict:
    """K1 against its plain version at the call batch (B=4096) and at
    K1_CASES, its tile plan and L2 weight bytes, and its time beside the
    plain version, cuDNN and the layer-0 input product it includes."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import (bilstm_encoder_fused_plain,
                                                 layer0_product)
    from deepsignal_tpu_torch.ops.cuda import lstm
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    dtype = torch_dtype(dtype_name)
    tol = TOL[dtype_name]
    errs = {}
    args = encoder_inputs(np.random.default_rng(17), dtype, device)
    for shape in ((B, T, D, H),) + K1_CASES:
        case = args if shape == (B, T, D, H) else encoder_inputs(
            np.random.default_rng(17), dtype, device, shape)
        got = bilstm_encoder_fused(*case)
        want = bilstm_encoder_fused_plain(*case)
        torch.cuda.synchronize()
        key = "B{}_T{}_D{}_H{}".format(*shape)
        check(tuple(got.shape) == (shape[0], 2 * shape[3])
              and got.dtype == dtype,
              f"K1 {dtype_name} {key}: shape {tuple(got.shape)} {got.dtype}")
        check(bool(torch.isfinite(got).all()),
              f"K1 {dtype_name} {key}: non-finite")
        errs[key] = (got.float() - want.float()).abs().max().item()
        print(f"K1 {dtype_name} {key}: max_abs_err {errs[key]:.3e} "
              f"(tolerance {tol:g})", flush=True)
        check(errs[key] <= tol, f"K1 {dtype_name} {key}: error {errs[key]} "
              f"above {tol}")
        if case is args:
            want_call = want
    plan = lstm.tile_plan(B, H, dtype)
    clusters = lstm.active_clusters(H, dtype)
    l2_bytes = lstm.l2_weight_bytes(B, T, H, dtype)
    waves = -(-plan["grid"][1] * plan["grid"][2] // clusters)
    print(f"K1 {dtype_name}: tile plan {json.dumps(plan)}; {clusters} "
          f"clusters at once, {waves} waves; L2 weight bytes per batch "
          f"{l2_bytes} ({l2_bytes / 1e9:.2f} GB)", flush=True)
    library = cudnn_encoder(args)
    lib_err = (library().float() - want_call.float()).abs().max().item()
    print(f"K1 {dtype_name}: cuDNN yardstick vs plain max_abs_err "
          f"{lib_err:.3e}", flush=True)
    bound, bound_by = encoder_bound_ms(dtype_name, want_call.element_size())
    x, kf, _, kb, _ = args
    row = {"name": f"lstm_encoder_{'f32' if dtype_name == 'float32' else 'bf16'}",
           "route": "cuda",
           "source": "deepsignal_tpu_torch/csrc/lstm_encoder.cu",
           "replaces": "deepsignal_tpu/ops/pallas/lstm.py:42",
           "launches": None, "max_abs_err": max(errs.values()),
           "ms": cuda_ms(lambda: bilstm_encoder_fused(*args)),
           "plain_ms": cuda_ms(lambda: bilstm_encoder_fused_plain(*args)),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": cuda_ms(library),
           "projection_ms": cuda_ms(lambda: layer0_product(x, kf[0],
                                                           kb[0])),
           "cases": errs, "plan": plan, "active_clusters": clusters,
           "waves": waves, "l2_weight_bytes": l2_bytes}
    print(f"K1 {dtype_name}: kernel {row['ms']:.3f} ms (of it the layer-0 "
          f"product {row['projection_ms']:.3f} ms), plain "
          f"{row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by})", flush=True)
    return row


def check_encoder_d3(dtype_name: str, device) -> dict:
    """K1 at denoise's scoring shapes: depth 3 (the RNN-only model's three
    per-base features), the batch of 512 and the tail's 464 rows, against
    its plain version, one launch each; its time at B=512 beside the plain
    version, cuDNN and the bound.  Returns the keys it adds to K1's row."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import bilstm_encoder_fused_plain
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    dtype = torch_dtype(dtype_name)
    tol = TOL[dtype_name]
    rng = np.random.default_rng(43)
    errs = {}
    for b in (TRAIN_B, DENOISE_TAIL):
        shape = (b, T, D_DENOISE, H)
        case = encoder_inputs(rng, dtype, device, shape)
        before = bilstm_encoder_fused.launches
        got = bilstm_encoder_fused(*case)
        want = bilstm_encoder_fused_plain(*case)
        torch.cuda.synchronize()
        key = "B{}_T{}_D{}_H{}".format(*shape)
        check(bilstm_encoder_fused.launches == before + 1,
              f"K1 {dtype_name} {key}: the kernel did not launch once")
        check(tuple(got.shape) == (b, 2 * H) and got.dtype == dtype
              and bool(torch.isfinite(got).all()),
              f"K1 {dtype_name} {key}: {tuple(got.shape)} {got.dtype}")
        errs[key] = (got.float() - want.float()).abs().max().item()
        print(f"K1 {dtype_name} {key}: max_abs_err {errs[key]:.3e} "
              f"(tolerance {tol:g})", flush=True)
        check(errs[key] <= tol, f"K1 {dtype_name} {key}: error {errs[key]} "
              f"above {tol}")
        if b == TRAIN_B:
            args = case
    library = cudnn_encoder(args)
    bound, bound_by = encoder_bound_ms(dtype_name, args[0].element_size(),
                                       TRAIN_B, D_DENOISE)
    row = {"ms_d3": cuda_ms(lambda: bilstm_encoder_fused(*args)),
           "plain_ms_d3": cuda_ms(lambda: bilstm_encoder_fused_plain(*args)),
           "library_ms_d3": cuda_ms(library), "bound_ms_d3": bound,
           "bound_by_d3": bound_by, "cases_d3": errs}
    print(f"K1 {dtype_name} D{D_DENOISE} B{TRAIN_B}: kernel "
          f"{row['ms_d3']:.3f} ms, plain {row['plain_ms_d3']:.3f} ms, cuDNN "
          f"{row['library_ms_d3']:.3f} ms, bound {bound:.4f} ms ({bound_by})",
          flush=True)
    return row


# --------------------------------------------------------------------------
# K2: the per-layer LSTM scan


def scan_inputs(rng, d, dtype, device, shape=None):
    """Seeded K2 inputs (x, kernel, bias) at (batch, steps, depth, hidden),
    by default the train path's with depth ``d``."""
    import torch

    b, t, d, h = shape or (TRAIN_B, T, d, H)

    def arr(a):
        return torch.from_numpy(a.astype("float32")).to(device).to(dtype)

    return (arr(rng.normal(0, 1, (b, t, d))),
            arr(rng.uniform(-0.07, 0.07, (d + h, 4 * h))),
            arr(rng.normal(0, 0.05, 4 * h)))


# (batch, steps, depth, hidden) of K2's checks besides the two train shapes
# (depth 131 for layer 0, 256 for layers 1-2): a ragged tile, the call
# path's small batch (the per-layer encoder), and two hidden sizes that take
# the streaming variant
K2_CASES = ((9, T, H, H), (4, T, D, H), (3, 5, 7, 100), (9, 5, 16, 512))


def scan_instantiations(log: str) -> dict:
    """K2's resident kernels in ptxas's report, by dtype, H and batch tile,
    each with its registers and spills; fails on a spill or a missing
    one."""

    import torch

    from deepsignal_tpu_torch.ops.cuda import lstm_scan
    found = {}
    for name, info in ptxas_report(log).items():
        m = re.search(r"lstm_scan_resident_kernelI(13__nv_bfloat16|f)"
                      r"Li(\d+)ELi(\d+)E", name)
        if m:
            dtype = "f32" if m.group(1) == "f" else "bf16"
            found[f"{dtype}_H{m.group(2)}_R{m.group(3)}"] = info
    for dtype, key in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for hidden in lstm_scan.RESIDENT_HIDDEN:
            for rows in lstm_scan.ROW_TILES[dtype]:
                name = f"{key}_H{hidden}_R{rows}"
                check(name in found and "registers" in found[name],
                      f"K2 {name}: not in ptxas's report")
                info = found[name]
                print(f"K2 resident {name}: {info['registers']} registers, "
                      f"{info['spill_stores']} bytes spill stores, "
                      f"{info['spill_loads']} bytes spill loads", flush=True)
                check(info["spill_stores"] == 0 and info["spill_loads"] == 0,
                      f"K2 {name}: ptxas spills")
    return found


def cudnn_scan(x, kernel, bias, reverse):
    """The same function as one cuDNN ``nn.LSTM(D, H, 1)`` call on x
    (flipped in time for ``reverse``).  Returns the timed call and a
    function that brings its output to absolute time.  A yardstick only."""
    import torch
    lstm = cudnn_lstm([kernel], [bias], x.shape[2])
    xin = x.flip(1) if reverse else x

    def run():
        with torch.no_grad():
            return lstm(xin)[0]
    return run, (lambda y: y.flip(1)) if reverse else (lambda y: y)


def scan_bound_ms(d: int, dtype_name: str, elem: int) -> tuple:
    """(bound_ms, bound_by) of one wrapper call: the input projection and
    T steps of the recurrent product (the gate math is not counted)."""
    flops = 2 * TRAIN_B * T * d * 4 * H + 2 * TRAIN_B * T * H * 4 * H
    nbytes = (TRAIN_B * T * d + (d + H) * 4 * H + 4 * H
              + TRAIN_B * T * H) * elem
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_scan(args, dtype_name: str) -> dict:
    """One forward K2 call at a train shape: the wrapper (input product
    included), its parts (the input product; the resident launch alone on
    that product), the input product and the streaming variant on the same
    inputs (the design K2 had before, its bias pass now in the kernel), the
    plain version and cuDNN."""
    import torch

    from deepsignal_tpu_torch.ops.bilstm import input_product, lstm_scan_plain
    from deepsignal_tpu_torch.ops.cuda import lstm_scan

    x, kernel, bias = args
    b, t, d = x.shape
    plan = lstm_scan.card_plan(b, H, x.dtype, x.device)
    xp = input_product(x.reshape(b * t, d), kernel[:d]).reshape(b, t, 4 * H)
    streaming = lstm_scan.streaming_plan(b, H)
    library, _ = cudnn_scan(*args, False)
    with torch.no_grad():
        calls = {
            "ms": lambda: lstm_scan.lstm_layer_scan(*args),
            "product_ms": lambda: input_product(x.reshape(b * t, d),
                                                kernel[:d]),
            "kernel_ms": lambda: lstm_scan.scan_on_product(
                xp, kernel[d:], bias, False, plan),
            "streaming_ms": lambda: lstm_scan.scan_on_product(
                input_product(x.reshape(b * t, d), kernel[:d]).reshape(
                    b, t, 4 * H), kernel[d:], bias, False, streaming),
            "plain_ms": lambda: lstm_scan_plain(*args),
            "library_ms": library}
        # in turns, so that a drift of the card's clock hits all alike
        times = {k: [] for k in calls}
        for _ in range(2):
            for k, fn in calls.items():
                times[k].append(cuda_ms(fn))
    res = {k: float(np.median(v)) for k, v in times.items()}
    res["bound_ms"], res["bound_by"] = scan_bound_ms(d, dtype_name,
                                                     x.element_size())
    return res


def time_tiles(dtype, device) -> dict:
    """The resident kernel alone at each built batch tile, at the call
    path's small batch (4) and the training batch, with the waves each
    tile takes there, and the tile ``card_plan`` picks."""
    import torch

    from deepsignal_tpu_torch.ops.bilstm import input_product
    from deepsignal_tpu_torch.ops.cuda import lstm_scan

    rng = np.random.default_rng(29)
    tiles = lstm_scan.ROW_TILES[dtype]
    at_once = {r: lstm_scan.active_clusters(H, dtype, r) for r in tiles}
    res = {}
    for b in (4, TRAIN_B):
        x, kernel, bias = scan_inputs(rng, D, dtype, device, (b, T, D, H))
        xp = input_product(x.reshape(b * T, D), kernel[:D]).reshape(
            b, T, 4 * H)
        plans = {r: lstm_scan.resident_plan(b, H, dtype, r) for r in tiles}
        times = {r: [] for r in tiles}
        with torch.no_grad():
            for _ in range(2):  # in turns, as in time_scan
                for r, plan in plans.items():
                    times[r].append(cuda_ms(lambda: lstm_scan.scan_on_product(
                        xp, kernel[D:], bias, False, plan)))
        ms = {r: float(np.median(v)) for r, v in times.items()}
        picked = lstm_scan.card_plan(b, H, dtype, x.device)["rows"]
        res[f"B{b}"] = {
            "ms": {str(r): t for r, t in ms.items()},
            "waves": {str(r): -(-p["grid"][1] // at_once[r])
                      for r, p in plans.items()},
            "picked": picked, "picked_fastest": ms[picked] == min(ms.values())}
    return res


def check_scan(dtype_name: str, device) -> dict:
    """K2 against its plain version at the train shapes (B=512, T=17,
    H=256, D=131 for layer 0 and D=256 for layers 1-2, and D=3 for layer 0
    of denoise's RNN-only model) and at K2_CASES, both directions, each
    through the variant ``scan_plan`` gives; its plan, waves and L2 weight
    bytes at B=512; and its times at the three train shapes.  The row's
    ``ms`` is that of the D=256 call (four of the six launches of a train
    step), ``ms_d131`` and ``ms_d3`` those of layer 0's."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import lstm_scan_plain
    from deepsignal_tpu_torch.ops.cuda import lstm_scan
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

    dtype = torch_dtype(dtype_name)
    tol = TOL[dtype_name]
    rng = np.random.default_rng(19)
    shapes, timed = {}, {}
    for shape in ((TRAIN_B, T, D, H), (TRAIN_B, T, H, H),
                  (TRAIN_B, T, D_DENOISE, H)) + K2_CASES:
        b, t, d, h = shape
        args = scan_inputs(rng, d, dtype, device, shape)
        variant = ("resident" if h in lstm_scan.RESIDENT_HIDDEN
                   else "streaming")
        for reverse in (False, True):
            before = dict(lstm_layer_scan.launches_by_variant)
            with torch.no_grad():
                got = lstm_layer_scan(*args, reverse=reverse)
                want = lstm_scan_plain(*args, reverse=reverse)
            torch.cuda.synchronize()
            key = f"B{b}_T{t}_D{d}_H{h}_{'bw' if reverse else 'fw'}"
            launched = {k: n - before[k]
                        for k, n in lstm_layer_scan.launches_by_variant.items()}
            check(launched[variant] == 1 and sum(launched.values()) == 1,
                  f"K2 {dtype_name} {key}: launched {launched}, want one "
                  f"{variant}")
            check(tuple(got.shape) == (b, t, h) and got.dtype == dtype,
                  f"K2 {dtype_name} {key}: {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()),
                  f"K2 {dtype_name} {key}: non-finite")
            err = (got.float() - want.float()).abs().max().item()
            msg = ""
            if b == TRAIN_B:
                library, to_time_order = cudnn_scan(*args, reverse)
                lib_err = (to_time_order(library()).float()
                           - want.float()).abs().max().item()
                msg = f"; cuDNN yardstick vs plain {lib_err:.3e}"
            print(f"K2 {dtype_name} {key} ({variant}): max_abs_err "
                  f"{err:.3e} (tolerance {tol:g}){msg}", flush=True)
            check(err <= tol, f"K2 {dtype_name} {key}: error {err} above "
                  f"{tol}")
            shapes[key] = {"max_abs_err": err, "variant": variant}
        if b == TRAIN_B:
            timed[d] = time_scan(args, dtype_name)
            print(f"K2 {dtype_name} D{d}: {json.dumps(timed[d])}", flush=True)
    clusters = lstm_scan.active_clusters(H, dtype)
    plan = lstm_scan.scan_plan(TRAIN_B, H, dtype, clusters)
    at_once = lstm_scan.active_clusters(H, dtype, plan["rows"])
    waves = -(-plan["grid"][1] // at_once)
    l2_bytes = lstm_scan.l2_weight_bytes(plan, T, H, dtype)
    l2_streaming = lstm_scan.l2_weight_bytes(
        lstm_scan.streaming_plan(TRAIN_B, H), T, H, dtype)
    print(f"K2 {dtype_name}: scan plan at B={TRAIN_B} {json.dumps(plan)}; "
          f"{at_once} clusters at once, {waves} wave(s); L2 weight bytes "
          f"per launch by the plan {l2_bytes} ({l2_bytes / 1e6:.1f} MB; the "
          f"streaming variant {l2_streaming / 1e9:.2f} GB)", flush=True)
    check(plan["variant"] == "resident" and waves == 1,
          f"K2 {dtype_name}: B={TRAIN_B} takes {waves} waves")
    tiles = time_tiles(dtype, device)
    print(f"K2 {dtype_name}: resident kernel alone by batch tile "
          f"{json.dumps(tiles)}", flush=True)
    row = timed[H]
    return {"name": f"lstm_scan_{'f32' if dtype_name == 'float32' else 'bf16'}",
            "route": "cuda", "source": "deepsignal_tpu_torch/csrc/lstm_scan.cu",
            "replaces": "deepsignal_tpu/ops/pallas/lstm.py:202",
            "launches": None,
            "max_abs_err": max(v["max_abs_err"] for v in shapes.values()),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "ms_d131": timed[D]["ms"], "plain_ms_d131": timed[D]["plain_ms"],
            "bound_ms_d131": timed[D]["bound_ms"],
            "library_ms_d131": timed[D]["library_ms"],
            "ms_d3": timed[D_DENOISE]["ms"],
            "plain_ms_d3": timed[D_DENOISE]["plain_ms"],
            "bound_ms_d3": timed[D_DENOISE]["bound_ms"],
            "bound_by_d3": timed[D_DENOISE]["bound_by"],
            "library_ms_d3": timed[D_DENOISE]["library_ms"],
            "times": {f"D{d}": v for d, v in timed.items()}, "tiles": tiles,
            "plan": plan, "active_clusters": at_once, "waves": waves,
            "cases": shapes}


# --------------------------------------------------------------------------
# gradients and the per-layer path on the card


def check_gradients(dtype_name: str, device) -> dict:
    """K1's and K2's autograd gradients (x, kernels, biases) at B=512
    against autograd through their plain versions, with a loss linear in
    the output (so both backward passes get the same cotangent)."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import (bilstm_encoder_plain,
                                                 lstm_scan_plain)
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

    dtype = torch_dtype(dtype_name)
    rng = np.random.default_rng(23)
    x, kf, bf, kb, bb = encoder_inputs(rng, dtype, device)
    x = x[:TRAIN_B].contiguous()
    cases = {
        "K1": ([x, *kf, *bf, *kb, *bb],
               lambda x, *p: bilstm_encoder_fused(x, p[0:3], p[3:6], p[6:9],
                                                  p[9:12]),
               lambda x, *p: bilstm_encoder_plain(x, p[0:3], p[3:6], p[6:9],
                                                  p[9:12])),
        "K2": (list(scan_inputs(rng, H, dtype, device)),
               lambda *a: lstm_layer_scan(*a, reverse=True),
               lambda *a: lstm_scan_plain(*a, reverse=True)),
    }
    errs = {}
    for name, (arrays, fn, plain) in cases.items():
        grads = []
        for f in (fn, plain):
            args = [a.detach().clone().requires_grad_(True) for a in arrays]
            out = f(*args)
            weights = torch.linspace(-1, 1, out.numel(), device=device)
            (out.float() * weights.reshape(out.shape)).sum().backward()
            grads.append([a.grad.float() for a in args])
        torch.cuda.synchronize()
        # the backward of each Function is autograd through the plain
        # version: the same arithmetic, equal up to library sum order
        rel = max((g - w).abs().max().item() / max(w.abs().max().item(),
                                                   1e-30)
                  for g, w in zip(*grads))
        finite = all(bool(torch.isfinite(g).all()) for g in grads[0])
        print(f"gradients {name} {dtype_name}: largest difference / largest "
              f"gradient {rel:.3e} over {len(arrays)} inputs", flush=True)
        check(finite, f"gradients {name} {dtype_name}: non-finite")
        check(rel <= 1e-5, f"gradients {name} {dtype_name}: {rel} above 1e-5")
        errs[name] = rel
    return errs


def check_small_batch(dtype_name: str, device) -> None:
    """A batch of 4, which the fused kernel does not take, runs the
    encoder's per-layer path: six K2 launches and none of K1, and the same
    output as the encoder with the plain scan (and, in float32, as the plain
    encoder)."""
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.models import layers
    from deepsignal_tpu_torch.ops.bilstm import (bilstm_encoder_plain,
                                                 lstm_scan_plain)
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

    dtype = torch_dtype(dtype_name)
    enc = layers.BiLSTMEncoder(D, H, 3).to(device)
    gen = torch.Generator(device=device).manual_seed(29)
    with torch.no_grad():
        for p in enc.parameters():
            p.uniform_(-0.07, 0.07, generator=gen)
    x = torch.randn(4, T, D, device=device, generator=gen).to(dtype)
    scans, fused = lstm_layer_scan.launches, bilstm_encoder_fused.launches
    resident = lstm_layer_scan.launches_by_variant["resident"]
    with torch.no_grad():
        got = enc(x)
        torch.cuda.synchronize()
        check(lstm_layer_scan.launches - scans == 6
              and lstm_layer_scan.launches_by_variant["resident"] - resident
              == 6 and bilstm_encoder_fused.launches == fused,
              f"batch 4 {dtype_name}: {lstm_layer_scan.launches - scans} K2 "
              f"({lstm_layer_scan.launches_by_variant['resident'] - resident}"
              f" resident) and {bilstm_encoder_fused.launches - fused} K1 "
              f"launches")
        with mock.patch.object(layers, "lstm_layer_scan", lstm_scan_plain):
            want = enc(x)
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            params = [[getattr(getattr(enc, f"{side}_{i}"), leaf)
                       for i in range(3)]
                      for side in ("fw", "bw") for leaf in ("kernel", "bias")]
            ref = bilstm_encoder_plain(x, *params)
            err = max(err, (got - ref).abs().max().item())
    print(f"batch 4 {dtype_name}: 6 resident K2 launches, max_abs_err {err:.3e} "
          f"(tolerance {TOL[dtype_name]:g})", flush=True)
    check(err <= TOL[dtype_name], f"batch 4 {dtype_name}: error {err}")


# --------------------------------------------------------------------------
# end to end


def random_state_dict(cfg, rng) -> dict:
    """Seeded float32 weights for every tensor of DeepSignalNet(cfg), with
    batch-norm statistics away from the identity."""
    import torch

    from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in DeepSignalNet(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            a = rng.uniform(0.8, 1.2, shape)
        elif leaf == "mean":
            a = rng.normal(0, 0.5, shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 2.0, shape)
        elif leaf == "bias":
            a = rng.normal(0, 0.05, shape)
        elif name == "embedding":
            a = rng.normal(0, (2.0 / shape[0]) ** 0.5, shape)
        elif leaf == "kernel":  # LSTM, [(D+H), 4H]
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            a = rng.uniform(-lim, lim, shape)
        else:  # conv [Cout, Cin, K] or dense [out, in]
            a = rng.normal(0, (int(np.prod(shape[1:]))) ** -0.5, shape)
        sd[name] = a.astype(np.float32)
    return sd


def spread_logits(cfg, sd: dict, tsv: str) -> None:
    """Give the random model confident, mixed calls.  Random weights call
    every site alike: the joint features share one large common mode, and
    what varies from site to site is small.  Set fc2's logit difference to
    the main direction in which the fc1 outputs of the first rows vary
    (made orthogonal to their mean, so labels split), scaled to a logit
    spread of 2."""
    import torch

    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    model = model_from_state_dict(cfg, sd, torch.device("cuda"))
    with open(tsv) as f:
        fb = parse_feature_lines([next(f) for _ in range(512)])
    seen = {}
    hook = model.joint_model.register_forward_pre_hook(
        lambda module, args: seen.setdefault("joint", args[0]))
    with torch.inference_mode():
        model(*(torch.from_numpy(a).cuda() for a in
                (fb.kmers, fb.means, fb.stds, fb.lens.astype(np.float32),
                 fb.signals)))
    hook.remove()
    fc1 = seen["joint"].double().cpu().numpy() @ sd["joint_model.fc1.weight"].T
    mean = fc1.mean(axis=0)
    diff = np.linalg.svd(fc1 - mean, full_matrices=False)[2][0]
    diff -= (diff @ mean) / (mean @ mean) * mean
    diff *= 2.0 / (fc1 @ diff).std()
    w2 = sd["joint_model.fc2.weight"].astype(np.float64)
    w2[1] = w2[0] + diff
    sd["joint_model.fc2.weight"] = w2.astype(np.float32)


def write_features(path: str, cfg, rng) -> None:
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    k, s = cfg.kmer_len, cfg.cent_signals_len
    bases = np.array(list("ACGT"))
    with open(path, "w") as f:
        for i in range(N_ROWS):
            kmer = bases[rng.integers(0, 4, k)]
            kmer[k // 2:k // 2 + 2] = ["C", "G"]
            f.write(format_feature_row(
                "chr1", 1000 + i, "+", 1000 + i,
                f"read{i // SITES_PER_READ:05d}", "t", "".join(kmer),
                rng.normal(0, 1, k), np.abs(rng.normal(0.3, 0.1, k)),
                rng.integers(3, 30, k), np.around(rng.normal(0, 1, s), 6),
                1) + "\n")


def run_e2e(dtype_name, tsv, ckpt, out_path) -> tuple:
    """``run_call_mods`` on the TSV: K1 launched once per device batch, the
    native parser once per read batch (in the reader process), the native
    formatter and read counter once per device-sized block; the calls in
    input order, finite, summing to 1, with mixed labels."""
    from deepsignal_tpu_torch.io import native
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import run_call_mods

    bilstm_encoder_fused.launches = 0
    native.parse_feature_block.calls = native.format_call_block.calls = 0
    native.count_read_runs.calls = 0
    printed = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(printed):
        n = run_call_mods(tsv, ckpt, out_path, batch_size=B,
                          compute_dtype=dtype_name)
    seconds = time.time() - t0
    print(printed.getvalue(), end="", flush=True)
    # the meter's line: its clock starts after the checkpoint is loaded
    meter = re.search(r"\[call_mods\] \d+ sites, .* in ([\d.]+)s \| (\d+) "
                      r"sites/s", printed.getvalue())
    check(meter is not None, f"{dtype_name}: no meter line")
    launches = bilstm_encoder_fused.launches
    host_calls = {"parse": native.parse_feature_block.calls,
                  "format": native.format_call_block.calls,
                  "count_read_runs": native.count_read_runs.calls}
    device_batches = -(-N_ROWS // B)
    read_batches = -(-(N_ROWS // SITES_PER_READ) // READS_PER_BATCH)
    check(n == N_ROWS, f"{dtype_name}: {n} calls for {N_ROWS} rows")
    check(launches == device_batches,
          f"{dtype_name}: K1 launched {launches} times for {device_batches} "
          f"device batches")
    check(host_calls == {"parse": read_batches, "format": device_batches,
                         "count_read_runs": device_batches},
          f"{dtype_name}: native calls {host_calls}, want {read_batches} "
          f"parses and {device_batches} of each of the others")
    with open(out_path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    with open(tsv) as f:
        want_info = [line.split("\t", 6)[:6] for line in f]
    check(len(rows) == N_ROWS, f"{dtype_name}: {len(rows)} output rows")
    check(all(len(r) == 10 for r in rows), f"{dtype_name}: not 10 columns")
    check([r[:6] for r in rows] == want_info,
          f"{dtype_name}: rows out of input order")
    p = np.array([[float(r[6]), float(r[7])] for r in rows])
    labels = np.array([int(r[8]) for r in rows])
    check(bool(np.isfinite(p).all()), f"{dtype_name}: non-finite probs")
    check(float(np.abs(p.sum(1) - 1).max()) < 1e-5,
          f"{dtype_name}: prob_0 + prob_1 != 1")
    check(set(labels.tolist()) <= {0, 1}, f"{dtype_name}: labels")
    check(0.05 < labels.mean() < 0.95,
          f"{dtype_name}: {labels.mean():.3f} of the labels are 1")
    reads = N_ROWS // SITES_PER_READ
    res = {"dtype": dtype_name, "rows": n, "reads": reads,
           "seconds": seconds, "sites_per_s": n / seconds,
           "reads_per_s": reads / seconds, "launches": launches,
           "meter_seconds": float(meter.group(1)),
           "meter_sites_per_s": int(meter.group(2)),
           "native_calls": host_calls, "label_1_share": float(labels.mean())}
    print(f"e2e {dtype_name}: {json.dumps(res)}", flush=True)
    return res, p, labels, rows


def check_native_host(tsv: str, calls_path: str) -> dict:
    """The native parser against its plain version on the whole call TSV,
    array for array and bit for bit; the native formatter against its plain
    version on the calls ``run_call_mods`` wrote, byte for byte (and equal
    to that file); their times per row; and the background reader's start
    (its first batch) and its whole stream."""
    from deepsignal_tpu_torch.io import calls_codec, feature_codec
    from deepsignal_tpu_torch.runtime.pipeline import \
        stream_file_feature_batches

    with open(tsv, "rb") as f:
        block = f.read()
    lines = block.decode().splitlines(True)
    t0 = time.perf_counter()
    fb = feature_codec.parse_feature_bytes(block)
    parse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = feature_codec.parse_feature_lines_plain(lines)
    parse_plain_s = time.perf_counter() - t0
    check(fb.sampleinfo == plain.sampleinfo, "native parse: sampleinfo")
    for name in ("kmers", "means", "stds", "lens", "signals", "labels"):
        a, b = getattr(fb, name), getattr(plain, name)
        same = (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.view(np.uint32) if a.dtype == np.float32
                                   else a,
                                   b.view(np.uint32) if b.dtype == np.float32
                                   else b))
        check(same, f"native parse: {name} differs from the plain version")

    with open(calls_path, "rb") as f:
        calls = f.read()
    rows = [line.split("\t") for line in calls.decode().splitlines()]
    p0 = np.array([r[6] for r in rows], dtype=np.float32)
    p1 = np.array([r[7] for r in rows], dtype=np.float32)
    pred = np.array([int(r[8]) for r in rows], dtype=np.int64)
    t0 = time.perf_counter()
    got = calls_codec.format_call_block(fb.sampleinfo, p0, p1, pred, fb.kmers)
    format_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = calls_codec.format_call_block_plain(fb.sampleinfo, p0, p1, pred,
                                               fb.kmers)
    format_plain_s = time.perf_counter() - t0
    check(got == want, "native call rows differ from the plain version")
    check(got == calls, "native call rows differ from run_call_mods's file")

    t0 = time.perf_counter()
    stream = stream_file_feature_batches(tsv, READS_PER_BATCH)
    n = len(next(stream))
    reader_start_s = time.perf_counter() - t0
    n += sum(len(b) for b in stream)
    reader_s = time.perf_counter() - t0
    check(n == N_ROWS, f"reader: {n} rows of {N_ROWS}")
    res = {"parse_us_per_row": parse_s / N_ROWS * 1e6,
           "parse_plain_us_per_row": parse_plain_s / N_ROWS * 1e6,
           "format_us_per_row": format_s / N_ROWS * 1e6,
           "format_plain_us_per_row": format_plain_s / N_ROWS * 1e6,
           "reader_start_s": reader_start_s, "reader_s": reader_s}
    print(f"native host: {json.dumps(res)}", flush=True)
    return res


def time_stages(tsv, ckpt, calls, native: dict) -> dict:
    """Seconds of each stage of the bfloat16 run, one at a time: checkpoint
    load onto the card, TSV parse (native and, through the same read
    grouping, plain), device forward of every batch (CUDA events), call-row
    formatting (native and plain); and one forward batch's host-clock time,
    device time, idle share and top device ops (``torch.profiler``)."""
    import dataclasses
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.io import feature_codec
    from deepsignal_tpu_torch.io.calls_codec import (format_call_block,
                                                     format_call_block_plain)
    from deepsignal_tpu_torch.io.feature_codec import (
        FeatureBatch, iter_feature_batches_by_read)
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    from deepsignal_tpu_torch.parallel.mesh import pad_to_multiple
    from deepsignal_tpu_torch.train.checkpoints import (
        load_checkpoint, variables_to_state_dict)

    stages = {}
    t0 = time.time()
    cfg, variables = load_checkpoint(ckpt)
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
    model = model_from_state_dict(cfg, variables_to_state_dict(cfg, variables),
                                  torch.device("cuda"))
    torch.cuda.synchronize()
    stages["load_s"] = time.time() - t0
    t0 = time.time()
    fb = FeatureBatch.concat(list(iter_feature_batches_by_read(
        tsv, READS_PER_BATCH)))
    stages["parse_s"] = time.time() - t0

    # the same grouping with the pure-Python parse the native one replaced
    def parse_plain(block):
        return feature_codec.parse_feature_lines_plain(
            block.decode().splitlines(True))

    with mock.patch.object(feature_codec, "parse_feature_bytes", parse_plain):
        t0 = time.time()
        FeatureBatch.concat(list(iter_feature_batches_by_read(
            tsv, READS_PER_BATCH)))
        stages["parse_plain_s"] = time.time() - t0
    batches = []
    for i in range(0, len(fb), B):
        batches.append([torch.from_numpy(pad_to_multiple(a[i:i + B], B)[0])
                        .cuda() for a in (fb.kmers, fb.means, fb.stds,
                                          fb.lens.astype(np.float32),
                                          fb.signals)])

    def forward_all():
        with torch.inference_mode():
            for batch in batches:
                model(*batch)
    stages["device_s"] = cuda_ms(forward_all, reps=3, warmup=1) / 1e3

    def forward_one():
        with torch.inference_mode():
            model(*batches[0])
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward_one()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    device_ms, top = profile_steps(forward_one, top=10)
    stages["forward_profile"] = {
        "batch": B, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_idle_share": 1 - device_ms / wall_ms, "top_ops": top}
    print(f"forward profile bfloat16, one batch of {B}: "
          f"{json.dumps(stages['forward_profile'])}", flush=True)
    p0 = np.float32([r[6] for r in calls])
    p1 = np.float32([r[7] for r in calls])
    pred = np.array([int(r[8]) for r in calls])
    t0 = time.time()
    format_call_block(fb.sampleinfo, p0, p1, pred, fb.kmers)
    stages["format_s"] = time.time() - t0
    t0 = time.time()
    format_call_block_plain(fb.sampleinfo, p0, p1, pred, fb.kmers)
    stages["format_plain_s"] = time.time() - t0
    stages.update(native)
    print(f"stages bfloat16: {json.dumps(stages)}", flush=True)
    return stages


def check_first_batch(dtype_name, tsv, ckpt, probs, labels) -> None:
    """Labels of the first device batch of the TSV equal those of the same
    model with the plain encoder (outside the |p1 - p0| < MARGIN band)."""
    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    with open(tsv) as f:
        fb = parse_feature_lines([next(f) for _ in range(B)])
    check_batch_against_plain(dtype_name, "e2e", fb, ckpt, probs[:B],
                              labels[:B])


def check_batch_against_plain(dtype_name, tag, fb, ckpt, probs,
                              labels) -> dict:
    """The calls of one device batch (``probs`` [n, 2], ``labels`` [n])
    against the same model with the plain encoder on the batch's features:
    no label differs outside the |p1 - p0| < MARGIN band, and no
    probability by DPROB_TOL or more."""
    import dataclasses
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.models import layers
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    from deepsignal_tpu_torch.ops.bilstm import bilstm_encoder_fused_plain
    from deepsignal_tpu_torch.train.checkpoints import (
        load_checkpoint, variables_to_state_dict)

    cfg, variables = load_checkpoint(ckpt)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype_name)
    model = model_from_state_dict(cfg, variables_to_state_dict(cfg, variables),
                                  torch.device("cuda"))
    dev = [torch.from_numpy(a).cuda() for a in
           (fb.kmers, fb.means, fb.stds, fb.lens.astype(np.float32),
            fb.signals)]
    with torch.inference_mode(), \
            mock.patch.object(layers, "bilstm_encoder_fused",
                              bilstm_encoder_fused_plain):
        act = torch.sigmoid(model(*dev)).cpu().numpy()
    p_plain = act / act.sum(1, keepdims=True)
    plain_labels = act.argmax(1)
    sure = np.abs(p_plain[:, 1] - p_plain[:, 0]) >= MARGIN
    flips = int((plain_labels[sure] != labels[sure]).sum())
    dprob = float(np.abs(p_plain - probs).max())
    print(f"{tag} {dtype_name}: first batch vs plain encoder: {flips} label "
          f"flips over {int(sure.sum())} sites outside the margin, max "
          f"|dprob| {dprob:.3e}", flush=True)
    check(flips == 0, f"{tag} {dtype_name}: {flips} labels differ from the "
          f"plain encoder")
    check(dprob < DPROB_TOL[dtype_name], f"{tag} {dtype_name}: max |dprob| "
          f"{dprob:.3e} vs the plain encoder, bound {DPROB_TOL[dtype_name]}")
    return {"label_flips": flips, "sites_outside_margin": int(sure.sum()),
            "max_dprob": dprob}


# --------------------------------------------------------------------------
# the library calls: ModCaller.call_feature_batch and its relatives


def run_library(dtype_name: str, tsv: str, ckpt: str, e2e_rows: list) -> dict:
    """The JAX package's library calls on the card at full width, on the
    first ``LIBRARY_ROWS`` rows of the TSV: ``parse_feature_lines`` with the
    widths given (equal to the probed parse), ``ModCaller``'s
    ``call_feature_batch`` (K1 once per device batch), ``collect`` and
    ``collect_block`` on one handle (the rows equal the block's lines), the
    rows against the e2e run's calls (labels equal, probabilities within
    DPROB_TOL), ``ModRecord.to_line`` giving back every row,
    ``batch_metrics`` against ``counts_to_metrics`` of the counts made on
    the card, and ``forward_with_loss`` on the card's logits of the first
    batch against the same function on the CPU, in both pos_weight forms.
    It times ``call_feature_batch`` (the per-row ``format_call_row``) beside
    ``dispatch_feature_batch`` + ``collect_block`` (the native formatter)."""
    import dataclasses
    import itertools

    import torch

    from deepsignal_tpu_torch.io.calls_codec import ModRecord
    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.models import forward_with_loss
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import ModCaller
    from deepsignal_tpu_torch.train.checkpoints import load_checkpoint
    from deepsignal_tpu_torch.train.metrics import (batch_metrics,
                                                    counts_to_metrics,
                                                    metric_counts)

    t_phase = time.time()
    cfg, variables = load_checkpoint(ckpt)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype_name)
    tag = f"library {dtype_name}"
    with open(tsv) as f:
        lines = list(itertools.islice(f, LIBRARY_ROWS))
    t0 = time.time()
    fb = parse_feature_lines(lines, kmer_len=cfg.kmer_len,
                             signal_len=cfg.cent_signals_len)
    parse_s = time.time() - t0
    probed = parse_feature_lines(lines)
    check(len(fb) == LIBRARY_ROWS and fb.sampleinfo == probed.sampleinfo
          and all(np.array_equal(getattr(fb, k), getattr(probed, k))
                  for k in ("kmers", "means", "stds", "lens", "signals",
                            "labels")),
          f"{tag}: the parse at the given widths differs from the probed one")
    caller = ModCaller(cfg, variables, batch_size=B, device=None)

    bilstm_encoder_fused.launches = 0
    t0 = time.time()
    rows, pred, (p0, p1) = caller.call_feature_batch(fb)
    first_call_s = time.time() - t0
    launches = bilstm_encoder_fused.launches
    device_batches = -(-LIBRARY_ROWS // B)
    check(launches == device_batches, f"{tag}: K1 launched {launches} times "
          f"for {device_batches} device batches")

    handle = caller.dispatch_feature_batch(fb)
    collected, pred_c, _ = caller.collect(handle)
    block, pred_b, (q0, q1) = caller.collect_block(handle)
    check(block.decode().split("\n") == collected + [""],
          f"{tag}: collect's rows differ from collect_block's block")
    check(np.array_equal(pred_c, pred_b), f"{tag}: collect's labels differ")
    check(collected == rows and np.array_equal(pred, pred_b),
          f"{tag}: a second scoring of the batch differs from the first")

    want = e2e_rows[:LIBRARY_ROWS]
    got = [r.split("\t") for r in rows]
    check(all(len(r) == 10 for r in got), f"{tag}: not 10 columns")
    check([r[:6] + r[8:] for r in got] == [r[:6] + r[8:] for r in want],
          f"{tag}: labels, sites or k-mers differ from the e2e run's calls")
    dprob = float(np.abs(np.float64([r[6:8] for r in got])
                         - np.float64([r[6:8] for r in want])).max())
    check(dprob <= DPROB_TOL[dtype_name], f"{tag}: max |dprob| {dprob} "
          f"against the e2e run's calls, bound {DPROB_TOL[dtype_name]}")
    check(all(ModRecord.from_fields(r.split("\t")).to_line() == r
              for r in rows), f"{tag}: ModRecord.to_line changed a row")

    dev = caller.device
    labels = fb.labels.astype(np.int64)
    on_card = metric_counts(torch.from_numpy(pred).to(dev),
                            torch.from_numpy(labels).to(dev),
                            torch.ones(len(labels), device=dev))
    card_metrics = counts_to_metrics(on_card.cpu())
    host_metrics = batch_metrics(labels, pred)
    check(host_metrics == card_metrics, f"{tag}: batch_metrics "
          f"{host_metrics} != counts_to_metrics {card_metrics}")

    first = [torch.from_numpy(a[:B]).to(dev) for a in
             (fb.kmers, fb.means, fb.stds, fb.lens.astype(np.float32),
              fb.signals)]
    with torch.inference_mode():
        logits = caller.model(*first)
    check(logits.dtype == torch.float32, f"{tag}: logits {logits.dtype}")
    target = torch.from_numpy(labels[:B]).to(dev)
    losses = {}
    for pos_weight in (1.0, 2.5):
        card = float(forward_with_loss(logits, target, 2, pos_weight))
        host = float(forward_with_loss(logits.cpu(), target.cpu(), 2,
                                       pos_weight))
        rel = abs(card - host) / abs(host)
        check(np.isfinite(card) and rel <= LOSS_RTOL, f"{tag}: "
              f"forward_with_loss(pos_weight={pos_weight}) {card} on the "
              f"card, {host} on the CPU")
        losses[str(pos_weight)] = {"card": card, "cpu": host, "rel": rel}

    def seconds(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return sorted(times)[reps // 2]
    call_s = seconds(lambda: caller.call_feature_batch(fb))
    block_s = seconds(lambda: caller.collect_block(
        caller.dispatch_feature_batch(fb)))
    res = {"dtype": dtype_name, "rows": LIBRARY_ROWS, "launches": launches,
           "parse_widths_s": parse_s, "first_call_s": first_call_s,
           "call_feature_batch_s": call_s, "dispatch_collect_block_s": block_s,
           "max_abs_dprob_vs_e2e": dprob, "metrics": list(host_metrics),
           "loss": losses, "phase_s": time.time() - t_phase}
    print(f"library {dtype_name}: {json.dumps(res)} | {card_line()}",
          flush=True)
    return res


# --------------------------------------------------------------------------
# the reads path: featurize -> K1 -> call TSV, from seeded in-memory reads


def make_reads(seed: int) -> list:
    """``N_READS`` in-memory tombo-resquiggled reads of ``READ_BASES``
    uniform random bases, 3-21 raw samples a base, raw int16 values in
    380-919 with the scaling constants of ``write_synthetic_fast5``, drawn
    as the golden fixture draws its reads (tests/test_golden.py); strands
    alternate, and the reads tile the contig."""
    from deepsignal_tpu_torch.io.fast5 import synthetic_read
    return [synthetic_read(**kw)
            for kw in read_kwargs(seed, N_READS, READ_BASES)]


def read_kwargs(seed: int, n: int, bases: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, bases)])
        lengths = rng.integers(3, 22, size=bases)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920, size=int(lengths.sum()) + 7
                           ).astype(np.int16)
        out.append(dict(read_id=f"read-{i:04d}", raw_signal=raw,
                        event_starts_rel=starts, event_lengths=lengths,
                        seq=seq, mapped_chrom="chr1", mapped_start=bases * i,
                        mapped_strand="+-"[i % 2], read_start_rel_to_raw=4))
    return out


def golden_reads() -> list:
    """The three reads of the golden fixture (tests/test_golden.py), drawn
    as it draws them, in memory."""
    from deepsignal_tpu_torch.io.fast5 import synthetic_read
    rng = np.random.default_rng(424242)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    reads = []
    for i, strand in enumerate(["+", "-", "+"]):
        start = 700 * i
        seq = genome[start:start + 250]
        lengths = rng.integers(3, 22, size=len(seq))
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920,
                           size=int(lengths.sum()) + 7).astype(np.int16)
        reads.append(synthetic_read(
            read_id=f"golden-{i}", raw_signal=raw, event_starts_rel=starts,
            event_lengths=lengths, seq=seq, mapped_chrom="chrG",
            mapped_start=start, mapped_strand=strand,
            read_start_rel_to_raw=4))
    return reads


def check_featurize(reads: list) -> tuple:
    """The native featurizer against its plain version on the card's host:
    on ``FEATURIZE_READS`` of the reads, the rows of ``to_tsv_rows`` (native
    segment stats and ``format_rows6``) equal those of the plain segment
    stats and ``format_feature_row`` byte for byte, and their time per
    site; and the golden fixture's rows equal
    tests/golden/features_golden.tsv byte for byte.  Returns (result, the
    rows of those reads)."""
    from unittest import mock

    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.core.constants import get_motif_seqs
    from deepsignal_tpu_torch.featurize import extractor, signal
    from deepsignal_tpu_torch.io import native

    cfg = FeatureConfig()
    motifs = get_motif_seqs(cfg.motifs)
    some = reads[:FEATURIZE_READS]
    signal.featurizer_checked()  # the first use's probe, outside the clock
    native.segment_stats.calls = native.format_rows6.calls = 0
    t0 = time.perf_counter()
    feats = [extractor.extract_read_features(r, motifs, cfg) for r in some]
    rows = [row for f in feats for row in f.to_tsv_rows()]
    native_s = time.perf_counter() - t0
    calls = {"segment_stats": native.segment_stats.calls,
             "format_rows6": native.format_rows6.calls}
    check(calls == {"segment_stats": len(some), "format_rows6": 3 * len(some)},
          f"featurize: native calls {calls}")
    with mock.patch.object(extractor, "segment_stats",
                           signal.segment_stats_plain):
        t0 = time.perf_counter()
        plain_feats = [extractor.extract_read_features(r, motifs, cfg)
                       for r in some]
        plain = [row for f in plain_feats for row in f.to_tsv_rows_plain()]
        plain_s = time.perf_counter() - t0
    check(rows == plain, "featurize: the native rows differ from the plain "
          "version's")
    for f, g in zip(feats, plain_feats):
        for name in ("means", "stds"):
            check(getattr(f, name).tobytes() == getattr(g, name).tobytes(),
                  f"featurize: native segment {name} differ from numpy's")

    # the native MAD normalization (off the path) against the one the path
    # runs, on the same reads
    scaled = [signal.rescale_signals(r.raw_signal, r.scaling, r.offset)
              for r in some]
    t0 = time.perf_counter()
    mad_native = [native.normalize_mad(x) for x in scaled]
    mad_native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mad_path = [signal.normalize_signals(x, "mad") for x in scaled]
    mad_path_s = time.perf_counter() - t0
    check(all(a.tobytes() == b.tobytes() for a, b in zip(mad_native, mad_path)),
          "featurize: the native MAD normalization differs from numpy's")

    golden = [row for f in extractor.extract_fast5_batch(
        golden_reads(), motifs, FeatureConfig(central_sample_seed=99),
        chrom2len={"chrG": 3000})[0] for row in f.to_tsv_rows()]
    with open(os.path.join(REPO, "tests", "golden",
                           "features_golden.tsv")) as f:
        want = f.read().splitlines()
    differ = sum(a != b for a, b in zip(golden, want))
    check(golden == want, f"featurize: {differ} of {len(want)} golden rows "
          f"differ ({len(golden)} rows)")
    res = {"reads": len(some), "sites": len(rows),
           "native_us_per_site": native_s / len(rows) * 1e6,
           "plain_us_per_site": plain_s / len(rows) * 1e6,
           "mad_native_us_per_read": mad_native_s / len(some) * 1e6,
           "mad_path_us_per_read": mad_path_s / len(some) * 1e6,
           "golden_rows": len(golden), "host_cpus": os.cpu_count(),
           "numpy": np.__version__}
    print(f"featurize host: {json.dumps(res)}", flush=True)
    return res, rows


def run_extract_phase(reads: list, rows: list, work: str) -> dict:
    """``run_extract_reads`` (``run_extract``'s seam) on the in-memory
    reads with ``EXTRACT_NPROC`` processes: every read's sites written, and
    the featurize phase's reads give the same rows."""
    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.runtime.pipeline import run_extract_reads

    out = os.path.join(work, "extract.tsv")
    stats = {}
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        errors = run_extract_reads(reads, out, FeatureConfig(),
                                   nproc=EXTRACT_NPROC,
                                   f5_batch_num=READS_PER_WORKER_BATCH,
                                   stats=stats)
    seconds = time.perf_counter() - t0
    print(printed.getvalue(), end="", flush=True)
    names = {r.split("\t", 5)[4] for r in rows}
    with open(out) as f:
        written = f.read().splitlines()
    mine = sorted(r for r in written if r.split("\t", 5)[4] in names)
    check(errors == 0 and stats["lost_batches"] == 0
          and stats["crashed_workers"] == 0, f"extract: {stats}")
    check(stats["rows"] == len(written), "extract: rows written")
    check(mine == sorted(rows), "extract: the rows of the featurize phase's "
          "reads differ")
    res = {"reads": len(reads), "rows": len(written), "seconds": seconds,
           "sites_per_s": len(written) / seconds,
           "workers": stats["n_workers"],
           "first_batch_s": stats["first_batch_s"],
           "reads_per_batch": READS_PER_WORKER_BATCH}
    print(f"extract: {json.dumps(res)}", flush=True)
    return res


def run_e2e_reads(dtype_name: str, reads: list, ckpt: str, work: str,
                  profiled: bool) -> dict:
    """call_mods from the in-memory reads at full width: ``ModCaller`` and
    ``call_mods_on_batches`` over ``stream_read_feature_batches`` (the seam
    of ``stream_fast5_feature_batches``), the workers started before the
    checkpoint loads, as ``run_call_mods`` starts them.  K1 launched once
    per device batch; the calls in stream order, finite, summing to 1;
    the first device batch equal to it through the plain encoder.  Also the
    seconds the caller waited on the workers for batches (the first one
    included).  With ``profiled``, the device's busy time over the run from
    ``torch.profiler``."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.core.logging import ThroughputMeter
    from deepsignal_tpu_torch.io import native
    from deepsignal_tpu_torch.io.feature_codec import FeatureBatch
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import (ModCaller,
                                                     call_mods_on_batches)
    from deepsignal_tpu_torch.runtime.pipeline import \
        stream_read_feature_batches
    from deepsignal_tpu_torch.train.checkpoints import load_checkpoint

    out_path = os.path.join(work, f"calls_reads_{dtype_name}.tsv")
    seen = []
    waited = [0.0]

    def recorded(stream):
        """The stream's batches, kept for the checks, and the time the
        caller waits on the workers for them."""
        while True:
            t = time.perf_counter()
            fb = next(stream, None)
            waited[0] += time.perf_counter() - t
            if fb is None:
                return
            seen.append(fb)
            yield fb

    stats = {}
    prof = profile(activities=[ProfilerActivity.CUDA]) if profiled else \
        contextlib.nullcontext()
    printed = io.StringIO()
    bilstm_encoder_fused.launches = native.segment_stats.calls = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed), prof:
        stream = stream_read_feature_batches(
            reads, FeatureConfig(), nproc=EXTRACT_NPROC,
            f5_batch_num=READS_PER_WORKER_BATCH, stats=stats)
        try:
            cfg, variables = load_checkpoint(ckpt)
            cfg = dataclasses.replace(cfg, compute_dtype=dtype_name)
            caller = ModCaller(cfg, variables, batch_size=B)
            meter = ThroughputMeter("call_mods")
            n = call_mods_on_batches(caller, recorded(stream), out_path,
                                     meter=meter)
        finally:
            stream.close()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = bilstm_encoder_fused.launches
    segment_calls = native.segment_stats.calls
    print(printed.getvalue(), end="", flush=True)
    tag = f"e2e reads {dtype_name}" + (" profiled" if profiled else "")
    check(segment_calls == len(reads), f"{tag}: the workers' native segment "
          f"stats ran {segment_calls} times for {len(reads)} reads")
    fb = FeatureBatch.concat(seen)
    device_batches = -(-len(fb) // B)
    check(n == len(fb) > 0, f"{tag}: {n} calls for {len(fb)} sites")
    check(stats["errors"] == stats["lost_batches"] == 0, f"{tag}: {stats}")
    check(launches == device_batches, f"{tag}: K1 launched {launches} times "
          f"for {device_batches} device batches")
    with open(out_path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    check(["\t".join(r[:6]) for r in rows] == fb.sampleinfo,
          f"{tag}: rows out of stream order")
    p = np.array([[float(r[6]), float(r[7])] for r in rows])
    labels = np.array([int(r[8]) for r in rows])
    check(bool(np.isfinite(p).all()), f"{tag}: non-finite probs")
    check(float(np.abs(p.sum(1) - 1).max()) < 1e-5,
          f"{tag}: prob_0 + prob_1 != 1")
    res = {"dtype": dtype_name, "profiled": profiled, "reads": len(reads),
           "sites": n, "seconds": seconds, "sites_per_s": n / seconds,
           "reads_per_s": len(reads) / seconds,
           "first_batch_s": stats["first_batch_s"],
           "after_first_batch_sites_per_s":
               n / (seconds - stats["first_batch_s"]),
           "wait_for_workers_s": waited[0],
           "workers": stats["n_workers"], "launches": launches,
           "device_batches": device_batches,
           "label_1_share": float(labels.mean())}
    if profiled:
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA
                        and not e.is_user_annotation) / 1e3
        check(device_ms > 0, f"{tag}: the profiler saw no device time")
        res.update(device_ms=device_ms,
                   device_idle_share=1 - device_ms / (seconds * 1e3))
    else:
        res["first_batch"] = check_batch_against_plain(
            dtype_name, "e2e reads", fb[:B], ckpt, p[:B], labels[:B])
    print(f"{tag}: {json.dumps(res)}", flush=True)
    return res


def same_read(got, want) -> bool:
    """Two ``ResquiggledRead``s field for field: types, dtypes, values."""
    import dataclasses
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if type(a) is not type(b) or not np.array_equal(a, b) or \
                getattr(a, "dtype", None) != getattr(b, "dtype", None):
            return False
    return True


def check_fast5_fixtures() -> dict:
    """Each committed fixture of tests/fixtures/fast5 (written by h5py: the
    JAX package's writer's layout, a MinKNOW- and tombo-like file, the
    latest file format, a file with no Alignment) read by the port's
    ``read_resquiggled_fast5`` as the JAX package's reader read it
    (expected.npz), field for field."""
    import dataclasses

    from deepsignal_tpu_torch.io.fast5 import read_resquiggled_fast5

    where = os.path.join(REPO, "tests", "fixtures", "fast5")
    expected = np.load(os.path.join(where, "expected.npz"))
    names = sorted({k.split(".")[0] for k in expected.files})
    check(names == sorted(FAST5_FIXTURES), f"fast5 fixtures: {names}")
    for name in names:
        read = read_resquiggled_fast5(os.path.join(where, f"{name}.fast5"))
        if f"{name}.none" in expected.files:
            check(read is None, f"fast5 fixture {name}: a read where the "
                  "JAX reader found none")
            continue
        for f in dataclasses.fields(read):
            got, want = np.asarray(getattr(read, f.name)), \
                expected[f"{name}.{f.name}"]
            check(got.dtype == want.dtype and np.array_equal(got, want),
                  f"fast5 fixture {name}: {f.name} differs")
    return {"fixtures": names}


# the reader's time per file in a fresh process, as an extract worker reads:
# 3 passes over the files, each with its wall and CPU time, then the files'
# bytes alone (open().read())
READER_TIMING = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from deepsignal_tpu_torch.io.fast5 import read_resquiggled_fast5
paths = sys.argv[2:]
out = {"reader": [], "reader_cpu": [], "open_read": []}
for _ in range(3):
    t0, c0 = time.perf_counter(), time.process_time()
    for p in paths:
        read_resquiggled_fast5(p)
    out["reader"].append((time.perf_counter() - t0) / len(paths) * 1e6)
    out["reader_cpu"].append((time.process_time() - c0) / len(paths) * 1e6)
    t0 = time.perf_counter()
    for p in paths:
        with open(p, "rb") as f:
            f.read()
    out["open_read"].append((time.perf_counter() - t0) / len(paths) * 1e6)
print(json.dumps(out))
"""


def time_reader(paths: list) -> dict:
    """µs per file of ``read_resquiggled_fast5`` on the card's host, median
    of 3 passes over ``paths``: in a fresh process (what an extract worker
    pays; with its CPU time and the bytes' read alone), and in this
    process, which holds the earlier phases' objects and threads."""
    from deepsignal_tpu_torch.io.fast5 import read_resquiggled_fast5

    done = subprocess.run([sys.executable, "-c", READER_TIMING, REPO] + paths,
                          capture_output=True, text=True, timeout=600)
    check(done.returncode == 0, "fast5: the reader's timing process: "
          + done.stderr[-500:])
    fresh = json.loads(done.stdout.splitlines()[-1])
    here = []
    for _ in range(3):
        t0 = time.perf_counter()
        for path in paths:
            read_resquiggled_fast5(path)
        here.append((time.perf_counter() - t0) / len(paths) * 1e6)
    return {"reader_us_per_file": float(np.median(fresh["reader"])),
            "reader_cpu_us_per_file": float(np.median(fresh["reader_cpu"])),
            "open_read_us_per_file": float(np.median(fresh["open_read"])),
            "reader_us_per_file_passes": fresh["reader"],
            "reader_us_per_file_in_this_process": float(np.median(here))}


def run_fast5_phase(ckpt: str, work: str, e2e_reads: list) -> dict:
    """The reads phase's reads as fast5 files, through the port's own HDF5
    code (no h5py): the ``N_READS`` reads written by
    ``write_synthetic_fast5`` (each read back as the in-memory read);
    ``extract -i <dir>`` through the CLI, whose feature TSV equals the
    in-memory reads' (``run_extract_phase``) after sorting; ``call_mods -i
    <dir>`` through the CLI in bfloat16 and float32 at the in-memory runs'
    ``f5_batch_num``, whose calls equal the in-memory reads' calls row for
    row after sorting (every device batch is padded to ``B`` rows, so a
    site's result does not depend on its batch-mates), K1 once per device
    batch; the committed fixtures; the reader's µs per file on the
    card's host (``time_reader``); and one read in two file formats
    (``run_fixture_formats``)."""
    import shutil

    from deepsignal_tpu_torch.io.fast5 import (read_resquiggled_fast5,
                                               synthetic_read,
                                               write_synthetic_fast5)
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    card = card_line()
    f5_dir = os.path.join(work, "fast5")
    shutil.rmtree(f5_dir, ignore_errors=True)
    os.makedirs(f5_dir)
    kwargs = read_kwargs(READS_SEED, N_READS, READ_BASES)
    paths = [os.path.join(f5_dir, f"read{i:04d}.fast5")
             for i in range(len(kwargs))]
    t0 = time.perf_counter()
    for path, kw in zip(paths, kwargs):
        write_synthetic_fast5(path, **kw)
    write_s = time.perf_counter() - t0
    check(all(same_read(read_resquiggled_fast5(p), synthetic_read(**kw))
              for p, kw in zip(paths, kwargs)),
          "fast5: a file does not read back as the read written")
    res = {"files": len(paths), "write_s": write_s,
           "mean_file_bytes": float(np.mean([os.path.getsize(p)
                                              for p in paths]))}
    print(f"fast5: wrote {len(paths)} files in {write_s:.3f} s | {card}",
          flush=True)

    out = os.path.join(work, "extract_fast5.tsv")
    flags = ["-p", str(EXTRACT_NPROC), "--f5_batch_num",
             str(READS_PER_WORKER_BATCH)]
    printed, seconds = cli(["extract", "-i", f5_dir, "-o", out] + flags)
    check(f"0 of {N_READS} fast5 files failed" in printed,
          "fast5 extract: " + printed[-300:])
    with open(out) as f:
        got = sorted(f.read().splitlines())
    with open(os.path.join(work, "extract.tsv")) as f:
        want = sorted(f.read().splitlines())
    check(got == want, f"fast5 extract: {len(got)} rows, "
          f"{sum(a != b for a, b in zip(got, want))} of {len(want)} differ "
          "from the in-memory reads' rows")
    res["extract"] = {"rows": len(got), "seconds": seconds,
                      "sites_per_s": len(got) / seconds}

    for mem in e2e_reads:
        dtype_name = mem["dtype"]
        out = os.path.join(work, f"calls_fast5_{dtype_name}.tsv")
        bilstm_encoder_fused.launches = 0
        printed, seconds = cli(["call_mods", "-i", f5_dir, "-m", ckpt, "-o",
                                out, "--compute_dtype", dtype_name] + flags)
        launches = bilstm_encoder_fused.launches
        got = rows_of(out)
        want = rows_of(os.path.join(work, f"calls_reads_{dtype_name}.tsv"))
        tag = f"fast5 call_mods {dtype_name}"
        if got != want:
            print(f"{tag}: differs from the in-memory calls: "
                  f"{compare_calls(tag, got, want, dtype_name)}", flush=True)
        check(got == want, f"{tag}: the calls differ from the in-memory "
              "reads' calls")
        batches = -(-len(got) // B)
        check(launches == batches, f"{tag}: K1 launched {launches} times "
              f"for {batches} device batches")
        res[dtype_name] = {
            "sites": len(got), "seconds": seconds,
            "sites_per_s": len(got) / seconds,
            "memory_sites_per_s": mem["sites_per_s"],
            "launches": launches, "device_batches": batches}

    res.update(check_fast5_fixtures())
    res.update(time_reader(paths))
    res["formats"] = run_fixture_formats(ckpt, work, card)
    res["card"] = card
    print(f"fast5: {json.dumps(res)}", flush=True)
    return res


def run_fixture_formats(ckpt: str, work: str, card: str) -> dict:
    """The committed fixtures ``FORMAT_FIXTURES``, one read in HDF5's
    earliest and latest file formats, each alone in a directory:
    ``extract -i`` and ``call_mods -i`` through the CLI in bfloat16 and
    float32 give the same rows and the same calls from both files, K1
    launched once a run (the read's sites are one device batch); then the
    reader's µs per file (``time_reader``) on ``FORMAT_COPIES`` copies of
    each."""
    import shutil

    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    where = os.path.join(REPO, "tests", "fixtures", "fast5")
    res, rows = {}, {}
    for name in FORMAT_FIXTURES:
        src = os.path.join(where, f"{name}.fast5")
        one = os.path.join(work, f"fixture_{name}")
        shutil.rmtree(one, ignore_errors=True)
        os.makedirs(one)
        shutil.copy(src, one)
        out = os.path.join(work, f"extract_{name}.tsv")
        printed, seconds = cli(["extract", "-i", one, "-o", out, "-p", "2"])
        check("0 of 1 fast5 files failed" in printed,
              f"fast5 {name} extract: " + printed[-300:])
        rows[name, "extract"] = rows_of(out)
        res[name] = {"extract": {"rows": len(rows[name, "extract"]),
                                 "seconds": seconds}}
        for dtype_name in ("bfloat16", "float32"):
            out = os.path.join(work, f"calls_{name}_{dtype_name}.tsv")
            bilstm_encoder_fused.launches = 0
            printed, seconds = cli(["call_mods", "-i", one, "-m", ckpt, "-o",
                                    out, "--compute_dtype", dtype_name, "-p",
                                    "2"])
            launches = bilstm_encoder_fused.launches
            check(launches == 1, f"fast5 {name} call_mods {dtype_name}: K1 "
                  f"launched {launches} times for one device batch")
            rows[name, dtype_name] = rows_of(out)
            res[name][dtype_name] = {"sites": len(rows[name, dtype_name]),
                                     "seconds": seconds,
                                     "launches": launches}
        copies = os.path.join(work, f"copies_{name}")
        shutil.rmtree(copies, ignore_errors=True)
        os.makedirs(copies)
        paths = [os.path.join(copies, f"{name}_{i:03d}.fast5")
                 for i in range(FORMAT_COPIES)]
        for path in paths:
            shutil.copy(src, path)
        res[name]["file_bytes"] = os.path.getsize(src)
        res[name].update(time_reader(paths))
    first, second = FORMAT_FIXTURES
    for key in ("extract", "bfloat16", "float32"):
        check(len(rows[first, key]) > 0 and
              rows[first, key] == rows[second, key],
              f"fast5 {second} {key}: {len(rows[second, key])} rows differ "
              f"from {first}'s {len(rows[first, key])}")
    us = {name: res[name]["reader_us_per_file"] for name in FORMAT_FIXTURES}
    res["latest_over_earliest"] = us[second] / us[first]
    print(f"fast5 formats: the reader {us[first]:.1f} µs a file "
          f"({first}), {us[second]:.1f} µs ({second}); equal rows and calls, "
          f"K1 once a run | {card}", flush=True)
    return res


# --------------------------------------------------------------------------
# TF1 import, the profiled call, and the host tools on the reads path's calls


def tf1_arrays(seed: int) -> dict:
    """The published model's TF1 name space
    (tests/fixtures/tf1_variables_bn17_sn360.json, 581 variables) with
    seeded fan-in-scaled values, drawn as tests/test_tf1_value_parity.py
    draws them."""
    with open(os.path.join(REPO, "tests", "fixtures",
                           "tf1_variables_bn17_sn360.json")) as f:
        shapes = json.load(f)["variables"]
    rng = np.random.default_rng(seed)
    arrs = {}
    for name, shape in shapes.items():
        if name.endswith("moving_variance"):
            a = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("gamma"):
            a = rng.uniform(0.8, 1.2, shape)
        elif name.endswith(("beta", "moving_mean", "bias")):
            a = rng.normal(0, 0.1, shape)
        elif shape:
            a = rng.normal(0, 1.0 / np.sqrt(max(int(np.prod(shape[:-1])), 1)),
                           shape)
        else:
            a = np.zeros(shape)
        arrs[name] = a.astype(np.float32)
    return arrs


def run_tf1(tsv: str, work: str) -> dict:
    """A TF1 ``Saver`` checkpoint of the published name space, with Adam's
    slots for every variable and ``beta1_power``, ``beta2_power`` and
    ``global_step``, written as .npz, imported with ``import_tf1_npz`` and
    saved with ``save_checkpoint``; its state dict equals the slot-free
    one's bit for bit.  Then ``run_call_mods`` on the call TSV at full
    width in bfloat16 (profiled: ``profile_dir`` set) and float32, K1
    launched once per device batch, the first batch held against the plain
    encoder; the trace names K1's kernel."""
    import shutil

    import torch

    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.core.logging import StageTimer
    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.models.tf1_import import (import_tf1_npz,
                                                        import_tf1_state_dict)
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    from deepsignal_tpu_torch.train.checkpoints import (
        ckpt_name, save_checkpoint, variables_to_state_dict)

    cfg = ModelConfig()
    timer = StageTimer()
    folder = os.path.join(work, "tf1")
    prof_dir = os.path.join(folder, "profile")
    shutil.rmtree(folder, ignore_errors=True)
    os.makedirs(folder)
    with timer.stage("make"):
        arrs = tf1_arrays(TF1_SEED)
        saver = dict(arrs)
        for name, a in arrs.items():
            saver[name + "/Adam"] = a + 1
            saver[name + "/Adam_1"] = a * a
        saver.update(beta1_power=np.float32(0.9 ** 1000),
                     beta2_power=np.float32(0.999 ** 1000),
                     global_step=np.int64(1000))
    npz = os.path.join(folder, "deepsignal_tf1_weights.npz")
    with timer.stage("npz_write"):
        np.savez(npz, **saver)
    del saver
    with timer.stage("import"):
        variables = import_tf1_npz(npz, cfg)
    with timer.stage("save_checkpoint"):
        ckpt = save_checkpoint(os.path.join(folder, ckpt_name(
            cfg.kmer_len, cfg.cent_signals_len, 0)), cfg, variables)
    with timer.stage("compare"):
        got = variables_to_state_dict(cfg, variables)
        want = import_tf1_state_dict(arrs, cfg)
        same = got.keys() == want.keys() and all(
            got[k].dtype == want[k].dtype
            and got[k].tobytes() == want[k].tobytes() for k in got)
    check(same and len(got) == len(arrs) - 1, "tf1: the slot-bearing "
          "import differs from the slot-free one")
    del arrs, variables, got, want
    with open(tsv) as f:
        fb = parse_feature_lines([next(f) for _ in range(B)])
    res = {"variables": TF1_VARIABLES, "npz_bytes": os.path.getsize(npz)}
    for dtype_name in ("bfloat16", "float32"):
        out_path = os.path.join(folder, f"calls_{dtype_name}.tsv")
        profiled = dtype_name == "bfloat16"
        bilstm_encoder_fused.launches = 0
        printed = io.StringIO()
        with timer.stage(f"call_mods_{dtype_name}"), \
                contextlib.redirect_stdout(printed):
            n = run_call_mods(tsv, ckpt, out_path, batch_size=B,
                              compute_dtype=dtype_name,
                              profile_dir=prof_dir if profiled else None)
            torch.cuda.synchronize()
        print(printed.getvalue(), end="", flush=True)
        launches = bilstm_encoder_fused.launches
        tag = f"tf1 {dtype_name}"
        check(n == N_ROWS, f"{tag}: {n} calls for {N_ROWS} rows")
        check(launches == -(-N_ROWS // B), f"{tag}: K1 launched {launches} "
              f"times for {-(-N_ROWS // B)} device batches")
        with open(out_path) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]
        p = np.array([[float(r[6]), float(r[7])] for r in rows])
        labels = np.array([int(r[8]) for r in rows])
        check(len(rows) == N_ROWS and bool(np.isfinite(p).all())
              and float(np.abs(p.sum(1) - 1).max()) < 1e-5,
              f"{tag}: calls not finite or not summing to 1")
        first = check_batch_against_plain(dtype_name, "tf1", fb, ckpt, p[:B],
                                          labels[:B])
        res[dtype_name] = {"launches": launches, "first_batch": first,
                           "seconds": timer.totals[f"call_mods_{dtype_name}"],
                           "label_1_share": float(labels.mean())}
    traces = os.listdir(prof_dir)
    check(len(traces) == 1 and traces[0].endswith(".pt.trace.json"),
          f"tf1: trace files {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and "lstm_encoder_kernel" in e.get("name", "")]
    check(len(k1_events) == res["bfloat16"]["launches"],
          f"tf1: the trace names K1's kernel {len(k1_events)} times for "
          f"{res['bfloat16']['launches']} launches")
    res.update(trace_kernel=k1_events[0]["name"],
               trace_k1_us=sum(e.get("dur", 0) for e in k1_events),
               trace_bytes=os.path.getsize(os.path.join(prof_dir,
                                                        traces[0])),
               stages_s=dict(timer.totals))
    print(timer.summary(), flush=True)
    print(f"tf1: {json.dumps(res)}", flush=True)
    return res


def genome_of_reads(kwargs: list) -> str:
    """The contig the reads tile: a '+' read is its span's sequence, a '-'
    read its reverse complement (featurize/extractor.py maps a '-' read's
    base l to chrom_start + n - 1 - l)."""
    from deepsignal_tpu_torch.core.constants import complement_seq
    chrom = [""] * len(kwargs)
    for i, kw in enumerate(sorted(kwargs, key=lambda k: k["mapped_start"])):
        seq = kw["seq"]
        # complement_seq reverses and complements
        chrom[i] = seq if kw["mapped_strand"] == "+" else complement_seq(seq)
        check(sum(map(len, chrom[:i])) == kw["mapped_start"],
              "tools: the reads do not tile the contig")
    return "".join(chrom)


def cli(argv: list) -> tuple:
    """The port's CLI on ``argv``: (its printed text, seconds)."""
    from deepsignal_tpu_torch.cli.main import main as cli_main
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        rc = cli_main(argv)
    seconds = time.perf_counter() - t0
    check(rc == 0, f"tools: {argv[0]} exited {rc}")
    return printed.getvalue(), seconds


def run_tools(work: str, ckpt: str, tsv: str) -> dict:
    """The host tools through the port's CLI on the calls of the ``e2e
    reads`` runs: ``call_freq`` (TSV and bedMethyl, sorted, prob_cf 0 and
    0.2; coverage sums to the calls kept), ``combine_freq`` of the bfloat16
    and float32 frequency files, ``combine_strands`` against the contig
    the reads tile (no row outside its CG sites), and ``runner``: its
    ``--dry_run`` plan printed, then its in-process stage alone
    (``--is_resquiggled yes``) on the call TSV, K1 launched once per device
    batch and the calls those of the bfloat16 e2e run."""
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    folder = os.path.join(work, "tools")
    os.makedirs(folder, exist_ok=True)
    calls = {d: os.path.join(work, f"calls_reads_{d}.tsv")
             for d in ("bfloat16", "float32")}
    with open(calls["bfloat16"]) as f:
        rows = [line.split("\t") for line in f]
    res = {"calls": len(rows)}
    for prob_cf, bed in ((0.0, False), (0.0, True), (0.2, False),
                         (0.2, True)):
        out = os.path.join(folder, f"freq_{prob_cf}{'.bed' if bed else '.tsv'}")
        _, seconds = cli(["call_freq", "-i", calls["bfloat16"], "-o", out,
                          "--prob_cf", str(prob_cf), "--sort"]
                         + (["--bed"] if bed else []))
        kept = sum(abs(float(r[6]) - float(r[7])) >= prob_cf for r in rows)
        with open(out) as f:
            freq = [line.rstrip("\n").split("\t") for line in f]
        coverage = sum(int(r[9 if bed else 8]) for r in freq)
        check(coverage == kept, f"call_freq prob_cf {prob_cf} bed {bed}: "
              f"coverage {coverage} for {kept} calls kept")
        check([(r[0], int(r[1])) for r in freq]
              == sorted((r[0], int(r[1])) for r in freq),
              f"call_freq prob_cf {prob_cf}: not sorted")
        res[f"call_freq_{prob_cf}{'_bed' if bed else ''}"] = {
            "sites": len(freq), "kept": kept, "seconds": seconds,
            "rows_per_s": len(rows) / seconds}
    freqs = {}
    for d, path in calls.items():
        freqs[d] = os.path.join(folder, f"freq_{d}.tsv")
        cli(["call_freq", "-i", path, "-o", freqs[d]])
    combined = os.path.join(folder, "freq_combined.tsv")
    cli(["combine_freq", "--modsfile", freqs["bfloat16"], "--modsfile",
         freqs["float32"], "--wfile", combined])
    with open(combined) as f:
        cov = sum(int(line.split("\t")[8]) for line in f)
    check(cov == 2 * len(rows), f"combine_freq: coverage {cov} for "
          f"{2 * len(rows)} calls")

    ref = os.path.join(folder, "chr1.fa")
    genome = genome_of_reads(read_kwargs(READS_SEED, N_READS, READ_BASES))
    with open(ref, "w") as f:
        f.write(">chr1\n" + "\n".join(genome[i:i + 80] for i in
                                       range(0, len(genome), 80)) + "\n")
    printed, seconds = cli(["combine_strands", "--frequency_fp",
                            freqs["bfloat16"], "-r", ref])
    check("not in selected motif poses" not in printed,
          "combine_strands: rows outside the genome's CG sites: "
          + printed[:300])
    out = os.path.join(folder, "freq_bfloat16.fb_combined.tsv")
    with open(out) as f:
        merged = [line.split("\t") for line in f]
    check(all(genome[int(r[1]):int(r[1]) + 2] == "CG" for r in merged)
          and sum(int(r[8]) for r in merged) == len(rows),
          "combine_strands: a row off a CG site, or calls lost")
    res["combine_strands"] = {"sites": len(merged), "seconds": seconds,
                              "genome_bases": len(genome)}
    printed, _ = cli(["runner", "-i", os.path.join(folder, "fast5"), "-r",
                      ref, "-m", ckpt, "-o", os.path.join(folder, "r.tsv"),
                      "--dry_run", "yes"])
    plan = [line for line in printed.splitlines() if line.startswith("cmd:")]
    print("runner --dry_run plan:\n" + "\n".join(plan), flush=True)
    check(len(plan) == 4 and plan[-1].startswith("cmd: <in-process> "
                                                  "call_mods"),
          f"runner: plan {plan}")
    res["runner_plan_stages"] = len(plan)
    out = os.path.join(folder, "runner_calls.tsv")
    bilstm_encoder_fused.launches = 0
    printed, seconds = cli(["runner", "-i", tsv, "-r", ref, "-m", ckpt, "-o",
                            out, "--is_resquiggled", "yes"])
    launches = bilstm_encoder_fused.launches
    with open(out) as f:
        got = [line.rstrip("\n").split("\t") for line in f]
    with open(os.path.join(work, "calls_bfloat16.tsv")) as f:
        want = [line.rstrip("\n").split("\t") for line in f]
    dprob = float(np.abs(np.float32([r[6:8] for r in got])
                         - np.float32([r[6:8] for r in want])).max())
    check(launches == -(-N_ROWS // B), f"runner: K1 launched {launches} "
          f"times for {-(-N_ROWS // B)} device batches")
    check(len(got) == N_ROWS and [r[:6] for r in got] == [r[:6] for r in want]
          and dprob < DPROB_TOL["bfloat16"],
          f"runner: {len(got)} calls, max |dprob| {dprob} against the e2e run")
    res["runner"] = {"launches": launches, "calls": len(got),
                     "seconds": seconds, "max_dprob_vs_e2e": dprob,
                     "identical_lines": sum(a == b for a, b in zip(got, want))}
    res["card"] = card_line()
    print(f"tools: {json.dumps(res)}", flush=True)
    return res


def run_tools_after_train(work: str, files: dict) -> dict:
    """``evaluate`` on the float32 score run's calls of the labelled
    validation rows, split by their true label (the all-sites AUC above
    0.6), and ``visualize_log`` on the float32 train run's logs (a PNG, or
    the RuntimeError where matplotlib is missing)."""
    import random

    from deepsignal_tpu_torch.tools.evaluate import evaluate_mods_call
    from deepsignal_tpu_torch.tools.vis import draw_log

    folder = os.path.join(work, "tools")
    with open(files["valid_tsv"]) as f:
        labels = [int(line.rsplit("\t", 1)[1]) for line in f]
    with open(os.path.join(work, "valid_calls_float32.tsv")) as f:
        calls = f.readlines()
    check(len(calls) == len(labels), "evaluate: calls and labels differ")
    split = {1: os.path.join(folder, "meth.tsv"),
             0: os.path.join(folder, "unmeth.tsv")}
    for label, path in split.items():
        with open(path, "w") as f:
            f.writelines(c for c, y in zip(calls, labels) if y == label)
    out = os.path.join(folder, "evaluate.txt")
    t0 = time.perf_counter()
    evaluate_mods_call(split[1], split[0], out, rng=random.Random(EVAL_SEED))
    seconds = time.perf_counter() - t0
    with open(out) as f:
        last = f.read().splitlines()[-1].split("\t")
    auc, accuracy = float(last[14]), float(last[6])
    print(f"evaluate all_sites: accuracy {accuracy:.3f}, AUC {auc:.3f}",
          flush=True)
    check(last[0] == "all_sites" and auc > 0.6,
          f"evaluate: all_sites AUC {auc}")
    res = {"evaluate": {"rows": len(calls), "auc": auc,
                        "accuracy": accuracy, "seconds": seconds,
                        "rows_per_s": len(calls) / seconds}}
    log_dir = os.path.join(work, "logs_float32")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        try:
            draw_log(log_dir)
        except RuntimeError as e:
            check("matplotlib" in str(e), f"visualize_log: {e}")
            res["visualize_log"] = {"matplotlib": False, "raised": str(e)}
        else:
            fail("visualize_log: drew without matplotlib")
    else:
        png = draw_log(log_dir)
        with open(png, "rb") as f:
            check(f.read(8) == b"\x89PNG\r\n\x1a\n", "visualize_log: no PNG")
        res["visualize_log"] = {"matplotlib": True, "png": png}
    res["card"] = card_line()
    print(f"tools after train: {json.dumps(res)}", flush=True)
    return res


# --------------------------------------------------------------------------
# train


def write_labelled_features(path: str, n: int, cfg, rng,
                            noisy_frac: float = 0.0,
                            shift: float = 0.5) -> set:
    """A separable labelled set: the signal of a row shifts the k-mer means
    and the central signals by +-``shift`` (unit noise), so a few steps
    learn it.  A ``noisy_frac`` of the positives carry the signal of
    negatives; returns the indexes of those mislabelled rows (their pos is
    1000 + index)."""
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    k, s = cfg.kmer_len, cfg.cent_signals_len
    bases = np.array(list("ACGT"))
    noisy = set()
    with open(path, "w") as f:
        for i in range(n):
            label = int(rng.integers(0, 2))
            if noisy_frac and label and rng.random() < noisy_frac:
                noisy.add(i)
            sign = 1 if label and i not in noisy else -1
            kmer = bases[rng.integers(0, 4, k)]
            kmer[k // 2:k // 2 + 2] = ["C", "G"]
            f.write(format_feature_row(
                "chr1", 1000 + i, "+", 1000 + i,
                f"read{i // SITES_PER_READ:05d}", "t", "".join(kmer),
                rng.normal(sign * shift, 1, k),
                np.abs(rng.normal(0.3, 0.1, k)), rng.integers(3, 30, k),
                np.around(rng.normal(sign * shift, 1, s), 6), label) + "\n")
    return noisy


def recording_trainer(model_cfg, train_cfg, device=None):
    """The port's Trainer, which also records each train step's loss and
    counts and counts train and eval steps; ``train()`` drives it as its
    own."""
    from deepsignal_tpu_torch.train.trainer import Trainer

    class RecordingTrainer(Trainer):
        def __init__(self):
            super().__init__(model_cfg, train_cfg, device=device)
            self.losses, self.counts = [], []
            self.train_steps = self.eval_steps = 0

        def train_on_batch_async(self, batch, lr):
            self.train_steps += 1
            return super().train_on_batch_async(batch, lr)

        def resolve_metrics(self, handle):
            out = super().resolve_metrics(handle)
            self.losses.append(out[0])
            self.counts.append([int(c) for c in out[1]])
            return out

        def eval_on_batch_async(self, batch):
            self.eval_steps += 1
            return super().eval_on_batch_async(batch)

    return RecordingTrainer()


def run_train(dtype_name: str, epochs: int, files: dict, work: str) -> tuple:
    """``train()`` at full width with keep_prob 0.5, with the checks on its
    kernel launches, losses and logs; returns (result, trainer)."""

    import torch

    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan
    from deepsignal_tpu_torch.train.trainer import train

    cfg = ModelConfig(compute_dtype=dtype_name)
    tcfg = TrainConfig(batch_size=TRAIN_B, keep_prob=0.5, max_epoch_num=epochs,
                       min_epoch_num=1, display_step=DISPLAY_STEP,
                       save_state=False)
    trainer = recording_trainer(cfg, tcfg)
    model_dir = os.path.join(work, f"model_{dtype_name}")
    log_dir = os.path.join(work, f"logs_{dtype_name}")
    bilstm_encoder_fused.launches = lstm_layer_scan.launches = 0
    lstm_layer_scan.launches_by_variant = {"resident": 0, "streaming": 0}
    t0 = time.time()
    summary = train(files["train_bin"], files["valid_bin"], model_dir, log_dir,
                    cfg, tcfg, is_binary=True, trainer=trainer)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    k1, k2 = bilstm_encoder_fused.launches, lstm_layer_scan.launches
    k2_resident = lstm_layer_scan.launches_by_variant["resident"]
    steps, losses = trainer.train_steps, trainer.losses
    valid_batches = -(-VALID_ROWS // TRAIN_B)
    with open(os.path.join(log_dir, "train.txt")) as f:
        train_log = f.read().splitlines()
    with open(os.path.join(log_dir, "valid.txt")) as f:
        valid_log = f.read().splitlines()
    sweeps = len(valid_log)
    tag = f"train {dtype_name}"
    check(steps == summary["epochs_run"] * (TRAIN_ROWS // TRAIN_B),
          f"{tag}: {steps} steps in {summary['epochs_run']} epochs")
    check(k2 == 6 * steps, f"{tag}: K2 launched {k2} times for {steps} steps")
    check(k2_resident == k2, f"{tag}: {k2_resident} of {k2} K2 launches of "
          f"the resident variant")
    check(sweeps > 0 and k1 == trainer.eval_steps == valid_batches * sweeps,
          f"{tag}: K1 launched {k1} times, {trainer.eval_steps} eval steps, "
          f"{sweeps} sweeps of {valid_batches} batches")
    check(len(losses) == steps and bool(np.isfinite(losses).all()),
          f"{tag}: losses {losses}")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    check(last < first, f"{tag}: mean loss of the last 4 steps {last:.4f} "
          f"not below the first 4 {first:.4f}")
    line = re.compile(r"epoch:\d+, iterid:\d+, loss:\d+\.\d{3}, "
                      r"accuracy:\d\.\d{3}, recall:\d\.\d{3}, "
                      r"precision:\d\.\d{3}$")
    check(len(train_log) == sweeps and all(
        line.match(x) for x in train_log + valid_log),
        f"{tag}: log lines {train_log[:2]} {valid_log[:2]}")
    check(summary["model_path"] is not None
          and os.path.isdir(summary["model_path"]), f"{tag}: no checkpoint")
    res = {"dtype": dtype_name, "steps": steps, "epochs": summary["epochs_run"],
           "seconds": seconds, "wall_sites_per_s": steps * TRAIN_B / seconds,
           "sweeps": sweeps, "k1_launches": k1, "k2_launches": k2,
           "k2_resident_launches": k2_resident,
           "loss_first4": first, "loss_last4": last,
           "best_accuracy": summary["best_accuracy"]}
    print(f"{tag}: {json.dumps(res)}", flush=True)
    print(f"{tag}: {train_log[-1]} | valid {valid_log[-1]}", flush=True)
    return res, trainer, summary["model_path"]


def score_checkpoint(dtype_name: str, ckpt: str, files: dict, work: str,
                     min_accuracy: float) -> dict:
    """``run_call_mods`` on the validation TSV with the trained
    checkpoint: one row per site, finite probabilities, K1 launched once
    per device batch, and calls that agree with the labels."""
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import run_call_mods

    out_path = os.path.join(work, f"valid_calls_{dtype_name}.tsv")
    bilstm_encoder_fused.launches = 0
    n = run_call_mods(files["valid_tsv"], ckpt, out_path, batch_size=B,
                      compute_dtype=dtype_name)
    k1 = bilstm_encoder_fused.launches
    with open(out_path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    with open(files["valid_tsv"]) as f:
        labels = np.array([int(line.rsplit("\t", 1)[1]) for line in f])
    p = np.array([[float(r[6]), float(r[7])] for r in rows])
    calls = np.array([int(r[8]) for r in rows])
    tag = f"score {dtype_name}"
    check(n == VALID_ROWS == len(rows), f"{tag}: {n} calls, {len(rows)} rows")
    check(k1 == -(-VALID_ROWS // B), f"{tag}: K1 launched {k1} times")
    check(bool(np.isfinite(p).all()), f"{tag}: non-finite probabilities")
    accuracy = float((calls == labels).mean())
    print(f"{tag}: {n} calls, K1 launches {k1}, accuracy against the labels "
          f"{accuracy:.4f}", flush=True)
    check(accuracy >= min_accuracy, f"{tag}: accuracy {accuracy} below "
          f"{min_accuracy}")
    return {"rows": n, "k1_launches": k1, "accuracy": accuracy}


def run_denoise(work: str, rng) -> dict:
    """``denoise()`` with ``DenoiseConfig``'s defaults (RNN-only model at
    full width, batch 512, keep_prob 0.5) cut to one iteration of one round
    of one epoch, on DENOISE_ROWS labelled rows of which DENOISE_NOISY of
    the positives are mislabelled.  Checks: six resident K2 launches per
    train step, one K1 launch per scoring batch, a probability for every
    line, both labels in the output and no intermediate file left, and a
    smaller kept share of the mislabelled positives than of the true ones."""
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.core.config import DenoiseConfig, ModelConfig
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan
    from deepsignal_tpu_torch.train import denoise as denoise_mod
    from deepsignal_tpu_torch.train.trainer import Trainer

    dcfg = DenoiseConfig(iterations=1, rounds=1, epoch_num=1)
    cfg = ModelConfig(is_cnn=dcfg.is_cnn, is_rnn=dcfg.is_rnn,
                      is_base=dcfg.is_base)  # what denoise() builds
    folder = os.path.join(work, "denoise")
    os.makedirs(folder, exist_ok=True)
    for name in os.listdir(folder):
        os.remove(os.path.join(folder, name))
    path = os.path.join(folder, "train.tsv")
    noisy = write_labelled_features(path, DENOISE_ROWS, cfg, rng,
                                    noisy_frac=DENOISE_NOISY,
                                    shift=DENOISE_SHIFT)
    with open(path) as f:
        labels = [int(line.rsplit("\t", 1)[1]) for line in f]
    steps = {"train": 0, "eval": 0}

    class CountingTrainer(Trainer):
        def train_on_batch_async(self, batch, lr):
            steps["train"] += 1
            return super().train_on_batch_async(batch, lr)

        def eval_on_batch_async(self, batch):
            steps["eval"] += 1
            return super().eval_on_batch_async(batch)

    scored = []
    train_1time = denoise_mod.train_1time

    def recording_train_1time(train_file, valid_file, valid_lidxs, *a, **kw):
        probs = train_1time(train_file, valid_file, valid_lidxs, *a, **kw)
        scored.append((list(valid_lidxs), probs))
        return probs

    bilstm_encoder_fused.launches = lstm_layer_scan.launches = 0
    lstm_layer_scan.launches_by_variant = {"resident": 0, "streaming": 0}
    t0 = time.time()
    with mock.patch.object(denoise_mod, "Trainer", CountingTrainer), \
            mock.patch.object(denoise_mod, "train_1time",
                              recording_train_1time):
        out = denoise_mod.denoise(path, None, dcfg, seed=47)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    k1, k2 = bilstm_encoder_fused.launches, lstm_layer_scan.launches
    k2_resident = lstm_layer_scan.launches_by_variant["resident"]
    half = DENOISE_ROWS // 2
    want_steps = 2 * -(-half // dcfg.batch_size)
    check(steps == {"train": want_steps, "eval": want_steps},
          f"denoise: {steps} steps, want {want_steps} train and eval")
    check(k2 == 6 * steps["train"] and k2_resident == k2,
          f"denoise: K2 launched {k2} times ({k2_resident} resident) for "
          f"{steps['train']} train steps")
    check(k1 == steps["eval"], f"denoise: K1 launched {k1} times for "
          f"{steps['eval']} scoring batches")
    check(len(scored) == 2 and all(sorted(p) == sorted(lidxs)
                                   for lidxs, p in scored)
          and sorted(i for lidxs, _ in scored for i in lidxs)
          == list(range(DENOISE_ROWS))
          and all(np.isfinite(list(p.values())).all() for _, p in scored),
          "denoise: not every line got one finite probability")
    check(sorted(os.listdir(folder)) == ["train.denoise1.tsv", "train.tsv"]
          and out == os.path.join(folder, "train.denoise1.tsv"),
          f"denoise: files left {sorted(os.listdir(folder))}, output {out}")
    with open(out) as f:
        kept = [line.split("\t") for line in f]
    out_labels = [int(r[-1]) for r in kept]
    kept_pos = {int(r[1]) - 1000 for r in kept if int(r[-1]) == 1}
    true_pos = {i for i, lab in enumerate(labels) if lab == 1} - noisy
    share_true = len(kept_pos & true_pos) / len(true_pos)
    share_noisy = len(kept_pos & noisy) / len(noisy)
    check(0 < sum(out_labels) < len(out_labels),
          f"denoise: output labels {sum(out_labels)} of {len(out_labels)}")
    check(share_noisy < share_true,
          f"denoise: kept {share_noisy:.3f} of the mislabelled positives, "
          f"{share_true:.3f} of the true ones")
    res = {"rows": DENOISE_ROWS, "mislabelled": len(noisy),
           "seconds": seconds, "train_steps": steps["train"],
           "scoring_batches": steps["eval"], "k1_launches": k1,
           "k2_launches": k2, "k2_resident_launches": k2_resident,
           "output_rows": len(kept), "kept_share_true": share_true,
           "kept_share_mislabelled": share_noisy}
    print(f"denoise: {json.dumps(res)}", flush=True)
    return res


def profile_steps(step, steps: int = 3, top: int = 8) -> tuple:
    """Device time per step from ``torch.profiler`` (the sum of every
    kernel's time over ``steps`` steps, divided by ``steps``), and the
    kernels that take the most of it (ms per step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    # the kernels' own events, as the profiler's table sums them (an op's
    # self device time repeats its kernels' time)
    per_op = sorted(((e.self_device_time_total / steps / 1e3, e.key[:80])
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.is_user_annotation), reverse=True)
    device_ms = sum(ms for ms, _ in per_op)
    check(device_ms > 0, "the profiler saw no device time")
    return device_ms, [[key, ms] for ms, key in per_op[:top]]


def step_profile(trainer, staged) -> dict:
    """Two train steps on ``staged`` traced (under the trainer's process
    group, when it has one): ms per step of device time, of it in NCCL's
    kernels and in the 8 kernels that take the most."""
    device_ms, ops = profile_steps(
        lambda: trainer.train_on_batch(staged, trainer.tcfg.learning_rate),
        steps=2, top=None)
    return {"device_ms": device_ms,
            "nccl_ms": sum(ms for key, ms in ops if "nccl" in key.lower()),
            "top_ops": ops[:8]}


def step_ms(trainer, staged, reps: int = 10) -> float:
    """ms per train step on ``staged``: the host clock around synchronized
    steps, median of ``reps`` after 2 warm-up steps."""
    import torch

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    times = []
    for i in range(reps + 2):
        sync()
        t0 = time.perf_counter()
        trainer.train_on_batch(staged, trainer.tcfg.learning_rate)
        sync()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def time_train_step(trainer, files) -> dict:
    """ms per train step (host clock around synchronized steps, median of
    10 after 2 warm-up steps) and one step split by CUDA events into the
    forward with the loss, the backward and the optimizer step, with the
    encoder's own forward and backward timed alone beside it."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.train.data import open_dataset
    from deepsignal_tpu_torch.train.trainer import INPUTS, masked_mean_loss

    batch = next(open_dataset(files["train_bin"], True).batches(TRAIN_B))
    staged = trainer.stage_batch(batch)
    lr = trainer.tcfg.learning_rate
    ms = step_ms(trainer, staged)

    tensors, mask, _ = staged
    model, tcfg = trainer.model, trainer.tcfg

    def split(fwd, bwd, opt=None, reps=6):
        parts = []
        for i in range(reps + 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            trainer.optimizer.zero_grad(set_to_none=True)
            ev[0].record()
            out = fwd()
            ev[1].record()
            bwd(out)
            ev[2].record()
            if opt is not None:
                opt()
            ev[3].record()
            torch.cuda.synchronize()
            if i:
                parts.append([ev[j].elapsed_time(ev[j + 1]) for j in range(3)])
        return np.median(np.array(parts), axis=0).tolist()

    fwd_ms, bwd_ms, opt_ms = split(
        lambda: masked_mean_loss(
            model(*(tensors[k] for k in INPUTS), train=True,
                  keep_prob=tcfg.keep_prob, generator=trainer.generator),
            tensors["labels"], mask, trainer.mcfg.class_num, tcfg.pos_weight),
        lambda loss: loss.backward(), trainer.optimizer.step)
    enc = model.event_model
    x = torch.randn(TRAIN_B, T, D, device=trainer.device).to(
        torch_dtype(trainer.mcfg.compute_dtype)).requires_grad_(True)
    g = torch.randn(TRAIN_B, 2 * H, device=trainer.device).to(x.dtype)
    enc_fwd_ms, enc_bwd_ms, _ = split(
        lambda: enc(x, True, tcfg.keep_prob, trainer.generator),
        lambda out: out.backward(g))
    device_ms, top = profile_steps(lambda: trainer.train_on_batch(staged, lr))
    res = {"ms_per_step": ms, "sites_per_s": TRAIN_B / ms * 1e3,
           "device_ms_per_step": device_ms,
           "device_idle_share": 1 - device_ms / ms, "top_ops": top,
           "forward_ms": fwd_ms, "backward_ms": bwd_ms, "optimizer_ms": opt_ms,
           "encoder_forward_ms": enc_fwd_ms,
           "encoder_backward_ms": enc_bwd_ms}
    print(f"train step {trainer.mcfg.compute_dtype}: {json.dumps(res)}",
          flush=True)
    return res


def check_step_parity(dtype_name: str, device) -> dict:
    """One train step's loss and gradients through K2 (and K1's absence)
    against the same step with the plain scan patched in, from the same
    weights, batch and dropout seed (so the same dropout masks)."""
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.models import layers
    from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
    from deepsignal_tpu_torch.ops.bilstm import lstm_scan_plain
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan
    from deepsignal_tpu_torch.train.trainer import masked_mean_loss

    cfg = ModelConfig(compute_dtype=dtype_name)
    model = DeepSignalNet(cfg, seed=31).to(device)
    rng = np.random.default_rng(37)

    def t(a):
        return torch.from_numpy(a).to(device)

    inputs = [t(rng.integers(0, 1024, (TRAIN_B, T)).astype(np.int32)),
              t(rng.normal(0, 1, (TRAIN_B, T)).astype(np.float32)),
              t(np.abs(rng.normal(0.3, 0.1, (TRAIN_B, T))).astype(np.float32)),
              t(rng.integers(3, 30, (TRAIN_B, T)).astype(np.float32)),
              t(rng.normal(0, 1, (TRAIN_B, cfg.cent_signals_len)).astype(
                  np.float32))]
    labels = t(rng.integers(0, 2, TRAIN_B).astype(np.int32))
    mask = torch.ones(TRAIN_B, device=device)
    params = list(model.parameters())

    def step():
        gen = torch.Generator(device=device).manual_seed(41)
        logits = model(*inputs, train=True, keep_prob=0.5, generator=gen)
        loss = masked_mean_loss(logits, labels, mask, cfg.class_num, 1.0)
        return loss.item(), torch.autograd.grad(loss, params)

    scans = lstm_layer_scan.launches
    resident = lstm_layer_scan.launches_by_variant["resident"]
    loss_k, grads_k = step()
    check(lstm_layer_scan.launches - scans == 6
          and lstm_layer_scan.launches_by_variant["resident"] - resident == 6,
          f"step parity {dtype_name}: {lstm_layer_scan.launches - scans} K2 "
          f"launches, {lstm_layer_scan.launches_by_variant['resident'] - resident}"
          f" resident")
    with mock.patch.object(layers, "lstm_layer_scan", lstm_scan_plain):
        loss_p, grads_p = step()
    flat_k, flat_p = (torch.cat([g.float().flatten() for g in grads])
                      for grads in (grads_k, grads_p))
    rel = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    # reported, not checked: a tensor whose gradient is a sum with much
    # cancellation (a batch-norm bias) shows bfloat16's noise, not K2's
    worst, name = max(
        ((a.float() - b.float()).norm().item()
         / max(b.float().norm().item(), 1e-30), name)
        for (name, _), a, b in zip(model.named_parameters(), grads_k,
                                   grads_p))
    dloss = abs(loss_k - loss_p)
    print(f"step parity {dtype_name}: loss {loss_k:.6f} vs plain "
          f"{loss_p:.6f}, relative gradient difference {rel:.3e} (tolerance "
          f"{STEP_TOL[dtype_name]:g}), largest for one tensor {worst:.3e} "
          f"({name})", flush=True)
    check(np.isfinite(loss_k) and dloss <= STEP_TOL[dtype_name] * abs(loss_p),
          f"step parity {dtype_name}: loss {loss_k} vs {loss_p}")
    check(rel <= STEP_TOL[dtype_name],
          f"step parity {dtype_name}: gradients {rel}")
    return {"loss": loss_k, "loss_plain": loss_p, "grad_rel_err": rel,
            "worst_tensor_rel_err": worst, "worst_tensor": name}


# --------------------------------------------------------------------------
# the parallel phase: ranks of torchrun (python -m torch.distributed.run),
# each one process; chip_smoke.py --rank <spec.json> is one rank's body


def torchrun(nproc: int, spec: dict, work: str, tag: str,
             timeout: int = 300) -> list:
    """Run ``spec`` in ``nproc`` ranks under torchrun (a free local port),
    bounded by ``timeout``; the ranks' JSON results in rank order.  The
    ranks' output goes to ``<work>/<tag>.log``."""
    spec_path = os.path.join(work, f"{tag}.json")
    spec["out"] = spec_path + ".rank"
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    for r in range(nproc):
        if os.path.exists(f"{spec['out']}{r}"):
            os.remove(f"{spec['out']}{r}")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--rank",
           spec_path]
    log = os.path.join(work, f"{tag}.log")
    with open(log, "wb") as out:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            stop_torchrun(proc)
            rc = "timeout"
    if rc != 0:
        with open(log, errors="replace") as f:
            fail(f"{tag}: torchrun ended with {rc}:\n{f.read()[-4000:]}")
    results = []
    for r in range(nproc):
        with open(f"{spec['out']}{r}") as f:
            results.append(json.load(f))
    return results


def stop_torchrun(proc) -> None:
    """Stop a torchrun agent and its ranks.  The agent starts each rank in
    a session of its own, so a signal to the agent's group misses them: a
    SIGTERM makes the agent stop its ranks first, and SIGKILL follows for
    whatever is left of its group."""
    import signal

    proc.terminate()
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:  # the group ended with the agent
        pass
    proc.wait()


def grad_norms(trainer) -> dict:
    """The float64 2-norm of each parameter's gradient as the last step
    left it, fc1's whole (every rank of a model axis must call it)."""
    from deepsignal_tpu_torch.parallel.mesh import TP_PARAM, all_gather_cat

    out = {}
    for name, p in trainer.model.named_parameters():
        g = p.grad
        if name == TP_PARAM and trainer.mesh is not None \
                and trainer.mesh.model > 1:
            g = all_gather_cat(g, trainer.mesh.model_group)
        out[name] = float(g.double().norm())
    return out


def recorded_train(spec: dict, mesh, steps: int) -> dict:
    """``steps`` train steps of the spec's model and global batches (the
    binary file in file order) through ``Trainer`` on ``mesh`` (None: one
    process; ``spec["perturb"]`` moves step 1's signals by that relative
    noise): per step the loss and counts, each parameter's gradient norm
    after step 1, a float64 checksum of every parameter (fc1 whole), the
    K2 launches by variant and the wall ms per step (the host clock around
    synchronized steps)."""
    import torch

    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan
    from deepsignal_tpu_torch.train.data import open_dataset
    from deepsignal_tpu_torch.train.trainer import Trainer

    trainer = Trainer(ModelConfig(**spec["model"]),
                      TrainConfig(batch_size=spec["batch"], keep_prob=0.5,
                                  seed=spec["seed"]),
                      device=spec["device"], mesh=mesh)
    batches = open_dataset(spec["train_bin"], True).batches(spec["batch"])
    lstm_layer_scan.launches = 0
    lstm_layer_scan.launches_by_variant = {"resident": 0, "streaming": 0}
    out, times = [], []
    for i in range(steps):
        batch = next(batches)
        if i == 0 and spec.get("perturb"):
            # the signals moved by about one float32 rounding
            noise = np.random.default_rng(spec["seed"]).standard_normal(
                batch["signals"].shape)
            batch = dict(batch, signals=(batch["signals"] * (
                1 + spec["perturb"] * noise)).astype(np.float32))
        t0 = time.perf_counter()
        loss, counts, _preds, _valid = trainer.train_on_batch(batch,
                                                              spec["lr"])
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        times.append((time.perf_counter() - t0) * 1e3)
        out.append({"loss": loss, "counts": [int(c) for c in counts]})
        if len(out) == 1:
            norms = grad_norms(trainer)

    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else [v]

    checksum = float(sum(np.asarray(a, dtype=np.float64).sum()
                         for a in leaves(trainer.variables["params"])))
    return {"steps": out, "grad_norms": norms, "checksum": checksum,
            "ms_per_step": times,
            "k2_launches": lstm_layer_scan.launches,
            "k2_resident": lstm_layer_scan.launches_by_variant["resident"],
            "local_batch": spec["batch"] // (1 if mesh is None else
                                             mesh.data),
            "fc1_rows": int(trainer.model.joint_model.fc1.weight.shape[0]),
            "device": str(trainer.device)}


def rank_cli(argvs: list) -> dict:
    """One rank of the port's CLI on each of ``argvs`` in turn (each
    call makes and destroys its process group), with the K1 launches and
    seconds of each.  For ``train`` it also records each step's loss and
    counts as ``train()`` reads them, and times steps on its first batch
    with the trainer ``train()`` made, inside the CLI's process group."""
    from deepsignal_tpu_torch.cli.main import main as cli_main
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan
    from deepsignal_tpu_torch.train import trainer as trainer_mod
    from deepsignal_tpu_torch.train.data import open_dataset

    steps, made, timing = [], [], {}

    class Recording(trainer_mod.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def resolve_metrics(self, handle):
            out = super().resolve_metrics(handle)
            steps.append({"loss": out[0],
                          "counts": [int(c) for c in out[1]]})
            return out

    real_train = trainer_mod.train

    def timed_train(*args, **kwargs):
        summary = real_train(*args, **kwargs)
        timing["k2_launches"] = lstm_layer_scan.launches
        timing["k2_resident"] = lstm_layer_scan.launches_by_variant[
            "resident"]
        trainer = made[0]
        n = len(steps)
        batch = next(open_dataset(args[0], True).batches(
            trainer.tcfg.batch_size))
        staged = trainer.stage_batch(batch)
        timing["ms_per_step"] = step_ms(trainer, staged, reps=5)
        if trainer.device.type == "cuda":
            timing["profile"] = step_profile(trainer, staged)
        del steps[n:]
        timing["grad_bytes"] = 4 * sum(p.numel() for p in
                                       trainer.model.parameters())
        timing["mesh"] = None if trainer.mesh is None else \
            trainer.mesh.shape
        timing["device"] = str(trainer.device)
        timing["model_path"] = summary["model_path"]
        return summary

    trainer_mod.Trainer = Recording
    trainer_mod.train = timed_train
    calls = []
    for argv in argvs:
        bilstm_encoder_fused.launches = 0
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            rc = cli_main(argv)
        calls.append({"seconds": time.perf_counter() - t0,
                      "k1_launches": bilstm_encoder_fused.launches})
        print(printed.getvalue(), end="", flush=True)
        check(rc == 0, f"{argv[0]} exited {rc}")
    return {"calls": calls, "steps": steps, **timing}


def rank_steps(spec: dict) -> dict:
    """One rank of the train steps in a ``spec["backend"]`` group: data-
    parallel steps of the global batch on ``make_mesh()``, then one step
    with fc1's rows split over ``make_mesh(model_parallel=2)``."""
    from deepsignal_tpu_torch.parallel.dist import distributed
    from deepsignal_tpu_torch.parallel.mesh import make_mesh

    with distributed(spec["device"], backend=spec["backend"]) as (_r, world):
        check(world == spec["ranks"], f"steps: world size {world}")
        dp = recorded_train(spec, make_mesh(), spec["dp_steps"])
        tp = recorded_train(spec, make_mesh(model_parallel=2), 1)
    return {"steps": {"dp": dp, "tp": tp}}


def rank_worker(spec_path: str) -> None:
    """The body of one rank: the spec's CLI calls (``argvs``), then its
    train steps (``steps``), and its wall seconds, written to
    ``<spec["out"]><rank>``."""
    sys.path.insert(0, REPO)

    with open(spec_path) as f:
        spec = json.load(f)
    rank = int(os.environ["RANK"])
    t0 = time.perf_counter()
    out = rank_cli(spec["argvs"]) if "argvs" in spec else {}
    if "steps" in spec:
        out.update(rank_steps(spec["steps"]))
    out.update(rank=rank, seconds=time.perf_counter() - t0)
    with open(f"{spec['out']}{rank}", "w") as f:
        json.dump(out, f)


def rows_of(path: str) -> list:
    with open(path) as f:
        return sorted(line.rstrip("\n").split("\t") for line in f)


def compare_calls(tag: str, got: list, want: list, dtype_name: str) -> dict:
    """Sorted call rows against sorted call rows: the same sites, every
    column but the probabilities byte-identical (the label too, except at
    a site with |p1 - p0| below MARGIN in ``want``, where the batches'
    other row counts may pick another cuBLAS or cuDNN kernel), the
    probabilities within DPROB_TOL."""
    check(len(got) == len(want) > 0, f"{tag}: {len(got)} rows for "
          f"{len(want)}")
    key = [r[:6] for r in got]
    check(key == [r[:6] for r in want], f"{tag}: not the same sites")
    p_got = np.array([[float(r[6]), float(r[7])] for r in got])
    p_want = np.array([[float(r[6]), float(r[7])] for r in want])
    near = np.abs(p_want[:, 1] - p_want[:, 0]) < MARGIN
    labels_differ = np.array([g[8] != w[8] for g, w in zip(got, want)])
    check(not (labels_differ & ~near).any(), f"{tag}: "
          f"{int((labels_differ & ~near).sum())} labels differ")
    check(all(g[9:] == w[9:] for g, w in zip(got, want)),
          f"{tag}: k-mer column differs")
    dprob = float(np.abs(p_got - p_want).max())
    check(dprob <= DPROB_TOL[dtype_name], f"{tag}: max |dprob| {dprob}")
    return {"rows": len(got), "max_abs_dprob": dprob,
            "labels_differ_near_margin": int(labels_differ.sum())}


def run_ranks(tsv: str, ckpt: str, files: dict, work: str, card: str,
              nproc: int = 2, device=None, backend: str = "nccl") -> tuple:
    """``nproc`` ranks under torchrun: ``call_mods`` through the CLI in
    bfloat16 and then float32, each call making and destroying the default
    NCCL group (on a shared card it makes no communicator, since inference
    issues no collective), then the train steps of ``check_steps`` in a
    ``backend`` group.  ``device`` None puts rank k on cuda:k; "cuda:0"
    puts every rank on the first card, where NCCL refuses two ranks and
    the steps run over gloo.  Returns the results of ``check_call_shards``
    and ``check_steps``."""
    dtypes = ("bfloat16", "float32")
    outs = [os.path.join(work, f"calls_{nproc}ranks_{d}.tsv")
            for d in dtypes]
    argvs = [["call_mods", "-i", tsv, "-m", ckpt, "-o", out, "--batch_size",
              str(B), "--f5_batch_num", str(READS_PER_BATCH),
              "--compute_dtype", d] + (["--device", device] if device else [])
             for d, out in zip(dtypes, outs)]
    steps = {"model": {}, "batch": TRAIN_B, "seed": 13, "device": device,
             "backend": backend, "ranks": nproc,
             "train_bin": files["train_bin"], "dp_steps": 3,
             "lr": PARITY_LR}
    t0 = time.time()
    ranks = torchrun(nproc, {"argvs": argvs, "steps": steps}, work,
                     f"{nproc}_ranks")
    wall = time.time() - t0
    print(f"parallel: {nproc} ranks under torchrun: {wall:.1f} s wall, "
          f"{[round(r['seconds'], 1) for r in ranks]} s in the ranks | "
          f"{card}", flush=True)
    return (check_call_shards(ranks, dtypes, outs, work, card),
            {**check_steps(ranks, steps, card), "torchrun_wall_s": wall})


def check_call_shards(ranks: list, dtypes: tuple, outs: list, work: str,
                      card: str) -> list:
    """Each rank's part file holds its stride shard of the read batches,
    its K1 launches equal its device batches, and the merged rows equal
    the single-process e2e run's."""
    from deepsignal_tpu_torch.parallel.dist import merge_call_shards

    nproc = len(ranks)
    read_batches = -(-(N_ROWS // SITES_PER_READ) // READS_PER_BATCH)
    results = []
    for c, (dtype_name, out) in enumerate(zip(dtypes, outs)):
        tag = f"parallel call_mods {dtype_name}"
        per_rank = []
        for r, res in enumerate(ranks):
            with open(f"{out}.part{r}-of-{nproc}") as f:
                n = sum(1 for _ in f)
            want = len(range(r, read_batches, nproc)) * READS_PER_BATCH \
                * SITES_PER_READ
            batches = -(-n // B)
            launches = res["calls"][c]["k1_launches"]
            check(n == want, f"{tag}: rank {r} wrote {n} rows, want {want}")
            check(launches == batches, f"{tag}: rank {r} launched K1 "
                  f"{launches} times for {batches} device batches")
            per_rank.append({"rank": r, "rows": n, "device_batches": batches,
                             "k1_launches": launches,
                             "seconds": res["calls"][c]["seconds"]})
            print(f"{tag}: rank {r}: {n} rows, K1 {launches} launches, "
                  f"{res['calls'][c]['seconds']:.3f} s | {card}", flush=True)
        merged = merge_call_shards(out, nproc, remove_shards=True)
        cmp = compare_calls(tag, rows_of(merged),
                            rows_of(os.path.join(work,
                                                 f"calls_{dtype_name}.tsv")),
                            dtype_name)
        res = {"dtype": dtype_name, "ranks": per_rank,
               "launches": sum(r["k1_launches"] for r in per_rank), **cmp}
        print(f"{tag}: {json.dumps(res)}", flush=True)
        results.append(res)
    return results


def run_sharded_reads(reads: list, ckpt: str, work: str) -> dict:
    """``stream_read_feature_batches`` with ``host_shard=(k, 2)`` for k = 0
    and 1 in turn in this process, called in bfloat16: each shard's K1
    launches equal its device batches, and the union of the calls equals
    the unsharded e2e reads run's."""
    import dataclasses

    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import (ModCaller,
                                                     call_mods_on_batches)
    from deepsignal_tpu_torch.runtime.pipeline import \
        stream_read_feature_batches
    from deepsignal_tpu_torch.train.checkpoints import load_checkpoint

    cfg, variables = load_checkpoint(ckpt)
    caller = ModCaller(dataclasses.replace(cfg, compute_dtype="bfloat16"),
                       variables, batch_size=B)
    rows, shards = [], []
    for k in range(2):
        out = os.path.join(work, f"calls_reads_shard{k}.tsv")
        bilstm_encoder_fused.launches = 0
        t0 = time.perf_counter()
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            stream = stream_read_feature_batches(
                reads, FeatureConfig(), nproc=EXTRACT_NPROC,
                f5_batch_num=READS_PER_WORKER_BATCH, host_shard=(k, 2))
            try:
                n = call_mods_on_batches(caller, stream, out)
            finally:
                stream.close()
        seconds = time.perf_counter() - t0
        launches = bilstm_encoder_fused.launches
        check(launches == -(-n // B), f"sharded reads {k}: K1 launched "
              f"{launches} times for {n} sites")
        shard_rows = rows_of(out)
        check({r[4] for r in shard_rows}
              == {r.read_id for r in reads[k::2]},
              f"sharded reads {k}: not the reads of its stride")
        rows += shard_rows
        shards.append({"shard": k, "sites": n, "k1_launches": launches,
                       "seconds": seconds})
    cmp = compare_calls("sharded reads", sorted(rows),
                        rows_of(os.path.join(work,
                                             "calls_reads_bfloat16.tsv")),
                        "bfloat16")
    res = {"shards": shards, **cmp,
           "launches": sum(s["k1_launches"] for s in shards)}
    print(f"sharded reads: {json.dumps(res)}", flush=True)
    return res


def run_train_ranks(files: dict, work: str, card: str, nproc: int = 1,
                    device: str = "cuda") -> dict:
    """``train`` through the CLI under torchrun at world size ``nproc``,
    NCCL (each rank on its own card), float32, WORLD1_STEPS steps at
    PARITY_LR: its per-step loss and counts
    against the non-distributed ``train()`` on the same file and seed,
    within the spread of two non-distributed runs measured first (cuDNN's
    and the embedding's backward are not bitwise deterministic), with a
    floor of STEP_TOL on the loss where the two runs agree exactly; its
    checkpoint read back by ``run_call_mods``; and the ms per step of both,
    the difference being what the group and its collectives cost."""
    import torch

    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.io.feature_codec import binary_record_dtype
    from deepsignal_tpu_torch.train.data import open_dataset
    from deepsignal_tpu_torch.train.trainer import train

    train_bin = os.path.join(work, "train_world1.bin")
    np.fromfile(files["train_bin"], dtype=binary_record_dtype(T, 360))[
        :WORLD1_STEPS * TRAIN_B].tofile(train_bin)
    tcfg = TrainConfig(batch_size=TRAIN_B, learning_rate=PARITY_LR,
                       keep_prob=0.5, max_epoch_num=1, min_epoch_num=1,
                       display_step=2, seed=11, save_state=False)
    refs = []
    for i in range(2):
        trainer = recording_trainer(ModelConfig(), tcfg, device)
        train(train_bin, files["valid_bin"],
              os.path.join(work, f"model_ref{i}"), None, ModelConfig(),
              tcfg, is_binary=True, trainer=trainer)
        refs.append({"losses": trainer.losses, "counts": trainer.counts})
    batch = next(open_dataset(train_bin, True).batches(TRAIN_B))
    staged = trainer.stage_batch(batch)
    ref_ms = step_ms(trainer, staged, reps=5)
    ref_profile = step_profile(trainer, staged) if device != "cpu" else None
    del trainer
    if device != "cpu":
        torch.cuda.empty_cache()

    model_dir = os.path.join(work, f"model_world{nproc}")
    argv = ["train", "--train_file", train_bin, "--valid_file",
            files["valid_bin"], "--is_binary", "yes", "--model_dir",
            model_dir, "--log_dir", os.path.join(work, f"logs_world{nproc}"),
            "--batch_size", str(TRAIN_B), "--learning_rate", str(PARITY_LR),
            "--keep_prob", "0.5", "--max_epoch_num", "1", "--min_epoch_num",
            "1", "--display_step", "2", "--seed", "11", "--device", device]
    rank0 = torchrun(nproc, {"argvs": [argv]}, work,
                     f"train_world{nproc}")[0]
    tag = f"parallel train world {nproc}"
    check(rank0["mesh"] == {"data": nproc, "model": 1}
          and rank0["device"] == ("cuda:0" if device == "cuda" else device),
          f"{tag}: mesh {rank0['mesh']} on {rank0['device']}")
    a, b = refs
    check(len(rank0["steps"]) == len(a["losses"]) == WORLD1_STEPS,
          f"{tag}: {len(rank0['steps'])} steps")
    check(rank0["k2_launches"] == 6 * WORLD1_STEPS == rank0["k2_resident"],
          f"{tag}: K2 launched {rank0['k2_launches']} times "
          f"({rank0['k2_resident']} resident) in {WORLD1_STEPS} steps")
    worst = 0.0
    for i, st in enumerate(rank0["steps"]):
        spread = abs(a["losses"][i] - b["losses"][i])
        bound = max(spread, STEP_TOL["float32"] * abs(a["losses"][i]))
        d = abs(st["loss"] - a["losses"][i])
        worst = max(worst, d / bound)
        check(d <= bound, f"{tag}: step {i} loss {st['loss']} vs "
              f"{a['losses'][i]} (two runs {spread:.3e} apart)")
        cspread = np.abs(np.subtract(a["counts"][i], b["counts"][i]))
        dc = np.abs(np.subtract(st["counts"], a["counts"][i]))
        check((dc <= cspread).all(), f"{tag}: step {i} counts "
              f"{st['counts']} vs {a['counts'][i]} and {b['counts'][i]}")
    check(rank0["model_path"] is not None
          and os.path.isdir(rank0["model_path"]),
          f"{tag}: no checkpoint in {model_dir}")
    # a few steps at PARITY_LR learn little: the call must only load it
    score = score_checkpoint("float32", rank0["model_path"], files, work,
                             min_accuracy=0.0)
    res = {"steps": len(rank0["steps"]),
           "loss_max_diff_over_bound": worst,
           "ms_per_step": rank0["ms_per_step"],
           "ms_per_step_non_distributed": ref_ms,
           "profile": rank0.get("profile"),
           "profile_non_distributed": ref_profile,
           "grad_allreduce_mb": rank0["grad_bytes"] / 1e6,
           "k1_launches": rank0["calls"][0]["k1_launches"],
           "k2_launches": rank0["k2_launches"],
           "seconds": rank0["seconds"], "score": score,
           "loss": [st["loss"] for st in rank0["steps"]],
           "loss_non_distributed": refs[0]["losses"]}
    prof = rank0.get("profile")
    traced = "" if prof is None else (
        f"; device {prof['device_ms']:.1f} ms a step, {prof['nccl_ms']:.1f} "
        f"of it NCCL (non-distributed {ref_profile['device_ms']:.1f})")
    print(f"{tag}: {rank0['ms_per_step']:.1f} ms per step under NCCL "
          f"(non-distributed {ref_ms:.1f}){traced}; a gradient of "
          f"{rank0['grad_bytes'] / 1e6:.1f} MB "
          f"{'summed over the ranks' if nproc > 1 else 'and no collective'}"
          f" a step | {card}", flush=True)
    print(f"{tag}: {json.dumps(res)}", flush=True)
    return res


def norms_apart(got: dict, want: dict) -> tuple:
    """The largest relative difference of two runs' gradient norms over
    the parameters, and the parameter where it is."""
    check(got.keys() == want.keys(), "gradient norms of other parameters")
    diffs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
             for k in want}
    leaf = max(diffs, key=diffs.get)
    return diffs[leaf], leaf


def check_steps(ranks: list, spec: dict, card: str) -> dict:
    """The ranks' train steps: 3 float32 data-parallel steps of the global
    batch TRAIN_B and one fc1 tensor-parallel step (model axis 2), against
    the same steps in this process without a mesh.  Counts exact and the
    same on every rank, each parameter's step 1 gradient norm within
    GRAD_TOL, loss and a float64 params checksum within STEP_TOL, every K2
    launch resident at the per-rank batch."""
    import torch

    tag = f"parallel {spec['backend']}"
    parts = (("dp", spec["dp_steps"], len(ranks)), ("tp", 1, len(ranks) // 2))
    wants = {}
    for part, steps, perturb in (("dp", spec["dp_steps"], 0), ("tp", 1, 0),
                                 ("noise", 1, 1e-7)):
        wants[part] = recorded_train(
            dict(spec, device=spec["device"] or "cuda", perturb=perturb),
            None, steps)
        if spec["device"] != "cpu":
            torch.cuda.empty_cache()
    # the readings GRAD_TOL is set from: step 1 of one process twice, and
    # once more on signals moved by 1e-7 (relative)
    spread, spread_leaf = norms_apart(wants["tp"]["grad_norms"],
                                      wants["dp"]["grad_norms"])
    noise, noise_leaf = norms_apart(wants["noise"]["grad_norms"],
                                    wants["dp"]["grad_norms"])
    print(f"{tag}: step 1 gradient norms of one process, largest relative "
          f"difference of two runs {spread:.3e} ({spread_leaf}), on signals "
          f"moved by 1e-7 {noise:.3e} ({noise_leaf}); GRAD_TOL {GRAD_TOL:g} "
          f"| {card}", flush=True)
    res = {"grad_norm_one_process_spread": spread,
           "grad_norm_perturbed_1e-7": noise}
    for part, steps, data in parts:
        want = wants[part]
        got = [r["steps"][part] for r in ranks]
        check(all(g["steps"] == got[0]["steps"]
                  and g["checksum"] == got[0]["checksum"]
                  and g["grad_norms"] == got[0]["grad_norms"] for g in got),
              f"{tag} {part}: the ranks differ")
        gdiff, gleaf = norms_apart(got[0]["grad_norms"], want["grad_norms"])
        print(f"{tag} {part}: step 1 gradient norms against one process, "
              f"largest relative difference {gdiff:.3e} ({gleaf}) | {card}",
              flush=True)
        check(gdiff <= GRAD_TOL, f"{tag} {part}: step 1 gradient of {gleaf} "
              f"{gdiff:.3e} (relative) from one process's")
        for g, w in zip(got[0]["steps"], want["steps"]):
            check(g["counts"] == w["counts"], f"{tag} {part}: counts "
                  f"{g['counts']} vs {w['counts']}")
            check(abs(g["loss"] - w["loss"])
                  <= STEP_TOL["float32"] * abs(w["loss"]),
                  f"{tag} {part}: loss {g['loss']} vs {w['loss']}")
        rel = abs(got[0]["checksum"] - want["checksum"]) / abs(
            want["checksum"])
        check(rel <= STEP_TOL["float32"], f"{tag} {part}: params checksum "
              f"{got[0]['checksum']} vs {want['checksum']}")
        for r in got:
            check(r["local_batch"] == TRAIN_B // data
                  and r["k2_launches"] == 6 * steps == r["k2_resident"],
                  f"{tag} {part}: K2 {r['k2_launches']} launches, "
                  f"{r['k2_resident']} resident, at batch "
                  f"{r['local_batch']}")
        res[part] = {"steps": steps, "checksum_rel_diff": rel,
                     "grad_norm_rel_diff": gdiff,
                     "loss": [s["loss"] for s in got[0]["steps"]],
                     "loss_one_process": [s["loss"] for s in want["steps"]],
                     "ms_per_step": [r["ms_per_step"] for r in got],
                     "ms_per_step_one_process": want["ms_per_step"],
                     "k2_launches": sum(r["k2_launches"] for r in got),
                     "fc1_rows": got[0]["fc1_rows"],
                     "local_batch": got[0]["local_batch"]}
        print(f"{tag} {part}: ms per step by rank "
              f"{[np.round(r['ms_per_step'], 1).tolist() for r in got]}, "
              f"one process {np.round(want['ms_per_step'], 1).tolist()} | "
              f"{card}", flush=True)
    print(f"{tag}: {json.dumps(res)}", flush=True)
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "deepsignal_tpu_torch")):
        fail("run from the root of a deepsignal-tpu checkout")
    sys.path.insert(0, REPO)
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.core.device import resolve_device
    from deepsignal_tpu_torch.io import native
    from deepsignal_tpu_torch.io.feature_codec import convert_txt_to_binary
    from deepsignal_tpu_torch.ops.cuda import build, lstm, lstm_scan
    from deepsignal_tpu_torch.train.checkpoints import (
        ckpt_name, save_checkpoint, state_dict_to_variables)

    start = time.time()
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = resolve_device(None)

    cxx = subprocess.run([build.cxx_path(), "--version"], capture_output=True,
                         text=True, timeout=60).stdout.splitlines()[0]
    print(f"host compiler: {cxx}", flush=True)
    t0 = time.time()
    reports = build.build_libraries([lstm.LIBRARY, lstm_scan.LIBRARY,
                                     native.PARSER_LIBRARY,
                                     native.FORMATTER_LIBRARY,
                                     native.FEATURIZER_LIBRARY])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    k1_ptxas = encoder_instantiations(reports[lstm.LIBRARY])
    k2_ptxas = scan_instantiations(reports[lstm_scan.LIBRARY])

    dtypes = ("bfloat16", "float32")
    k1_rows = {d: check_encoder(d, device) for d in dtypes}
    for d in dtypes:
        d3 = check_encoder_d3(d, device)
        k1_rows[d]["max_abs_err"] = max(k1_rows[d]["max_abs_err"],
                                        *d3["cases_d3"].values())
        k1_rows[d].update(d3)
    for d, key in (("bfloat16", "bf16"), ("float32", "f32")):
        k1_rows[d]["ptxas"] = {h: k1_ptxas[f"{key}_H{h}"] for h in (128, 256)}
    k2_rows = {d: check_scan(d, device) for d in dtypes}
    for d, key in (("bfloat16", "bf16"), ("float32", "f32")):
        k2_rows[d]["ptxas"] = {k: v for k, v in k2_ptxas.items()
                               if k.startswith(key)}
    grads = {d: check_gradients(d, device) for d in dtypes}
    for d in dtypes:
        check_small_batch(d, device)
    launches = {("K1", d): {} for d in dtypes}
    launches.update({("K2", d): {} for d in dtypes})

    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cfg = ModelConfig()
    rng = np.random.default_rng(2024)
    t0 = time.time()
    tsv = os.path.join(work, "features.tsv")
    write_features(tsv, cfg, rng)
    sd = random_state_dict(cfg, rng)
    spread_logits(cfg, sd, tsv)
    ckpt = save_checkpoint(
        os.path.join(work, ckpt_name(cfg.kmer_len, cfg.cent_signals_len, 0)),
        cfg, state_dict_to_variables(cfg, sd))
    print(f"setup: checkpoint + {N_ROWS}-row TSV in {time.time() - t0:.1f} s",
          flush=True)

    e2e = []
    library = []
    for dtype_name in dtypes:
        calls_path = os.path.join(work, f"calls_{dtype_name}.tsv")
        res, probs, labels, rows = run_e2e(dtype_name, tsv, ckpt, calls_path)
        launches["K1", dtype_name]["call_mods"] = res["launches"]
        check_first_batch(dtype_name, tsv, ckpt, probs, labels)
        if dtype_name == "bfloat16":
            res["stages"] = time_stages(tsv, ckpt, rows,
                                        check_native_host(tsv, calls_path))
        e2e.append(res)
        library.append(run_library(dtype_name, tsv, ckpt, rows))
        launches["K1", dtype_name]["library"] = library[-1]["launches"]

    t0 = time.time()
    reads = make_reads(READS_SEED)
    print(f"reads: {N_READS} in-memory reads of {READ_BASES} bases in "
          f"{time.time() - t0:.1f} s", flush=True)
    featurized, feature_rows = check_featurize(reads)
    extracted = run_extract_phase(reads, feature_rows, work)
    e2e_reads = []
    for dtype_name in dtypes:
        res = run_e2e_reads(dtype_name, reads, ckpt, work, profiled=False)
        launches["K1", dtype_name]["call_mods_reads"] = res["launches"]
        res["profile"] = run_e2e_reads(dtype_name, reads, ckpt, work,
                                       profiled=True)
        e2e_reads.append(res)
    fast5 = run_fast5_phase(ckpt, work, e2e_reads)
    for dtype_name in dtypes:
        launches["K1", dtype_name]["call_mods_fast5"] = \
            fast5[dtype_name]["launches"]
        for name in FORMAT_FIXTURES:
            launches["K1", dtype_name][f"call_mods_{name}"] = \
                fast5["formats"][name][dtype_name]["launches"]
    t0 = time.time()
    parallel = {"sharded_reads": run_sharded_reads(reads, ckpt, work)}
    launches["K1", "bfloat16"]["sharded_reads"] = \
        parallel["sharded_reads"]["launches"]
    phase_s = time.time() - t0
    del reads
    tf1 = run_tf1(tsv, work)
    for dtype_name in dtypes:
        launches["K1", dtype_name]["tf1_call_mods"] = \
            tf1[dtype_name]["launches"]
    tools = run_tools(work, ckpt, tsv)
    launches["K1", "bfloat16"]["runner"] = tools["runner"]["launches"]

    t0 = time.time()
    files = {k: os.path.join(work, name) for k, name in (
        ("train_tsv", "train.tsv"), ("valid_tsv", "valid.tsv"),
        ("train_bin", "train.bin"), ("valid_bin", "valid.bin"))}
    for part, n in (("train", TRAIN_ROWS), ("valid", VALID_ROWS)):
        write_labelled_features(files[f"{part}_tsv"], n, cfg, rng)
        check(convert_txt_to_binary(files[f"{part}_tsv"], files[f"{part}_bin"])
              == n, f"{part}: binary records")
    print(f"setup: {TRAIN_ROWS} + {VALID_ROWS} labelled rows as TSV and "
          f"binary in {time.time() - t0:.1f} s", flush=True)
    trains = []
    for dtype_name, epochs in (("float32", 2), ("bfloat16", 1)):
        res, trainer, best = run_train(dtype_name, epochs, files, work)
        launches["K1", dtype_name]["train"] = res["k1_launches"]
        launches["K2", dtype_name]["train"] = res["k2_launches"]
        res["score"] = score_checkpoint(dtype_name, best, files, work,
                                        min_accuracy=0.6)
        launches["K1", dtype_name]["score"] = res["score"]["k1_launches"]
        res["step"] = time_train_step(trainer, files)
        del trainer
        trains.append(res)
    tools.update(run_tools_after_train(work, files))
    denoised = run_denoise(work, rng)
    launches["K1", "float32"]["denoise"] = denoised["k1_launches"]
    launches["K2", "float32"]["denoise"] = denoised["k2_launches"]
    parity = {d: check_step_parity(d, device) for d in dtypes}

    t0 = time.time()
    parallel["call_mods"], gloo = run_ranks(tsv, ckpt, files, work, card,
                                            device="cuda:0", backend="gloo")
    parallel["gloo_2ranks"] = gloo
    for res in parallel["call_mods"]:
        launches["K1", res["dtype"]]["call_mods_2ranks"] = res["launches"]
    world1 = parallel["train_world1"] = run_train_ranks(files, work, card)
    launches["K1", "float32"]["train_world1"] = world1["k1_launches"]
    launches["K2", "float32"]["train_world1"] = world1["k2_launches"]
    launches["K1", "float32"]["train_world1_score"] = \
        world1["score"]["k1_launches"]
    launches["K2", "float32"]["gloo_2ranks"] = \
        gloo["dp"]["k2_launches"] + gloo["tp"]["k2_launches"]
    parallel["seconds"] = phase_s + time.time() - t0
    print(f"parallel: {parallel['seconds']:.1f} s | {card}", flush=True)

    rows = []
    for kernel, by_dtype in (("K1", k1_rows), ("K2", k2_rows)):
        for d in dtypes:
            row = by_dtype[d]
            row["launches_by_path"] = launches[kernel, d]
            row["launches"] = sum(launches[kernel, d].values())
            check(row["launches"] > 0, f"{row['name']}: no launch on a main "
                  f"path")
            rows.append(row)
    print(f"chip_smoke: {time.time() - start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"e2e": e2e, "library": library, "train": trains,
                      "denoise": denoised,
                      "gradients": grads, "step_parity": parity,
                      "reads": {"featurize": featurized,
                                "extract": extracted, "e2e": e2e_reads,
                                "fast5": fast5},
                      "tf1": tf1, "tools": tools, "parallel": parallel,
                      "card": card}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def cards_main(cards: int) -> None:
    """``--cards N``: the multi-GPU paths with one rank per card on N
    cards, under NCCL, at full width: ``call_mods`` through the CLI in
    bfloat16 and float32 against the single-process run, the data- and
    fc1 tensor-parallel steps against one process, and ``train`` through
    the CLI at world size N and 1 against two non-distributed runs, with
    their ms per step."""
    import torch
    if torch.cuda.device_count() < cards:
        fail(f"{cards} cards asked for, {torch.cuda.device_count()} seen")
    if not os.path.isdir(os.path.join(REPO, "deepsignal_tpu_torch")):
        fail("run from the root of a deepsignal-tpu checkout")
    sys.path.insert(0, REPO)
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.io import native
    from deepsignal_tpu_torch.io.feature_codec import convert_txt_to_binary
    from deepsignal_tpu_torch.ops.cuda import build, lstm, lstm_scan
    from deepsignal_tpu_torch.train.checkpoints import (
        ckpt_name, save_checkpoint, state_dict_to_variables)

    start = time.time()
    card = card_line()
    print(card, flush=True)
    build.build_libraries([lstm.LIBRARY, lstm_scan.LIBRARY,
                           native.PARSER_LIBRARY, native.FORMATTER_LIBRARY,
                           native.FEATURIZER_LIBRARY])
    work = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    cfg = ModelConfig()
    rng = np.random.default_rng(2024)
    tsv = os.path.join(work, "features.tsv")
    write_features(tsv, cfg, rng)
    sd = random_state_dict(cfg, rng)
    spread_logits(cfg, sd, tsv)
    ckpt = save_checkpoint(
        os.path.join(work, ckpt_name(cfg.kmer_len, cfg.cent_signals_len, 0)),
        cfg, state_dict_to_variables(cfg, sd))
    e2e = [run_e2e(d, tsv, ckpt, os.path.join(work, f"calls_{d}.tsv"))[0]
           for d in ("bfloat16", "float32")]
    files = {k: os.path.join(work, name) for k, name in (
        ("train_tsv", "train.tsv"), ("valid_tsv", "valid.tsv"),
        ("train_bin", "train.bin"), ("valid_bin", "valid.bin"))}
    for part, n in (("train", TRAIN_ROWS), ("valid", VALID_ROWS)):
        write_labelled_features(files[f"{part}_tsv"], n, cfg, rng)
        check(convert_txt_to_binary(files[f"{part}_tsv"], files[f"{part}_bin"])
              == n, f"{part}: binary records")
    calls, steps = run_ranks(tsv, ckpt, files, work, card, nproc=cards)
    trains = [run_train_ranks(files, work, card, nproc=n)
              for n in (cards, 1)]
    print(f"chip_smoke --cards {cards}: {time.time() - start:.1f} s",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"e2e": e2e, "call_mods": calls, "steps": steps,
                      "train": trains, "card": card}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--cards"]:
        cards_main(int(sys.argv[2]))
    else:
        main()
