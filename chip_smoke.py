#!/usr/bin/env python3
"""Smoke run of deepsignal_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It prints the card, builds every CUDA kernel of the port from
``deepsignal_tpu_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes of the main path (and times kernel, plain version and
one PyTorch library call that computes the same function), then runs
``call_mods`` end to end through ``run_call_mods`` at the full width of the
default model, with random seeded weights, on a synthetic feature TSV, in
bfloat16 and in float32.  Any failed check exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``.  Without CUDA, or outside a
checkout, it exits non-zero at once.  Scratch files go to
``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the main path's shapes: batch 4096, k-mer 17, 128-wide embedding + 3
# features, hidden 256
B, T, D, H = 4096, 17, 131, 256
N_ROWS = 20000          # synthetic feature rows: 4 full device batches + tail
SITES_PER_READ = 40
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # kernel vs plain, max abs
MARGIN = 1e-3           # label check skips sites with |p1 - p0| below this
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


def encoder_inputs(rng, dtype, device):
    import torch

    def t(a):
        return torch.from_numpy(a.astype("float32")).to(device).to(dtype)

    x = t(rng.normal(0, 1, (B, T, D)))
    def kernels():
        return [t(rng.uniform(-0.07, 0.07, (d + H, 4 * H))) for d in (D, H, H)]
    def biases():
        return [t(rng.normal(0, 0.05, 4 * H)) for _ in range(3)]
    return x, kernels(), biases(), kernels(), biases()


def cudnn_encoder(args):
    """The same function as two cuDNN ``nn.LSTM(num_layers=3)`` calls (fw on
    x, bw on x reversed in time), gates permuted from TF's i, j, f, o to
    PyTorch's i, f, g, o and the forget bias folded in.  A yardstick only."""
    import torch
    x, kf, bf, kb, bb = args
    perm = torch.cat([torch.arange(g * H, (g + 1) * H) for g in (0, 2, 1, 3)])
    forget = torch.zeros(4 * H, device=x.device, dtype=x.dtype)
    forget[H:2 * H] = 1.0
    lstms = []
    for ks, bs in ((kf, bf), (kb, bb)):
        lstm = torch.nn.LSTM(D, H, num_layers=3, batch_first=True).to(
            device=x.device, dtype=x.dtype)
        with torch.no_grad():
            for layer, (k, b) in enumerate(zip(ks, bs)):
                d_in = D if layer == 0 else H
                getattr(lstm, f"weight_ih_l{layer}").copy_(k[:d_in, perm].T)
                getattr(lstm, f"weight_hh_l{layer}").copy_(k[d_in:, perm].T)
                getattr(lstm, f"bias_ih_l{layer}").copy_(b[perm] + forget)
                getattr(lstm, f"bias_hh_l{layer}").zero_()
        lstm.flatten_parameters()
        lstms.append(lstm)
    xr = x.flip(1)

    def run():
        with torch.no_grad():
            fw = lstms[0](x)[0][:, -1]
            bw = lstms[1](xr)[0][:, -1]
        return torch.cat([fw, bw], dim=1)
    return run


def encoder_bound_ms(dtype_name: str, elem: int) -> tuple:
    """(bound_ms, bound_by) of the wrapper's work: layer-0 projection of
    both directions, then 17 steps x 3 layers x 2 directions of products."""
    flops = (2 * B * T * D * 8 * H                       # projection
             + 2 * T * B * 2 * 4 * H * (H + 2 * H + 2 * H))  # recurrence
    weights = 2 * ((D + H) + 4 * H) * 4 * H + 2 * 3 * 4 * H
    nbytes = (B * T * D + weights + B * 2 * H) * elem
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_encoder(dtype_name: str, device) -> dict:
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import bilstm_encoder_fused_plain
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

    dtype = torch_dtype(dtype_name)
    args = encoder_inputs(np.random.default_rng(17), dtype, device)
    got = bilstm_encoder_fused(*args)
    want = bilstm_encoder_fused_plain(*args)
    torch.cuda.synchronize()
    check(tuple(got.shape) == (B, 2 * H) and got.dtype == dtype,
          f"K1 {dtype_name}: shape {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), f"K1 {dtype_name}: non-finite")
    err = (got.float() - want.float()).abs().max().item()
    print(f"K1 {dtype_name}: max_abs_err {err:.3e} (tolerance "
          f"{TOL[dtype_name]:g})", flush=True)
    check(err <= TOL[dtype_name], f"K1 {dtype_name}: error {err} above "
          f"{TOL[dtype_name]}")
    library = cudnn_encoder(args)
    lib_err = (library().float() - want.float()).abs().max().item()
    print(f"K1 {dtype_name}: cuDNN yardstick vs plain max_abs_err "
          f"{lib_err:.3e}", flush=True)
    bound, bound_by = encoder_bound_ms(dtype_name, got.element_size())
    row = {"name": f"lstm_encoder_{'f32' if dtype_name == 'float32' else 'bf16'}",
           "route": "cuda",
           "source": "deepsignal_tpu_torch/csrc/lstm_encoder.cu",
           "replaces": "deepsignal_tpu/ops/pallas/lstm.py:42",
           "launches": None, "max_abs_err": err,
           "ms": cuda_ms(lambda: bilstm_encoder_fused(*args)),
           "plain_ms": cuda_ms(lambda: bilstm_encoder_fused_plain(*args)),
           "bound_ms": bound, "bound_by": bound_by,
           "library_ms": cuda_ms(library)}
    print(f"K1 {dtype_name}: kernel {row['ms']:.3f} ms, plain "
          f"{row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.3f} ms, "
          f"bound {bound:.3f} ms ({bound_by})", flush=True)
    return row


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
    from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
    from deepsignal_tpu_torch.runtime.caller import run_call_mods

    bilstm_encoder_fused.launches = 0
    t0 = time.time()
    n = run_call_mods(tsv, ckpt, out_path, batch_size=B,
                      compute_dtype=dtype_name)
    seconds = time.time() - t0
    launches = bilstm_encoder_fused.launches
    device_batches = -(-N_ROWS // B)
    check(n == N_ROWS, f"{dtype_name}: {n} calls for {N_ROWS} rows")
    check(launches == device_batches,
          f"{dtype_name}: K1 launched {launches} times for {device_batches} "
          f"device batches")
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
           "label_1_share": float(labels.mean())}
    print(f"e2e {dtype_name}: {json.dumps(res)}", flush=True)
    return res, p, labels, rows


def time_stages(tsv, ckpt, calls) -> dict:
    """Seconds of each stage of the bfloat16 run, one at a time: checkpoint
    load onto the card, TSV parse, device forward of every batch (CUDA
    events), call-row formatting."""
    import dataclasses

    import torch

    from deepsignal_tpu_torch.io.calls_codec import format_call_block
    from deepsignal_tpu_torch.io.feature_codec import (
        FeatureBatch, iter_feature_batches_by_read)
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    from deepsignal_tpu_torch.runtime.caller import _pad
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
    fb = FeatureBatch.concat(list(iter_feature_batches_by_read(tsv, 50)))
    stages["parse_s"] = time.time() - t0
    batches = []
    for i in range(0, len(fb), B):
        batches.append([torch.from_numpy(_pad(a[i:i + B], B)).cuda() for a in
                        (fb.kmers, fb.means, fb.stds,
                         fb.lens.astype(np.float32), fb.signals)])

    def forward_all():
        with torch.inference_mode():
            for batch in batches:
                model(*batch)
    stages["device_s"] = cuda_ms(forward_all, reps=3, warmup=1) / 1e3
    p0 = np.float32([r[6] for r in calls])
    p1 = np.float32([r[7] for r in calls])
    pred = np.array([int(r[8]) for r in calls])
    t0 = time.time()
    format_call_block(fb.sampleinfo, p0, p1, pred, fb.kmers)
    stages["format_s"] = time.time() - t0
    print(f"stages bfloat16: {json.dumps(stages)}", flush=True)
    return stages


def check_first_batch(dtype_name, tsv, ckpt, probs, labels) -> None:
    """Labels of the first device batch equal those of the same model with
    the plain encoder (outside the |p1 - p0| < MARGIN band)."""
    import dataclasses
    from unittest import mock

    import torch

    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.models import layers
    from deepsignal_tpu_torch.models.deepsignal import model_from_state_dict
    from deepsignal_tpu_torch.ops.bilstm import bilstm_encoder_fused_plain
    from deepsignal_tpu_torch.train.checkpoints import (
        load_checkpoint, variables_to_state_dict)

    cfg, variables = load_checkpoint(ckpt)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype_name)
    model = model_from_state_dict(cfg, variables_to_state_dict(cfg, variables),
                                  torch.device("cuda"))
    with open(tsv) as f:
        fb = parse_feature_lines([next(f) for _ in range(B)])
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
    flips = int((plain_labels[sure] != labels[:B][sure]).sum())
    dprob = float(np.abs(p_plain - probs[:B]).max())
    print(f"e2e {dtype_name}: first batch vs plain encoder: {flips} label "
          f"flips over {int(sure.sum())} sites outside the margin, max "
          f"|dprob| {dprob:.3e}", flush=True)
    check(flips == 0, f"{dtype_name}: {flips} labels differ from the plain "
          f"encoder")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "deepsignal_tpu_torch")):
        fail("run from the root of a deepsignal-tpu checkout")
    sys.path.insert(0, REPO)
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.core.device import resolve_device
    from deepsignal_tpu_torch.ops.cuda import build
    from deepsignal_tpu_torch.ops.cuda.lstm import LIBRARY
    from deepsignal_tpu_torch.train.checkpoints import (
        ckpt_name, save_checkpoint, state_dict_to_variables)

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    device = resolve_device(None)

    t0 = time.time()
    reports = build.build_libraries([LIBRARY])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    kernel_rows = {d: check_encoder(d, device) for d in ("bfloat16", "float32")}

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
    for dtype_name in ("bfloat16", "float32"):
        res, probs, labels, rows = run_e2e(
            dtype_name, tsv, ckpt, os.path.join(work, f"calls_{dtype_name}.tsv"))
        kernel_rows[dtype_name]["launches"] = res["launches"]
        check_first_batch(dtype_name, tsv, ckpt, probs, labels)
        if dtype_name == "bfloat16":
            res["stages"] = time_stages(tsv, ckpt, rows)
        e2e.append(res)

    print(card, flush=True)
    print(json.dumps({"e2e": e2e, "card": card}), flush=True)
    print(json.dumps({"kernels": list(kernel_rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
