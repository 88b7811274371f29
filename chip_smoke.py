#!/usr/bin/env python3
"""Smoke run of deepsignal_tpu_torch on one NVIDIA GPU.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

It prints the card and builds every CUDA kernel of the port from
``deepsignal_tpu_torch/csrc``, with ptxas's register and spill counts (a
spill in the fused encoder or in a resident scan kernel fails the run).  It
holds each kernel against its plain PyTorch version at the shapes of the
main paths (the fused encoder also at the call path's tail batch and at a
small ragged one; the scan at both train depths, a ragged tile, the call
path's small batch and two hidden sizes of its streaming variant, checking
which variant launched), prints each kernel's launch plan, waves and the L2
weight bytes it implies, and times the kernel, the plain version and one
PyTorch library call that computes the same function (the scan also in its
parts and through its streaming variant, at both train depths).
It checks the kernels' gradients against autograd through their plain
versions, and that a batch the fused encoder does not take runs through the
per-layer kernel.  Then it drives the two main paths at the full width of
the default model:

- ``call_mods`` end to end through ``run_call_mods``, with random seeded
  weights, on a synthetic feature TSV, in bfloat16 and in float32;
- ``train`` through ``train()`` on a synthetic separable labelled set
  (written as TSV, converted to binary records by the port), in float32 for
  two epochs and in bfloat16 for one, after which ``run_call_mods`` scores
  the validation TSV with the best checkpoint; every scan launch of a train
  step must be of the resident variant.  One train step through the
  kernels is held against the same step through the plain versions.

The bfloat16 call run is also timed stage by stage, and one forward batch of
4096 is profiled (its top device ops and the device's idle share).

Any failed check exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout, it
exits non-zero at once.  Scratch files go to ``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
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
# the train path: batch 512 (TrainConfig's default), 12 train batches and 2
# validation batches (the second one padded), a sweep every 6 steps
TRAIN_B = 512
TRAIN_ROWS = 12 * TRAIN_B
VALID_ROWS = 1000
DISPLAY_STEP = 6
# kernel vs plain, max abs: float32 sums in another order; in bfloat16 the
# output may sit one bfloat16 rounding (2**-8 near 1) apart
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# one train step through the kernels vs the plain versions: the loss, and
# all gradients as one vector, |g_kernel - g_plain| / |g_plain| (2-norms).
# float32 layers pass on 1e-7 differences.  In bfloat16 some K2 outputs sit
# one rounding (2**-8) apart, and the bfloat16 forward and backward
# downstream round again at other places: a few 2**-8, with a margin.
STEP_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
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
    import re
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
    fw, bw = cudnn_lstm(kf, bf, D), cudnn_lstm(kb, bb, D)
    xr = x.flip(1)

    def run():
        with torch.no_grad():
            return torch.cat([fw(x)[0][:, -1], bw(xr)[0][:, -1]], dim=1)
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
    import re

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
    H=256, D=131 for layer 0 and D=256 for layers 1-2) and at K2_CASES,
    both directions, each through the variant ``scan_plan`` gives; its plan,
    waves and L2 weight bytes at B=512; and its times at both train shapes.
    The row's ``ms`` is that of the D=256 call (four of the six launches of
    a train step), ``ms_d131`` that of layer 0's."""
    import torch

    from deepsignal_tpu_torch.core.device import torch_dtype
    from deepsignal_tpu_torch.ops.bilstm import lstm_scan_plain
    from deepsignal_tpu_torch.ops.cuda import lstm_scan
    from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

    dtype = torch_dtype(dtype_name)
    tol = TOL[dtype_name]
    rng = np.random.default_rng(19)
    shapes, timed = {}, {}
    for shape in ((TRAIN_B, T, D, H), (TRAIN_B, T, H, H)) + K2_CASES:
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
    events), call-row formatting; and one forward batch's host-clock time,
    device time, idle share and top device ops (``torch.profiler``)."""
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


# --------------------------------------------------------------------------
# train


def write_labelled_features(path: str, n: int, cfg, rng) -> None:
    """A separable labelled set: the label shifts the k-mer means and the
    central signals by +-0.5 (unit noise), so a few steps learn it."""
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    k, s = cfg.kmer_len, cfg.cent_signals_len
    bases = np.array(list("ACGT"))
    with open(path, "w") as f:
        for i in range(n):
            label = int(rng.integers(0, 2))
            shift = 0.5 if label else -0.5
            kmer = bases[rng.integers(0, 4, k)]
            kmer[k // 2:k // 2 + 2] = ["C", "G"]
            f.write(format_feature_row(
                "chr1", 1000 + i, "+", 1000 + i,
                f"read{i // SITES_PER_READ:05d}", "t", "".join(kmer),
                rng.normal(shift, 1, k), np.abs(rng.normal(0.3, 0.1, k)),
                rng.integers(3, 30, k),
                np.around(rng.normal(shift, 1, s), 6), label) + "\n")


def recording_trainer(model_cfg, train_cfg):
    """The port's Trainer, which also records each train step's loss and
    counts train and eval steps; ``train()`` drives it as its own."""
    from deepsignal_tpu_torch.train.trainer import Trainer

    class RecordingTrainer(Trainer):
        def __init__(self):
            super().__init__(model_cfg, train_cfg)
            self.losses = []
            self.train_steps = self.eval_steps = 0

        def train_on_batch_async(self, batch, lr):
            self.train_steps += 1
            return super().train_on_batch_async(batch, lr)

        def resolve_metrics(self, handle):
            out = super().resolve_metrics(handle)
            self.losses.append(out[0])
            return out

        def eval_on_batch_async(self, batch):
            self.eval_steps += 1
            return super().eval_on_batch_async(batch)

    return RecordingTrainer()


def run_train(dtype_name: str, epochs: int, files: dict, work: str) -> tuple:
    """``train()`` at full width with keep_prob 0.5, with the checks on its
    kernel launches, losses and logs; returns (result, trainer)."""
    import re

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
    times = []
    for i in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_on_batch(staged, lr)
        torch.cuda.synchronize()
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(times))

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
    res = {"ms_per_step": step_ms, "sites_per_s": TRAIN_B / step_ms * 1e3,
           "device_ms_per_step": device_ms,
           "device_idle_share": 1 - device_ms / step_ms, "top_ops": top,
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not os.path.isdir(os.path.join(REPO, "deepsignal_tpu_torch")):
        fail("run from the root of a deepsignal-tpu checkout")
    sys.path.insert(0, REPO)
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.core.device import resolve_device
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

    t0 = time.time()
    reports = build.build_libraries([lstm.LIBRARY, lstm_scan.LIBRARY])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    k1_ptxas = encoder_instantiations(reports[lstm.LIBRARY])
    k2_ptxas = scan_instantiations(reports[lstm_scan.LIBRARY])

    dtypes = ("bfloat16", "float32")
    k1_rows = {d: check_encoder(d, device) for d in dtypes}
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
    for dtype_name in dtypes:
        res, probs, labels, rows = run_e2e(
            dtype_name, tsv, ckpt, os.path.join(work, f"calls_{dtype_name}.tsv"))
        launches["K1", dtype_name]["call_mods"] = res["launches"]
        check_first_batch(dtype_name, tsv, ckpt, probs, labels)
        if dtype_name == "bfloat16":
            res["stages"] = time_stages(tsv, ckpt, rows)
        e2e.append(res)

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
    parity = {d: check_step_parity(d, device) for d in dtypes}

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
    print(json.dumps({"e2e": e2e, "train": trains, "gradients": grads,
                      "step_parity": parity, "card": card}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
