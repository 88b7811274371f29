"""Wrapper of the per-layer LSTM scan kernel (``csrc/lstm_scan.cu``).

The kernel replaces the TPU kernel
``deepsignal_tpu/ops/pallas/lstm.py::_lstm_scan_kernel`` (launched by
``lstm_layer_pallas``): one layer-direction of the TF-LSTMCell scan,
[B, T, D] -> [B, T, H], every step at its absolute time index.  The input
product ``x @ W_x`` is one ``torch`` matmul outside the kernel, in x's
dtype, as in the JAX package (``ops.bilstm.input_product``: a bfloat16
depth is padded to a multiple of 8 on the card); the kernel adds the bias
as torch adds it, so no elementwise pass is left.  ``BiLSTMEncoder`` runs it
six times per forward whenever dropout is live (training) or the fused
encoder kernel does not take the shape.

Two hand-written variants in one library, chosen by ``scan_plan``:

- **resident** (H 128 and 256, the model's shapes): a thread-block cluster
  owns a batch tile for the whole scan; each CTA keeps its hidden units'
  four gate columns of W_h in shared memory (128 KB at H 256: 64 units of
  bf16 in clusters of 4, 32 units of f32 in clusters of 8), their c in
  registers, and pushes its slice of each new h to every CTA of the cluster
  through distributed shared memory under one split cluster barrier per
  step.  bfloat16 products run on the tensor cores (``mma.sync`` m16n8k16),
  float32 ones in full FP32 on the FMA units.  The batch tile is the
  smallest whose clusters the card runs in one wave
  (``active_clusters``): at B 512, 16 clusters of 4 in bfloat16.  W_h
  crosses L2 once per cluster (``l2_weight_bytes``: 8.4 MB bf16 at B 512,
  where the streaming design read 1.1 GB), so bfloat16 is bound by its 17
  serial steps and float32 by its FMAs.
- **streaming** (every other H up to 512): one CTA of H threads per 4 batch
  rows, W_h streamed from L2 at every step.

The source comment in ``lstm_scan.cu`` has the arithmetic.

A CPU tensor takes the plain version (``ops.bilstm.lstm_scan_plain``); a
CUDA tensor launches a kernel or raises.  The gradient is a
``torch.autograd.Function`` whose backward recomputes through
``lstm_scan_plain`` under autograd: the JAX package defines no gradient of
its own for this kernel, so the gradient is that of the function the
forward computes.  The backward is no kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..bilstm import input_product, lstm_scan_plain
from .lstm import recompute_grads

LIBRARY = "lstm_scan"
MAX_HIDDEN = 512
THREADS = 256           # threads of a resident CTA
SMEM_LIMIT = 232_448    # dynamic shared memory one CTA may have on Hopper
RESIDENT_HIDDEN = (128, 256)
# hidden units per resident CTA, and the batch tiles (rows per cluster) the
# resident kernel is built for, per dtype: the larger runs the training
# batch of 512 in one wave, the smaller the call path's batches below 8
UNITS_PER_CTA = {torch.float32: 32, torch.bfloat16: 64}
ROW_TILES = {torch.float32: (32, 40), torch.bfloat16: (16, 32)}
STREAM_ROWS = 4         # batch rows per streaming CTA

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}


@functools.lru_cache(maxsize=None)
def _kernel_fn(variant: str, dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY),
                 f"ds_lstm_scan_{variant}_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def streaming_plan(batch: int, hidden: int) -> dict:
    """The streaming kernel's launch: one CTA of ``hidden`` threads per 4
    batch rows, h of its rows in shared memory as float32."""
    return {"variant": "streaming", "rows": STREAM_ROWS, "cluster": 1,
            "grid": (-(-batch // STREAM_ROWS), 1), "threads": hidden,
            "units": hidden, "cols": 4 * hidden, "w_slice_bytes": 0,
            "smem_bytes": STREAM_ROWS * ((hidden + 3) & ~3) * 4}


def resident_plan(batch: int, hidden: int, dtype: torch.dtype,
                  rows: int) -> dict:
    """The resident kernel's launch with ``rows`` batch rows per cluster: a
    CTA's shared memory holds its [H, 4 units] slice of W_h and h of the
    tile [2][rows][H], both in the storage dtype, and one 8-byte
    mbarrier."""
    elem = _ELEM[dtype]
    units = UNITS_PER_CTA[dtype]
    cluster = hidden // units
    cols = 4 * units
    return {"variant": "resident", "rows": rows, "cluster": cluster,
            "grid": (cluster, -(-batch // rows)), "threads": THREADS,
            "units": units, "cols": cols,
            "w_slice_bytes": hidden * cols * elem,
            "smem_bytes": (hidden * cols + 2 * rows * hidden) * elem + 8}


def scan_plan(batch: int, hidden: int, dtype: torch.dtype,
              clusters_at_once: int | None) -> dict:
    """The launch the wrapper hands the kernel: the variant, batch rows per
    cluster, CTAs per cluster, grid (cluster rank, batch tile), threads,
    hidden units and gate columns per CTA, the bytes of W_h a resident CTA
    holds, and dynamic shared-memory bytes per CTA.

    H 128 and 256 take the resident kernel, with the smallest batch tile
    whose clusters fit in one wave of ``clusters_at_once`` (the card's
    ``active_clusters``; the largest tile when none fits).  Every other H
    takes the streaming kernel, and ``clusters_at_once`` is not read."""
    if hidden not in RESIDENT_HIDDEN:
        return streaming_plan(batch, hidden)
    if (clusters_at_once or 0) < 1:
        raise RuntimeError(
            f"the card runs no cluster of the resident lstm scan kernel at "
            f"hidden {hidden}, {dtype} (cudaOccupancyMaxActiveClusters gave "
            f"{clusters_at_once})")
    tiles = ROW_TILES[dtype]
    rows = next((r for r in tiles if -(-batch // r) <= clusters_at_once),
                tiles[-1])
    return resident_plan(batch, hidden, dtype, rows)


_plan = functools.lru_cache(maxsize=256)(scan_plan)


def l2_weight_bytes(plan: dict, steps: int, hidden: int,
                    dtype: torch.dtype) -> int:
    """W_h bytes a launch with ``plan`` reads from L2: a resident cluster
    loads W_h once (each CTA its slice); a streaming CTA reads all of it at
    every step."""
    w_h = hidden * 4 * hidden * _ELEM[dtype]
    if plan["variant"] == "resident":
        return plan["grid"][1] * w_h
    return plan["grid"][0] * steps * w_h


def active_clusters(hidden: int, dtype: torch.dtype,
                    rows: int | None = None) -> int:
    """Clusters of the resident kernel the card runs at once (one wave),
    from ``cudaOccupancyMaxActiveClusters``, for the batch tile ``rows``
    (by default the largest, which has the most shared memory); builds the
    library."""
    from .build import load_library
    fn = getattr(load_library(LIBRARY),
                 f"ds_lstm_scan_active_clusters_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(hidden, rows or ROW_TILES[dtype][-1], ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: cudaError {err}")
    return out.value


@functools.lru_cache(maxsize=None)
def _clusters_at_once(hidden: int, dtype: torch.dtype, device: int) -> int:
    with torch.cuda.device(device):
        return active_clusters(hidden, dtype)


def _check(x, kernel, bias):
    if x.dtype not in _SUFFIX:
        raise TypeError(f"lstm scan takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or min(x.shape) < 1:
        raise ValueError(f"lstm scan takes a non-empty [B, T, D] input, got "
                         f"{tuple(x.shape)}")
    d = x.shape[2]
    h = kernel.shape[-1] // 4
    if not 1 <= h <= MAX_HIDDEN:
        raise ValueError(f"lstm scan kernel does not take hidden {h} (at most "
                         f"{MAX_HIDDEN})")
    if tuple(kernel.shape) != (d + h, 4 * h) or tuple(bias.shape) != (4 * h,):
        raise ValueError(f"kernel {tuple(kernel.shape)} / bias "
                         f"{tuple(bias.shape)}, want {(d + h, 4 * h)} / "
                         f"{(4 * h,)}")
    for a in (x, kernel, bias):
        if a.device != x.device or a.dtype != x.dtype:
            raise ValueError("lstm scan inputs must share x's device and dtype")
        if not a.is_contiguous():
            raise ValueError("lstm scan inputs must be contiguous")


def card_plan(batch: int, hidden: int, dtype: torch.dtype,
              device: torch.device) -> dict:
    """``scan_plan`` with the cluster count of the card ``device``."""
    at_once = (_clusters_at_once(hidden, dtype, device.index or 0)
               if hidden in RESIDENT_HIDDEN else None)
    return _plan(batch, hidden, dtype, at_once)


def scan_on_product(xp, w_h, bias, reverse: bool, plan: dict):
    """The kernel alone, on CUDA tensors: xp [B, T, 4H] the input product
    x @ W_x without the bias, w_h [H, 4H] the recurrent rows, bias [4H],
    all contiguous in one dtype, launched with ``plan``.  Returns
    [B, T, H]."""
    b, t, g = xp.shape
    out = torch.empty(b, t, g // 4, dtype=xp.dtype, device=xp.device)
    fn = _kernel_fn(plan["variant"], xp.dtype)
    # a launch must come from the device of the stream it goes to
    with torch.cuda.device(xp.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xp.data_ptr(), w_h.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, t, g // 4, int(reverse), plan["rows"],
                 plan["cluster"], plan["smem_bytes"], stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan {plan['variant']} kernel launch "
                           f"failed: cudaError {err}")
    lstm_layer_scan.launches += 1
    lstm_layer_scan.launches_by_variant[plan["variant"]] += 1
    return out


def _launch(x, kernel, bias, reverse: bool):
    """The forward: the plain version for a CPU tensor, the kernel for a
    CUDA one, launched with ``card_plan``."""
    if x.device.type == "cpu":
        return lstm_scan_plain(x, kernel, bias, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"lstm scan runs on cpu or cuda, not {x.device}")
    _check(x, kernel, bias)
    b, t, d = x.shape
    h = kernel.shape[1] // 4
    w_h = kernel[d:]
    if w_h.data_ptr() % 16:  # the resident kernel copies 16-byte chunks
        w_h = w_h.clone()
    xp = input_product(x.reshape(b * t, d), kernel[:d]).reshape(b, t, 4 * h)
    return scan_on_product(xp, w_h, bias, reverse,
                           card_plan(b, h, x.dtype, x.device))


class _Scan(torch.autograd.Function):
    """The kernel forward, the plain version's gradient."""

    @staticmethod
    def forward(ctx, x, kernel, bias, reverse):
        ctx.save_for_backward(x, kernel, bias)
        ctx.reverse = reverse
        return _launch(x, kernel, bias, reverse)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads(
            lambda x, k, b: lstm_scan_plain(x, k, b, ctx.reverse), ctx,
            grad_out), None)


def lstm_layer_scan(x, kernel, bias, reverse: bool = False):
    """One layer-direction [B, T, D] -> [B, T, H] in x's dtype, outputs by
    absolute time; differentiable.  ``kernel`` is the TF-layout
    [(D + H), 4H] matrix and ``bias`` [4H], both in x's dtype (the JAX
    package's ``lstm_layer_pallas`` signature)."""
    return _Scan.apply(x, kernel, bias, reverse)


# launches of the kernels (not of the plain version) since the last reset,
# in all and by variant
lstm_layer_scan.launches = 0
lstm_layer_scan.launches_by_variant = {"resident": 0, "streaming": 0}
