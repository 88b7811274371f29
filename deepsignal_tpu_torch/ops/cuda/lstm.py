"""Wrapper of the fused BiLSTM-encoder kernel (``csrc/lstm_encoder.cu``).

The kernel replaces the TPU kernel
``deepsignal_tpu/ops/pallas/lstm.py::_encoder_kernel`` (launched by
``bilstm_encoder_pallas``): the whole 3-layer x 2-direction TF-LSTMCell
encoder [B, T, D] -> [B, 2H] in one launch.  Layer 0's input product
``x @ W_x`` is one ``torch`` matmul outside the kernel, as in the JAX
package; the kernel adds its bias.

On the H100 a thread-block cluster of H / 64 CTAs owns one direction and one
batch tile (64 rows in bfloat16, 32 in float32); each CTA owns 64 hidden
units, their cell state in registers and their 256 gate columns of every
weight matrix, which it streams from L2 by ``cp.async`` into a ring of
shared-memory stages guarded by mbarriers; the new h goes to every CTA of
the cluster through distributed shared memory.  bfloat16 products run on
the tensor cores (``mma.sync`` m16n8k16), float32 ones in full FP32 on the
FMA units, with every [*, 4H] operand gate-interleaved (``gate_interleave``)
so that a unit's four gates are one float4.  ``tile_plan`` is the launch's
shape and shared-memory budget (229,424 bytes of the 232,448 a CTA may have,
at H 256), which the kernel checks against its own; ``l2_weight_bytes`` is
the weight stream it implies: 5.7 GB (bfloat16) and 22.8 GB (float32) per
batch of 4096.  bfloat16 is bound by that stream and the 51 serial
layer-steps, float32 by its 365 GFLOP of FMAs.  The source comment in
``lstm_encoder.cu`` has the arithmetic.

A CPU tensor takes the plain version (``ops.bilstm.bilstm_encoder_fused_plain``);
a CUDA tensor launches the kernel or raises.

The gradient is a ``torch.autograd.Function`` whose forward is the kernel
and whose backward recomputes through ``ops.bilstm.bilstm_encoder_plain``
under autograd, as the JAX package's ``custom_vjp`` recomputes through
``bilstm_encoder_xla`` (deepsignal_tpu/ops/pallas/lstm.py:174-199).  The
backward is no kernel: the JAX package has none either.
"""

from __future__ import annotations

import ctypes

import torch

from ..bilstm import (bilstm_encoder_fused_plain, bilstm_encoder_plain,
                      layer0_product)

LIBRARY = "lstm_encoder"
MAX_HIDDEN = 256
THREADS = 256
UNITS_PER_CTA = 64      # hidden units each CTA of a cluster owns
SMEM_LIMIT = 232_448    # dynamic shared memory one CTA may have on Hopper
# batch rows per cluster, K-rows per staged weight slice and weight stages
# in shared memory, per dtype
_TILE = {torch.float32: (32, 32, 3), torch.bfloat16: (64, 64, 3)}

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY), f"ds_lstm_encoder_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def tile_plan(batch: int, hidden: int, dtype: torch.dtype) -> dict:
    """The launch the wrapper hands the kernel: batch rows per CTA (every
    CTA of a cluster takes the same rows, each its own 64 hidden units),
    CTAs per cluster, grid (cluster rank, batch tile, direction), threads,
    K-rows per weight slice, weight stages and dynamic shared-memory bytes
    per CTA.  The shared memory holds h of the 3 layers [3][rows][H], the
    weight ring [stages][slice][256] and the step's xp slice [rows][256],
    all in the storage dtype, and two 8-byte mbarriers per stage."""
    rows, slice_rows, stages = _TILE[dtype]
    elem = torch.empty((), dtype=dtype).element_size()
    cluster = hidden // UNITS_PER_CTA
    cols = 4 * UNITS_PER_CTA
    smem = ((3 * rows * hidden + stages * slice_rows * cols + rows * cols)
            * elem + 2 * stages * 8)
    return {"rows_per_cta": rows, "cluster": cluster,
            "grid": (cluster, -(-batch // rows), 2), "threads": THREADS,
            "slice_rows": slice_rows, "stages": stages, "smem_bytes": smem}


def gate_interleave(a: torch.Tensor, hidden: int) -> torch.Tensor:
    """The float32 kernel's column order of a TF-layout [..., 4H] tensor
    (gate blocks i, j, f, o): column 4u + g holds gate g of hidden unit u,
    so a CTA's 64 units are 256 contiguous columns and the four gates of a
    unit one float4.  A permutation."""
    shape = a.shape
    return (a.reshape(*shape[:-1], 4, hidden).transpose(-1, -2)
            .reshape(shape).contiguous())


def l2_weight_bytes(batch: int, steps: int, hidden: int,
                    dtype: torch.dtype) -> int:
    """Recurrent-weight bytes the launch streams from L2: each cluster reads
    its direction's 5H x 4H weights (layer 0's [H, 4H] rows, layers 1 and
    2's [2H, 4H] kernels) once per step, each CTA its own 256 columns."""
    plan = tile_plan(batch, hidden, dtype)
    elem = torch.empty((), dtype=dtype).element_size()
    clusters = plan["grid"][1] * plan["grid"][2]
    return clusters * steps * 5 * hidden * 4 * hidden * elem


def active_clusters(hidden: int, dtype: torch.dtype) -> int:
    """Clusters of the kernel the card runs at once (one wave), from
    ``cudaOccupancyMaxActiveClusters``; builds the library."""
    from .build import load_library
    fn = getattr(load_library(LIBRARY),
                 f"ds_lstm_encoder_active_clusters_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    err = fn(hidden, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: cudaError {err}")
    return out.value


def kernel_takes(batch: int, hidden: int, num_layers: int) -> bool:
    """Shapes the kernel handles: the JAX package's fused rule
    (deepsignal_tpu/models/layers.py:92-97) and the kernel's own limit:
    h of the 3 layers and the weight ring fit one CTA's shared memory up to
    H 256 (``tile_plan``)."""
    return (num_layers == 3 and hidden % 128 == 0 and hidden <= MAX_HIDDEN
            and batch >= 8)


def _check(x, kernels, biases):
    b, t, d = x.shape
    h = kernels[0].shape[1] // 4
    if x.dtype not in _TILE:
        raise TypeError(f"fused encoder takes float32 or bfloat16, got {x.dtype}")
    if len(kernels) != 3 or len(biases) != 3:
        raise ValueError("fused encoder takes exactly 3 layers per direction")
    if not kernel_takes(b, h, 3):
        raise ValueError(f"fused encoder kernel does not take batch {b}, "
                         f"hidden {h}")
    shapes = [(d + h, 4 * h), (2 * h, 4 * h), (2 * h, 4 * h)]
    for w, shape in zip(kernels, shapes):
        if tuple(w.shape) != shape:
            raise ValueError(f"kernel shape {tuple(w.shape)}, want {shape}")
    for bias in biases:
        if tuple(bias.shape) != (4 * h,):
            raise ValueError(f"bias shape {tuple(bias.shape)}, want {(4 * h,)}")
    for a in (x, *kernels, *biases):
        if a.device != x.device or a.dtype != x.dtype:
            raise ValueError("fused encoder inputs must share x's device and "
                             "dtype")
        if not a.is_contiguous():
            raise ValueError("fused encoder inputs must be contiguous")


def recompute_grads(fn, ctx, grad_out):
    """Backward of an autograd Function whose forward equals ``fn`` on
    ``ctx.saved_tensors``: run ``fn`` again under autograd and return the
    gradient of each input that needs one (None for the others)."""
    needs = ctx.needs_input_grad[:len(ctx.saved_tensors)]
    with torch.enable_grad():
        inputs = [a.detach().requires_grad_(need)
                  for a, need in zip(ctx.saved_tensors, needs)]
        out = fn(*inputs)
        grads = iter(torch.autograd.grad(
            out, [a for a in inputs if a.requires_grad], grad_out))
    return tuple(next(grads) if need else None for need in needs)


def _encoder_plain(x, *params):
    return bilstm_encoder_plain(x, params[0:3], params[3:6], params[6:9],
                                params[9:12])


class _FusedEncoder(torch.autograd.Function):
    """The kernel forward, the plain encoder's gradient."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return _launch(x, list(params[0:3]), list(params[3:6]),
                       list(params[6:9]), list(params[9:12]))

    @staticmethod
    def backward(ctx, grad_out):
        return recompute_grads(_encoder_plain, ctx, grad_out)


def bilstm_encoder_fused(x, kernels_fw, biases_fw, kernels_bw, biases_bw):
    """Fused 3-layer bidirectional encoder [B, T, D] -> [B, 2H] in x's dtype,
    differentiable.

    ``kernels_*``: 3 TF-layout [(D_l + H), 4H] matrices per direction;
    ``biases_*``: 3 [4H] vectors; all in x's dtype (parameters cast to the
    compute dtype by the caller)."""
    return _FusedEncoder.apply(x, *kernels_fw, *biases_fw, *kernels_bw,
                               *biases_bw)


def _launch(x, kernels_fw, biases_fw, kernels_bw, biases_bw):
    """The forward: the plain version for a CPU tensor, the kernel for a
    CUDA one."""
    if x.device.type == "cpu":
        return bilstm_encoder_fused_plain(x, kernels_fw, biases_fw,
                                          kernels_bw, biases_bw)
    if x.device.type != "cuda":
        raise ValueError(f"fused encoder runs on cpu or cuda, not {x.device}")
    _check(x, kernels_fw, biases_fw)
    _check(x, kernels_bw, biases_bw)
    b, t, d = x.shape
    h = kernels_fw[0].shape[1] // 4
    if x.dtype == torch.float32:
        # the float32 kernel takes every [*, 4H] operand gate-interleaved;
        # xp is then interleaved too (the product's columns are permuted)
        kernels_fw, biases_fw, kernels_bw, biases_bw = (
            [gate_interleave(a, h) for a in arrays]
            for arrays in (kernels_fw, biases_fw, kernels_bw, biases_bw))
    # the kernel copies weights in 16-byte chunks (cp.async)
    kernels_fw, kernels_bw = ([k if k.data_ptr() % 16 == 0 else k.clone()
                               for k in ks] for ks in (kernels_fw, kernels_bw))
    # the kernel adds layer 0's bias to the product as torch adds it
    xp = layer0_product(x, kernels_fw[0], kernels_bw[0])
    upper = [bias.float().contiguous() for bias in
             (biases_fw[1], biases_fw[2], biases_bw[1], biases_bw[2])]
    out = torch.empty(b, 2 * h, dtype=x.dtype, device=x.device)
    row = 4 * h * x.element_size()  # bytes of one kernel row
    plan = tile_plan(b, h, x.dtype)
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(xp.data_ptr(),
             kernels_fw[0].data_ptr() + d * row, kernels_fw[1].data_ptr(),
             kernels_fw[2].data_ptr(), biases_fw[0].data_ptr(),
             upper[0].data_ptr(), upper[1].data_ptr(),
             kernels_bw[0].data_ptr() + d * row, kernels_bw[1].data_ptr(),
             kernels_bw[2].data_ptr(), biases_bw[0].data_ptr(),
             upper[2].data_ptr(), upper[3].data_ptr(), out.data_ptr(), b, t,
             h, plan["rows_per_cta"], plan["cluster"], plan["smem_bytes"],
             stream)
    if err != 0:
        raise RuntimeError(f"lstm_encoder kernel launch failed: cudaError {err}")
    bilstm_encoder_fused.launches += 1
    return out


# launches of the kernel (not of the plain version) since the last reset
bilstm_encoder_fused.launches = 0
