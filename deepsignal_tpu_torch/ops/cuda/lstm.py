"""Wrapper of the fused BiLSTM-encoder kernel (``csrc/lstm_encoder.cu``).

The kernel replaces the TPU kernel
``deepsignal_tpu/ops/pallas/lstm.py::_encoder_kernel`` (launched by
``bilstm_encoder_pallas``): the whole 3-layer x 2-direction TF-LSTMCell
encoder [B, T, D] -> [B, 2H] in one launch.  Layer 0's input projection is
one ``torch`` product outside the kernel, as in the JAX package.

On the H100 the kernel is bound by streaming the recurrent weights from L2
(every CTA re-reads them at every step, about 45 GB per float32 batch of
4096) and by its float32 FMAs (365 GFLOP); its design keeps h and c on chip
for all 17 steps and 3 layers and reads the weights coalesced.  The source
comment in ``lstm_encoder.cu`` has the details.

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
                      layer0_projection)

LIBRARY = "lstm_encoder"
MAX_HIDDEN = 256

_SYMBOLS = {torch.float32: "ds_lstm_encoder_f32",
            torch.bfloat16: "ds_lstm_encoder_bf16"}


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def kernel_takes(batch: int, hidden: int, num_layers: int) -> bool:
    """Shapes the kernel handles: the JAX package's fused rule
    (deepsignal_tpu/models/layers.py:92-97) and the kernel's own limit of
    one thread per hidden unit."""
    return (num_layers == 3 and hidden % 128 == 0 and hidden <= MAX_HIDDEN
            and batch >= 8)


def _check(x, kernels, biases):
    b, t, d = x.shape
    h = kernels[0].shape[1] // 4
    if x.dtype not in _SYMBOLS:
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
    xp = layer0_projection(x, kernels_fw[0], biases_fw[0], kernels_bw[0],
                           biases_bw[0])
    upper = [bias.float().contiguous() for bias in
             (biases_fw[1], biases_fw[2], biases_bw[1], biases_bw[2])]
    out = torch.empty(b, 2 * h, dtype=x.dtype, device=x.device)
    row = 4 * h * x.element_size()  # bytes of one kernel row
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(xp.data_ptr(),
             kernels_fw[0].data_ptr() + d * row, kernels_fw[1].data_ptr(),
             kernels_fw[2].data_ptr(), upper[0].data_ptr(), upper[1].data_ptr(),
             kernels_bw[0].data_ptr() + d * row, kernels_bw[1].data_ptr(),
             kernels_bw[2].data_ptr(), upper[2].data_ptr(), upper[3].data_ptr(),
             out.data_ptr(), b, t, h, stream)
    if err != 0:
        raise RuntimeError(f"lstm_encoder kernel launch failed: cudaError {err}")
    bilstm_encoder_fused.launches += 1
    return out


# launches of the kernel (not of the plain version) since the last reset
bilstm_encoder_fused.launches = 0
