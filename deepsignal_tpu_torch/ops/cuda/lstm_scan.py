"""Wrapper of the per-layer LSTM scan kernel (``csrc/lstm_scan.cu``).

The kernel replaces the TPU kernel
``deepsignal_tpu/ops/pallas/lstm.py::_lstm_scan_kernel`` (launched by
``lstm_layer_pallas``): one layer-direction of the TF-LSTMCell scan,
[B, T, D] -> [B, T, H], every step at its absolute time index.  The input
projection ``x @ W_x + b`` is one ``torch`` product outside the kernel, in
x's dtype, as in the JAX package.  ``BiLSTMEncoder`` runs it six times per
forward whenever dropout is live (training) or the fused encoder kernel does
not take the shape.

On the H100 the kernel is bound by re-reading W_h from L2 at every step in
every CTA and by its float32 FMAs; its 4-row batch tile fills 128 of the
132 SMs at the training batch of 512.  The source comment in
``lstm_scan.cu`` has the details.

A CPU tensor takes the plain version (``ops.bilstm.lstm_scan_plain``); a
CUDA tensor launches the kernel or raises.  The gradient is a
``torch.autograd.Function`` whose backward recomputes through
``lstm_scan_plain`` under autograd: the JAX package defines no gradient of
its own for this kernel, so the gradient is that of the function the
forward computes.  The backward is no kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ..bilstm import lstm_scan_plain
from .lstm import recompute_grads

LIBRARY = "lstm_scan"
MAX_HIDDEN = 512

_SYMBOLS = {torch.float32: "ds_lstm_scan_f32",
            torch.bfloat16: "ds_lstm_scan_bf16"}


def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY), _SYMBOLS[dtype])
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, kernel, bias):
    if x.dtype not in _SYMBOLS:
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


def _launch(x, kernel, bias, reverse: bool):
    """The forward: the plain version for a CPU tensor, the kernel for a
    CUDA one."""
    if x.device.type == "cpu":
        return lstm_scan_plain(x, kernel, bias, reverse)
    if x.device.type != "cuda":
        raise ValueError(f"lstm scan runs on cpu or cuda, not {x.device}")
    _check(x, kernel, bias)
    b, t, d = x.shape
    h = kernel.shape[1] // 4
    xp = (x.reshape(b * t, d) @ kernel[:d] + bias).reshape(b, t, 4 * h)
    out = torch.empty(b, t, h, dtype=x.dtype, device=x.device)
    fn = _kernel_fn(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(xp.data_ptr(), kernel.data_ptr() + d * 4 * h * x.element_size(),
             out.data_ptr(), b, t, h, int(reverse), stream)
    if err != 0:
        raise RuntimeError(f"lstm_scan kernel launch failed: cudaError {err}")
    lstm_layer_scan.launches += 1
    return out


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


# launches of the kernel (not of the plain version) since the last reset
lstm_layer_scan.launches = 0
