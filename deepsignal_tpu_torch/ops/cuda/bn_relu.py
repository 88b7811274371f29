"""Wrapper of the batch-norm-and-relu kernel (``csrc/bn_relu.cu``).

Batch norm at inference, ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` over the channel axis of a [B, C, L] activation with the running
statistics, and optionally the relu after it, in one pass that reads each
element once and writes it once.  It replaces no TPU kernel (the JAX
package leaves batch norm to XLA); on the card torch ran it as seven
[C]-sized ops and four passes over the activation.  The kernel rounds
where torch rounds, so its output is ``batch_norm_relu_plain``'s bit for
bit; the source comment in ``bn_relu.cu`` has the arithmetic and the
design.

``models.layers.TFBatchNorm`` launches it where ``bn_kernel_takes`` holds:
an inference forward on the card (``train`` false, autograd off) of a
contiguous bfloat16 or float32 activation.  Everything else (training,
autograd, the CPU, other dtypes) runs ``batch_norm_relu_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LIBRARY = "bn_relu"
# each channel's three float factors in a block's 48 KB of shared memory
# (Inception's widest batch norm has 256 channels)
MAX_CHANNELS = 48 * 1024 // 12

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY), f"ds_bn_relu_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def bn_kernel_takes(device_type: str, train: bool, grad_enabled: bool,
                    dtype: torch.dtype, contiguous: bool) -> bool:
    """Whether batch norm runs the kernel: an inference forward on the card
    with autograd off, of a contiguous bfloat16 or float32 activation."""
    return (device_type == "cuda" and not train and not grad_enabled
            and dtype in _SUFFIX and contiguous)


def batch_norm_relu_plain(x, mean, var, scale, bias, eps, relu: bool):
    """The function in torch ops, in x's dtype: ``mean``, ``var``,
    ``scale`` and ``bias`` [C] (cast to x's dtype here), ``eps`` a 0-d
    tensor of x's dtype; differentiable."""
    dt = x.dtype
    inv = torch.rsqrt(var.to(dt)[:, None] + eps)
    out = (x - mean.to(dt)[:, None]) * (inv * scale.to(dt)[:, None]) \
        + bias.to(dt)[:, None]
    return torch.relu(out) if relu else out


def _check(x, params, eps):
    if x.dtype not in _SUFFIX:
        raise TypeError(f"bn_relu takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"bn_relu takes a contiguous [B, C, L] tensor, got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"bn_relu takes 1 to {MAX_CHANNELS} channels, got "
                         f"{c}")
    for p in params:
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != (c,) or not p.is_contiguous()):
            raise ValueError(f"bn_relu's statistics, scale and bias must be "
                             f"contiguous float32 [{c}] on {x.device}")
    if eps.device != x.device or eps.dtype != x.dtype or eps.dim() != 0:
        raise ValueError(f"bn_relu's eps must be a 0-d {x.dtype} tensor on "
                         f"{x.device}")


def batch_norm_relu(x, mean, var, scale, bias, eps, relu: bool):
    """The kernel, on a CUDA [B, C, L] tensor: ``batch_norm_relu_plain``'s
    arguments (the statistics, scale and bias float32), a new tensor out.
    Launches on the current stream, does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu runs on cuda, not {x.device}")
    _check(x, (mean, var, scale, bias), eps)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    # a launch must come from the device of the stream it goes to
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(x.dtype)(
            x.data_ptr(), out.data_ptr(), mean.data_ptr(), var.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), eps.data_ptr(), x.numel(),
            x.shape[1], x.shape[2], int(relu), stream)
    if err != 0:
        raise RuntimeError(f"bn_relu kernel launch failed: cudaError {err}")
    return out
