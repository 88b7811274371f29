"""Wrapper of the batch-norm-and-relu kernel (``csrc/bn_relu.cu``).

Batch norm at inference, ``(x - mean) * (rsqrt(var + eps) * scale) +
bias`` over the channel axis of a [B, C, L] activation with the running
statistics, and the relu after it on a leading block of the channels (none,
all, or the first of a merged conv's outputs), in one pass that reads each
element once and writes it once.  It replaces no TPU kernel (the JAX
package leaves batch norm to XLA); on the card torch ran it as seven
[C]-sized ops and four passes over the activation.  The kernel rounds
where torch rounds, so its output is ``batch_norm_relu_plain``'s bit for
bit; the source comment in ``bn_relu.cu`` has the arithmetic and the
design.

``models.layers.TFBatchNorm`` launches it where ``bn_kernel_takes`` holds:
an inference forward on the card (``train`` false, autograd off) of a
contiguous bfloat16 or float32 activation, and so does
``InceptionBlock``'s merged 1x1 convs' batch norm.  Everything else
(training, autograd, the CPU, other dtypes) runs ``batch_norm_relu_plain``.

``relu`` is the number of leading channels the relu applies to, 0 to C
(a bool is refused: it reads as 0 or 1 channel).  With ``groups``, channel
counts that sum to C, the output comes as one [B, C_g, L] tensor a group:
the kernel writes each group as a contiguous block of one buffer, the plain
version returns channel slices of its one output.
"""

from __future__ import annotations

import ctypes
import functools

import torch

LIBRARY = "bn_relu"
# each channel's three float factors in a block's 48 KB of shared memory
# (Inception's widest batch norm has 256 channels)
MAX_CHANNELS = 48 * 1024 // 12
MAX_GROUPS = 8
# with groups, each channel's group (two ints) beside its factors
MAX_GROUPED_CHANNELS = 48 * 1024 // 20

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(dtype: torch.dtype):
    from .build import load_library
    fn = getattr(load_library(LIBRARY), f"ds_bn_relu_{_SUFFIX[dtype]}")
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def bn_kernel_takes(device_type: str, train: bool, grad_enabled: bool,
                    dtype: torch.dtype, contiguous: bool) -> bool:
    """Whether batch norm runs the kernel: an inference forward on the card
    with autograd off, of a contiguous bfloat16 or float32 activation."""
    return (device_type == "cuda" and not train and not grad_enabled
            and dtype in _SUFFIX and contiguous)


def _relu_channels(relu: int, channels: int) -> int:
    if isinstance(relu, bool) or not 0 <= relu <= channels:
        raise ValueError(f"bn_relu's relu takes a count of 0 to {channels} "
                         f"channels, got {relu!r}")
    return int(relu)


def batch_norm_relu_plain(x, mean, var, scale, bias, eps, relu: int,
                          groups=None):
    """The function in torch ops, in x's dtype: ``mean``, ``var``,
    ``scale`` and ``bias`` [C] (cast to x's dtype here), ``eps`` a 0-d
    tensor of x's dtype, the relu on the leading ``relu`` channels, with
    ``groups`` the output's channel slices; differentiable."""
    dt = x.dtype
    inv = torch.rsqrt(var.to(dt)[:, None] + eps)
    out = (x - mean.to(dt)[:, None]) * (inv * scale.to(dt)[:, None]) \
        + bias.to(dt)[:, None]
    r = _relu_channels(relu, x.shape[1])
    if r == x.shape[1]:
        out = torch.relu(out)
    elif r > 0:
        out = torch.cat((torch.relu(out[:, :r]), out[:, r:]), dim=1)
    return out if groups is None else out.split(list(groups), dim=1)


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


def _group_channels(groups, channels: int) -> list:
    sizes = [int(g) for g in groups]
    if (not 1 <= len(sizes) <= MAX_GROUPS or min(sizes) < 1
            or sum(sizes) != channels
            or (len(sizes) > 1 and channels > MAX_GROUPED_CHANNELS)):
        raise ValueError(f"bn_relu's groups must be 1 to {MAX_GROUPS} "
                         f"positive channel counts summing to {channels} "
                         f"(more than one: at most {MAX_GROUPED_CHANNELS} "
                         f"channels), got {sizes}")
    return sizes


def batch_norm_relu(x, mean, var, scale, bias, eps, relu: int,
                    groups=None):
    """The kernel, on a CUDA [B, C, L] tensor: ``batch_norm_relu_plain``'s
    arguments (the statistics, scale and bias float32); a new tensor out,
    or with ``groups`` a tuple of contiguous tensors, one a group, blocks
    of one new buffer.  Launches on the current stream, does not
    synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"bn_relu runs on cuda, not {x.device}")
    _check(x, (mean, var, scale, bias), eps)
    b, c, n = x.shape
    sizes = [c] if groups is None else _group_channels(groups, c)
    relu = _relu_channels(relu, c)
    out = torch.empty_like(x)
    if x.numel():
        counts = (ctypes.c_int * len(sizes))(*sizes)
        # a launch must come from the device of the stream it goes to
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = _kernel_fn(x.dtype)(
                x.data_ptr(), out.data_ptr(), mean.data_ptr(),
                var.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                eps.data_ptr(), x.numel(), c, n, relu, len(sizes),
                ctypes.addressof(counts), stream)
        if err != 0:
            raise RuntimeError(f"bn_relu kernel launch failed: cudaError "
                               f"{err}")
    if groups is None:
        return out
    blocks = out.view(-1).split([b * g * n for g in sizes])
    return tuple(block.view(b, g, n) for block, g in zip(blocks, sizes))
