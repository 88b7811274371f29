"""Wrapper of the max-pool kernel (``csrc/max_pool.cu``).

TF's SAME max-pool of window 3 and stride 1 or 2 over the last axis of a
[B, C, L] activation, the pad (-inf, the extra one on the right) taken in
the kernel's index arithmetic: one pass that reads each input once and
writes each output once, and no index.  It replaces no TPU kernel (the JAX
package leaves pooling to XLA's ``reduce_window``); on the card torch ran
it as a padded copy and then ATen's pool with indices, an int64 beside
every output.  The kernel scans each window as ATen's does, so its output
is ``max_pool_plain``'s bit for bit (a NaN's payload aside); the source
comment in ``max_pool.cu`` has the design.

``models.layers.max_pool_same`` launches it where ``pool_kernel_takes``
holds: an inference forward on the card (``train`` false, autograd off) of
a contiguous bfloat16 or float32 activation.  Everything else (training,
whose backward needs the pool's indices, autograd, the CPU, other dtypes)
runs ``max_pool_plain``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

LIBRARY = "max_pool"
WINDOW = 3
STRIDES = (1, 2)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def tf_same_pads(length: int, window: int, stride: int):
    """TF 'SAME' (left, right) padding: extra pad on the right."""
    out_len = -(-length // stride)
    pad = max((out_len - 1) * stride + window - length, 0)
    return pad // 2, pad - pad // 2


@functools.lru_cache(maxsize=None)
def _kernel_fns(dtype: torch.dtype):
    """(launch, grid) entry points of ``dtype``."""
    from .build import load_library
    lib = load_library(LIBRARY)
    launch = getattr(lib, f"ds_max_pool_{_SUFFIX[dtype]}")
    launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    launch.restype = ctypes.c_int
    grid = getattr(lib, f"ds_max_pool_grid_{_SUFFIX[dtype]}")
    grid.argtypes = [ctypes.c_int, ctypes.c_int,
                     ctypes.POINTER(ctypes.c_int)]
    grid.restype = ctypes.c_int
    return launch, grid


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int, dtype: torch.dtype, stride: int,
                 aligned: bool) -> int:
    """The most blocks a launch takes: as many as the device keeps
    resident, asked once per device, dtype, stride and alignment."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _kernel_fns(dtype)[1](stride, int(aligned), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"max_pool's grid query failed: cudaError {err}")
    return blocks.value


def pool_kernel_takes(device_type: str, train: bool, grad_enabled: bool,
                      dtype: torch.dtype, contiguous: bool) -> bool:
    """Whether a max-pool runs the kernel: an inference forward on the card
    with autograd off, of a contiguous bfloat16 or float32 activation."""
    return (device_type == "cuda" and not train and not grad_enabled
            and dtype in _SUFFIX and contiguous)


def max_pool_plain(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """The SAME max-pool in torch ops: ``x`` padded with -inf, then
    ``F.max_pool1d``; differentiable."""
    pads = tf_same_pads(x.shape[-1], window, stride)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    return F.max_pool1d(x, window, stride)


def _check(x: torch.Tensor, window: int, stride: int) -> None:
    if x.dtype not in _SUFFIX:
        raise TypeError(f"max_pool takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"max_pool takes a contiguous [B, C, L] tensor, got "
                         f"{tuple(x.shape)}")
    if window != WINDOW or stride not in STRIDES:
        raise ValueError(f"max_pool takes window {WINDOW} and a stride in "
                         f"{STRIDES}, got {window} and {stride}")


def max_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """The kernel, on a CUDA [B, C, L] tensor: ``max_pool_plain``'s
    arguments, a new [B, C, ceil(L / stride)] tensor out.  Launches on the
    current stream, does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"max_pool runs on cuda, not {x.device}")
    _check(x, window, stride)
    b, c, n = x.shape
    out = x.new_empty((b, c, -(-n // stride)))
    if out.numel() == 0:
        return out
    aligned = (x.data_ptr() | out.data_ptr()) % 16 == 0
    launch = _kernel_fns(x.dtype)[0]
    # a launch must come from the device of the stream it goes to
    with torch.cuda.device(x.device):
        blocks = _grid_blocks(x.device.index, x.dtype, stride, aligned)
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), b * c, n, stride, blocks,
                     stream)
    if err != 0:
        raise RuntimeError(f"max_pool kernel launch failed: cudaError {err}")
    return out
