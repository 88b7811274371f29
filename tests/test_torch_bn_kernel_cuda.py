"""The batch-norm-and-relu kernel (``csrc/bn_relu.cu``) against the torch
formula, on the card, bit for bit.

This file imports neither JAX nor deepsignal_tpu; on a machine with a GPU
run it without the suite's conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_bn_kernel_cuda.py

Without a GPU every test skips.
"""

import time
from unittest import mock

import pytest
import torch

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda.bn_relu import (MAX_CHANNELS,
                                                   batch_norm_relu,
                                                   batch_norm_relu_plain)

B = 4096
# (C, L) of every batch norm of the published InceptionNet (360 signals,
# x16, blocks 3/5/3): the stem's three convs, then the blocks' 2t, 3t and
# 4t channels at each stage's length
SHAPES = [(64, 180), (128, 90), (256, 90),
          *((c, n) for n in (90, 45, 23) for c in (32, 48, 64))]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepsignal_tpu_torch.core.device import resolve_device
    return resolve_device("cuda")


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _norm(c, device, seed):
    """Running statistics away from 0 and 1, scales of both signs."""
    gen = torch.Generator().manual_seed(seed)
    mean = torch.randn(c, generator=gen) * 0.7
    var = torch.rand(c, generator=gen) * 3.0 + 0.05
    scale = (torch.rand(c, generator=gen) * 2.5 + 0.25) \
        * torch.where(torch.rand(c, generator=gen) < 0.5, -1.0, 1.0)
    bias = torch.randn(c, generator=gen) * 0.5
    return [t.to(device) for t in (mean, var, scale, bias)]


def _activation(b, c, n, dtype, device, mean, seed):
    """Normal activations (sd 2) with NaN, +-inf, -0.0,
    0.0 and each channel's mean (rounded to the dtype) planted."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(b, c, n, generator=gen, device=device) * 2.0).to(dtype)
    flat = x.view(-1)
    rows = torch.randint(0, b * c, (4 * len(SPECIALS),),
                         generator=torch.Generator().manual_seed(seed))
    for i, r in enumerate(rows.tolist()):
        flat[r * n + i % n] = SPECIALS[i % len(SPECIALS)]
    x[:, :, n // 2] = mean.to(dtype)
    return x


def _eps(dtype, device):
    return torch.full((), 1e-3, dtype=dtype, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_bits_equal_the_torch_formula(cuda_device, dtype, relu, shape):
    c, n = shape
    stats = _norm(c, cuda_device, seed=c * 1000 + n)
    x = _activation(B, c, n, dtype, cuda_device, stats[0], seed=c + n)
    with torch.inference_mode():
        want = batch_norm_relu_plain(x, *stats, _eps(dtype, cuda_device),
                                     c if relu else 0)
        got = batch_norm_relu(x, *stats, _eps(dtype, cuda_device),
                              c if relu else 0)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_factors_equal_torch_s_over_variances(cuda_device, dtype):
    """rsqrt and the factors' roundings over 16,384 variances from 1e-12 to
    1e12, below and above epsilon, one channel each, at x = 1 and x = 0,
    in calls of the kernel's most channels."""
    n = 16384
    gen = torch.Generator().manual_seed(11)
    var = torch.exp(torch.empty(n).uniform_(-27.6, 27.6, generator=gen))
    every = [torch.randn(n, generator=gen) * 0.1, var,
             torch.randn(n, generator=gen), torch.randn(n, generator=gen)]
    every = [t.to(cuda_device) for t in every]
    eps = _eps(dtype, cuda_device)
    for lo in range(0, n, MAX_CHANNELS):
        stats = [t[lo:lo + MAX_CHANNELS] for t in every]
        x = torch.zeros(3, len(stats[0]), 2, dtype=dtype, device=cuda_device)
        x[1] = 1.0
        x[2, :, 0] = stats[0].to(dtype)
        with torch.inference_mode():
            want = batch_norm_relu_plain(x, *stats, eps, 0)
            got = batch_norm_relu(x, *stats, eps, 0)
        assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, offset", [
    ((3, 5, 7), 0),      # a tail of n % 8 elements
    ((4, 3, 1), 0),      # rows shorter than a vector
    ((5, 6, 3), 0),
    ((2, 7, 45), 1),     # a base off the 16-byte boundary
    ((4096, 32, 23), 1),
    ((1, 1, 1), 0),
])
def test_kernel_takes_any_length_tail_and_base(cuda_device, dtype, shape,
                                               offset):
    b, c, n = shape
    stats = _norm(c, cuda_device, seed=n)
    x = _activation(b, c, n, dtype, cuda_device, stats[0], seed=b)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda_device)
        buf[offset:].copy_(x.view(-1))
        x = buf[offset:].view(b, c, n)
        assert x.is_contiguous() and x.data_ptr() % 16
    eps = _eps(dtype, cuda_device)
    for relu in (0, c):
        with torch.inference_mode():
            want = batch_norm_relu_plain(x, *stats, eps, relu)
            got = batch_norm_relu(x, *stats, eps, relu)
        assert _same_bits(got, want)


@pytest.mark.cuda
def test_kernel_launches_on_the_current_stream(cuda_device):
    stats = _norm(64, cuda_device, seed=3)
    x = _activation(B, 64, 90, torch.bfloat16, cuda_device, stats[0], seed=4)
    eps = _eps(torch.bfloat16, cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        got = batch_norm_relu(x, *stats, eps, 64)
        want = batch_norm_relu_plain(x, *stats, eps, 64)
        same = torch.equal(got.view(torch.int16), want.view(torch.int16))
    torch.cuda.current_stream().wait_stream(side)
    assert bool(same)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    stats = _norm(8, cuda_device, seed=5)
    eps = _eps(torch.float32, cuda_device)
    x = torch.zeros(2, 8, 5, device=cuda_device)
    with pytest.raises(ValueError, match="runs on cuda"):
        batch_norm_relu(x.cpu(), *stats, eps, 8)
    with pytest.raises(TypeError):
        batch_norm_relu(x.half(), *stats, eps.half(), 8)
    with pytest.raises(ValueError):
        batch_norm_relu(x.transpose(1, 2).contiguous().transpose(1, 2)
                        [:, :, :4], *stats, eps, 8)
    with pytest.raises(ValueError):
        batch_norm_relu(x, *[s.cpu() for s in stats], eps, 8)
    with pytest.raises(ValueError):
        batch_norm_relu(x, *stats, eps.bfloat16(), 8)


# --------------------------------------------------------------------------
# the kernel inside InceptionNet's forward


def _inception(device, seed=0):
    """The published InceptionNet (360 signals, x16, blocks 3/5/3) with
    seeded weights and batch-norm statistics away from zero and one."""
    net = layers.InceptionNet(360)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.uniform_(0.5, 2.0, generator=gen)
            elif leaf in ("bias", "mean"):
                t.normal_(0.0, 0.3, generator=gen)
            else:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=gen)
    return net.to(device)


def _signals(batch, dtype, device, seed, length=360):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 1, length, generator=gen).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4096, 37])
def test_inference_forward_bits_equal_the_autograd_forward(cuda_device,
                                                           dtype, batch):
    """The replayed forward (every batch norm through the kernel) and the
    eager one under ``inference_mode`` (the kernel, no graph) give the bits
    of the forward with autograd on (the torch formula, eager)."""
    net = _inception(cuda_device)
    x = _signals(batch, dtype, cuda_device, 1)
    want = net(x).detach()
    with torch.inference_mode():
        replayed = net(x)
        with mock.patch.object(layers, "graph_takes", lambda *a: False):
            eager = net(x)
    assert _same_bits(replayed, want) and _same_bits(eager, want)


@pytest.mark.cuda
def test_inference_forward_makes_no_synchronising_call(cuda_device):
    """A fresh net's first inference forward (warm-up, capture, replay), a
    replay and an eager kernel forward, under the sync debug mode's
    "error": none synchronises the stream."""
    with torch.inference_mode():   # the process's own first-use syncs
        _inception(cuda_device, seed=1)(
            _signals(64, torch.bfloat16, cuda_device, 2))
    net = _inception(cuda_device, seed=2)
    x = _signals(256, torch.bfloat16, cuda_device, 3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            net(x)
            net(x)
            with mock.patch.object(layers, "graph_takes", lambda *a: False):
                net(x)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _counts(t0):
    return tuple(RECORD.counted(name, t0, time.perf_counter())
                 for name in ("bn.kernel", "bn.plain"))


@pytest.mark.cuda
def test_inception_counts_batch_norms_by_path(cuda_device):
    """Replays count the capture's 69 kernel batch norms (113 less the 44
    that each block's merged 1x1 convs share), once a forward; an eager
    inference forward counts its own; training counts nothing."""
    net = _inception(cuda_device)
    n = len(net._norms) - 4 * sum(net.blocks)
    assert n == 69
    x = _signals(64, torch.bfloat16, cuda_device, 7)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    with torch.no_grad():
        net(x)
    assert _counts(t0) == ([n] * 3, [])
    t0 = time.perf_counter()
    net(x)   # autograd on: eager, the torch formula
    assert _counts(t0) == ([], [n])
    t0 = time.perf_counter()
    with torch.inference_mode(), \
            mock.patch.object(layers, "graph_takes", lambda *a: False):
        net(x)
    assert _counts(t0) == ([n], [])
    t0 = time.perf_counter()
    net(x.float(), train=True).sum().backward()
    with torch.no_grad():
        net(x.float(), train=True)
    assert _counts(t0) == ([], [])


def _kernel_runs(fn) -> int:
    """The batch-norm kernels the profiler sees the card run in ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "bn_relu_kernel" in e.key)


@pytest.mark.cuda
def test_the_card_runs_the_kernel_for_every_batch_norm(cuda_device):
    """Seen where the card runs them: 69 kernels a replayed or eager
    inference forward (each block's five merged 1x1 convs share one), none
    with autograd on or in training."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 8)
    with torch.inference_mode():
        net(x)   # the capture

    def replays():
        with torch.inference_mode():
            net(x)
            net(x)

    def eager():
        with torch.inference_mode(), \
                mock.patch.object(layers, "graph_takes", lambda *a: False):
            net(x)
    assert _kernel_runs(replays) == 2 * 69
    assert _kernel_runs(eager) == 69
    assert _kernel_runs(lambda: net(x)) == 0
    assert _kernel_runs(lambda: net(x.float(), train=True)) == 0
