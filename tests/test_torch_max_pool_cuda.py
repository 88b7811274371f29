"""The max-pool kernel (``csrc/max_pool.cu``) against ``max_pool_plain``
(``F.pad`` with -inf, then ``F.max_pool1d``), on the card, bit for bit: equal
NaN positions and every other value's bits.

This file imports neither JAX nor deepsignal_tpu; on a machine with a GPU
run it without the suite's conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_max_pool_cuda.py

Without a GPU every test skips.
"""

import time
from unittest import mock

import pytest
import torch

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda.max_pool import max_pool, max_pool_plain

B = 4096
# (C, L, stride) of the published InceptionNet's 14 max-pools (360 signals,
# x16, blocks 3/5/3): the stem's after its first conv, the later stages'
# heads, and the head of each block's branch 1
POOLS = [(64, 180, 2), (256, 90, 1), *[(240, 90, 1)] * 2, (240, 90, 2),
         *[(240, 45, 1)] * 5, (240, 45, 2), *[(240, 23, 1)] * 3]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepsignal_tpu_torch.core.device import resolve_device
    return resolve_device("cuda")


def _same_bits(got, want):
    """Equal shapes, dtypes and NaN positions, every other value bit for
    bit (a NaN's payload may differ)."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    nan = torch.isnan(got)
    if not torch.equal(nan, torch.isnan(want)):
        return False
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    return torch.equal(got.masked_fill(nan, 0).contiguous().view(bits),
                       want.masked_fill(nan, 0).contiguous().view(bits))


def _activation(b, c, n, dtype, device, seed, specials=True):
    """Normal activations with NaN, +-inf and ties of +0/-0 in both orders
    planted at rows' first, last and middle elements."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(b, c, n, generator=gen, device=device).to(dtype)
    if not specials:
        return x
    flat = x.view(-1, n)
    rows = torch.randint(0, b * c, (12 * len(SPECIALS),),
                         generator=torch.Generator().manual_seed(seed))
    for i, r in enumerate(rows.tolist()):
        flat[r, (0, n - 1, n // 2)[i % 3]] = SPECIALS[i % len(SPECIALS)]
    if n >= 2:
        for r, pair in ((0, (0.0, -0.0)), (1, (-0.0, 0.0))):
            r = r % flat.shape[0]
            flat[r, :2] = torch.tensor(pair)
            flat[-1 - r, -2:] = torch.tensor(pair)
    return x


def _both(x, stride):
    with torch.inference_mode():
        got = max_pool(x, 3, stride)
        want = max_pool_plain(x, 3, stride)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", sorted(set(POOLS)))
def test_kernel_bits_equal_the_plain_pool(cuda_device, dtype, pool):
    c, n, stride = pool
    x = _activation(B, c, n, dtype, cuda_device, seed=c * 1000 + n + stride)
    got, want = _both(x, stride)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_kernel_takes_ties_of_zeros_and_specials_at_every_edge(cuda_device,
                                                                dtype,
                                                                stride):
    """Every pair and triple of (NaN, +-inf, +-0, 1, -1) at a row's start,
    middle and end, one row each, at L = 23 (rows straddle vectors)."""
    vals = SPECIALS + [1.0, -1.0]
    combos = [(a, b, c) for a in vals for b in vals for c in vals]
    n = 23
    x = torch.full((len(combos), 3, n), -5.0)
    for r, (a, b, c) in enumerate(combos):
        for ch, at in enumerate((0, n // 2 - 1, n - 3)):
            x[r, ch, at:at + 3] = torch.tensor([a, b, c])
    got, want = _both(x.to(cuda_device, dtype).contiguous(), stride)
    assert _same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("shape, offset", [
    ((5, 3, 1), 0),       # rows of one element: each is its own max
    ((5, 3, 2), 0),
    ((5, 3, 3), 0),
    ((6, 7, 7), 0),       # a tail of n % 8 elements
    ((1, 1, 7), 0),       # fewer elements than a vector
    ((37, 5, 45), 1),     # a base off the 16-byte boundary
    ((4096, 16, 23), 3),
    ((300, 64, 90), 0),   # more vectors than one wave of the grid holds
])
def test_kernel_takes_any_length_tail_and_base(cuda_device, dtype, stride,
                                               shape, offset):
    b, c, n = shape
    x = _activation(b, c, n, dtype, cuda_device, seed=b + n)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda_device)
        buf[offset:].copy_(x.view(-1))
        x = buf[offset:].view(b, c, n)
        assert x.is_contiguous() and x.data_ptr() % 16
    got, want = _both(x, stride)
    assert _same_bits(got, want)


@pytest.mark.cuda
def test_kernel_launches_on_the_current_stream(cuda_device):
    x = _activation(B, 240, 45, torch.bfloat16, cuda_device, seed=4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.inference_mode(), torch.cuda.stream(side):
        same = [_same_bits(max_pool(x, 3, s), max_pool_plain(x, 3, s))
                for s in (1, 2)]
    torch.cuda.current_stream().wait_stream(side)
    assert same == [True, True]


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(2, 8, 5, device=cuda_device)
    with pytest.raises(ValueError, match="runs on cuda"):
        max_pool(x.cpu(), 3, 1)
    with pytest.raises(TypeError):
        max_pool(x.half(), 3, 1)
    with pytest.raises(ValueError):
        max_pool(x.transpose(1, 2).contiguous().transpose(1, 2), 3, 1)
    with pytest.raises(ValueError):
        max_pool(x, 5, 1)
    with pytest.raises(ValueError):
        max_pool(x, 3, 3)


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


def _signals(batch, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 1, 360, generator=gen).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4096, 37])
def test_inference_forward_bits_equal_the_autograd_forward(cuda_device,
                                                           dtype, batch):
    """The replayed forward and the eager one under ``inference_mode``
    (every pool and batch norm through its kernel) give the bits of the
    forward with autograd on (the plain pool and batch norm, eager)."""
    net = _inception(cuda_device, seed=5)
    x = _signals(batch, dtype, cuda_device, 6)
    want = net(x).detach()
    with torch.inference_mode():
        replayed = net(x)
        with mock.patch.object(layers, "graph_takes", lambda *a: False):
            eager = net(x)
    assert _same_bits(replayed, want) and _same_bits(eager, want)


def _counts(t0):
    return tuple(RECORD.counted(name, t0, time.perf_counter())
                 for name in ("pool.kernel", "pool.plain"))


@pytest.mark.cuda
def test_inception_counts_pools_by_path(cuda_device):
    """Replays count the capture's 14 kernel pools, once a forward; an
    eager inference forward its own; autograd the plain ones; training
    nothing."""
    net = _inception(cuda_device)
    assert len(net._pools) == 14
    x = _signals(64, torch.bfloat16, cuda_device, 7)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    assert _counts(t0) == ([14, 14], [])
    t0 = time.perf_counter()
    net(x)
    assert _counts(t0) == ([], [14])
    t0 = time.perf_counter()
    net(x.float(), train=True).sum().backward()
    assert _counts(t0) == ([], [])


def _runs(fn, name) -> int:
    """The kernels whose name holds ``name`` that the profiler sees the
    card run in ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if name in e.key)


@pytest.mark.cuda
def test_the_card_runs_the_kernel_for_every_pool(cuda_device):
    """Seen where the card runs them: 14 kernels a replay and no ATen pool;
    with autograd on or in training ATen's pool and no kernel."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 8)
    with torch.inference_mode():
        net(x)   # the capture

    def replays():
        with torch.inference_mode():
            net(x)
            net(x)
    assert _runs(replays, "max_pool3_") == 2 * 14
    assert _runs(replays, "max_pool_forward_nchw") == 0
    assert _runs(lambda: net(x), "max_pool3_") == 0
    assert _runs(lambda: net(x), "max_pool_forward_nchw") == 14
    assert _runs(lambda: net(x.float(), train=True), "max_pool3_") == 0
