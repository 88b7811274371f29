"""The max-pool's rule for the hand-written kernel, and what stays as it was,
on the CPU.

On the card an inference max-pool with autograd off runs
``ops/cuda/max_pool.py``'s kernel (``pool_kernel_takes``; the card's tests
in ``test_torch_max_pool_cuda.py`` hold it to ``max_pool_plain`` bit for
bit).  Here: the rule itself; ``max_pool_plain`` against a SAME max-pool
written out as a scan over each window with an explicit -inf pad; the CPU
and training paths, which keep the bits and gradients they had and count
nothing; the wrapper's checks; and the counts of a captured forward, 14 a
forward of the published model by the rule, with the card's graph calls
stood in for by host ones.
"""

import contextlib
import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda import max_pool as mp

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
COUNTS = ("pool.kernel", "pool.plain")
# (C, L, stride) of the published InceptionNet's 14 max-pools (360 signals,
# x16, blocks 3/5/3): the stem's after its first conv, the later stages'
# heads, and the head of each block's branch 1
POOLS = [(64, 180, 2), (256, 90, 1), *[(240, 90, 1)] * 2, (240, 90, 2),
         *[(240, 45, 1)] * 5, (240, 45, 2), *[(240, 23, 1)] * 3]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0]


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("contiguous", [True, False])
def test_kernel_takes_contiguous_inference_on_the_card_without_autograd(
        device_type, train, grad_enabled, dtype, contiguous):
    takes = (device_type == "cuda" and not train and not grad_enabled
             and dtype in (torch.float32, torch.bfloat16) and contiguous)
    assert mp.pool_kernel_takes(device_type, train, grad_enabled, dtype,
                                contiguous) is takes


def _scan_pool(x: np.ndarray, window: int, stride: int) -> np.ndarray:
    """TF's SAME max-pool over the last axis of a float64 [B, C, L] array,
    written out: each window scanned left to right from -inf, the pad's
    positions -inf, a value taken where it is greater than the max so far
    or NaN."""
    length = x.shape[-1]
    out_len = -(-length // stride)
    pad = max((out_len - 1) * stride + window - length, 0)
    left = pad // 2
    out = np.empty(x.shape[:-1] + (out_len,))
    for o in range(out_len):
        m = np.full(x.shape[:-1], -np.inf)
        for k in range(window):
            i = o * stride - left + k
            v = x[..., i] if 0 <= i < length else np.full_like(m, -np.inf)
            m = np.where((v > m) | np.isnan(v), v, m)
        out[..., o] = m
    return out


def _planted(b, c, n, dtype, seed):
    """Normal values with NaN, +-inf and ties of +0/-0 in both orders planted
    at rows' edges and inside them."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, n, generator=gen)
    flat = x.view(-1, n)
    rows = torch.randint(0, b * c, (6 * len(SPECIALS),), generator=gen)
    for i, r in enumerate(rows.tolist()):
        at = (0, n - 1, n // 2)[i % 3]
        flat[r, at] = SPECIALS[i % len(SPECIALS)]
    if n >= 2:
        flat[0, :2] = torch.tensor([0.0, -0.0])
        flat[-1, -2:] = torch.tensor([-0.0, 0.0])
        flat[1 % flat.shape[0], -2:] = torch.tensor([0.0, -0.0])
    return x.to(dtype)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal NaN positions, and every other value bit for bit."""
    nan = torch.isnan(got)
    if got.shape != want.shape or not torch.equal(nan, torch.isnan(want)):
        return False
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    return torch.equal(got.masked_fill(nan, 0).view(bits),
                       want.masked_fill(nan, 0).view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", sorted(set(POOLS)))
def test_plain_pool_equals_the_written_out_scan_at_inception_s_shapes(
        dtype, pool):
    c, n, stride = pool
    x = _planted(3, c, n, dtype, seed=c + n + stride)
    want = torch.from_numpy(_scan_pool(x.double().numpy(), 3, stride))
    got = mp.max_pool_plain(x, 3, stride)
    assert got.dtype == dtype
    assert _same_bits(got.double(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("length", [1, 2, 3, 4, 5, 7, 8, 9, 23, 45, 181])
def test_plain_pool_equals_the_written_out_scan_at_odd_lengths(
        dtype, stride, length):
    x = _planted(4, 5, length, dtype, seed=length * 10 + stride)
    want = torch.from_numpy(_scan_pool(x.double().numpy(), 3, stride))
    assert _same_bits(mp.max_pool_plain(x, 3, stride).double(), want)


def test_the_pool_keeps_the_first_of_equal_zeros():
    x = torch.tensor([[[0.0, -0.0, 5.0, -0.0, 0.0]]])
    got = mp.max_pool_plain(x, 3, 1)[0, 0].tolist()
    # windows [pad, 0, -0] and [-0, 0, pad]: the first zero of each
    assert got == [0.0, 5.0, 5.0, 5.0, 0.0]
    assert [math.copysign(1.0, got[i]) for i in (0, 4)] == [1.0, -1.0]


def _pool_before(x, window, stride):
    """``max_pool_same`` as written before the kernel."""
    pads = layers.tf_same_pads(x.shape[-1], window, stride)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    return F.max_pool1d(x, window, stride)


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("grad", ["enabled", "no_grad", "inference_mode"])
def test_cpu_pool_keeps_the_bits_and_gradients_it_had(dtype, train, stride,
                                                      grad):
    outs, grads = [], []
    t0 = time.perf_counter()
    for fn in (lambda x: layers.max_pool_same(x, 3, stride, train),
               lambda x: _pool_before(x, 3, stride)):
        x = _planted(3, 6, 23, dtype, seed=stride)
        ctx = getattr(torch, grad)() if grad != "enabled" \
            else contextlib.nullcontext()
        with ctx:
            xi = x.clone().requires_grad_(grad == "enabled")
            out = fn(xi)
        if grad == "enabled":
            out.float().nan_to_num().square().sum().backward()
            grads.append(_bits(xi.grad))
        outs.append(_bits(out))
    assert torch.equal(*outs)
    if grads:
        assert torch.equal(*grads)
    for name in COUNTS:
        assert RECORD.counted(name, t0, time.perf_counter()) == []


def _small_net(seed=0):
    net = layers.InceptionNet(60, times=2, blocks=(1, 1, 1))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict(keep_vars=True).items():
            if name.endswith(("scale", "var")):
                t.uniform_(0.5, 2.0, generator=gen)
            else:
                t.normal_(0.0, 0.3, generator=gen)
    return net, gen


def _counts(t0):
    return tuple(RECORD.counted(name, t0, time.perf_counter())
                 for name in COUNTS)


@pytest.mark.parametrize("grad", ["inference_mode", "no_grad", "enabled"])
@pytest.mark.parametrize("train", [False, True])
def test_cpu_and_training_forwards_count_no_pool(grad, train):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)
    t0 = time.perf_counter()
    ctx = getattr(torch, grad)() if grad != "enabled" \
        else contextlib.nullcontext()
    with ctx:
        net(x, train)
    assert _counts(t0) == ([], [])


def test_the_pool_list_holds_the_published_model_s_14():
    net = layers.InceptionNet(360)
    assert len(net._pools) == 14
    assert sorted(net._pools) == sorted((3, s) for _, _, s in POOLS)


class _Graph:
    """A CUDA graph's stand-in: a replay runs no Python of the model."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


@pytest.fixture
def host_graphs(monkeypatch):
    """The card's stream and graph calls stood in for by host ones, so that
    ``InceptionNet``'s capture and replay run on the CPU; a pool takes the
    'kernel' (its plain version here, kept in ``takes["pools"]``) where
    ``takes`` says, and every call of the rule is kept in
    ``takes["calls"]``."""
    class _Stream:
        def wait_stream(self, other):
            pass

    null = contextlib.nullcontext
    for name, value in (("device", lambda d: null()),
                        ("Stream", _Stream), ("current_stream", _Stream),
                        ("stream", lambda s: null()), ("CUDAGraph", _Graph),
                        ("graph", lambda g, **kw: null())):
        monkeypatch.setattr(torch.cuda, name, value)
    monkeypatch.setattr(layers, "graph_takes",
                        lambda device_type, train, grad: not (train or grad))
    takes = {"rule": lambda *a: True, "calls": [], "pools": []}

    def kernel(x, window, stride):
        takes["pools"].append((tuple(x.shape), window, stride))
        return mp.max_pool_plain(x, window, stride)

    def rule(*a):
        takes["calls"].append(a)
        return takes["rule"](*a)
    monkeypatch.setattr(layers, "max_pool", kernel)
    monkeypatch.setattr(layers, "pool_kernel_takes", rule)
    return takes


def test_a_replay_counts_the_published_model_s_14_pools_once_a_forward(
        host_graphs):
    net = layers.InceptionNet(360)
    x = torch.randn(2, 1, 360, generator=torch.Generator().manual_seed(3))
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)   # warm-up and capture count nothing, the replay counts
    assert _counts(t0) == ([14], [])
    # the warm-up and the capture each ran the 14 pools through the kernel
    assert sorted((s[1], s[2], stride)
                  for s, _, stride in host_graphs["pools"]) \
        == sorted(POOLS * 2)
    replays = _Graph.replays
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    assert _Graph.replays == replays + 2
    assert _counts(t0) == ([14, 14], [])
    assert len(host_graphs["pools"]) == 2 * 14


@pytest.mark.parametrize("takes", [True, False])
def test_the_counts_follow_the_rule_at_the_forward_s_input(host_graphs,
                                                          takes):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen).to(torch.bfloat16)
    host_graphs["rule"] = lambda *a: takes
    t0 = time.perf_counter()
    with torch.no_grad():
        net(x)
    n = len(net._pools)
    assert n == 3 + 3
    assert _counts(t0) == (([n], []) if takes else ([], [n]))
    # the forward asks once, with its own input's device, dtype and mode
    assert host_graphs["calls"][-1] == ("cpu", False, False, torch.bfloat16,
                                        True)


def test_every_pool_of_a_forward_takes_a_contiguous_input(host_graphs):
    """The forward counts its pools as if each took a contiguous input: so
    each does, in the warm-up and in the capture."""
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)[:, :, ::1]
    with torch.inference_mode():
        net(x)
    n = len(net._pools)
    calls = host_graphs["calls"]
    assert len(calls) == 2 * n + 1
    assert all(c == ("cpu", False, False, torch.float32, True) for c in calls)


def test_the_wrapper_runs_on_cuda_only():
    with pytest.raises(ValueError, match="runs on cuda"):
        mp.max_pool(torch.zeros(2, 3, 9), 3, 1)


@pytest.mark.parametrize("x, window, stride, error", [
    (torch.zeros(2, 4, 9, dtype=torch.float16), 3, 1, TypeError),
    (torch.zeros(2, 4, 9, dtype=torch.float64), 3, 2, TypeError),
    (torch.zeros(2, 9), 3, 1, ValueError),
    (torch.zeros(2, 4, 9, 1), 3, 1, ValueError),
    (torch.zeros(2, 9, 4).transpose(1, 2), 3, 1, ValueError),
    (torch.zeros(2, 4, 18)[:, :, ::2], 3, 2, ValueError),
    (torch.zeros(2, 4, 9), 5, 1, ValueError),
    (torch.zeros(2, 4, 9), 3, 3, ValueError),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(x, window, stride,
                                                           error):
    with pytest.raises(error):
        mp._check(x, window, stride)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stride", [1, 2])
def test_the_wrapper_takes_the_model_s_arguments(dtype, stride):
    mp._check(torch.zeros(2, 4, 9, dtype=dtype), 3, stride)
