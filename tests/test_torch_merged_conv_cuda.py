"""The merged 1x1 convs of an Inception block (``InceptionBlock.merged_1x1``)
against the five split convs, on the card, and the batch-norm kernel's relu
on a leading block of channels against the torch formula, bit for bit.

This file imports neither JAX nor deepsignal_tpu; on a machine with a GPU
run it without the suite's conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_merged_conv_cuda.py

Without a GPU every test skips.
"""

import time
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda.bn_relu import (batch_norm_relu,
                                                   batch_norm_relu_plain)

B = 4096
# (C, L) of the published InceptionNet's block inputs (360 signals, x16,
# blocks 3/5/3): the first block's, then each stage's
BLOCKS = [(256, 90), (240, 90), (240, 45), (240, 23)]
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepsignal_tpu_torch.core.device import resolve_device
    return resolve_device("cuda")   # TF32 off, as the port runs


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _seeded(module, device, seed):
    """Seeded weights at a conv's He scale, batch-norm statistics away from
    zero and one."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.uniform_(0.5, 2.0, generator=gen)
            elif leaf in ("bias", "mean"):
                t.normal_(0.0, 0.3, generator=gen)
            else:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=gen)
    return module.to(device)


def _input(b, c, n, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, c, n, generator=gen, device=device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BLOCKS)
def test_merged_convs_equal_the_split_convs_bit_for_bit(cuda_device, dtype,
                                                        shape):
    """At B=4,096 cuDNN sums the merged conv's channels as it sums the
    split ones (an H100, bf16 and f32 with TF32 off), so each output,
    batch norm and relu included, and the block's output are the split
    path's bits."""
    c, n = shape
    block = _seeded(layers.InceptionBlock(c, 16), cuda_device, c + n)
    x = _input(B, c, n, dtype, cuda_device, n)
    with torch.inference_mode():
        merged = block.merged_1x1(x)
        split = [conv(x) for conv in block.merged_convs()]
        got = block(x)
        with mock.patch.object(layers, "merge_takes", lambda *a: False):
            want = block(x)
    assert [m.shape[1] for m in merged] == [48, 32, 32, 32, 48]
    for a, b in zip(merged, split):
        assert _same_bits(a, b)
    assert _same_bits(got, want)


def _norm(c, device, seed):
    gen = torch.Generator().manual_seed(seed)
    mean = torch.randn(c, generator=gen) * 0.7
    var = torch.rand(c, generator=gen) * 3.0 + 0.05
    scale = (torch.rand(c, generator=gen) * 2.5 + 0.25) \
        * torch.where(torch.rand(c, generator=gen) < 0.5, -1.0, 1.0)
    bias = torch.randn(c, generator=gen) * 0.5
    return [t.to(device) for t in (mean, var, scale, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [0, 144, 192])
@pytest.mark.parametrize("length", [90, 45, 23])
def test_kernel_relu_on_leading_channels_equals_the_torch_formula(
        cuda_device, dtype, relu, length):
    c = 192
    stats = _norm(c, cuda_device, seed=relu + length)
    x = _input(B, c, length, dtype, cuda_device, length) * 2.0
    flat = x.view(-1)
    at = torch.randint(0, flat.numel(), (8 * len(SPECIALS),),
                       generator=torch.Generator().manual_seed(relu))
    for i, k in enumerate(at.tolist()):
        flat[k] = SPECIALS[i % len(SPECIALS)]
    x[:, :, length // 2] = stats[0].to(dtype)   # exact zeros after centring
    eps = torch.full((), 1e-3, dtype=dtype, device=cuda_device)
    with torch.inference_mode():
        want = batch_norm_relu_plain(x, *stats, eps, relu)
        got = batch_norm_relu(x, *stats, eps, relu)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any())
    if 0 < relu < c:
        assert bool((got[:, relu:] < 0).any())
        assert not bool((got[:, :relu] < 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("groups, length, offset", [
    ((48, 32, 32, 32, 48), 90, 0),   # the merged convs': whole vectors
    ((48, 32, 32, 32, 48), 23, 0),
    ((48, 32, 32, 32, 48), 45, 1),   # a base off 16 bytes: one at a time
    ((3, 189), 23, 0),               # a group's start inside a vector
    ((1, 190, 1), 7, 0),
    ((192,), 45, 0),
])
def test_kernel_groups_equal_the_torch_formula_s_slices(
        cuda_device, dtype, groups, length, offset):
    """Each group's own contiguous output holds the channels the torch
    formula's slice holds, bit for bit, on both of the kernel's paths."""
    c, b = 192, 37
    stats = _norm(c, cuda_device, seed=length)
    x = _input(b, c, length, dtype, cuda_device, len(groups)) * 2.0
    x.view(-1)[:len(SPECIALS)] = torch.tensor(SPECIALS)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype,
                          device=cuda_device)
        buf[offset:].copy_(x.view(-1))
        x = buf[offset:].view(b, c, length)
    eps = torch.full((), 1e-3, dtype=dtype, device=cuda_device)
    with torch.inference_mode():
        want = batch_norm_relu_plain(x, *stats, eps, 144, groups)
        got = batch_norm_relu(x, *stats, eps, 144, groups)
    assert len(got) == len(want) == len(groups)
    for g, a, w in zip(groups, got, want):
        assert a.is_contiguous() and a.shape == (b, g, length)
        assert _same_bits(a, w.contiguous())


def _inception(device, seed=0):
    return _seeded(layers.InceptionNet(360), device, seed)


def _signals(batch, dtype, device, seed, length=360):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 1, length, generator=gen).to(device, dtype)


@pytest.mark.cuda
def test_a_replay_sees_siblings_changed_in_place(cuda_device):
    """An in-place change to a merged sibling's weight or running variance
    shows at the next replay, with no new capture: the stacking is inside
    the graph."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 4)
    with torch.inference_mode():
        before = net(x)
    with torch.no_grad():
        net.incp_layer3.branch5_convstem.weight.mul_(1.5)
    with torch.inference_mode():
        got = net(x)
        want = net._eager(x, False)
    assert len(net._graphs) == 1
    assert _same_bits(got, want) and not torch.equal(got, before)
    with torch.no_grad():
        net.incp_layer7.branch3_conv0c.bn.var.mul_(3.0)
    with torch.inference_mode():
        again = net(x)
        want = net._eager(x, False)
    assert len(net._graphs) == 1
    assert _same_bits(again, want) and not torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4096, 37])
def test_the_replayed_forward_equals_the_autograd_forward(cuda_device, dtype,
                                                          batch):
    """Both merge (the card, ``train`` false): the replay through the
    kernel and the forward with autograd on through the torch formula give
    the same bits, and so does the split forward."""
    net = _inception(cuda_device, seed=1)
    x = _signals(batch, dtype, cuda_device, 2)
    want = net(x).detach()
    with torch.inference_mode():
        got = net(x)
        with mock.patch.object(layers, "merge_takes", lambda *a: False):
            net._graphs.clear()
            split = net(x)
    assert _same_bits(got, want) and _same_bits(split, want)


def _conv_calls(fn) -> int:
    calls, real = [], F.conv1d

    def conv1d(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)
    with mock.patch.object(layers.F, "conv1d", conv1d):
        fn()
    return len(calls)


def _kernel_runs(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if "bn_relu_kernel" in e.key)


@pytest.mark.cuda
def test_a_forward_makes_69_convs_and_69_batch_norm_kernels(cuda_device):
    net = _inception(cuda_device, seed=3)
    x = _signals(64, torch.bfloat16, cuda_device, 5)

    def eager():
        with torch.inference_mode(), \
                mock.patch.object(layers, "graph_takes", lambda *a: False):
            net(x)

    def replay():
        with torch.inference_mode():
            net(x)
    assert _conv_calls(eager) == 69
    # training splits the convs: its first forward runs the eager training
    # forward twice (the graphs' warm-up and capture), a replay none
    assert _conv_calls(lambda: net(x, train=True)) == 2 * 113
    assert _conv_calls(lambda: net(x, train=True)) == 0
    replay()   # the capture
    assert _kernel_runs(replay) == 69
    assert _kernel_runs(eager) == 69


def _counts(t0):
    return tuple(RECORD.counted(name, t0, time.perf_counter())
                 for name in ("conv.merged", "conv.split"))


@pytest.mark.cuda
def test_inference_forwards_count_11_merged_blocks(cuda_device):
    """Replays, eager inference forwards and forwards with autograd on
    count 11 merged blocks each; training counts nothing."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 7)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
        with mock.patch.object(layers, "graph_takes", lambda *a: False):
            net(x)
    net(x)
    assert _counts(t0) == ([11] * 4, [])
    t0 = time.perf_counter()
    net(x.float(), train=True).sum().backward()
    assert _counts(t0) == ([], [])
