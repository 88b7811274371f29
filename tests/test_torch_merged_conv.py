"""The merged 1x1 convs of an Inception block, on the CPU.

On the card every inference forward runs each block's five 1x1 convs that
read the block's input as one conv and one batch norm
(``InceptionBlock.merged_1x1``, where ``merge_takes`` holds; the card's
tests in ``test_torch_merged_conv_cuda.py`` hold it to the split convs).
Here: the rule itself; the merged routine called directly on the CPU
against the split convs; ``batch_norm_relu_plain`` with the relu on a
leading block of channels against a loop over the channels; the order of
the stacked weights and statistics; and the counts, which the CPU and
training paths never make and which a captured forward makes once, 11
blocks a forward of the published model, with the card's graph calls stood
in for by host ones.
"""

import contextlib
import time
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda import bn_relu

COUNTS = ("conv.merged", "conv.split")
SPECIALS = [float("nan"), float("inf"), -float("inf"), -0.0, 0.0]


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("train", [False, True])
def test_the_merge_takes_inference_on_the_card(device_type, train):
    assert layers.merge_takes(device_type, train) is (
        device_type == "cuda" and not train)


def _seeded(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith(("scale", "var")):
                t.uniform_(0.5, 2.0, generator=gen)
            else:
                t.normal_(0.0, 0.3, generator=gen)
    return module, gen


def _scaled(a, b) -> float:
    """max |a - b| in float32 steps of max |b| (``test_torch_layer_ulp``'s
    second unit)."""
    a, b = a.detach().double().numpy(), b.detach().double().numpy()
    top = np.float32(np.abs(b).max())
    return float(np.abs(a - b).max() / np.spacing(top)) if top else 0.0


def _same(a, b) -> bool:
    """Equal NaN positions (a NaN's payload follows the CPU's code path),
    every other value bit for bit."""
    nan = torch.isnan(a)
    return a.shape == b.shape and torch.equal(nan, torch.isnan(b)) and \
        torch.equal(a.masked_fill(nan, 0).contiguous().view(torch.uint8),
                    b.masked_fill(nan, 0).contiguous().view(torch.uint8))


@pytest.mark.parametrize("in_ch, times, length", [(24, 2, 11), (30, 2, 23),
                                                  (40, 4, 7)])
@pytest.mark.parametrize("seed", [0, 1])
def test_merged_routine_equals_the_split_convs_within_float32_rounding(
        in_ch, times, length, seed):
    """Each output of the merged routine against its own module's forward:
    a conv of ``in_ch`` products, then batch norm's four roundings, in
    another grouping of the sums at most."""
    block, gen = _seeded(layers.InceptionBlock(in_ch, times), seed)
    x = torch.randn(3, in_ch, length, generator=gen)
    with torch.no_grad():
        merged = block.merged_1x1(x)
        split = [c(x) for c in block.merged_convs()]
    assert len(merged) == len(split) == 5
    for got, want in zip(merged, split):
        assert got.shape == want.shape
        assert _scaled(got, want) <= in_ch + 4


@pytest.mark.parametrize("grad", ["no_grad", "enabled"])
def test_a_merged_block_equals_the_split_block_within_float32_rounding(grad):
    block, gen = _seeded(layers.InceptionBlock(24, 2), 2)
    x = torch.randn(4, 24, 15, generator=gen)
    ctx = torch.no_grad() if grad == "no_grad" else contextlib.nullcontext()
    with ctx:
        want = block(x)
        with mock.patch.object(layers, "merge_takes", lambda *a: True):
            got = block(x)
    assert got.shape == want.shape == (4, 15 * 2, 15)
    # the sums of the 1x1 convs, then the k3/k5 convs of the branches
    assert _scaled(got, want) <= 24 * 5 + 4


def test_the_merged_block_is_differentiable_to_the_five_modules():
    block, gen = _seeded(layers.InceptionBlock(24, 2), 3)
    x = torch.randn(4, 24, 9, generator=gen)
    with mock.patch.object(layers, "merge_takes", lambda *a: True):
        block(x).square().sum().backward()
    for conv in block.merged_convs():
        assert conv.weight.grad is not None
        assert bool(conv.weight.grad.abs().sum() > 0)


def _planted(b, c, n, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, c, n, generator=gen)
    flat = x.view(-1, n)
    for i, r in enumerate(torch.randint(0, b * c, (4 * len(SPECIALS),),
                                        generator=gen).tolist()):
        flat[r, i % n] = SPECIALS[i % len(SPECIALS)]
    return x.to(dtype)


def _norm(c, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(c, generator=gen) * 0.5,
            torch.rand(c, generator=gen) * 2 + 0.1,
            torch.randn(c, generator=gen),
            torch.randn(c, generator=gen) * 0.5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [0, 1, 7, 23, 24])
def test_plain_batch_norm_takes_the_relu_on_leading_channels(dtype, relu):
    """Against each channel alone, with the relu where the channel is among
    the leading ``relu`` (0: none, 24: all); NaN, +-inf and +-0
    included."""
    c = 24
    x = _planted(5, c, 13, dtype, 4)
    mean, var, scale, bias = _norm(c, 5)
    eps = torch.full((), 1e-3, dtype=dtype)
    got = bn_relu.batch_norm_relu_plain(x, mean, var, scale, bias, eps, relu)
    for ch in range(c):
        one = bn_relu.batch_norm_relu_plain(
            x[:, ch:ch + 1], mean[ch:ch + 1], var[ch:ch + 1],
            scale[ch:ch + 1], bias[ch:ch + 1], eps, int(ch < relu))
        assert _same(got[:, ch:ch + 1], one), ch


@pytest.mark.parametrize("relu", [-1, 25, True, False])
def test_the_relu_count_stays_within_the_channels(relu):
    """A count of 0 to C; a bool, which would read as 0 or 1 channel, is
    refused."""
    x = torch.zeros(2, 24, 3)
    with pytest.raises(ValueError, match="0 to 24 channels"):
        bn_relu.batch_norm_relu_plain(x, *_norm(24, 6),
                                      torch.full((), 1e-3), relu)


def test_plain_batch_norm_gives_each_group_its_channels():
    x = _planted(3, 24, 5, torch.float32, 9)
    stats = _norm(24, 10)
    eps = torch.full((), 1e-3)
    whole = bn_relu.batch_norm_relu_plain(x, *stats, eps, 7)
    parts = bn_relu.batch_norm_relu_plain(x, *stats, eps, 7, [5, 12, 7])
    assert [p.shape[1] for p in parts] == [5, 12, 7]
    assert _same(torch.cat(parts, dim=1), whole)


@pytest.mark.parametrize("groups", [[], [24, 1], [0, 24], [23], [3] * 8 + [0],
                                    [1] * 9])
def test_the_kernel_s_groups_cover_the_channels_once(groups):
    with pytest.raises(ValueError, match="groups"):
        bn_relu._group_channels(groups, 24)


def test_the_merged_order_stacks_each_sibling_where_it_returns_it():
    """Each sibling gets a weight and statistics of its own: the merged
    routine returns each sibling's own output, in ``MERGED`` order, the
    relu on the 9t channels before the stem's."""
    t = 2
    block, _ = _seeded(layers.InceptionBlock(6, t), 7)
    assert block.MERGED == ("branch2_conv0b", "branch3_conv0c",
                            "branch4_conv0d", "branch5_conv0e",
                            "branch5_convstem")
    with torch.no_grad():
        for i, conv in enumerate(block.merged_convs()):
            conv.weight.fill_(0.0)
            conv.weight[:, i] = 1.0 + i   # reads input channel i only
            conv.bn.mean.fill_(0.5 * i)
            conv.bn.var.fill_(1.0 + i)
            conv.bn.scale.fill_(2.0 - 0.25 * i)
            conv.bn.bias.fill_(-0.125 * i)
    x = torch.randn(2, 6, 5, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        merged = block.merged_1x1(x)
        split = [c(x) for c in block.merged_convs()]
    assert [m.shape[1] for m in merged] == [3 * t, 2 * t, 2 * t, 2 * t, 3 * t]
    for got, want in zip(merged, split):
        assert torch.equal(got, want)
    # the relu's channels never go below 0; the stem's do
    assert all(bool((m >= 0).all()) for m in merged[:4])
    assert bool((merged[4] < 0).any())


def test_every_batch_norm_of_a_merged_forward_is_listed():
    """Each block's five merged convs are five distinct batch norms of the
    model's list, which a merged forward runs as one: 113 less 4 a block."""
    net = layers.InceptionNet(360)
    blocks = [m for m in net.modules()
              if isinstance(m, layers.InceptionBlock)]
    assert len(blocks) == sum(net.blocks) == 11
    assert len(net._norms) == 113
    merged = [c.bn for b in blocks for c in b.merged_convs()]
    assert len({id(bn) for bn in merged}) == 5 * 11
    assert {id(bn) for bn in merged} <= {id(bn) for bn in net._norms}
    assert len(net._norms) - len(merged) + len(blocks) == 69


def _counts(t0):
    return tuple(RECORD.counted(name, t0, time.perf_counter())
                 for name in COUNTS)


@pytest.mark.parametrize("grad", ["inference_mode", "no_grad", "enabled"])
@pytest.mark.parametrize("train", [False, True])
def test_cpu_and_training_forwards_count_no_conv(grad, train):
    net, gen = _seeded(layers.InceptionNet(60, times=2, blocks=(1, 1, 1)), 0)
    x = torch.randn(5, 1, 60, generator=gen)
    t0 = time.perf_counter()
    ctx = getattr(torch, grad)() if grad != "enabled" \
        else contextlib.nullcontext()
    with ctx:
        net(x, train)
    assert _counts(t0) == ([], [])


class _Graph:
    """A CUDA graph's stand-in: a replay runs no Python of the model."""

    def replay(self):
        pass


@pytest.fixture
def host_graphs(monkeypatch):
    """The card's stream and graph calls stood in for by host ones, so that
    ``InceptionNet``'s capture and replay run on the CPU; the blocks merge
    where ``takes["rule"]`` says."""
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
    takes = {"rule": lambda *a: True}
    monkeypatch.setattr(layers, "merge_takes",
                        lambda *a: takes["rule"](*a))
    return takes


@pytest.mark.parametrize("takes", [True, False])
def test_a_forward_counts_the_published_model_s_11_blocks_by_the_rule(
        host_graphs, takes):
    """Warm-up and capture count nothing, each replay 11 blocks, by the
    path the rule gives, and the batch norms as that path runs them."""
    host_graphs["rule"] = lambda *a: takes
    net, gen = _seeded(layers.InceptionNet(60, times=2), 1)
    x = torch.randn(3, 1, 60, generator=gen)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    merged, split = _counts(t0)
    assert (merged, split) == (([11, 11], []) if takes else ([], [11, 11]))
    norms = 69 if takes else 113
    assert RECORD.counted("bn.plain", t0, time.perf_counter()) \
        == [norms, norms]


@pytest.mark.parametrize("takes, convs", [(True, 69), (False, 113)])
def test_a_merged_forward_makes_69_convs(host_graphs, takes, convs):
    host_graphs["rule"] = lambda *a: takes
    net, gen = _seeded(layers.InceptionNet(60, times=2), 2)
    x = torch.randn(3, 1, 60, generator=gen)
    calls, real = [], F.conv1d

    def conv1d(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)
    with mock.patch.object(layers.F, "conv1d", conv1d), torch.no_grad():
        net._eager(x, False)
    assert len(calls) == convs
    assert sum(w[0] == 12 * 2 for w in calls) == (11 if takes else 0)


@pytest.mark.parametrize("takes, norms", [(True, 69), (False, 113)])
def test_a_merged_forward_runs_the_batch_norms_it_counts(host_graphs, takes,
                                                         norms):
    """The batch norms an eager forward runs are those ``InceptionNet``
    counts: 113 less 4 a block where the blocks merge."""
    host_graphs["rule"] = lambda *a: takes
    net, gen = _seeded(layers.InceptionNet(60, times=2), 3)
    x = torch.randn(3, 1, 60, generator=gen)
    calls, real = [], bn_relu.batch_norm_relu_plain

    def plain(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)
    with mock.patch.object(layers, "batch_norm_relu_plain", plain), \
            torch.no_grad():
        net._eager(x, False)
    assert len(calls) == norms \
        == len(net._norms) - (4 * sum(net.blocks) if takes else 0)
    assert calls.count(12 * 2) == (11 if takes else 0)
