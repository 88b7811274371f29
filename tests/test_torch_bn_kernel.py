"""Batch norm's rule for the hand-written kernel, and what stays as it was,
on the CPU.

On the card an inference batch norm with autograd off runs
``ops/cuda/bn_relu.py``'s kernel, relu included (``bn_kernel_takes``; the
card's tests in ``test_torch_bn_kernel_cuda.py`` hold it to the torch
formula bit for bit).  Here: the rule itself; the CPU and training paths,
which keep the torch formula with the bits it gave before the kernel and
count nothing; the wrapper's checks; and the counts of a captured forward,
by the rule once a forward and never in the warm-up or the capture, with
the card's graph calls stood in for by host ones.
"""

import contextlib
import time

import pytest
import torch
import torch.nn.functional as F

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.ops.cuda import bn_relu

DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
COUNTS = ("bn.kernel", "bn.plain")


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("contiguous", [True, False])
def test_kernel_takes_contiguous_inference_on_the_card_without_autograd(
        device_type, train, grad_enabled, dtype, contiguous):
    takes = (device_type == "cuda" and not train and not grad_enabled
             and dtype in (torch.float32, torch.bfloat16) and contiguous)
    assert bn_relu.bn_kernel_takes(device_type, train, grad_enabled, dtype,
                                   contiguous) is takes


def _bn_before(bn, x, train, relu):
    """TFBatchNorm and ConvBNRelu's relu as written before the kernel."""
    dt = x.dtype
    if train:
        mean = x.mean(dim=(0, 2))
        var = torch.square(x - mean[:, None]).mean(dim=(0, 2))
        with torch.no_grad():
            bn.mean.copy_(bn._keep * bn.mean + bn._take * mean.float())
            bn.var.copy_(bn._keep * bn.var + bn._take * var.float())
        mean, var = mean[:, None], var[:, None]
    else:
        mean = bn.mean.to(dt)[:, None]
        var = bn.var.to(dt)[:, None]
    inv = torch.rsqrt(var + bn._epsilon(dt, x.device))
    out = (x - mean) * (inv * bn.scale.to(dt)[:, None]) \
        + bn.bias.to(dt)[:, None]
    return F.relu(out) if relu else out


def _bn(seed, channels=48):
    gen = torch.Generator().manual_seed(seed)
    bn = layers.TFBatchNorm(channels)
    with torch.no_grad():
        bn.scale.uniform_(-2.0, 2.0, generator=gen)
        bn.bias.normal_(0.0, 0.3, generator=gen)
        bn.mean.normal_(0.0, 0.3, generator=gen)
        bn.var.uniform_(0.2, 3.0, generator=gen)
    return bn, gen


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("grad", ["enabled", "no_grad"])
def test_cpu_batch_norm_keeps_the_bits_it_had(dtype, train, relu, grad):
    """Output, running statistics and, in training with autograd, every
    gradient bit for bit as before the kernel; and nothing counted."""
    outs, grads, stats = [], [], []
    t0 = time.perf_counter()
    for fn in (lambda bn, x: bn(x, train, 48 if relu else 0),
               lambda bn, x: _bn_before(bn, x, train, relu)):
        bn, gen = _bn(5)
        x = torch.randn(6, 48, 23, generator=gen).to(dtype)
        x[0, 0, :4] = torch.tensor([0.0, -0.0, float("nan"), float("inf")])
        with contextlib.nullcontext() if grad == "enabled" \
                else torch.no_grad():
            xi = x.clone().requires_grad_(grad == "enabled")
            out = fn(bn, xi)
        if train and grad == "enabled":
            out.float().nan_to_num().square().sum().backward()
            grads.append([_bits(t) for t in (xi.grad, bn.scale.grad,
                                             bn.bias.grad)])
        outs.append(_bits(out))
        stats.append([_bits(bn.mean), _bits(bn.var)])
    assert torch.equal(*outs)
    for got, want in zip(*stats):
        assert torch.equal(got, want)
    for got, want in zip(*grads):
        assert torch.equal(got, want)
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
def test_cpu_and_training_forwards_count_no_batch_norm(grad, train):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)
    t0 = time.perf_counter()
    ctx = getattr(torch, grad)() if grad != "enabled" \
        else contextlib.nullcontext()
    with ctx:
        net(x, train)
    assert _counts(t0) == ([], [])


def test_every_batch_norm_of_the_net_is_listed():
    net, _ = _small_net()
    convs = [m for m in net.modules() if isinstance(m, layers.ConvBNRelu)]
    assert len(net._norms) == len(convs) == 3 + 3 * 10
    assert {id(bn) for bn in net._norms} == {id(c.bn) for c in convs}


class _Graph:
    """A CUDA graph's stand-in: a replay runs no Python of the model."""

    replays = 0

    def replay(self):
        _Graph.replays += 1


@pytest.fixture
def host_graphs(monkeypatch):
    """The card's stream and graph calls stood in for by host ones, so that
    ``InceptionNet``'s capture and replay run on the CPU; batch norm takes
    the 'kernel' (its plain version here) where ``takes`` says, and every
    call of the rule is kept in ``takes["calls"]``."""
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
    monkeypatch.setattr(layers, "batch_norm_relu",
                        bn_relu.batch_norm_relu_plain)
    takes = {"rule": lambda *a: True, "calls": []}

    def rule(*a):
        takes["calls"].append(a)
        return takes["rule"](*a)
    monkeypatch.setattr(layers, "bn_kernel_takes", rule)
    return takes


def test_a_replay_counts_its_batch_norms_once_a_forward(host_graphs):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)
    n = len(net._norms)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)   # warm-up and capture count nothing, the replay counts
    assert _counts(t0) == ([n], [])
    assert len(net._graphs) == 1
    # the replays run no batch norm: each forward counts them once
    replays = _Graph.replays
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    assert _Graph.replays == replays + 2
    assert _counts(t0) == ([n, n], [])


@pytest.mark.parametrize("takes", [True, False])
def test_the_counts_follow_the_rule_at_the_forward_s_input(host_graphs,
                                                          takes):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen).to(torch.bfloat16)
    host_graphs["rule"] = lambda *a: takes
    t0 = time.perf_counter()
    with torch.no_grad():
        net(x)
    n = len(net._norms)
    assert _counts(t0) == (([n], []) if takes else ([], [n]))
    # the forward asks once, with its own input's device, dtype and mode
    assert host_graphs["calls"][-1] == ("cpu", False, False, torch.bfloat16,
                                        True)


def test_every_batch_norm_of_a_forward_takes_a_contiguous_input(host_graphs):
    """The forward counts its batch norms as if each took a contiguous
    input: so each does, in the warm-up and in the capture."""
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)[:, :, ::1]
    with torch.inference_mode():
        net(x)
    n = len(net._norms)
    calls = host_graphs["calls"]
    assert len(calls) == 2 * n + 1
    assert all(c == ("cpu", False, False, torch.float32, True) for c in calls)


def test_the_wrapper_runs_on_cuda_only():
    bn, gen = _bn(6)
    x = torch.randn(2, 48, 9, generator=gen)
    with pytest.raises(ValueError, match="runs on cuda"):
        bn_relu.batch_norm_relu(x, bn.mean, bn.var, bn.scale, bn.bias,
                                bn._epsilon(x.dtype, x.device), 48)


def _case(**kw):
    bn, gen = _bn(7)
    args = {"x": torch.randn(2, 48, 9, generator=gen), "mean": bn.mean,
            "var": bn.var, "scale": bn.scale, "bias": bn.bias,
            "eps": bn._epsilon(torch.float32, torch.device("cpu"))}
    args.update(kw)
    return args


@pytest.mark.parametrize("change, error", [
    ({"x": torch.zeros(2, 48, 9, dtype=torch.float16)}, TypeError),
    ({"x": torch.zeros(2, 48)}, ValueError),
    ({"x": torch.zeros(2, 9, 48).transpose(1, 2)}, ValueError),
    ({"x": torch.zeros(1, bn_relu.MAX_CHANNELS + 1, 1),
      "mean": torch.zeros(bn_relu.MAX_CHANNELS + 1)}, ValueError),
    ({"mean": torch.zeros(47)}, ValueError),
    ({"var": torch.ones(48, dtype=torch.float64)}, ValueError),
    ({"scale": torch.ones(96)[::2]}, ValueError),
    ({"eps": torch.full((1,), 1e-3)}, ValueError),
    ({"eps": torch.full((), 1e-3, dtype=torch.bfloat16)}, ValueError),
])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    args = _case(**change)
    with pytest.raises(error):
        bn_relu._check(args["x"], (args["mean"], args["var"], args["scale"],
                                   args["bias"]), args["eps"])


def test_the_wrapper_takes_the_model_s_arguments():
    args = _case()
    bn_relu._check(args["x"], (args["mean"], args["var"], args["scale"],
                               args["bias"]), args["eps"])
