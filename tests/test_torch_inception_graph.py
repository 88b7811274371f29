"""InceptionNet's rule for replaying a CUDA graph, and batch norm's
epsilon, on the CPU.

On the card an inference forward with autograd off replays a CUDA graph
(``layers.graph_takes``; the card's tests in ``test_torch_cuda.py`` hold the
replay to the eager forward bit for bit).  Here: the rule itself, the CPU's
eager path, which counts nothing, and batch norm's epsilon, made by a fill
on the device instead of a blocking copy from the host, which must give
the bits of the formula it replaced.
"""

import time

import pytest
import torch

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
def test_graph_takes_inference_on_the_card_without_autograd(
        device_type, train, grad_enabled):
    takes = device_type == "cuda" and not train and not grad_enabled
    assert layers.graph_takes(device_type, train, grad_enabled) is takes


def _bn_before(bn, x, train):
    """TFBatchNorm's output as computed before the epsilon was cached:
    ``var.new_tensor(eps)``, a 0-d tensor of the input dtype built from the
    Python float, added to the variance."""
    dt = x.dtype
    if train:
        mean = x.mean(dim=(0, 2))
        var = torch.square(x - mean[:, None]).mean(dim=(0, 2))
        mean, var = mean[:, None], var[:, None]
    else:
        mean = bn.mean.to(dt)[:, None]
        var = bn.var.to(dt)[:, None]
    inv = torch.rsqrt(var + var.new_tensor(bn.epsilon))
    return (x - mean) * (inv * bn.scale.to(dt)[:, None]) \
        + bn.bias.to(dt)[:, None]


def _bn(seed, channels=512):
    gen = torch.Generator().manual_seed(seed)
    bn = layers.TFBatchNorm(channels)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 2.0, generator=gen)
        bn.bias.normal_(0.0, 0.3, generator=gen)
        bn.mean.normal_(0.0, 0.3, generator=gen)
        # variances below epsilon, where its rounding to the dtype shows
        bn.var.uniform_(0.0, 1e-4, generator=gen)
    return bn, gen


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_bits_equal_the_new_tensor_formula(dtype, train):
    """Output, and in training every gradient, bit for bit as with
    ``var.new_tensor(eps)``."""
    bn, gen = _bn(3)
    x = (torch.randn(16, 512, 9, generator=gen) * 0.01).to(dtype)
    outs, grads = [], []
    for fn in (lambda x: bn(x, train), lambda x: _bn_before(bn, x, train)):
        xi = x.clone().requires_grad_(train)
        out = fn(xi)
        outs.append(out)
        if train:
            bn.zero_grad()
            out.float().square().sum().backward()
            grads.append([_bits(t) for t in (xi.grad, bn.scale.grad,
                                             bn.bias.grad)])
    assert outs[0].dtype == dtype
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))
    if train:
        for got, want in zip(*grads):
            assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_batch_norm_epsilon_is_made_once_per_dtype_and_device(dtype):
    bn, _ = _bn(4)
    eps = bn._epsilon(dtype, torch.device("cpu"))
    assert bn._epsilon(dtype, torch.device("cpu")) is eps
    assert eps.shape == () and eps.dtype == dtype
    assert torch.equal(_bits(eps),
                       _bits(torch.zeros((), dtype=dtype).new_tensor(1e-3)))


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


def test_graph_key_holds_every_parameter_and_buffer():
    net, _ = _small_net()
    tensors = [*net.parameters(), *net.buffers()]
    assert sorted(table[name].data_ptr() for table, name in net._slots) \
        == sorted(t.data_ptr() for t in tensors)


@pytest.mark.parametrize("grad", ["inference_mode", "no_grad"])
def test_cpu_inference_runs_eagerly_and_counts_nothing(grad):
    net, gen = _small_net()
    x = torch.randn(5, 1, 60, generator=gen)
    t0 = time.perf_counter()
    with getattr(torch, grad)():
        got = net(x)
        want = net._eager(x, False)
    t1 = time.perf_counter()
    assert torch.equal(_bits(got), _bits(want))
    assert got.shape == (5, net.out_dim)
    assert net._graphs == {}
    for name in ("inception.graph_replay", "inception.eager"):
        assert RECORD.counted(name, t0, t1) == []
