"""InceptionNet's training graphs (``layers.train_graph_takes``,
``layers._TrainReplay``) on the CPU.

On the card a training forward with autograd on, on no mesh or a mesh of
one data rank, replays a CUDA graph of the eager training forward and its
backward a graph of that forward's backward (the card's tests in
``test_torch_inception_train_graph_cuda.py`` hold them to the eager step).
Here: the rule itself; the CPU's training forward, which stays eager,
counts nothing and keeps its bits; and the replay's autograd plumbing, with
host stand-ins for the captured graphs (``host_train_graphs``): each
stand-in replay runs the eager pass it stands for, so every output,
gradient and running statistic must equal an eager twin's bit for bit.
"""

import copy
import time

import pytest
import torch

from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.parallel.mesh import Mesh

NAMES = ("inception.train_graph_replay", "inception.train_eager")
MESHES = {"none": None, "data1": Mesh(data=1, model=1),
          "data1_model2": Mesh(data=1, model=2),
          "data2": Mesh(data=2, model=1)}


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("grad_enabled", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_train_graph_takes_training_with_autograd_on_one_data_rank(
        device_type, train, grad_enabled, mesh):
    m = MESHES[mesh]
    takes = (device_type == "cuda" and train and grad_enabled
             and (m is None or m.data == 1))
    assert layers.train_graph_takes(device_type, train, grad_enabled, m) \
        is takes


def _net(seed=0, signal_len=60):
    net = layers.InceptionNet(signal_len, times=2, blocks=(1, 1, 1))
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict(keep_vars=True).items():
            if name.endswith(("scale", "var")):
                t.uniform_(0.5, 2.0, generator=gen)
            else:
                t.normal_(0.0, 0.3, generator=gen)
    return net


def _x(b=6, signal_len=60, seed=1, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(b, 1, signal_len, generator=gen).to(dtype)


def _bits(t):
    return t.detach().reshape(-1).contiguous().view(torch.uint8)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        torch.equal(_bits(a), _bits(b))


def _assert_same_state(net, twin):
    """Every parameter, gradient and running statistic bit for bit."""
    for (name, a), b in zip(net.named_parameters(), twin.parameters()):
        assert _same(a, b), name
        assert (a.grad is None) == (b.grad is None), name
        if a.grad is not None:
            assert _same(a.grad, b.grad), name
    for (name, a), b in zip(net.named_buffers(), twin.buffers()):
        assert _same(a, b), name


def _loss(out):
    """A loss whose gradient differs over the output's elements."""
    w = torch.linspace(-1.0, 1.0, out.shape[1], dtype=torch.float32)
    return (out.float().square() * w).sum()


def _counted(t0):
    return {name: sum(RECORD.counted(name, t0, time.perf_counter()))
            for name in NAMES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("grad", [True, False])
def test_cpu_training_runs_eagerly_counts_nothing_and_keeps_its_bits(
        dtype, grad):
    """The CPU's training forward (and backward, with autograd on) is the
    eager one: the same output, gradients and running statistics as
    ``_eager`` on a twin, no graph kept, neither count."""
    net = _net()
    twin = copy.deepcopy(net)
    x = _x(dtype=dtype)
    t0 = time.perf_counter()
    with torch.set_grad_enabled(grad):
        got = net(x, True)
        want = twin._eager(x, True)
    if grad:
        _loss(got).backward()
        _loss(want).backward()
    assert _same(got, want)
    _assert_same_state(net, twin)
    assert net._train_graphs == {} and net._graphs == {}
    assert _counted(t0) == {name: 0 for name in NAMES}


class _HostGraph:
    """A stand-in for a captured CUDA graph: ``replay`` runs ``run``."""

    def __init__(self, run):
        self.replay = run


def _host_capture(net, x, params, takes_grad):
    """``_TrainGraphs`` as ``InceptionNet._capture_train`` builds them,
    with host stand-ins for the two graphs: the forward's runs the eager
    training forward on the static input (moving the running statistics
    once), the backward's recomputes it with autograd and takes its
    gradients (leaving the running statistics as it found them)."""
    static_x = x.clone()
    wanted = [p for p, takes in zip(params, takes_grad) if takes]
    out = torch.empty(x.shape[0], net.out_dim, dtype=x.dtype)
    grad_out = torch.empty_like(out)
    flat = torch.empty(sum(p.numel() for p in wanted))
    running = [t for m in net._norms for t in (m.mean, m.var)]
    net.host_captures = getattr(net, "host_captures", 0) + 1

    def forward():
        with torch.no_grad():
            out.copy_(net._eager(static_x, True))

    def backward():
        saved = [t.clone() for t in running]
        with torch.enable_grad():
            grads = torch.autograd.grad(net._eager(static_x, True), wanted,
                                        grad_out)
        with torch.no_grad():
            for t, s in zip(running, saved):
                t.copy_(s)
            flat.copy_(torch.cat([g.reshape(-1) for g in grads]))

    return layers._TrainGraphs(_HostGraph(forward), _HostGraph(backward),
                               static_x, out, grad_out, flat, wanted,
                               takes_grad)


@pytest.fixture
def host_train_graphs(monkeypatch):
    """The training graphs' path on the CPU: the rule holds everywhere and
    the captures are host stand-ins (``_host_capture``)."""
    monkeypatch.setattr(layers, "train_graph_takes", lambda *a: True)
    monkeypatch.setattr(layers.InceptionNet, "_capture_train",
                        _host_capture)


def _step(net, x, lr=0.05):
    """One training forward and backward, then a plain update in place."""
    out = net(x, True)
    _loss(out).backward()
    with torch.no_grad():
        for p in net.parameters():
            p.sub_(lr * p.grad)
    return out


def test_replayed_steps_equal_eager_steps_bit_for_bit(host_train_graphs):
    """Three steps, each updating the parameters in place: one capture,
    one replay counted a step, and the output, gradients, parameters and
    running statistics of the eager steps, the capture's step included."""
    net = _net()
    twin = copy.deepcopy(net)
    for step in range(3):
        x = _x(seed=10 + step)
        t0 = time.perf_counter()
        got = _step(net, x)
        assert _counted(t0) == {"inception.train_graph_replay": 1,
                                "inception.train_eager": 0}
        with torch.no_grad():
            for p in twin.parameters():
                p.grad = None
        want = twin._eager(x, True)
        _loss(want).backward()
        with torch.no_grad():
            for p in twin.parameters():
                p.sub_(0.05 * p.grad)
        assert _same(got, want), step
        _assert_same_state(net, twin)
        for p in net.parameters():
            p.grad = None
    assert net.host_captures == 1 and len(net._train_graphs) == 1


def test_gradients_accumulate_over_replays_as_over_eager_steps(
        host_train_graphs):
    """Without zero_grad a second backward adds to the gradients: each
    replay's gradients are a fresh copy, not the graph's own buffer."""
    net = _net()
    twin = copy.deepcopy(net)
    for seed in (20, 21):
        _loss(net(_x(seed=seed), True)).backward()
        _loss(twin._eager(_x(seed=seed), True)).backward()
    _assert_same_state(net, twin)
    (entry,) = net._train_graphs.values()
    flat = entry.grads.untyped_storage().data_ptr()
    assert all(p.grad.untyped_storage().data_ptr() != flat
               for p in net.parameters())


def test_a_second_forward_before_the_backward_runs_eagerly(
        host_train_graphs):
    """The graphs hold one forward's activations: a second forward of the
    same key while the first's backward is to come runs eagerly, and one
    backward through both gives the eager gradients (a second replay
    would have overwritten the first's activations, and its backward would
    raise).  The CPU counts no eager forward."""
    net = _net()
    twin = copy.deepcopy(net)
    t0 = time.perf_counter()
    a, b = net(_x(seed=30), True), net(_x(seed=31), True)
    assert _counted(t0) == {"inception.train_graph_replay": 1,
                            "inception.train_eager": 0}
    (_loss(a) + 2 * _loss(b)).backward()
    wa, wb = twin._eager(_x(seed=30), True), twin._eager(_x(seed=31), True)
    (_loss(wa) + 2 * _loss(wb)).backward()
    assert _same(a, wa) and _same(b, wb)
    _assert_same_state(net, twin)
    t0 = time.perf_counter()
    net(_x(seed=32), True)        # the backward ran: the graphs are free
    assert _counted(t0)["inception.train_graph_replay"] == 1


def test_a_dropped_forward_frees_the_graphs(host_train_graphs):
    net = _net()
    out = net(_x(), True)
    del out
    t0 = time.perf_counter()
    net(_x(seed=2), True)
    assert _counted(t0) == {"inception.train_graph_replay": 1,
                            "inception.train_eager": 0}


def test_a_second_backward_of_a_replay_raises(host_train_graphs):
    net = _net()
    loss = _loss(net(_x(), True))
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="one backward per forward"):
        loss.backward()


def test_frozen_parameters_get_no_gradient_and_a_capture_of_their_own(
        host_train_graphs):
    net = _net()
    twin = copy.deepcopy(net)
    for m in (net, twin):
        m.conv_layer2.weight.requires_grad_(False)
    _loss(net(_x(), True)).backward()
    _loss(twin._eager(_x(), True)).backward()
    _assert_same_state(net, twin)
    assert net.conv_layer2.weight.grad is None
    net.conv_layer2.weight.requires_grad_(True)
    net(_x(), True)
    assert net.host_captures == 2


@pytest.mark.parametrize("what", ["input_grad", "all_frozen"])
def test_an_input_gradient_or_no_parameter_s_runs_eagerly(host_train_graphs,
                                                           what):
    """The graphs differentiate the parameters alone: a forward whose input
    requires a gradient, or none of whose parameters does, runs eagerly
    (with the eager bits) and captures nothing."""
    net = _net()
    twin = copy.deepcopy(net)
    x, wx = _x(), _x()
    if what == "input_grad":
        x.requires_grad_(True)
        wx.requires_grad_(True)
    else:
        for m in (net, twin):
            for p in m.parameters():
                p.requires_grad_(False)
    t0 = time.perf_counter()
    got = net(x, True)
    assert _counted(t0)["inception.train_graph_replay"] == 0
    assert net._train_graphs == {}
    want = twin._eager(wx, True)
    assert _same(got, want)
    if what == "input_grad":
        _loss(got).backward()
        _loss(want).backward()
        assert _same(x.grad, wx.grad)
    _assert_same_state(net, twin)


def test_a_new_shape_or_a_replaced_parameter_makes_a_new_capture(
        host_train_graphs):
    """The key holds the input's shape and every tensor's address: an
    update in place replays the same capture and is seen, a parameter
    replaced (``load_state_dict(..., assign=True)``) or a new batch shape
    captures anew; ``GRAPHS_KEPT`` captures are kept."""
    net = _net()
    twin = copy.deepcopy(net)
    net(_x(), True)
    with torch.no_grad():
        net.conv_layer1.weight.mul_(1.5)
        twin.conv_layer1.weight.mul_(1.5)
    assert _same(net(_x(), True), twin._eager(_x(), True))
    assert net.host_captures == 1
    state = {k: v.clone() for k, v in net.state_dict().items()}
    state["conv_layer1.weight"].mul_(0.5)
    twin.load_state_dict(state)
    net.load_state_dict(state, assign=True)
    assert _same(net(_x(), True), twin._eager(_x(), True))
    assert net.host_captures == 2
    for b in range(7, 7 + layers.GRAPHS_KEPT):
        net(_x(b=b), True)
    assert len(net._train_graphs) == layers.GRAPHS_KEPT
    assert net.host_captures == 2 + layers.GRAPHS_KEPT
