"""InceptionNet's training graphs (``layers._TrainReplay``) against the
eager training forward and backward, on the card: the full model at batch
512 in float32 (TF32 off), trained with Adam.

The forward's graph runs the eager forward's kernels, so Inception's output
and the batch norms' running statistics must be the eager bits.  cuDNN's
weight gradient is not bitwise deterministic (``train/trainer.py``
``_sum_gradients``), so the gradients and the parameters' changes are held
to the distance between two eager runs instead.  The eager side is the same
module with ``layers.train_graph_takes`` patched to False here.

This file imports neither JAX nor deepsignal_tpu; on a machine with a GPU
run it without the suite's conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_inception_train_graph_cuda.py

Without a GPU every test skips.
"""

import contextlib
import copy
import time
from unittest import mock

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models import layers

B = 512
STEPS = 3
LR = 1e-3
NAMES = ("inception.train_graph_replay", "inception.train_eager")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepsignal_tpu_torch.core.device import resolve_device
    return resolve_device("cuda")   # TF32 off, as the port runs


def _eager():
    return mock.patch.object(layers, "train_graph_takes", lambda *a: False)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _batches(seed: int, n: int = STEPS, b: int = B) -> list:
    """Seeded feature batches of the published model's widths."""
    rng = np.random.default_rng(seed)
    cfg = ModelConfig()
    k = cfg.kmer_len
    return [{"kmer": rng.integers(0, 4, (b, k)).astype(np.int32),
             "means": rng.normal(0, 1, (b, k)).astype(np.float32),
             "stds": rng.uniform(0.05, 0.5, (b, k)).astype(np.float32),
             "sanums": rng.integers(3, 40, (b, k)).astype(np.float32),
             "signals": rng.normal(0, 1, (b, cfg.cent_signals_len))
             .astype(np.float32),
             "labels": rng.integers(0, 2, b).astype(np.int64)}
            for _ in range(n)]


def _trainer(device):
    from deepsignal_tpu_torch.train.trainer import Trainer
    return Trainer(ModelConfig(), TrainConfig(batch_size=B, learning_rate=LR,
                                              save_state=False, seed=7),
                   device=device)


def _inception_outputs(trainer) -> list:
    """Every output of the trainer's Inception forward, copied."""
    seen = []
    trainer.model.signal_model.register_forward_hook(
        lambda m, args, out: seen.append(out.detach().clone()))
    return seen


def _counted(t0):
    return {name: sum(RECORD.counted(name, t0, time.perf_counter()))
            for name in NAMES}


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().double().reshape(-1) for t in tensors])


def _distance(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.cuda
def test_graphed_steps_give_the_eager_output_and_running_statistics(
        cuda_device):
    """Three Adam steps fed by the trainer's prefetch thread (which stages
    the next batch while the first step captures).  Before each step the
    graphed model takes the eager model's parameters in place, so each
    step's Inception output and the running statistics after it, the
    capture's step included, are the eager step's bits; one replay a step
    and one capture in all."""
    from deepsignal_tpu_torch.train.data import prefetch_batches
    graphed, eager = _trainer(cuda_device), _trainer(cuda_device)
    got, want = _inception_outputs(graphed), _inception_outputs(eager)
    batches = _batches(1)
    feed = prefetch_batches(map(graphed.stage_batch, batches))
    try:
        for step, batch in enumerate(batches):
            with torch.no_grad():
                for p, q in zip(graphed.model.parameters(),
                                eager.model.parameters()):
                    p.copy_(q)
            t0 = time.perf_counter()
            graphed.train_on_batch(next(feed), LR)
            assert _counted(t0) == {"inception.train_graph_replay": 1,
                                    "inception.train_eager": 0}, step
            t0 = time.perf_counter()
            with _eager():
                eager.train_on_batch(batch, LR)
            assert _counted(t0) == {"inception.train_graph_replay": 0,
                                    "inception.train_eager": 1}, step
            assert _same_bits(got[step], want[step]), step
            for (name, a), b in zip(
                    graphed.model.signal_model.named_buffers(),
                    eager.model.signal_model.buffers()):
                assert _same_bits(a, b), (step, name)
    finally:
        feed.close()
    assert len(graphed.model.signal_model._train_graphs) == 1
    assert eager.model.signal_model._train_graphs == {}


@pytest.mark.cuda
def test_graphed_gradients_and_changes_are_as_near_as_two_eager_runs(
        cuda_device):
    """Three Adam steps from the same weights on the same batches: the
    step-1 gradients and every parameter's change after step 3 lie no
    farther from one eager run's than a second eager run's do (twice that
    distance, or the eager bits where two eager runs agree bit for bit)."""
    batches = _batches(2)
    runs = {}
    for name in ("graphed", "eager1", "eager2"):
        trainer = _trainer(cuda_device)
        start = _flat(trainer.model.parameters())
        with (_eager() if name != "graphed" else contextlib.nullcontext()):
            for step, batch in enumerate(batches):
                trainer.train_on_batch(batch, LR)
                if step == 0:
                    grads = _flat(p.grad for p in trainer.model.parameters())
        runs[name] = (grads, _flat(trainer.model.parameters()) - start)
        del trainer
    for i, what in enumerate(("step-1 gradients", "changes after step 3")):
        eager_gap = _distance(runs["eager2"][i], runs["eager1"][i])
        graph_gap = _distance(runs["graphed"][i], runs["eager1"][i])
        print(f"{what}: graphed {graph_gap:.3e}, eager {eager_gap:.3e}")
        if eager_gap == 0.0:
            assert graph_gap == 0.0, what
        else:
            assert graph_gap <= 2 * eager_gap, what


def _inception(device, seed=3):
    """The published InceptionNet with seeded weights and statistics."""
    net = layers.InceptionNet(ModelConfig().cent_signals_len)
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


def _signals(device, b=B, seed=4):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(b, 1, ModelConfig().cent_signals_len, generator=gen,
                       device=device)


def _forward_backward(net, x):
    out = net(x, True)
    out.square().mean().backward()
    return out.detach()


@pytest.mark.cuda
def test_an_update_in_place_replays_and_a_new_tensor_or_shape_captures(
        cuda_device):
    """A parameter changed in place is seen at the next replay, with no new
    capture; a parameter replaced (``load_state_dict(..., assign=True)``)
    and a new batch shape each make a capture.  Every output equals the
    eager twin's bits, and so do the running statistics."""
    net = _inception(cuda_device)
    twin = copy.deepcopy(net)

    def check(x, captures):
        got = _forward_backward(net, x)
        with _eager():
            want = _forward_backward(twin, x)
        assert _same_bits(got, want)
        for a, b in zip(net.buffers(), twin.buffers()):
            assert _same_bits(a, b)
        assert len(net._train_graphs) == captures

    x = _signals(cuda_device)
    check(x, 1)
    with torch.no_grad():
        for m in (net, twin):
            m.conv_layer1.weight.mul_(1.5)
    check(x, 1)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    state["conv_layer3.weight"].mul_(0.5)
    twin.load_state_dict(state)
    net.load_state_dict(state, assign=True)
    check(x, 2)
    check(_signals(cuda_device, b=B // 2), 3)


@pytest.mark.cuda
def test_a_second_forward_before_the_backward_runs_eagerly(cuda_device):
    """The graphs hold one forward's activations: a second forward while
    the first's backward is to come runs (and counts) eagerly."""
    net = _inception(cuda_device)
    x = _signals(cuda_device)
    t0 = time.perf_counter()
    a, b = net(x, True), net(x, True)
    assert _counted(t0) == {"inception.train_graph_replay": 1,
                            "inception.train_eager": 1}
    assert _same_bits(a.detach(), b.detach())
    (a.square().mean() + b.square().mean()).backward()
