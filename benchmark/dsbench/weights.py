"""Seeded float32 weights, made on the run's device in a few large draws,
for every parameter the configuration's reference lists.

- LSTM kernels: Glorot uniform; LSTM biases: normal(0, 0.05);
- the embedding: normal(0, sqrt(2 / vocab));
- convolution weights (each followed by a batch norm and mostly a relu):
  normal(0, sqrt(2 / fan_in)), He's scale, which keeps the activations'
  scale through the Inception CNN's depth;
- dense weights: normal(0, 1 / sqrt(fan_in));
- batch-norm scales uniform(0.8, 1.2), offsets normal(0, 0.05); running
  statistics settled on a batch of the traffic, layer by layer: mean 0
  and the second moment of the layer's input to the norm, so that every
  layer's output has a steady scale from seed to seed;
- fc2's class-1 row: the class-0 row plus the main direction in which
  fc1's outputs vary over that batch (made orthogonal to their mean),
  scaled to a logit spread of 2.  Random weights call every site alike:
  fc1's outputs share one large common mode and what varies from site to
  site is small; a trained head reads what varies, and so does this one.

Two other choices fail.  Left at a fresh model's mean 0 and variance 1,
the scale of the CNN's output, and with it how sure the calls are, swings
by orders of magnitude from seed to seed.  Set to the batch's mean and
variance, channels whose mean is a hundred times their spread turn every
rounding into a large error, and bfloat16 reads as far from float32 as
fp8 does.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def torch_seed(seed: int, salt: int) -> int:
    """A 63-bit torch seed for one use (``salt``) of a seed of any size."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0), salt]
                                   ).generate_state(2)
    return (int(words[0]) << 31 | int(words[1])) & ((1 << 63) - 1)


def _law(name: str, shape: tuple):
    """("normal" | "uniform", scale, shift) of one tensor."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "kernel":
        return "uniform", math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if leaf == "bias":
        return "normal", 0.05, 0.0
    if leaf == "scale":
        return "uniform", 0.2, 1.0
    if leaf in ("mean", "var"):
        return "normal", 0.0, 0.0 if leaf == "mean" else 1.0
    if name == "embedding":
        return "normal", math.sqrt(2.0 / shape[0]), 0.0
    gain = 2.0 if len(shape) == 3 else 1.0  # convolutions: He's scale
    return "normal", math.sqrt(gain / math.prod(shape[1:])), 0.0


def make(ref, cfg: dict, seed: int, device, settle=None) -> dict:
    """{name: float32 tensor on ``device``}; ``settle``: the input dict
    (kmer, means, stds, sanums, signals; on ``device``) the batch norms'
    statistics and the head settle on."""
    shapes = ref.param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 11))
    laws = {k: _law(k, s) for k, s in shapes.items()}
    sizes = {kind: sum(math.prod(shapes[k]) for k, law in laws.items()
                       if law[0] == kind) for kind in ("normal", "uniform")}
    draws = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device).mul_(2).sub_(1)}
    offsets = {"normal": 0, "uniform": 0}
    params = {}
    for name, shape in shapes.items():
        kind, scale, shift = laws[name]
        n = math.prod(shape)
        flat = draws[kind][offsets[kind]:offsets[kind] + n]
        offsets[kind] += n
        params[name] = flat.view(shape).mul_(scale).add_(shift)
    if settle is not None:
        with torch.no_grad():
            if cfg["is_cnn"]:
                ref.inception(params, cfg, settle["signals"], False,
                              lambda x: x, settle=True)
            _settle_head(params, ref.joint(params, cfg, **settle))
    return params


def _settle_head(params: dict, joint: torch.Tensor) -> None:
    fc1 = (joint @ params["joint_model.fc1.weight"].T).double()
    mean = fc1.mean(dim=0)
    centred = fc1 - mean
    # the top right singular vector, by power iteration: products only
    direction = centred.sum(dim=0) + centred[0]
    for _ in range(64):
        direction = centred.T @ (centred @ direction)
        direction /= torch.linalg.vector_norm(direction)
    direction -= (direction @ mean) / (mean @ mean) * mean
    direction *= 2.0 / (fc1 @ direction).std()
    w2 = params["joint_model.fc2.weight"]
    w2[1] = (w2[0].double() + direction).float()
