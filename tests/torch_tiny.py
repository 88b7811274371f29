"""The tiny call model of the port's tests, built from a numpy seed.

Its weights and its feature rows come from ``numpy.random.default_rng``
only, so a machine without JAX (the card's) rebuilds the model whose
float32 calls the JAX package wrote into ``tests/golden/calls_tiny_f32.tsv``
(the features are ``tests/golden/features_tiny.tsv``).  Regenerate both,
after an intended change only, with ``python tests/test_torch_layer_ulp.py
--regen``.
"""

import os

import numpy as np

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
FEATURES = os.path.join(GOLDEN_DIR, "features_tiny.tsv")
CALLS_F32 = os.path.join(GOLDEN_DIR, "calls_tiny_f32.tsv")

K, S = 5, 25
# 3 layers at hidden 128: the fused-encoder path
TINY = dict(lstm_hidden=128, lstm_layers=3, inception_times=1,
            inception_blocks=(1, 1, 1), kmer_len=K, cent_signals_len=S)
# a seed whose calls split: 17 of the 40 are label 1, |p1 - p0| >= 0.015
WEIGHT_SEED = 30
N_ROWS = 40
ROW_SEED = 11


def tiny_cfg():
    from deepsignal_tpu_torch.core.config import ModelConfig
    return ModelConfig(**TINY)


def tiny_state_dict(seed: int = WEIGHT_SEED) -> dict:
    """float32 numpy weights for every tensor of the port's tiny
    DeepSignalNet: lecun-like normals, LSTM kernels glorot-uniform, biases
    and batch-norm statistics away from zero and one, so that every layer
    matters."""
    import torch

    from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  DeepSignalNet(tiny_cfg()).state_dict().items()}
    rng = np.random.default_rng(seed)
    sd = {}
    for name in sorted(shapes):
        shape = shapes[name]
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bias", "mean"):
            a = rng.normal(0, 0.3, shape)
        elif leaf in ("scale", "var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "embedding":
            a = rng.normal(0, (2.0 / shape[0]) ** 0.5, shape)
        elif leaf == "kernel":
            lim = (6.0 / (shape[0] + shape[1])) ** 0.5
            a = rng.uniform(-lim, lim, shape)
        else:
            a = rng.normal(0, int(np.prod(shape[1:])) ** -0.5, shape)
        sd[name] = a.astype(np.float32)
    return sd


def tiny_feature_rows(seed: int = ROW_SEED, n: int = N_ROWS) -> list:
    """``n`` feature-TSV rows at k-mer K and S signals, 6 sites a read."""
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        rows.append(format_feature_row(
            "chr1", 100 + i, "+-"[i % 2], 100 + i, f"read{i // 6}", "t",
            "".join(rng.choice(list("ACGTN"), K)), rng.normal(0, 1, K),
            np.abs(rng.normal(0, 1, K)), rng.integers(1, 50, K),
            np.around(rng.normal(0, 1, S), 6), 1))
    return rows
