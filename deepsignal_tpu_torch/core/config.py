"""Typed configuration, with the field names of ``deepsignal_tpu``.

``ModelConfig`` keeps the JAX package's field names so that a checkpoint's
``config.json`` written by either package loads in the other.  Two JAX
fields select XLA behaviour (``matmul_precision``, ``lstm_impl``); the port
has no use for them, so ``ModelConfig.from_dict`` drops them and the port's
``config.json`` omits them (the JAX loader then takes its defaults).
"""

from __future__ import annotations

import dataclasses

# JAX-only knobs found in checkpoints written by deepsignal_tpu
JAX_ONLY_KEYS = ("matmul_precision", "lstm_impl")


@dataclasses.dataclass
class FeatureConfig:
    """The featurizer field that call_mods reads on feature-TSV input."""

    is_dna: bool = True


@dataclasses.dataclass
class ModelConfig:
    """Model hyperparameters (deepsignal/model.py:19-20, layers.py)."""

    kmer_len: int = 17
    cent_signals_len: int = 360
    class_num: int = 2
    vocab_size: int = 1024
    embedding_size: int = 128
    lstm_hidden: int = 256
    lstm_layers: int = 3
    inception_times: int = 16
    inception_blocks: tuple = (3, 5, 3)
    is_cnn: bool = True
    is_rnn: bool = True
    is_base: bool = True
    pos_weight: float = 1.0
    # parameters stay float32; this is the dtype they are cast to at use
    compute_dtype: str = "float32"     # "float32" | "bfloat16"

    def __post_init__(self):
        if not (self.is_cnn or self.is_rnn):
            raise ValueError("at least one of is_cnn/is_rnn should be True")
        self.inception_blocks = tuple(self.inception_blocks)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """Build from a ``config.json`` dict of either package."""
        return cls(**{k: v for k, v in d.items() if k not in JAX_ONLY_KEYS})


@dataclasses.dataclass
class CallConfig:
    """call_mods knobs (deepsignal/deepsignal.py:258-267 defaults)."""

    batch_size: int = 512
    f5_batch_num: int = 50
    nproc: int = 1
