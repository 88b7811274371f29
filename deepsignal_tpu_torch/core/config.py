"""Typed configuration, with the field names of ``deepsignal_tpu``.

``ModelConfig`` keeps the JAX package's field names so that a checkpoint's
``config.json`` written by either package loads in the other.  Two JAX
fields select XLA behaviour (``matmul_precision``, ``lstm_impl``); the port
has no use for them, so ``ModelConfig.from_dict`` drops them and the port's
``config.json`` omits them (the JAX loader then takes its defaults).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# JAX-only knobs found in checkpoints written by deepsignal_tpu
JAX_ONLY_KEYS = ("matmul_precision", "lstm_impl")


@dataclasses.dataclass
class FeatureConfig:
    """Featurizer knobs (deepsignal/deepsignal.py:183-206 defaults).

    The reference subsamples an oversized middle base with the unseeded
    ``random.sample`` (extract_features.py:166-168); as in the JAX package
    the draw is seeded per read from ``central_sample_seed``, so extraction
    is reproducible (``None`` restores the reference's unseeded draw)."""

    kmer_len: int = 17
    cent_signals_len: int = 360
    motifs: str = "CG"
    mod_loc: int = 0
    methy_label: int = 1
    normalize_method: str = "mad"      # "mad" | "zscore"
    is_dna: bool = True
    corrected_group: str = "RawGenomeCorrected_000"
    basecall_subgroup: str = "BaseCalled_template"
    central_sample_seed: Optional[int] = 1234

    def __post_init__(self):
        if self.kmer_len % 2 == 0:
            raise ValueError("kmer_len must be odd")  # extract_features.py:218-219
        if self.normalize_method not in ("mad", "zscore"):
            raise ValueError("normalize_method must be 'mad' or 'zscore'")


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
class TrainConfig:
    """Trainer knobs (deepsignal/deepsignal.py:364-384 defaults)."""

    batch_size: int = 512
    learning_rate: float = 0.001
    decay_rate: float = 0.1
    keep_prob: float = 0.5
    max_epoch_num: int = 10
    min_epoch_num: int = 5
    display_step: int = 100
    pos_weight: float = 1.0
    seed: int = 42
    # rolling full-train-state checkpoint at each epoch end (params +
    # optimizer + generator + shuffle stream; enables exact resume).  The
    # state fetch+serialize is ~0.5 GB for the full model: turn off for
    # throwaway trainings (the best-model checkpointing at display-step
    # boundaries is unaffected).
    save_state: bool = True


@dataclasses.dataclass
class DenoiseConfig:
    """denoise knobs (deepsignal/deepsignal.py:400-418 defaults): the
    default model is RNN-only (no CNN branch, no base embedding)."""

    iterations: int = 6
    epoch_num: int = 5
    rounds: int = 5
    score_cf: float = 0.5
    step_interval: int = 100
    batch_size: int = 512
    learning_rate: float = 0.001
    decay_rate: float = 0.1
    keep_prob: float = 0.5
    pos_weight: float = 1.0
    is_cnn: bool = False
    is_base: bool = False
    is_rnn: bool = True


@dataclasses.dataclass
class CallConfig:
    """call_mods knobs (deepsignal/deepsignal.py:258-267 defaults)."""

    batch_size: int = 512
    f5_batch_num: int = 50
    nproc: int = 1
