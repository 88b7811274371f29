"""The DeepSignal fusion model (port of deepsignal_tpu/models/deepsignal.py).

- inputs: kmer codes [B, K] int, means/stds/sanums [B, K] float,
  signals [B, S] float (model.py:30-37)
- embedding [vocab=1024, emb=128]; fusion = concat(embed, means, stds,
  sanums) -> [B, K, 131] (model.py:64-69), or [B, K, 3] without bases
- event branch = BiLSTM encoder -> [B, 2H]; signal branch = InceptionNet
  on [B, 1, S]; joint head -> logits [B, class_num], returned as float32
- activation = sigmoid, not softmax (model.py:99-100)
- loss = weighted cross-entropy with logits (model.py:105-118); prediction
  = argmax(sigmoid) at pos_weight 1, else p1 > 0.5 (model.py:108-116)

Parameters stay float32; inputs, the embedding table and every weight are
cast to ``cfg.compute_dtype`` at use (deepsignal.py:46-60).  A new model's
weights come from a seed through ``init_weights``, with flax's initializers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ModelConfig
from ..core.device import torch_dtype
from ..core.logging import span
from ..parallel.mesh import param_shardings, shard_rows
from .layers import BiLSTMEncoder, InceptionNet, JointHead, TFBatchNorm


# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so that a truncated lecun_normal keeps the variance 1 / fan_in
TRUNCATED_STD = 0.87962566103423978


def _truncated_normal_(t: torch.Tensor, std: float, generator):
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter of a DeepSignalNet as flax's initializers do
    (deepsignal_tpu/models), drawing from ``generator``:

    - conv [Cout, Cin, K] and dense [out, in] weights: ``lecun_normal``, a
      normal truncated at 2 std with std sqrt(1 / fan_in) / TRUNCATED_STD;
    - LSTM kernels [(D+H), 4H]: ``glorot_uniform``;
    - the embedding: ``truncated_normal(sqrt(2 / vocab))``, cut at 2 std;
    - biases zero, batch-norm scales one (running stats are set at build).
    """
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "bias":
                p.zero_()
            elif leaf == "scale":
                p.fill_(1.0)
            elif leaf == "kernel":
                nn.init.xavier_uniform_(p, generator=generator)
            elif name == "embedding":
                _truncated_normal_(p, (2.0 / p.shape[0]) ** 0.5, generator)
            else:  # weight: fan_in = everything but the output axis
                fan_in = p[0].numel()
                _truncated_normal_(p, fan_in ** -0.5 / TRUNCATED_STD,
                                   generator)


class DeepSignalNet(nn.Module):
    """BiLSTM-over-kmer + Inception-CNN-over-signal fusion network.

    Weights are drawn from ``seed`` with flax's initializers
    (``init_weights``); a model built on the meta device is left empty for
    ``load_state_dict(..., assign=True)``."""

    def __init__(self, cfg: ModelConfig, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        joint_dim = 0
        if cfg.is_rnn:
            in_dim = 3
            if cfg.is_base:
                self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                          cfg.embedding_size))
                in_dim += cfg.embedding_size
            self.event_model = BiLSTMEncoder(in_dim, cfg.lstm_hidden,
                                             cfg.lstm_layers)
            joint_dim += 2 * cfg.lstm_hidden
        if cfg.is_cnn:
            self.signal_model = InceptionNet(cfg.cent_signals_len,
                                             cfg.inception_times,
                                             cfg.inception_blocks)
            joint_dim += self.signal_model.out_dim
        self.joint_model = JointHead(joint_dim, cfg.class_num)
        if not self.joint_model.fc1.weight.is_meta:
            init_weights(self, torch.Generator().manual_seed(seed))

    def set_mesh(self, mesh) -> None:
        """Run on ``mesh`` (``parallel/mesh.py``): batch norm, dropout and
        the joint head take the global batch's semantics, and with a model
        axis ``joint_model.fc1.weight`` keeps only this rank's output rows
        (``param_shardings``).  Call it before an optimizer takes the
        parameters."""
        for m in self.modules():
            if isinstance(m, (TFBatchNorm, BiLSTMEncoder, JointHead)):
                m.mesh = mesh
        for name, spec in param_shardings(self, mesh).items():
            if spec:  # (MODEL_AXIS, None): this rank's output rows
                owner, leaf = name.rsplit(".", 1)
                module = self.get_submodule(owner)
                setattr(module, leaf, nn.Parameter(shard_rows(
                    getattr(module, leaf).detach(), mesh).clone()))

    def forward(self, kmer, means, stds, sanums, signals, train: bool = False,
                keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        """Logits [B, class_num] in float32.  ``train`` uses the batch's
        batch-norm statistics (and moves the running ones) and, with
        ``keep_prob < 1``, dropout drawn from ``generator``.  The whole is a
        ``model.forward`` span, each branch and the head a span of its own
        (``model.encoder``, ``model.inception``, ``model.head``)."""
        with span("model.forward"):
            cfg = self.cfg
            dt = torch_dtype(cfg.compute_dtype)
            means, stds, sanums, signals = (a.to(dt) for a in
                                            (means, stds, sanums, signals))
            branches = []
            if cfg.is_rnn:
                if cfg.is_base:
                    # [B, K, emb]
                    embedded = self.embedding.to(dt)[kmer.long()]
                    fusion = torch.cat([embedded, means[..., None],
                                        stds[..., None], sanums[..., None]],
                                       dim=2)
                else:
                    fusion = torch.stack([means, stds, sanums], dim=2)
                with span("model.encoder"):
                    branches.append(self.event_model(fusion, train,
                                                     keep_prob, generator))
            if cfg.is_cnn:
                with span("model.inception"):
                    branches.append(self.signal_model(signals[:, None, :],
                                                      train))
            with span("model.head"):
                joint = torch.cat(branches, dim=1) if len(branches) > 1 \
                    else branches[0]
                return self.joint_model(joint, train, keep_prob,
                                        generator).float()


def weighted_ce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                            pos_weight: float) -> torch.Tensor:
    """tf.nn.weighted_cross_entropy_with_logits, numerically stable form:

    loss = (1 - z) * l + (1 + (w - 1) * z) * (log1p(exp(-|l|)) + max(-l, 0))
    """
    l, z = logits, targets
    log_weight = 1.0 + (pos_weight - 1.0) * z
    return ((1.0 - z) * l
            + log_weight * (torch.log1p(torch.exp(-torch.abs(l)))
                            + torch.clamp(-l, min=0.0)))


def predictions(logits: torch.Tensor, pos_weight: float = 1.0) -> torch.Tensor:
    """Reference prediction rule (model.py:108-116): argmax of the sigmoid
    at pos_weight 1, else p1 > 0.5."""
    if pos_weight == 1.0:
        return torch.argmax(torch.sigmoid(logits), dim=1)
    return (torch.sigmoid(logits[:, 1]) > 0.5).to(torch.int64)


def forward_with_loss(logits: torch.Tensor, labels: torch.Tensor,
                      class_num: int, pos_weight: float = 1.0) -> torch.Tensor:
    """Mean weighted-CE cost (model.py:105-118): over the one-hot [B, C]
    grid in the logits' dtype at pos_weight 1, else over the class-1 logit.
    The trainer keeps its own masked form (``train/trainer.py``)."""
    if pos_weight == 1.0:
        one_hot = F.one_hot(labels.long(), class_num).to(logits.dtype)
        return torch.mean(weighted_ce_with_logits(logits, one_hot, pos_weight))
    return torch.mean(weighted_ce_with_logits(
        logits[:, 1], labels.to(logits.dtype), pos_weight))


def normalized_probs(logits: torch.Tensor):
    """(prob_0, prob_1) with prob_i = sigmoid_i / (sigmoid_0 + sigmoid_1)
    (call_modifications.py:185-187)."""
    act = torch.sigmoid(logits)
    total = act[:, 0] + act[:, 1]
    return act[:, 0] / total, act[:, 1] / total


def model_from_state_dict(cfg: ModelConfig, state_dict: dict,
                          device) -> DeepSignalNet:
    """``DeepSignalNet(cfg)`` holding ``state_dict`` (name -> numpy array)
    on ``device``, in eval mode; no random init is spent on the way."""
    with torch.device("meta"):
        model = DeepSignalNet(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           state_dict.items()}, assign=True)
    return model.to(device).eval()
