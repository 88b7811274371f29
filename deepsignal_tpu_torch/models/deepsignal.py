"""The DeepSignal fusion model (port of deepsignal_tpu/models/deepsignal.py).

- inputs: kmer codes [B, K] int, means/stds/sanums [B, K] float,
  signals [B, S] float (model.py:30-37)
- embedding [vocab=1024, emb=128]; fusion = concat(embed, means, stds,
  sanums) -> [B, K, 131] (model.py:64-69), or [B, K, 3] without bases
- event branch = BiLSTM encoder -> [B, 2H]; signal branch = InceptionNet
  on [B, 1, S]; joint head -> logits [B, class_num], returned as float32
- activation = sigmoid, not softmax (model.py:99-100)

Parameters stay float32; inputs, the embedding table and every weight are
cast to ``cfg.compute_dtype`` at use (deepsignal.py:46-60).
"""

from __future__ import annotations

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.device import torch_dtype
from .layers import BiLSTMEncoder, InceptionNet, JointHead


class DeepSignalNet(nn.Module):
    """BiLSTM-over-kmer + Inception-CNN-over-signal fusion network
    (inference)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        joint_dim = 0
        if cfg.is_rnn:
            in_dim = 3
            if cfg.is_base:
                self.embedding = nn.Parameter(torch.empty(cfg.vocab_size,
                                                          cfg.embedding_size))
                std = (2.0 / cfg.vocab_size) ** 0.5
                nn.init.trunc_normal_(self.embedding, std=std, a=-2 * std,
                                      b=2 * std)
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

    def forward(self, kmer, means, stds, sanums, signals) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg.compute_dtype)
        means, stds, sanums, signals = (a.to(dt) for a in
                                        (means, stds, sanums, signals))
        branches = []
        if cfg.is_rnn:
            if cfg.is_base:
                embedded = self.embedding.to(dt)[kmer.long()]  # [B, K, emb]
                fusion = torch.cat([embedded, means[..., None],
                                    stds[..., None], sanums[..., None]], dim=2)
            else:
                fusion = torch.stack([means, stds, sanums], dim=2)
            branches.append(self.event_model(fusion))
        if cfg.is_cnn:
            branches.append(self.signal_model(signals[:, None, :]))
        joint = torch.cat(branches, dim=1) if len(branches) > 1 else branches[0]
        return self.joint_model(joint).float()


def predictions(logits: torch.Tensor) -> torch.Tensor:
    """Reference prediction rule at pos_weight 1 (model.py:108-110):
    argmax of the sigmoid."""
    return torch.argmax(torch.sigmoid(logits), dim=1)


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
