"""Building blocks of the DeepSignal fusion model (port of
deepsignal_tpu/models/layers.py).

Signals run in PyTorch's [B, C, L] layout.  Where TF semantics differ from
PyTorch's defaults, the TF rule is written out:

- SAME padding is asymmetric, the extra pad on the right (``tf_same_pads``):
  conv k7/s2 on L=360 pads (2, 3), a k3/s2 max-pool on L=180 pads (0, 1).
  PyTorch's symmetric ``padding=`` is off by one in both, so every conv and
  max-pool pads explicitly with ``F.pad`` (max-pools with -inf).
- the 7/s1 average pool excludes padding from the denominator.
- batch norm computes in the input dtype:
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` (layers.py:145-161),
  with the running statistics at inference and the batch's mean and biased
  variance in training, when the running statistics move with momentum 0.9.
- dropout is flax's ``nn.Dropout``: keep with probability ``keep_prob``,
  scale the kept values by ``1 / keep_prob``; its bits come from an explicit
  ``torch.Generator``.
- parameters stay float32 and are cast to the input dtype at use.

Modules take ``train`` (and ``keep_prob``, ``generator``) as arguments, as
the flax modules do, and ignore ``nn.Module.training``.  Parameters are
created empty; ``models.deepsignal.init_weights`` fills them.

On a mesh of ranks (``parallel/mesh.py``, set by
``DeepSignalNet.set_mesh``) a train step of n data ranks, each on its
contiguous block of the global batch, computes what one process computes
on the whole batch, as the JAX package's global mesh does: batch norm
takes the global batch's mean and biased variance (two differentiable sums
over the data group), every rank draws each dropout mask at the global
shape from the same generator and keeps its own rows, and with a model
axis fc1's output rows are sharded and its activation all-gathered.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.lstm import bilstm_encoder_fused, kernel_takes
from ..ops.cuda.lstm_scan import lstm_layer_scan
from ..parallel.mesh import local_block, model_parallel_linear, sum_over_data


def tf_same_pads(length: int, window: int, stride: int):
    """TF 'SAME' (left, right) padding: extra pad on the right."""
    out_len = -(-length // stride)
    pad = max((out_len - 1) * stride + window - length, 0)
    return pad // 2, pad - pad // 2


def _ceil_half(n: int) -> int:
    return -(-n // 2)


def dropout(x: torch.Tensor, keep_prob: float,
            generator: torch.Generator, mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout(rate=1 - keep_prob)`` in training: each value kept
    with probability ``keep_prob`` and scaled by ``1 / keep_prob``, the bits
    drawn from ``generator`` (on x's device).  With ``mesh`` the mask is
    drawn at the global batch's shape and this rank keeps its block's rows,
    the mask one process draws for the whole batch."""
    if keep_prob >= 1.0:
        return x
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    data = 1 if mesh is None else mesh.data
    keep = torch.rand((x.shape[0] * data, *x.shape[1:]), generator=generator,
                      device=x.device) < keep_prob
    if data > 1:
        keep = local_block(keep, mesh.data_rank, data)
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


class TFLSTMLayer(nn.Module):
    """One layer-direction with the TF1 LSTMCell layout: ``kernel``
    [(D+H), 4H] (input rows first), ``bias`` [4H]."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim + hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.empty(4 * hidden))


class BiLSTMEncoder(nn.Module):
    """Stacked bidirectional encoder (reference Event_model,
    layers.py:142-173), [B, T, D] -> [B, 2H] = concat(fw[:, -1], bw[:, 0]).

    Two paths, chosen as the JAX package chooses (layers.py:92-115):

    - fused: no live dropout and a shape the fused kernel takes (3 layers,
      ``hidden % 128 == 0``, batch >= 8) -> ``bilstm_encoder_fused``;
    - per layer otherwise: each layer-direction through ``lstm_layer_scan``,
      then dropout on its whole [B, T, H] output (DropoutWrapper
      output_keep_prob on every stacked cell, layers.py:51-54).

    Both wrappers launch their kernel on CUDA and run the plain version on
    the CPU, and both are differentiable."""

    def __init__(self, in_dim: int, hidden: int = 256, num_layers: int = 3):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.mesh = None
        for i in range(num_layers):
            d = in_dim if i == 0 else hidden
            self.add_module(f"fw_{i}", TFLSTMLayer(d, hidden))
            self.add_module(f"bw_{i}", TFLSTMLayer(d, hidden))

    def forward(self, x: torch.Tensor, train: bool = False,
                keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        dt = x.dtype
        layers = range(self.num_layers)
        kf = [getattr(self, f"fw_{i}").kernel.to(dt) for i in layers]
        bf = [getattr(self, f"fw_{i}").bias.to(dt) for i in layers]
        kb = [getattr(self, f"bw_{i}").kernel.to(dt) for i in layers]
        bb = [getattr(self, f"bw_{i}").bias.to(dt) for i in layers]
        x = x.contiguous()
        dropout_live = train and keep_prob < 1.0
        if not dropout_live and kernel_takes(x.shape[0], self.hidden,
                                             self.num_layers):
            return bilstm_encoder_fused(x, kf, bf, kb, bb)
        fw, bw = x, x
        for i in layers:
            fw = lstm_layer_scan(fw, kf[i], bf[i], reverse=False)
            bw = lstm_layer_scan(bw, kb[i], bb[i], reverse=True)
            if dropout_live:
                fw = dropout(fw, keep_prob, generator, self.mesh)
                bw = dropout(bw, keep_prob, generator, self.mesh)
        # Event_model (layers.py:169-173): last fw step, first bw step
        return torch.cat([fw[:, -1], bw[:, 0]], dim=1)


class TFBatchNorm(nn.Module):
    """``tf.contrib.layers.batch_norm`` (decay 0.9, eps 1e-3) over the
    channel axis of [B, C, L], computed in the input dtype.

    In training it normalizes with the batch's mean and biased variance
    over (B, L) and moves the float32 running statistics in place:
    ``stat = m * stat + (1 - m) * batch_stat`` with m and 1 - m the float32
    values the JAX package uses.  On a mesh with more than one data rank
    the batch statistics are the global batch's, the same on every rank,
    and so are the running ones."""

    def __init__(self, features: int, epsilon: float = 1e-3,
                 momentum: float = 0.9):
        super().__init__()
        self.epsilon = epsilon
        m = np.float32(momentum)
        self._keep, self._take = float(m), float(np.float32(1) - m)
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.mesh = None

    def _global_stats(self, x: torch.Tensor):
        """The global batch's mean and biased variance over (B, L): sums
        in float32 over the block, summed over the data group."""
        n = x.shape[0] * self.mesh.data * x.shape[2]
        mean = (sum_over_data(x.sum(dim=(0, 2), dtype=torch.float32),
                              self.mesh) / n).to(x.dtype)
        sq = torch.square(x - mean[:, None]).sum(dim=(0, 2),
                                                 dtype=torch.float32)
        return mean, (sum_over_data(sq, self.mesh) / n).to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype
        if train:
            if self.mesh is None or self.mesh.data == 1:
                mean = x.mean(dim=(0, 2))
                var = torch.square(x - mean[:, None]).mean(dim=(0, 2))
            else:
                mean, var = self._global_stats(x)
            with torch.no_grad():
                self.mean.copy_(self._keep * self.mean
                                + self._take * mean.float())
                self.var.copy_(self._keep * self.var + self._take * var.float())
            mean, var = mean[:, None], var[:, None]
        else:
            mean = self.mean.to(dt)[:, None]
            var = self.var.to(dt)[:, None]
        inv = torch.rsqrt(var + var.new_tensor(self.epsilon))
        return (x - mean) * (inv * self.scale.to(dt)[:, None]) \
            + self.bias.to(dt)[:, None]


class ConvBNRelu(nn.Module):
    """SAME conv (no bias) -> batch norm -> optional relu."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 use_relu: bool = True):
        super().__init__()
        self.stride = stride
        self.use_relu = use_relu
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel))
        self.bn = TFBatchNorm(out_ch)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        pads = tf_same_pads(x.shape[-1], self.weight.shape[-1], self.stride)
        if any(pads):
            x = F.pad(x, pads)
        x = F.conv1d(x, self.weight.to(x.dtype), stride=self.stride)
        x = self.bn(x, train)
        return F.relu(x) if self.use_relu else x


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    pads = tf_same_pads(x.shape[-1], window, stride)
    if any(pads):
        x = F.pad(x, pads, value=-math.inf)
    return F.max_pool1d(x, window, stride)


class InceptionBlock(nn.Module):
    """Five-branch inception block (layers.py:87-139); out = 15*times ch."""

    def __init__(self, in_ch: int, times: int = 16):
        super().__init__()
        t = times
        self.branch1_conv1a = ConvBNRelu(in_ch, 3 * t, 1)
        self.branch2_conv0b = ConvBNRelu(in_ch, 3 * t, 1)
        self.branch3_conv0c = ConvBNRelu(in_ch, 2 * t, 1)
        self.branch3_conv1c = ConvBNRelu(2 * t, 3 * t, 3)
        self.branch4_conv0d = ConvBNRelu(in_ch, 2 * t, 1)
        self.branch4_conv1d = ConvBNRelu(2 * t, 3 * t, 5)
        self.branch5_convstem = ConvBNRelu(in_ch, 3 * t, 1, use_relu=False)
        self.branch5_conv0e = ConvBNRelu(in_ch, 2 * t, 1)
        self.branch5_conv1e = ConvBNRelu(2 * t, 4 * t, 3)
        self.branch5_conv2e = ConvBNRelu(4 * t, 3 * t, 1, use_relu=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.branch1_conv1a(max_pool_same(x, 3, 1), train)
        b2 = self.branch2_conv0b(x, train)
        b3 = self.branch3_conv1c(self.branch3_conv0c(x, train), train)
        b4 = self.branch4_conv1d(self.branch4_conv0d(x, train), train)
        stem = self.branch5_convstem(x, train)
        b5 = self.branch5_conv0e(x, train)
        b5 = self.branch5_conv2e(self.branch5_conv1e(b5, train), train)
        b5 = F.relu(stem + b5)
        return torch.cat([b1, b2, b3, b4, b5], dim=1)


class InceptionNet(nn.Module):
    """Signal-branch CNN (layers.py:176-239): [B, 1, S] -> [B, L * C]
    flattened L-major, as JAX flattens [B, L, C]."""

    def __init__(self, signal_len: int, times: int = 16,
                 blocks: tuple = (3, 5, 3)):
        super().__init__()
        self.blocks = tuple(blocks)
        self.conv_layer1 = ConvBNRelu(1, 64, 7, stride=2)
        self.conv_layer2 = ConvBNRelu(64, 128, 1)
        self.conv_layer3 = ConvBNRelu(128, 256, 3)
        ch = 256
        length = _ceil_half(_ceil_half(signal_len))  # conv s2, then pool s2
        idx = 1
        for stage, n_blocks in enumerate(self.blocks):
            if stage > 0:
                length = _ceil_half(length)
            for _ in range(n_blocks):
                self.add_module(f"incp_layer{idx}", InceptionBlock(ch, times))
                ch = 15 * times
                idx += 1
        self.out_dim = length * ch

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.conv_layer1(x, train)
        x = max_pool_same(x, 3, 2)
        x = self.conv_layer3(self.conv_layer2(x, train), train)
        idx = 1
        for stage, n_blocks in enumerate(self.blocks):
            if stage > 0:
                x = max_pool_same(x, 3, 2)
            for _ in range(n_blocks):
                x = getattr(self, f"incp_layer{idx}")(x, train)
                idx += 1
        x = F.avg_pool1d(x, 7, 1, padding=3, count_include_pad=False)
        return x.transpose(1, 2).reshape(x.shape[0], -1)


class Dense(nn.Module):
    """A bias-free dense layer, ``weight`` [out, in] as in ``nn.Linear``."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))


class JointHead(nn.Module):
    """Joint FC head (layers.py:242-273): fc1 (same width) -> dropout -> fc2
    -> dropout, no biases, computed in the input dtype.  The dropout after
    the logits is the reference's quirk, kept; both are identity at
    inference.  On a mesh with a model axis ``fc1.weight`` holds this
    rank's output rows (``DeepSignalNet.set_mesh``)."""

    def __init__(self, in_dim: int, class_num: int = 2):
        super().__init__()
        self.fc1 = Dense(in_dim, in_dim)
        self.fc2 = Dense(in_dim, class_num)
        self.mesh = None

    def forward(self, joint: torch.Tensor, train: bool = False,
                keep_prob: float = 1.0,
                generator: torch.Generator = None) -> torch.Tensor:
        dt = joint.dtype
        w1 = self.fc1.weight.to(dt)
        fc1 = F.linear(joint, w1) if self.mesh is None else \
            model_parallel_linear(joint, w1, self.mesh)
        if train:
            fc1 = dropout(fc1, keep_prob, generator, self.mesh)
        fc2 = F.linear(fc1, self.fc2.weight.to(dt))
        return dropout(fc2, keep_prob, generator, self.mesh) if train \
            else fc2
