"""Building blocks of the DeepSignal fusion model (port of
deepsignal_tpu/models/layers.py).

Signals run in PyTorch's [B, C, L] layout.  Where TF semantics differ from
PyTorch's defaults, the TF rule is written out:

- SAME padding is asymmetric, the extra pad on the right (``tf_same_pads``):
  conv k7/s2 on L=360 pads (2, 3), a k3/s2 max-pool on L=180 pads (0, 1).
  PyTorch's symmetric ``padding=`` is off by one in both, so every conv and
  max-pool pads explicitly with ``F.pad`` (max-pools with -inf).
- the 7/s1 average pool excludes padding from the denominator.
- batch norm at inference computes in the input dtype:
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` (layers.py:145-161).
- parameters stay float32 and are cast to the input dtype at use.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bilstm import bilstm_encoder_plain
from ..ops.cuda.lstm import bilstm_encoder_fused, kernel_takes


def tf_same_pads(length: int, window: int, stride: int):
    """TF 'SAME' (left, right) padding: extra pad on the right."""
    out_len = -(-length // stride)
    pad = max((out_len - 1) * stride + window - length, 0)
    return pad // 2, pad - pad // 2


def _ceil_half(n: int) -> int:
    return -(-n // 2)


def _lecun_normal(shape, fan_in: int) -> nn.Parameter:
    return nn.Parameter(torch.randn(shape) * fan_in ** -0.5)


class TFLSTMLayer(nn.Module):
    """One layer-direction with the TF1 LSTMCell layout: ``kernel``
    [(D+H), 4H] (input rows first), ``bias`` [4H]."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim + hidden, 4 * hidden))
        nn.init.xavier_uniform_(self.kernel)
        self.bias = nn.Parameter(torch.zeros(4 * hidden))


class BiLSTMEncoder(nn.Module):
    """Stacked bidirectional encoder (reference Event_model,
    layers.py:142-173), [B, T, D] -> [B, 2H] = concat(fw[:, -1], bw[:, 0]).

    Inference only.  Where the fused kernel takes the shape (3 layers,
    ``hidden % 128 == 0``, batch >= 8: the JAX package's fused rule) the
    encoder goes through ``bilstm_encoder_fused``, which on CUDA launches the
    kernel and on the CPU runs its plain version.  Other shapes run the
    per-layer plain loop on the CPU and raise on CUDA."""

    def __init__(self, in_dim: int, hidden: int = 256, num_layers: int = 3):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        for i in range(num_layers):
            d = in_dim if i == 0 else hidden
            self.add_module(f"fw_{i}", TFLSTMLayer(d, hidden))
            self.add_module(f"bw_{i}", TFLSTMLayer(d, hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        layers = range(self.num_layers)
        kf = [getattr(self, f"fw_{i}").kernel.to(dt) for i in layers]
        bf = [getattr(self, f"fw_{i}").bias.to(dt) for i in layers]
        kb = [getattr(self, f"bw_{i}").kernel.to(dt) for i in layers]
        bb = [getattr(self, f"bw_{i}").bias.to(dt) for i in layers]
        if kernel_takes(x.shape[0], self.hidden, self.num_layers):
            return bilstm_encoder_fused(x.contiguous(), kf, bf, kb, bb)
        if x.device.type != "cpu":
            raise NotImplementedError(
                f"the fused encoder kernel does not take batch {x.shape[0]}, "
                f"hidden {self.hidden}, {self.num_layers} layers")
        return bilstm_encoder_plain(x, kf, bf, kb, bb)


class TFBatchNorm(nn.Module):
    """``tf.contrib.layers.batch_norm`` at inference (eps 1e-3), over the
    channel axis of [B, C, L], computed in the input dtype."""

    def __init__(self, features: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
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
        self.weight = _lecun_normal((out_ch, in_ch, kernel), in_ch * kernel)
        self.bn = TFBatchNorm(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = tf_same_pads(x.shape[-1], self.weight.shape[-1], self.stride)
        if any(pads):
            x = F.pad(x, pads)
        x = F.conv1d(x, self.weight.to(x.dtype), stride=self.stride)
        x = self.bn(x)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b1 = self.branch1_conv1a(max_pool_same(x, 3, 1))
        b2 = self.branch2_conv0b(x)
        b3 = self.branch3_conv1c(self.branch3_conv0c(x))
        b4 = self.branch4_conv1d(self.branch4_conv0d(x))
        stem = self.branch5_convstem(x)
        b5 = self.branch5_conv2e(self.branch5_conv1e(self.branch5_conv0e(x)))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_layer1(x)
        x = max_pool_same(x, 3, 2)
        x = self.conv_layer3(self.conv_layer2(x))
        idx = 1
        for stage, n_blocks in enumerate(self.blocks):
            if stage > 0:
                x = max_pool_same(x, 3, 2)
            for _ in range(n_blocks):
                x = getattr(self, f"incp_layer{idx}")(x)
                idx += 1
        x = F.avg_pool1d(x, 7, 1, padding=3, count_include_pad=False)
        return x.transpose(1, 2).reshape(x.shape[0], -1)


class JointHead(nn.Module):
    """Joint FC head (layers.py:242-264): fc1 (same width) -> fc2, no bias;
    computed in the input dtype.  The reference's dropouts are identity at
    inference."""

    def __init__(self, in_dim: int, class_num: int = 2):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, in_dim, bias=False)
        self.fc2 = nn.Linear(in_dim, class_num, bias=False)

    def forward(self, joint: torch.Tensor) -> torch.Tensor:
        dt = joint.dtype
        fc1 = F.linear(joint, self.fc1.weight.to(dt))
        return F.linear(fc1, self.fc2.weight.to(dt))
