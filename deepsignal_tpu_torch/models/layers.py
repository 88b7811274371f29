"""Building blocks of the DeepSignal fusion model (port of
deepsignal_tpu/models/layers.py).

Signals run in PyTorch's [B, C, L] layout.  Where TF semantics differ from
PyTorch's defaults, the TF rule is written out:

- SAME padding is asymmetric, the extra pad on the right (``tf_same_pads``):
  conv k7/s2 on L=360 pads (2, 3), a k3/s2 max-pool on L=180 pads (0, 1).
  PyTorch's symmetric ``padding=`` is off by one in both, so every conv
  pads explicitly with ``F.pad``, and so does every max-pool outside an
  inference forward on the card (with -inf, ``max_pool_plain``).
- the 7/s1 average pool excludes padding from the denominator.
- batch norm computes in the input dtype:
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` (layers.py:145-161),
  with the running statistics at inference and the batch's mean and biased
  variance in training, when the running statistics move with momentum 0.9.
- dropout is flax's ``nn.Dropout``: keep with probability ``keep_prob``,
  scale the kept values by ``1 / keep_prob``; its bits come from an explicit
  ``torch.Generator``.
- parameters stay float32 and are cast to the input dtype at use.

On the card, an inference forward of ``InceptionNet`` with autograd off
(``graph_takes``) replays a CUDA graph of its own eager forward, captured
once per input shape, dtype, device and parameter storage: one launch in
place of ~1,700, the same kernels and the same bits; with autograd on,
and on the CPU, it runs eagerly.  The process's record counts each
inference forward on the card as ``inception.graph_replay`` or
``inception.eager``.
A training forward on the card with autograd on, on no mesh or a mesh of
one data rank (``train_graph_takes``), likewise replays a graph of the
eager training forward, and its backward a graph of that forward's
backward (``_TrainReplay``): two launches in place of ~1,700 each, the
same kernels, the batch statistics and the running statistics' update
inside the forward's graph.  The record counts each training forward on
the card as ``inception.train_graph_replay`` or ``inception.train_eager``.
Inside it, batch norm with autograd off (``bn_kernel_takes``) is one
hand-written kernel with the relu after it (``ops/cuda/bn_relu.py``), one
pass over the activation with torch's bits; the record counts each
inference forward's batch norms on the card as ``bn.kernel`` or
``bn.plain``, by that rule at the forward's input (a replay runs its
capture's path: the key holds the dtype, and autograd is off at both).
Its 3-wide max-pools likewise (``pool_kernel_takes``) are one hand-written
kernel each (``ops/cuda/max_pool.py``) that takes the -inf pad in its index
arithmetic and writes no indices, with torch's bits; the record counts them
as ``pool.kernel`` or ``pool.plain`` by the same rule.  Every inference
forward on the card, with autograd on or off (``merge_takes``), runs each
block's five 1x1 convs that read the block's input as one conv and one
batch norm (``InceptionBlock.merged_1x1``): 69 convs and 69 batch norms a
forward of the published model in place of 113 each, the same dot products
(on an H100 cuDNN sums them alike: the split path's bits in bfloat16 and
float32).  The record counts the blocks as
``conv.merged`` or ``conv.split`` by that rule at the forward's input.

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

import weakref
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.autograd.function import once_differentiable

from ..core.logging import count
from ..ops.cuda.bn_relu import (batch_norm_relu, batch_norm_relu_plain,
                                bn_kernel_takes)
from ..ops.cuda.lstm import bilstm_encoder_fused, kernel_takes
from ..ops.cuda.lstm_scan import lstm_layer_scan
from ..ops.cuda.max_pool import (max_pool, max_pool_plain, pool_kernel_takes,
                                 tf_same_pads)
from ..parallel.mesh import local_block, model_parallel_linear, sum_over_data


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
    and so are the running ones.  At inference on the card with autograd
    off (``bn_kernel_takes``) it is one kernel, ``relu`` included."""

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
        self._eps = {}

    def _epsilon(self, dtype: torch.dtype, device: torch.device):
        """epsilon as a 0-d tensor of ``dtype`` on ``device``, rounded to
        the dtype before it is added, made once per dtype and device by a
        fill on the device: a tensor built from a Python float would be a
        blocking host-to-device copy, a stream sync in every forward."""
        eps = self._eps.get((dtype, device))
        if eps is None:
            eps = self._eps[(dtype, device)] = torch.full(
                (), self.epsilon, dtype=dtype, device=device)
        return eps

    def _global_stats(self, x: torch.Tensor):
        """The global batch's mean and biased variance over (B, L): sums
        in float32 over the block, summed over the data group."""
        n = x.shape[0] * self.mesh.data * x.shape[2]
        mean = (sum_over_data(x.sum(dim=(0, 2), dtype=torch.float32),
                              self.mesh) / n).to(x.dtype)
        sq = torch.square(x - mean[:, None]).sum(dim=(0, 2),
                                                 dtype=torch.float32)
        return mean, (sum_over_data(sq, self.mesh) / n).to(x.dtype)

    def forward(self, x: torch.Tensor, train: bool = False,
                relu: int = 0) -> torch.Tensor:
        """The normalized ``x``, the relu on its leading ``relu`` channels
        (0 for none, C for all)."""
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
            return batch_norm_relu_plain(x, mean, var, self.scale, self.bias,
                                         self._epsilon(x.dtype, x.device),
                                         relu)
        return self.infer(x, relu)

    def infer(self, x: torch.Tensor, relu: int, groups=None, stats=None):
        """Batch norm at inference with the running statistics: this
        module's own, or ``stats`` (mean, var, scale, bias: several
        modules' stacked, which share this one's epsilon); the kernel where
        ``bn_kernel_takes`` holds, else the torch formula.  ``relu`` and
        ``groups`` are ``batch_norm_relu``'s."""
        if stats is None:
            stats = (self.mean, self.var, self.scale, self.bias)
        takes = bn_kernel_takes(x.device.type, False, torch.is_grad_enabled(),
                                x.dtype, x.is_contiguous())
        norm = batch_norm_relu if takes else batch_norm_relu_plain
        return norm(x, *stats, self._epsilon(x.dtype, x.device), relu, groups)


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
        return self.bn(x, train, x.shape[1] if self.use_relu else 0)


def max_pool_same(x: torch.Tensor, window: int, stride: int,
                  train: bool = False) -> torch.Tensor:
    """TF's SAME max-pool over the last axis: the kernel where
    ``pool_kernel_takes`` holds (an inference forward on the card with
    autograd off), else ``max_pool_plain``."""
    takes = pool_kernel_takes(x.device.type, train, torch.is_grad_enabled(),
                              x.dtype, x.is_contiguous())
    return (max_pool if takes else max_pool_plain)(x, window, stride)


def merge_takes(device_type: str, train: bool) -> bool:
    """Whether an ``InceptionBlock`` runs its five 1x1 convs that read the
    block's input as one conv (``InceptionBlock.merged_1x1``): an inference
    forward on the card, with autograd on or off.  Training, whose batch
    norms take the batch's statistics and move each module's running ones,
    and the CPU run the five one by one."""
    return device_type == "cuda" and not train


class InceptionBlock(nn.Module):
    """Five-branch inception block (layers.py:87-139); out = 15*times ch.

    Five of its 1x1 convs read the block's input ``x``: branch 2's, the
    first of branches 3, 4 and 5, and branch 5's stem.  Where
    ``merge_takes`` holds they run as one conv of 12t output channels and
    one batch norm over them (``merged_1x1``), so ``x`` is read once, not
    five times; the parameters stay the five modules' own."""

    # the 1x1 convs that read the block's input, in the merged conv's
    # channel order: the 9t that take the relu first, the stem's 3t last
    MERGED = ("branch2_conv0b", "branch3_conv0c", "branch4_conv0d",
              "branch5_conv0e", "branch5_convstem")

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

    def merged_convs(self) -> list:
        return [getattr(self, name) for name in self.MERGED]

    def merged_1x1(self, x: torch.Tensor) -> tuple:
        """The ``MERGED`` convs' inference outputs from one conv and one
        batch norm: the five weights stacked and cast once, their
        statistics, scales and biases stacked, all inside the forward (so
        inside a captured graph, which reads the modules' tensors at every
        replay), the relu on the leading 9t channels.  Returns the five
        outputs in ``MERGED`` order: the kernel writes each its own
        contiguous tensor (the block's ``cat`` takes its vectorised copy
        only from contiguous inputs), the torch formula gives channel
        slices of one.  Each channel is the split conv's dot product over
        the same values, accumulated in float32, which cuDNN may group
        otherwise (on an H100 it does not, at the published model's
        shapes)."""
        convs = self.merged_convs()
        y = F.conv1d(x, torch.cat([c.weight for c in convs]).to(x.dtype))
        stats = [torch.cat([getattr(c.bn, k) for c in convs])
                 for k in ("mean", "var", "scale", "bias")]
        widths = [c.weight.shape[0] for c in convs]
        relu = sum(w for w, c in zip(widths, convs) if c.use_relu)
        # the five batch norms share the default epsilon
        return convs[0].bn.infer(y, relu, widths, stats)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        b1 = self.branch1_conv1a(max_pool_same(x, 3, 1, train), train)
        if merge_takes(x.device.type, train):
            b2, b3, b4, b5, stem = self.merged_1x1(x)
        else:
            b2, b3, b4, b5, stem = (c(x, train) for c in self.merged_convs())
        b3 = self.branch3_conv1c(b3, train)
        b4 = self.branch4_conv1d(b4, train)
        b5 = self.branch5_conv2e(self.branch5_conv1e(b5, train), train)
        b5 = F.relu(stem + b5)
        return torch.cat([b1, b2, b3, b4, b5], dim=1)


GRAPHS_KEPT = 4   # captured forwards an InceptionNet keeps, newest used


def graph_takes(device_type: str, train: bool, grad_enabled: bool) -> bool:
    """Whether ``InceptionNet.forward`` replays a CUDA graph: an inference
    forward on the card with autograd off (``no_grad``,
    ``inference_mode``).  Autograd and the CPU run eagerly; training has
    graphs of its own (``train_graph_takes``)."""
    return device_type == "cuda" and not train and not grad_enabled


def train_graph_takes(device_type: str, train: bool, grad_enabled: bool,
                      mesh) -> bool:
    """Whether a training forward of ``InceptionNet`` replays CUDA graphs
    of its eager forward and backward (``_TrainReplay``): on the card with
    autograd on, on no mesh or a mesh of one data rank.  On more data ranks
    batch norm all-reduces the batch's statistics over the data group
    (``TFBatchNorm._global_stats``) and the forward stays eager; so do
    inference, training under ``no_grad`` and the CPU."""
    return (device_type == "cuda" and train and grad_enabled
            and (mesh is None or mesh.data == 1))


class _TrainGraphs:
    """A training forward of ``InceptionNet`` captured as a CUDA graph, and
    its backward as another in the same memory pool: the static input
    ``x``, output ``out``, output gradient ``grad_out`` and flat gradients
    ``grads`` of the parameters ``wanted`` (those of the forward's that
    require one: where ``takes_grad`` holds) that the replays read and
    write.  ``last`` is a weak reference to the autograd node of the newest
    forward replay, ``pending`` whether its backward is still to run: the
    graphs hold one step's activations at a time."""

    def __init__(self, forward, backward, x, out, grad_out, grads, wanted,
                 takes_grad: tuple):
        self.forward, self.backward = forward, backward
        self.x, self.out, self.grad_out = x, out, grad_out
        self.grads, self.wanted, self.takes_grad = grads, wanted, takes_grad
        self.last, self.pending = None, False

    def busy(self) -> bool:
        """Whether a forward replay's backward is still to run while its
        autograd graph lives: another replay would overwrite the
        activations it needs."""
        return self.pending and self.last() is not None


class _TrainReplay(torch.autograd.Function):
    """Inception's training forward as one replay of its captured graph
    (which moves the batch norms' running statistics, as the eager forward
    does), its backward as one replay of the other.  The parameters'
    gradients reach them through autograd as the eager forward's do, each
    a view of a fresh copy of the graph's flat gradients, so that the next
    replay leaves them be."""

    @staticmethod
    def forward(ctx, entry, x, *params):
        entry.x.copy_(x)
        entry.forward.replay()
        ctx.entry = entry
        entry.last, entry.pending = weakref.ref(ctx), True
        return entry.out.clone()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        entry = ctx.entry
        if not entry.pending or entry.last() is not ctx:
            raise RuntimeError(
                "InceptionNet's training graph runs one backward per forward: "
                "its activations are gone (a second backward, or a later "
                "forward replayed over them)")
        entry.pending = False
        entry.grad_out.copy_(grad_out)
        entry.backward.replay()
        grads = iter(_unflatten_dense_tensors(entry.grads.clone(),
                                              entry.wanted))
        return (None, None, *(next(grads) if takes else None
                              for takes in entry.takes_grad))


class InceptionNet(nn.Module):
    """Signal-branch CNN (layers.py:176-239): [B, 1, S] -> [B, L * C]
    flattened L-major, as JAX flattens [B, L, C].

    Where ``graph_takes`` holds, the forward replays a CUDA graph of the
    eager forward, captured at the first such call of each key: the
    input's shape, dtype and device and the address of every parameter and
    buffer.  So a tensor replaced (``load_state_dict(..., assign=True)``,
    ``.to()``) makes a new capture, while an update in place shows at the
    next replay.  The newest ``GRAPHS_KEPT`` graphs are kept.

    Where ``train_graph_takes`` holds, a training forward replays a graph
    of the eager training forward and its backward a graph of that
    forward's backward (``_TrainReplay``), captured at the first such call
    of each key (the same, with whether each parameter requires a
    gradient) and kept likewise in a cache of their own.  A training
    forward whose input requires a gradient, or whose graphs still hold
    activations that a backward to come needs, runs eagerly."""

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
        # (the module's table, name) of every parameter and buffer: their
        # addresses are part of a graph's key (walking ``parameters()`` on
        # every forward would cost the host ~8x as much)
        self._slots = [(table, name) for m in self.modules()
                       for table in (m._parameters, m._buffers)
                       for name in table]
        self._params = [(m._parameters, name) for m in self.modules()
                        for name in m._parameters]
        self._graphs = OrderedDict()
        self._train_graphs = OrderedDict()
        self._norms = [m for m in self.modules()
                       if isinstance(m, TFBatchNorm)]
        # (window, stride) of a forward's max-pools: one of stride 2 at the
        # head of each stage (the first after the stem's first conv), one of
        # stride 1 at the head of every block's branch 1
        self._pools = [(3, 2)] * len(self.blocks) + [(3, 1)] * sum(self.blocks)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        grad = torch.is_grad_enabled()
        if train:
            return self._train(x, grad)
        if graph_takes(x.device.type, train, grad):
            count("inception.graph_replay", 1)
            out = self._replay(x)
        elif x.is_cuda:
            count("inception.eager", 1)
            out = self._eager(x, train)
        else:
            return self._eager(x, train)
        if merge_takes(x.device.type, train):
            count("conv.merged", sum(self.blocks))
            # each block's five merged 1x1 convs share one batch norm
            norms = len(self._norms) - 4 * sum(self.blocks)
        else:
            count("conv.split", sum(self.blocks))
            norms = len(self._norms)
        # every batch norm's input is a convolution's output, every
        # max-pool's a batch norm's or a block's ``cat``: contiguous
        if bn_kernel_takes(x.device.type, train, grad, x.dtype, True):
            count("bn.kernel", norms)
        else:
            count("bn.plain", norms)
        if pool_kernel_takes(x.device.type, train, grad, x.dtype, True):
            count("pool.kernel", len(self._pools))
        else:
            count("pool.plain", len(self._pools))
        return out

    def _train(self, x: torch.Tensor, grad: bool) -> torch.Tensor:
        """A training forward: ``_TrainReplay`` where ``train_graph_takes``
        holds, some parameter and not the input requires a gradient, and
        the key's graphs are free; else the eager forward."""
        if train_graph_takes(x.device.type, True, grad, self._norms[0].mesh):
            params = [table[name] for table, name in self._params]
            wants = tuple(p.requires_grad for p in params)
            if any(wants) and not x.requires_grad:
                key = (*self._key(x), wants)
                entry = self._train_graphs.pop(key, None)
                if entry is None:
                    entry = self._capture_train(x, params, wants)
                    while len(self._train_graphs) >= GRAPHS_KEPT:
                        self._train_graphs.popitem(last=False)
                self._train_graphs[key] = entry
                if not entry.busy():
                    count("inception.train_graph_replay", 1)
                    return _TrainReplay.apply(entry, x, *params)
        if x.is_cuda:
            count("inception.train_eager", 1)
        return self._eager(x, True)

    def _eager(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = self.conv_layer1(x, train)
        x = max_pool_same(x, 3, 2, train)
        x = self.conv_layer3(self.conv_layer2(x, train), train)
        idx = 1
        for stage, n_blocks in enumerate(self.blocks):
            if stage > 0:
                x = max_pool_same(x, 3, 2, train)
            for _ in range(n_blocks):
                x = getattr(self, f"incp_layer{idx}")(x, train)
                idx += 1
        x = F.avg_pool1d(x, 7, 1, padding=3, count_include_pad=False)
        return x.transpose(1, 2).reshape(x.shape[0], -1)

    def _key(self, x: torch.Tensor) -> tuple:
        """A graph's key: x's shape, dtype and device and the address of
        every parameter and buffer."""
        return (tuple(x.shape), x.dtype, x.device,
                tuple(table[name].data_ptr() for table, name in self._slots))

    def _replay(self, x: torch.Tensor) -> torch.Tensor:
        """The eager forward's output through the key's graph: ``x`` copied
        into the graph's input, one replay, the output cloned so that the
        next replay leaves it be."""
        key = self._key(x)
        with torch.inference_mode():
            entry = self._graphs.pop(key, None)
            if entry is None:
                entry = self._capture(x)
                while len(self._graphs) >= GRAPHS_KEPT:
                    self._graphs.popitem(last=False)
            self._graphs[key] = entry
            graph, static_x, static_out = entry
            static_x.copy_(x)
            graph.replay()
            return static_out.clone()

    def _capture(self, x: torch.Tensor) -> tuple:
        """(graph, its input, its output) of the eager inference forward at
        x's shape, dtype and device: one warm-up on a side stream (cuDNN's
        plans, the epsilons), then the capture, as ``torch.cuda.graphs``
        documents."""
        with torch.cuda.device(x.device):
            static_x = x.contiguous().clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._eager(static_x, False)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # thread_local: a trainer's staging thread may copy meanwhile
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self._eager(static_x, False)
        return graph, static_x, static_out

    def _capture_train(self, x: torch.Tensor, params: list,
                       takes_grad: tuple) -> _TrainGraphs:
        """The graphs of the eager training forward at x's shape, dtype and
        device and of its backward to each parameter where ``takes_grad``
        holds.  One warm-up forward and backward on a side stream, then the
        captures, as ``torch.cuda.make_graphed_callables`` makes them.  The
        warm-up moves the running statistics, which are put back: the
        capture runs nothing, so the first replay moves them once, as an
        eager step does."""
        wanted = [p for p, takes in zip(params, takes_grad) if takes]
        running = [t for m in self._norms for t in (m.mean, m.var)]
        with torch.cuda.device(x.device):
            static_x = x.contiguous().clone()
            saved = [t.clone() for t in running]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = self._eager(static_x, True)
                torch.autograd.grad(out, wanted, torch.ones_like(out))
                del out
            torch.cuda.current_stream().wait_stream(side)
            for t, s in zip(running, saved):
                t.copy_(s)
            forward, backward = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            # thread_local: a trainer's staging thread may copy meanwhile
            with torch.cuda.graph(forward, capture_error_mode="thread_local"):
                static_out = self._eager(static_x, True)
            grad_out = torch.empty_like(static_out)
            with torch.cuda.graph(backward, pool=forward.pool(),
                                  capture_error_mode="thread_local"):
                grads = _flatten_dense_tensors(
                    torch.autograd.grad(static_out, wanted, grad_out))
        return _TrainGraphs(forward, backward, static_x, static_out.detach(),
                            grad_out, grads, wanted, takes_grad)


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
