"""Plain float32 reference of DeepSignal (bioinformaticsCSU/deepsignal
v0.2.0, ``deepsignal/model.py``), written from the published description.

It imports torch and numpy only: nothing of the program under test.  Its
parameters are a ``{name: tensor}`` dict with the names the benchmark
gives every side (``param_shapes``).

- fusion input [B, K, 131] = concat(embedding[kmer] (128), means, stds,
  signal counts), or [B, K, 3] without bases; a 3-layer bidirectional
  stack of TF1 ``LSTMCell``s (gate order i, j, f, o; forget bias 1.0;
  kernel [(D+H), 4H], input rows first), fw and bw stacks independent,
  output concat(fw[:, -1], bw[:, 0]);
- Inception CNN over the 360 central signals: conv 7/2, max-pool 3/2,
  conv 1, conv 3, then blocks (3, 5, 3) of five-branch inception with a
  max-pool 3/2 between stages, then an average pool 7/1 (padding left out
  of the mean), flattened length-major; every conv is TF 'SAME' (the extra
  pad on the right), bias-free and followed by batch norm (eps 1e-3);
- joint head: fc1 (same width, no bias, no activation) -> dropout -> fc2
  -> dropout; the activation is a sigmoid; call_mods renormalises
  ``p_i = s_i / (s_0 + s_1)`` in float32 on the host;
- training: batch-norm batch statistics, dropout on every LSTM layer's
  output and after fc1 and fc2, the weighted cross-entropy with logits
  over the one-hot grid (pos_weight 1), Adam (0.9, 0.999, 1e-8).

``operand`` is applied to every tensor the forward computes (both
operands of every product and convolution, and every result it keeps):
the identity here, a rounding to a lower precision in a control.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FORGET_BIAS = 1.0
BN_EPS = 1e-3
ADAM = (0.9, 0.999, 1e-8)

# (name, in channels: "in" or a multiple of times, out multiple, kernel,
# relu) of one inception block's convolutions (layers.py:87-139)
BLOCK = (("branch1_conv1a", "in", 3, 1, True),
         ("branch2_conv0b", "in", 3, 1, True),
         ("branch3_conv0c", "in", 2, 1, True),
         ("branch3_conv1c", 2, 3, 3, True),
         ("branch4_conv0d", "in", 2, 1, True),
         ("branch4_conv1d", 2, 3, 5, True),
         ("branch5_convstem", "in", 3, 1, False),
         ("branch5_conv0e", "in", 2, 1, True),
         ("branch5_conv1e", 2, 4, 3, True),
         ("branch5_conv2e", 4, 3, 1, False))


def _identity(x):
    return x


def ceil_half(n: int) -> int:
    return -(-n // 2)


def inception_plan(cfg: dict):
    """[(prefix, in_ch, out_ch, kernel, stride)] of every convolution of
    the signal branch, its output length and channels, and the stage
    layout: the plain listing the counting functions walk too."""
    t = cfg["inception_times"]
    convs = [("signal_model.conv_layer1", 1, 64, 7, 2),
             ("signal_model.conv_layer2", 64, 128, 1, 1),
             ("signal_model.conv_layer3", 128, 256, 3, 1)]
    ch, idx = 256, 1
    length = ceil_half(ceil_half(cfg["cent_signals_len"]))
    lengths = [ceil_half(cfg["cent_signals_len"]), length, length]
    for stage, n_blocks in enumerate(cfg["inception_blocks"]):
        if stage > 0:
            length = ceil_half(length)
        for _ in range(n_blocks):
            for name, cin, cout, k, _relu in BLOCK:
                c_in = ch if cin == "in" else cin * t
                convs.append((f"signal_model.incp_layer{idx}.{name}", c_in,
                              cout * t, k, 1))
                lengths.append(length)
            ch = 15 * t
            idx += 1
    return convs, lengths, length, ch


def joint_dim(cfg: dict) -> int:
    dim = 2 * cfg["lstm_hidden"] if cfg["is_rnn"] else 0
    if cfg["is_cnn"]:
        _, _, length, ch = inception_plan(cfg)
        dim += length * ch
    return dim


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of every parameter ("mean"/"var": batch-norm running
    statistics, which are not trained)."""
    shapes = {}
    h = cfg["lstm_hidden"]
    if cfg["is_rnn"]:
        d = 3
        if cfg["is_base"]:
            shapes["embedding"] = (cfg["vocab_size"], cfg["embedding_size"])
            d += cfg["embedding_size"]
        for i in range(cfg["lstm_layers"]):
            for side in ("fw", "bw"):
                shapes[f"event_model.{side}_{i}.kernel"] = (
                    (d if i == 0 else h) + h, 4 * h)
                shapes[f"event_model.{side}_{i}.bias"] = (4 * h,)
    if cfg["is_cnn"]:
        for prefix, cin, cout, k, _ in inception_plan(cfg)[0]:
            shapes[f"{prefix}.weight"] = (cout, cin, k)
            for leaf in ("scale", "bias", "mean", "var"):
                shapes[f"{prefix}.bn.{leaf}"] = (cout,)
    dim = joint_dim(cfg)
    shapes["joint_model.fc1.weight"] = (dim, dim)
    shapes["joint_model.fc2.weight"] = (cfg["class_num"], dim)
    return shapes


def is_trained(name: str) -> bool:
    return not name.endswith((".bn.mean", ".bn.var"))


def same_pads(length: int, window: int, stride: int):
    out_len = -(-length // stride)
    pad = max((out_len - 1) * stride + window - length, 0)
    return pad // 2, pad - pad // 2


def dropout(x, keep_prob: float, gen):
    """Keep each value with probability ``keep_prob`` (a float32 uniform
    draw from ``gen`` below it), scaled by 1 / keep_prob."""
    if keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


def lstm_layer(x, kernel, bias, reverse: bool, operand=_identity):
    """[B, T, D] -> [B, T, H], outputs by absolute time."""
    b, t, d = x.shape
    h_dim = kernel.shape[1] // 4
    w_x, w_h = operand(kernel[:d]), operand(kernel[d:])
    xp = (operand(x).reshape(b * t, d) @ w_x + bias).reshape(b, t, 4 * h_dim)
    h = x.new_zeros(b, h_dim)
    c = x.new_zeros(b, h_dim)
    outs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        gates = operand(xp[:, ti] + operand(h) @ w_h)
        i, j, f, o = gates.chunk(4, dim=1)
        c = operand(torch.sigmoid(f + FORGET_BIAS) * c
                    + torch.sigmoid(i) * torch.tanh(j))
        h = operand(torch.sigmoid(o) * torch.tanh(c))
        outs[ti] = h
    return torch.stack(outs, dim=1)


def conv_bn(p, prefix, x, stride, relu, train, operand, settle=False):
    """SAME conv, batch norm (the batch's statistics in training), optional
    relu.  ``settle``: first set the running statistics to mean 0 and the
    batch's second moment (``weights.settle_statistics``)."""
    w = p[f"{prefix}.weight"]
    pads = same_pads(x.shape[-1], w.shape[-1], stride)
    x = operand(F.conv1d(F.pad(operand(x), pads), operand(w), stride=stride))
    if settle:
        p[f"{prefix}.bn.mean"].zero_()
        p[f"{prefix}.bn.var"].copy_(torch.square(x).mean(dim=(0, 2)))
    if train:
        mean = x.mean(dim=(0, 2))
        var = torch.square(x - mean[:, None]).mean(dim=(0, 2))
    else:
        mean, var = p[f"{prefix}.bn.mean"], p[f"{prefix}.bn.var"]
    x = operand((x - mean[:, None]) * (torch.rsqrt(var + BN_EPS)
                                       * p[f"{prefix}.bn.scale"])[:, None]
                + p[f"{prefix}.bn.bias"][:, None])
    return F.relu(x) if relu else x


def max_pool(x, window, stride):
    return F.max_pool1d(F.pad(x, same_pads(x.shape[-1], window, stride),
                              value=-math.inf), window, stride)


def inception(p, cfg, signals, train, operand, settle=False):
    x = conv_bn(p, "signal_model.conv_layer1", signals[:, None, :], 2, True,
                train, operand, settle)
    x = max_pool(x, 3, 2)
    x = conv_bn(p, "signal_model.conv_layer2", x, 1, True, train, operand,
                settle)
    x = conv_bn(p, "signal_model.conv_layer3", x, 1, True, train, operand,
                settle)
    idx = 1
    for stage, n_blocks in enumerate(cfg["inception_blocks"]):
        if stage > 0:
            x = max_pool(x, 3, 2)
        for _ in range(n_blocks):
            pre = f"signal_model.incp_layer{idx}."

            def cb(name, inp, relu=True):
                return conv_bn(p, pre + name, inp, 1, relu, train, operand,
                               settle)
            b1 = cb("branch1_conv1a", max_pool(x, 3, 1))
            b2 = cb("branch2_conv0b", x)
            b3 = cb("branch3_conv1c", cb("branch3_conv0c", x))
            b4 = cb("branch4_conv1d", cb("branch4_conv0d", x))
            stem = cb("branch5_convstem", x, relu=False)
            b5 = cb("branch5_conv2e", cb("branch5_conv1e",
                                         cb("branch5_conv0e", x)), relu=False)
            x = torch.cat([b1, b2, b3, b4, operand(F.relu(stem + b5))],
                          dim=1)
            idx += 1
    x = operand(F.avg_pool1d(x, 7, 1, padding=3, count_include_pad=False))
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def joint(p: dict, cfg: dict, kmer, means, stds, sanums, signals,
          train: bool = False, keep_prob: float = 1.0, gen=None,
          operand=_identity):
    """The joint head's input [B, 2H + L*C]: the encoder's and the CNN's
    outputs side by side."""
    branches = []
    if cfg["is_rnn"]:
        feats = [means[..., None], stds[..., None], sanums[..., None]]
        if cfg["is_base"]:
            feats.insert(0, p["embedding"][kmer.long()])
        x = torch.cat(feats, dim=2)
        fw, bw = x, x
        for i in range(cfg["lstm_layers"]):
            fw = lstm_layer(fw, p[f"event_model.fw_{i}.kernel"],
                            p[f"event_model.fw_{i}.bias"], False, operand)
            bw = lstm_layer(bw, p[f"event_model.bw_{i}.kernel"],
                            p[f"event_model.bw_{i}.bias"], True, operand)
            if train:
                fw = dropout(fw, keep_prob, gen)
                bw = dropout(bw, keep_prob, gen)
        branches.append(torch.cat([fw[:, -1], bw[:, 0]], dim=1))
    if cfg["is_cnn"]:
        branches.append(inception(p, cfg, signals, train, operand))
    return torch.cat(branches, dim=1)


def forward(p: dict, cfg: dict, kmer, means, stds, sanums, signals,
            train: bool = False, keep_prob: float = 1.0, gen=None,
            operand=_identity):
    """Logits [B, class_num], float32; inputs on the parameters' device."""
    x = joint(p, cfg, kmer, means, stds, sanums, signals, train, keep_prob,
              gen, operand)
    fc1 = operand(operand(x) @ operand(p["joint_model.fc1.weight"]).T)
    if train:
        fc1 = dropout(fc1, keep_prob, gen)
    logits = operand(operand(fc1) @ operand(p["joint_model.fc2.weight"]).T)
    return dropout(logits, keep_prob, gen) if train else logits


def call_probs(logits: torch.Tensor) -> np.ndarray:
    """[B] float64 prob_1 = s_1 / (s_0 + s_1) of the sigmoids."""
    act = torch.sigmoid(logits.double())
    return (act[:, 1] / (act[:, 0] + act[:, 1])).cpu().numpy()


def loss_fn(logits, labels, class_num: int):
    """Mean weighted cross-entropy with logits over the one-hot grid
    (pos_weight 1: plain sigmoid cross-entropy)."""
    z = F.one_hot(labels.long(), class_num).to(logits.dtype)
    per = (1.0 - z) * logits + torch.log1p(torch.exp(-torch.abs(logits))) \
        + torch.clamp(-logits, min=0.0)
    return per.mean()


def train_steps(p0: dict, cfg: dict, batches: list, keep_prob: float,
                lr: float, dropout_seed: int, steps: int = 3,
                operand=_identity) -> dict:
    """``steps`` training steps from ``p0`` on ``batches`` (dicts of
    tensors: kmer, means, stds, sanums, signals, labels), with dropout
    drawn from a generator on the parameters' device seeded with
    ``dropout_seed``.  Returns each step's loss, every trained leaf's
    gradient norm at step 1, and its change's norm after the last step."""
    device = next(iter(p0.values())).device
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed)
    params = {k: v.detach().clone().requires_grad_(is_trained(k))
              for k, v in p0.items()}
    trained = [k for k in params if is_trained(k)]
    m = {k: torch.zeros_like(params[k]) for k in trained}
    v = {k: torch.zeros_like(params[k]) for k in trained}
    b1, b2, eps = ADAM
    losses, grad_norms = [], {}
    for step in range(1, steps + 1):
        b = batches[step - 1]
        logits = forward(params, cfg, b["kmer"], b["means"], b["stds"],
                         b["sanums"], b["signals"], train=True,
                         keep_prob=keep_prob, gen=gen, operand=operand)
        loss = loss_fn(logits, b["labels"], cfg["class_num"])
        grads = torch.autograd.grad(loss, [params[k] for k in trained])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, g in zip(trained, grads):
                if step == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g.double()))
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(
            (params[k] - p0[k]).double())) for k in trained}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}


def bf16_operand(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, back in float32."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8_operand(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per tensor (its largest value
    at the format's 448), back in float32."""
    scale = torch.clamp(x.detach().abs().max(), min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def int8_operand(x: torch.Tensor) -> torch.Tensor:
    """Round to int8 with one scale per tensor (its largest value at 127),
    back in float32."""
    scale = torch.clamp(x.detach().abs().max(), min=1e-30) / 127.0
    return torch.clamp(torch.round(x / scale), -127, 127) * scale
