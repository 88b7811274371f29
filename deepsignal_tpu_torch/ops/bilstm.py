"""LSTM recurrence in plain PyTorch (port of deepsignal_tpu/ops/bilstm.py).

Cell math is TF1 ``LSTMCell``: gate order i, j, f, o; ``FORGET_BIAS`` added
to f; no peepholes.  Kernels keep the TF layout [(D+H), 4H] (input rows
first), so imported checkpoints need no permutation.

Two encoders:

- ``bilstm_encoder_plain`` = ``bilstm_encoder_xla``: six per-layer scans,
  state in the input dtype.
- ``bilstm_encoder_fused_plain`` = the plain version of the fused encoder
  kernel (``ops/cuda/lstm.py``), with that kernel's dtype rules, which are
  the Pallas kernel's (deepsignal_tpu/ops/pallas/lstm.py:61-85,126-138):
  layer 0's input projection in the compute dtype, h/c state in float32,
  h rounded to the compute dtype before every product, products summed in
  float32, upper-layer biases in float32.  In float32 the two encoders
  agree; in bfloat16 they do not.

One layer-direction:

- ``lstm_layer`` = the JAX package's ``lstm_layer``, state in the input
  dtype.
- ``lstm_scan_plain`` = the plain version of the per-layer scan kernel
  (``ops/cuda/lstm_scan.py``), with the Pallas scan kernel's dtype rules
  (deepsignal_tpu/ops/pallas/lstm.py:210-222): the projection in the input
  dtype, h/c state in float32, h rounded to the input dtype before every
  product, products summed in float32, the output in the input dtype.  In
  float32 it equals ``lstm_layer``.
"""

from __future__ import annotations

import torch

FORGET_BIAS = 1.0  # tf.contrib.rnn.LSTMCell default


def lstm_cell_step(h, c, gates):
    """One LSTM step given pre-activation gates [B, 4H] (order i, j, f, o)."""
    i, j, f, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f + FORGET_BIAS) * c + torch.sigmoid(i) * torch.tanh(j)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_layer(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               reverse: bool = False) -> torch.Tensor:
    """One unidirectional layer over [B, T, D] -> [B, T, H].

    Outputs are indexed by absolute time, also with ``reverse=True`` (the
    reversed scan's final step lands at index 0)."""
    b, t, d = x.shape
    h_dim = kernel.shape[1] // 4
    w_x, w_h = kernel[:d], kernel[d:]
    xp = (x.reshape(b * t, d) @ w_x + bias).reshape(b, t, 4 * h_dim)
    h = x.new_zeros(b, h_dim)
    c = x.new_zeros(b, h_dim)
    outs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = lstm_cell_step(h, c, xp[:, ti] + h @ w_h)
        outs[ti] = h
    return torch.stack(outs, dim=1)


def bilstm_encoder_plain(x, kernels_fw, biases_fw, kernels_bw, biases_bw):
    """Stacked bidirectional encoder [B, T, D] -> [B, 2H]: independent
    fw/bw stacks, output concat(fw[:, -1], bw[:, 0]) (Event_model)."""
    fw, bw = x, x
    for kf, bf, kb, bb in zip(kernels_fw, biases_fw, kernels_bw, biases_bw):
        fw = lstm_layer(fw, kf, bf, reverse=False)
        bw = lstm_layer(bw, kb, bb, reverse=True)
    return torch.cat([fw[:, -1], bw[:, 0]], dim=1)


def layer0_product(x, kernel_fw, kernel_bw):
    """Layer 0's input product of both directions in one matmul, in the
    input dtype and without the bias: [B, T, D] -> [B, T, 2, 4H] (fw, then
    bw).  On a GPU a bfloat16 depth D that is not a multiple of 8 is padded
    with zeros, which add nothing, so that cuBLAS takes its aligned
    kernels."""
    b, t, d = x.shape
    w_x = torch.cat([kernel_fw[:d], kernel_bw[:d]], dim=1)
    x2 = x.reshape(b * t, d)
    if x.is_cuda and x.dtype == torch.bfloat16 and d % 8:
        x2 = torch.nn.functional.pad(x2, (0, 8 - d % 8))
        w_x = torch.nn.functional.pad(w_x, (0, 0, 0, 8 - d % 8))
    return (x2 @ w_x).reshape(b, t, 2, -1)


def layer0_projection(x, kernel_fw, bias_fw, kernel_bw, bias_bw):
    """Layer 0's input projection of both directions, ``x @ w_x + bias`` in
    the input dtype as the JAX package writes it (the product rounded, then
    the bias added): [B, T, D] -> [B, T, 2, 4H] (fw, then bw)."""
    bias = torch.cat([bias_fw, bias_bw]).reshape(2, -1)
    return layer0_product(x, kernel_fw, kernel_bw) + bias


def _rounded(h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 state rounded to the compute dtype, held as float32."""
    return h.to(dtype).float()


def lstm_scan_plain(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                    reverse: bool = False) -> torch.Tensor:
    """Plain version of the per-layer scan kernel, [B, T, D] -> [B, T, H] in
    x's dtype, indexed by absolute time (see the module docstring for its
    dtype rules)."""
    b, t, d = x.shape
    h_dim = kernel.shape[1] // 4
    dt = x.dtype
    xp = (x.reshape(b * t, d) @ kernel[:d] + bias).reshape(b, t, 4 * h_dim)
    w_h = kernel[d:].float()
    h = c = x.new_zeros(b, h_dim, dtype=torch.float32)
    outs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = lstm_cell_step(h, c, xp[:, ti].float() + _rounded(h, dt) @ w_h)
        outs[ti] = h
    return torch.stack(outs, dim=1).to(dt)


def bilstm_encoder_fused_plain(x, kernels_fw, biases_fw, kernels_bw,
                               biases_bw):
    """Plain version of the fused 3-layer encoder kernel, [B, T, D] ->
    [B, 2H] in x's dtype (see the module docstring for its dtype rules)."""
    b, t, d = x.shape
    h_dim = kernels_fw[0].shape[1] // 4
    dt = x.dtype
    xp = layer0_projection(x, kernels_fw[0], biases_fw[0], kernels_bw[0],
                           biases_bw[0])
    outs = []
    for di, (ks, bs) in enumerate(((kernels_fw, biases_fw),
                                   (kernels_bw, biases_bw))):
        w0 = ks[0][d:].float()
        k1, k2 = ks[1].float(), ks[2].float()
        b1, b2 = bs[1].float(), bs[2].float()
        zeros = x.new_zeros(b, h_dim, dtype=torch.float32)
        h0 = c0 = h1 = c1 = h2 = c2 = zeros
        for s in range(t):
            ti = s if di == 0 else t - 1 - s
            g0 = xp[:, ti, di].float() + _rounded(h0, dt) @ w0
            h0, c0 = lstm_cell_step(h0, c0, g0)
            g1 = (b1 + _rounded(h0, dt) @ k1[:h_dim]
                  + _rounded(h1, dt) @ k1[h_dim:])
            h1, c1 = lstm_cell_step(h1, c1, g1)
            g2 = (b2 + _rounded(h1, dt) @ k2[:h_dim]
                  + _rounded(h2, dt) @ k2[h_dim:])
            h2, c2 = lstm_cell_step(h2, c2, g2)
        outs.append(h2.to(dt))
    return torch.cat(outs, dim=1)
