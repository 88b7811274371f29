"""The fused BiLSTM-encoder kernel's launch plan and weight layout, on the
CPU: the tile plan ``ops/cuda/lstm.py`` hands the kernel for every shape
the kernel takes, the L2 weight stream it implies, and the float32 kernel's
gate-interleaved column order (a permutation under which the encoder
computes the same function).  The kernel itself is held against its plain
version on the card, in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.ops import bilstm
from deepsignal_tpu_torch.ops.cuda import lstm

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hidden", [128, 256])
@pytest.mark.parametrize("batch", [8, 9, 300, 3616, 4096])
def test_tile_plan_fits_every_shape_the_kernel_takes(batch, hidden, dtype):
    assert lstm.kernel_takes(batch, hidden, 3)
    plan = lstm.tile_plan(batch, hidden, dtype)
    rows, (ranks, tiles, dirs) = plan["rows_per_cta"], plan["grid"]
    # the grid covers the batch, with no empty tile, for both directions
    assert tiles * rows >= batch > (tiles - 1) * rows
    assert dirs == 2
    # one cluster rank per 64 hidden units, at most 8 CTAs in a cluster
    assert ranks == plan["cluster"] == hidden // lstm.UNITS_PER_CTA
    assert plan["cluster"] <= 8
    assert plan["smem_bytes"] <= lstm.SMEM_LIMIT == 232_448
    # whole weight slices per layer and whole 16-byte copies per thread
    assert hidden % plan["slice_rows"] == 0
    elem = torch.empty((), dtype=dtype).element_size()
    copies = plan["slice_rows"] * 4 * lstm.UNITS_PER_CTA * elem // 16
    assert copies % plan["threads"] == 0


@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_plan_at_the_call_shape(dtype):
    """B 4096, H 256: the rows per cluster and the shared-memory sum the
    kernel's source note gives."""
    plan = lstm.tile_plan(4096, 256, dtype)
    rows = {torch.float32: 32, torch.bfloat16: 64}[dtype]
    assert plan["rows_per_cta"] == rows
    assert plan["grid"] == (4, 4096 // rows, 2)
    assert plan["smem_bytes"] == 229_424


def test_l2_weight_bytes_per_call_batch():
    """Each cluster streams its direction's 5H x 4H weights once per step:
    5.7 GB in bfloat16 (64-row tiles) and 22.8 GB in float32 (32-row tiles)
    per batch of 4096 at T 17, H 256 - under 6 GB and 23 GB."""
    per_step = 5 * 256 * 4 * 256
    bf16 = lstm.l2_weight_bytes(4096, 17, 256, torch.bfloat16)
    f32 = lstm.l2_weight_bytes(4096, 17, 256, torch.float32)
    assert bf16 == 64 * 2 * 17 * per_step * 2
    assert f32 == 128 * 2 * 17 * per_step * 4
    assert bf16 <= 6e9 and f32 <= 23e9


@pytest.mark.parametrize("hidden", [128, 256])
def test_gate_interleave_is_a_permutation(hidden):
    a = torch.arange(3 * 4 * hidden).reshape(3, 4 * hidden)
    packed = lstm.gate_interleave(a, hidden)
    assert torch.equal(packed.sort(dim=1).values, a)
    # column 4u + g holds gate g of unit u; a CTA's 64 units are the 256
    # contiguous columns from 256 * rank
    for u, g in ((0, 0), (1, 2), (hidden - 1, 3), (64, 1)):
        assert torch.equal(packed[:, 4 * u + g], a[:, g * hidden + u])
    assert torch.equal(lstm.gate_interleave(torch.arange(4 * hidden), hidden),
                       packed[0])


def _encoder_on_interleaved(x, kernels_fw, biases_fw, kernels_bw, biases_bw):
    """The fused encoder's arithmetic written against gate-interleaved
    operands, as the float32 kernel reads them: xp and every product come
    out in the column order 4u + g, and the cell reads gate g of unit u
    there."""
    b, t, d = x.shape
    h_dim = kernels_fw[0].shape[1] // 4
    dt = x.dtype
    pk = [[lstm.gate_interleave(a, h_dim) for a in arrays]
          for arrays in (kernels_fw, biases_fw, kernels_bw, biases_bw)]
    # the kernel takes layer 0's product and adds the bias itself
    xp = (bilstm.layer0_product(x, pk[0][0], pk[2][0])
          + torch.stack([pk[1][0], pk[3][0]]))

    def cell(h, c, gates):
        gi, gj, gf, go = gates.reshape(b, h_dim, 4).unbind(-1)
        c = (torch.sigmoid(gf + bilstm.FORGET_BIAS) * c
             + torch.sigmoid(gi) * torch.tanh(gj))
        return torch.sigmoid(go) * torch.tanh(c), c

    def rounded(h):
        return h.to(dt).float()

    outs = []
    for di, (ks, bs) in enumerate(((pk[0], pk[1]), (pk[2], pk[3]))):
        w0, k1, k2 = ks[0][d:].float(), ks[1].float(), ks[2].float()
        b1, b2 = bs[1].float(), bs[2].float()
        h0 = c0 = h1 = c1 = h2 = c2 = x.new_zeros(b, h_dim,
                                                  dtype=torch.float32)
        for s in range(t):
            ti = s if di == 0 else t - 1 - s
            h0, c0 = cell(h0, c0, xp[:, ti, di].float() + rounded(h0) @ w0)
            h1, c1 = cell(h1, c1, b1 + rounded(h1) @ k1[h_dim:]
                          + rounded(h0) @ k1[:h_dim])
            h2, c2 = cell(h2, c2, b2 + rounded(h2) @ k2[h_dim:]
                          + rounded(h1) @ k2[:h_dim])
        outs.append(h2.to(dt))
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(9, 5, 7, 128), (4, 3, 131, 256)])
def test_encoder_on_interleaved_weights_equals_fused_plain(shape, dtype):
    b, t, d, h = shape
    rng = np.random.default_rng(5)

    def mk(*s, scale=0.1):
        return torch.from_numpy(rng.normal(0, scale, s).astype(
            np.float32)).to(dtype)

    x = mk(b, t, d, scale=1.0)
    kf, kb = ([mk((d if i == 0 else h) + h, 4 * h) for i in range(3)]
              for _ in range(2))
    bf, bb = ([mk(4 * h) for _ in range(3)] for _ in range(2))
    want = bilstm.bilstm_encoder_fused_plain(x, kf, bf, kb, bb)
    got = _encoder_on_interleaved(x, kf, bf, kb, bb)
    assert got.dtype == want.dtype == dtype
    # the same products in permuted columns, summed in the recurrent-half-
    # first order of the kernel's upper layers: float32 rounding apart; in
    # bfloat16 an output may sit one rounding (2**-8 near 1) apart
    tol = 1e-6 if dtype == torch.float32 else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=tol)
