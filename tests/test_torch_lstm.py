"""The port's LSTM ops against deepsignal_tpu's: the per-layer scan, the
plain encoder and the plain version of the fused encoder kernel, held
against ``bilstm_encoder_xla`` and the Pallas kernel in interpret mode.  The
CUDA kernel itself is held against its plain version on the card, in
tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_tpu.ops.bilstm import bilstm_encoder_xla
from deepsignal_tpu.ops.bilstm import lstm_layer as jax_lstm_layer
from deepsignal_tpu.ops.pallas.lstm import bilstm_encoder_pallas
from deepsignal_tpu_torch.ops import bilstm
from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

torch.set_num_threads(1)

# f32: both sides sum the same products in another order
F32_TOL = 1e-5
# bf16: h is rounded to bfloat16 before every product (8-bit mantissa) and
# the two frameworks round the layer-0 projection at other places
BF16_TOL = 2e-2


def _encoder_case(seed, b, t, d, h):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    ks = {side: [rng.normal(0, 0.05, ((d if i == 0 else h) + h, 4 * h))
                 .astype(np.float32) for i in range(3)] for side in "fb"}
    bs = {side: [rng.normal(0, 0.05, 4 * h).astype(np.float32)
                 for _ in range(3)] for side in "fb"}
    return x, ks["f"], bs["f"], ks["b"], bs["b"]


def _jax(case, dtype=jnp.float32):
    x, kf, bf, kb, bb = case
    j = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    return j(x), tuple(map(j, kf)), tuple(map(j, bf)), tuple(map(j, kb)), \
        tuple(map(j, bb))


def _torch(case, dtype=torch.float32):
    x, kf, bf, kb, bb = case
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return t(x), [t(a) for a in kf], [t(a) for a in bf], \
        [t(a) for a in kb], [t(a) for a in bb]


# (batch, time, input, hidden): the shapes of tests/test_pallas.py
SHAPES = [(16, 17, 131, 256), (12, 5, 7, 128), (8, 9, 7, 128)]


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_matches_jax(reverse):
    x, kf, bf, _, _ = _encoder_case(0, 16, 17, 131, 256)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax_lstm_layer, static_argnames="reverse")(
            jnp.asarray(x), jnp.asarray(kf[0]), jnp.asarray(bf[0]),
            reverse=reverse)
    got = bilstm.lstm_layer(torch.from_numpy(x), torch.from_numpy(kf[0]),
                            torch.from_numpy(bf[0]), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_encoders_match_jax_xla(shape):
    case = _encoder_case(1, *shape)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(bilstm_encoder_xla)(*_jax(case)))
    for fn in (bilstm.bilstm_encoder_plain, bilstm.bilstm_encoder_fused_plain,
               bilstm_encoder_fused):
        got = fn(*_torch(case))
        assert got.shape == (shape[0], 2 * shape[3])
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=fn.__name__)


@pytest.mark.parametrize("shape", SHAPES[1:])
def test_plain_encoders_match_pallas_interpret(shape):
    case = _encoder_case(2, *shape)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(bilstm_encoder_pallas(*_jax(case), block_b=8,
                                                interpret=True))
    for fn in (bilstm.bilstm_encoder_plain, bilstm.bilstm_encoder_fused_plain):
        got = fn(*_torch(case))
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=fn.__name__)


def test_fused_plain_matches_pallas_interpret_bf16():
    case = _encoder_case(3, 8, 9, 7, 128)
    want = bilstm_encoder_pallas(*_jax(case, jnp.bfloat16), block_b=8,
                                 interpret=True)
    got = bilstm.bilstm_encoder_fused_plain(*_torch(case, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=BF16_TOL)


def test_fused_wrapper_counts_only_kernel_launches():
    case = _torch(_encoder_case(4, 8, 9, 7, 128))
    before = bilstm_encoder_fused.launches
    bilstm_encoder_fused(*case)  # a CPU tensor takes the plain version
    assert bilstm_encoder_fused.launches == before


def test_fused_wrapper_rejects_other_devices():
    x, kf, bf, kb, bb = _torch(_encoder_case(5, 8, 9, 7, 128))
    with pytest.raises(ValueError):
        bilstm_encoder_fused(x.to("meta"), [k.to("meta") for k in kf],
                             [b.to("meta") for b in bf],
                             [k.to("meta") for k in kb],
                             [b.to("meta") for b in bb])
