"""The port's per-layer scan (K2's plain version and wrapper) and the
autograd Functions of both LSTM kernels, against deepsignal_tpu: the Pallas
scan kernel in interpret mode, ``lstm_layer`` and ``bilstm_encoder_xla`` and
their JAX gradients; the plain version of K2's backward kernel and the
wrapper's code around it against autograd through the plain scan.  The CUDA
kernels themselves are held against their plain versions on the card, in
tests/test_torch_cuda.py."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_tpu.ops.bilstm import bilstm_encoder_xla
from deepsignal_tpu.ops.bilstm import lstm_layer as jax_lstm_layer
from deepsignal_tpu.ops.pallas.lstm import lstm_layer_pallas
from deepsignal_tpu_torch.core.logging import RECORD
from deepsignal_tpu_torch.models.layers import BiLSTMEncoder
from deepsignal_tpu_torch.ops import bilstm
from deepsignal_tpu_torch.ops.cuda import lstm_scan
from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

torch.set_num_threads(1)

# f32: both sides sum the same products in another order
F32_TOL = 1e-5
# bf16: the outputs are bfloat16 values in (-1, 1); the two frameworks round
# the projection at other places, which may move an output across one
# rounding boundary: one bfloat16 step at the top of the range, 2**-8
BF16_TOL = 2.0 ** -8


def _layer_case(seed, b, t, d, h):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, t, d)).astype(np.float32),
            rng.normal(0, 0.2, (d + h, 4 * h)).astype(np.float32),
            rng.normal(0, 0.2, 4 * h).astype(np.float32))


def _torch(arrays, dtype=torch.float32, grad=False):
    return [torch.from_numpy(a).to(dtype).requires_grad_(grad)
            for a in arrays]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_plain_matches_pallas_interpret(dtype, reverse):
    case = _layer_case(0, 16, 9, 7, 32)
    jdt = jnp.dtype(dtype)
    with jax.default_matmul_precision("highest"):
        want = lstm_layer_pallas(*(jnp.asarray(a, jdt) for a in case),
                                 reverse=reverse, interpret=True)
    got = bilstm.lstm_scan_plain(*_torch(case, getattr(torch, dtype)),
                                 reverse=reverse)
    assert got.dtype == getattr(torch, dtype) and got.shape == (16, 9, 32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_scan_plain_matches_pallas_batch_padding():
    # B=13 with an 8-row block: the Pallas kernel pads the batch to 16
    case = _layer_case(1, 13, 6, 5, 16)
    with jax.default_matmul_precision("highest"):
        want = lstm_layer_pallas(*map(jnp.asarray, case), block_b=8,
                                 interpret=True)
    got = bilstm.lstm_scan_plain(*_torch(case))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_plain_equals_lstm_layer_in_float32(reverse):
    case = _torch(_layer_case(2, 5, 7, 3, 12))
    torch.testing.assert_close(bilstm.lstm_scan_plain(*case, reverse=reverse),
                               bilstm.lstm_layer(*case, reverse=reverse),
                               rtol=0, atol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_gradient_matches_jax(reverse):
    x, k, b = case = _layer_case(3, 6, 7, 5, 16)
    g = np.random.default_rng(4).normal(0, 1, (6, 7, 16)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want_out, vjp = jax.vjp(
            lambda *a: jax_lstm_layer(*a, reverse=reverse),
            *map(jnp.asarray, case))
        want = vjp(jnp.asarray(g))
    args = _torch(case, grad=True)
    out = lstm_layer_scan(*args, reverse=reverse)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=F32_TOL, atol=F32_TOL)
    for a, w, name in zip(args, want, ("x", "kernel", "bias")):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=name)


def _encoder_case(seed, b, t, d, h):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, t, d)).astype(np.float32)
    params = [rng.normal(0, 0.1, shape).astype(np.float32)
              for _side in "fb"
              for shape in [((d if i == 0 else h) + h, 4 * h) for i in range(3)]
              + [(4 * h,)] * 3]
    return x, params


def _split(params):
    return params[0:3], params[3:6], params[6:9], params[9:12]


def test_fused_encoder_gradient_matches_jax():
    x, params = _encoder_case(5, 8, 5, 7, 16)
    g = np.random.default_rng(6).normal(0, 1, (8, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda x, *p: bilstm_encoder_xla(x, *_split(p)),
                         jnp.asarray(x), *map(jnp.asarray, params))
        want = vjp(jnp.asarray(g))
    args = _torch([x, *params], grad=True)
    bilstm_encoder_fused(args[0], *_split(args[1:])).backward(
        torch.from_numpy(g))
    for i, (a, w) in enumerate(zip(args, want)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w),
                                   rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=f"input {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fused", "scan"])
def test_autograd_functions_equal_autograd_through_plain(kernel, dtype):
    """Each Function's backward is autograd through the plain function whose
    gradient the JAX package takes, so with a loss linear in the output (the
    two forwards differ in bfloat16) the gradients are the same numbers."""
    if kernel == "fused":
        x, params = _encoder_case(7, 8, 4, 5, 8)
        fn = lambda x, *p: bilstm_encoder_fused(x, *_split(p))  # noqa: E731
        plain = lambda x, *p: bilstm.bilstm_encoder_plain(  # noqa: E731
            x, *_split(p))
        arrays = [x, *params]
    else:
        arrays = list(_layer_case(8, 5, 6, 3, 8))
        fn = lambda *a: lstm_layer_scan(*a, reverse=True)  # noqa: E731
        plain = lambda *a: bilstm.lstm_scan_plain(  # noqa: E731
            *a, reverse=True)
    grads = []
    for f in (fn, plain):
        args = _torch(arrays, dtype, grad=True)
        out = f(*args)
        weights = torch.linspace(-1, 1, out.numel()).reshape(out.shape)
        (out.float() * weights).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# (batch, steps, depth, hidden): the encoder's three layer-0 and upper
# depths at both resident H, at a batch that is a multiple of no batch tile
# (16, 32, 40), and one step alone
BACKWARD_SHAPES = [(45, 17, d, h) for h in (256, 128) for d in (3, 131, 256)]
BACKWARD_SHAPES.append((7, 1, 5, 128))


def _max_rel_gap(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", BACKWARD_SHAPES)
def test_scan_backward_plain_matches_autograd_through_the_plain_scan(
        shape, reverse):
    """The backward kernel's plain version (the gates again from the saved
    output, the serial walk, the products) against autograd through
    lstm_scan_plain: float32 sums in another order, so within 1e-5 of each
    gradient's largest value, the card test's tolerance."""
    b, t, d, h = shape
    args = _torch(_layer_case(13, b, t, d, h), grad=True)
    out = bilstm.lstm_scan_plain(*args, reverse=reverse)
    g = torch.from_numpy(np.random.default_rng(14).normal(
        0, 1, out.shape).astype(np.float32))
    out.backward(g)
    got = bilstm.lstm_scan_backward_plain(*(a.detach() for a in args),
                                          out.detach(), g, reverse)
    for a, grad, name in zip(args, got, ("x", "kernel", "bias")):
        assert grad.shape == a.shape, name
        assert _max_rel_gap(grad, a.grad) <= 1e-5, name


@pytest.mark.parametrize("device_type, dtype, hidden, takes", [
    ("cuda", torch.float32, 256, True), ("cuda", torch.float32, 128, True),
    ("cuda", torch.bfloat16, 256, False), ("cuda", torch.bfloat16, 128, False),
    ("cuda", torch.float32, 100, False), ("cuda", torch.float32, 512, False),
    ("cpu", torch.float32, 256, False)])
def test_scan_backward_takes_the_kernel_only_in_float32_on_the_card(
        device_type, dtype, hidden, takes):
    assert lstm_scan.backward_takes_kernel(device_type, dtype, hidden) is takes


def _counted(name, t0):
    return sum(RECORD.counted(name, t0, time.perf_counter()))


@pytest.mark.parametrize("needs", [(True, True, True), (False, True, True),
                                   (True, False, False)])
def test_scan_wrapper_backward_around_the_kernel(monkeypatch, needs):
    """The wrapper's kernel backward with the kernel's plain version in the
    kernel's place (the CPU has no kernel): the gradients of autograd
    through lstm_scan_plain, of the inputs that ask for one only, and one
    ``lstm.backward_kernel`` count per backward."""
    monkeypatch.setattr(lstm_scan, "backward_takes_kernel",
                        lambda *a: True)
    monkeypatch.setattr(lstm_scan, "gate_grads_on_card",
                        bilstm.lstm_gate_grads_plain)
    case = _layer_case(15, 11, 6, 5, 16)
    grads, counts = [], []
    for f in (lstm_layer_scan, bilstm.lstm_scan_plain):
        args = [a.requires_grad_(need) for a, need in zip(_torch(case), needs)]
        t0 = time.perf_counter()
        out = f(*args, reverse=True)
        out.backward(torch.linspace(-1, 1, out.numel()).reshape(out.shape))
        grads.append([a.grad for a in args])
        counts.append(_counted("lstm.backward_kernel", t0))
    assert counts == [1, 0]
    for got, want, need in zip(*grads, needs):
        assert (got is None) is (not need)
        if need:
            assert _max_rel_gap(got, want) <= 1e-5


def test_scan_backward_on_the_cpu_counts_neither_path():
    t0 = time.perf_counter()
    args = _torch(_layer_case(16, 4, 3, 2, 4), grad=True)
    lstm_layer_scan(*args).sum().backward()
    assert _counted("lstm.backward_kernel", t0) == 0
    assert _counted("lstm.backward_plain", t0) == 0


def test_scan_gradient_skips_inputs_without_grad():
    x, k, b = _torch(_layer_case(9, 4, 3, 2, 4))
    k.requires_grad_(True)
    lstm_layer_scan(x, k, b).sum().backward()
    assert x.grad is None and b.grad is None and k.grad is not None


def test_scan_wrapper_counts_only_kernel_launches():
    case = _torch(_layer_case(10, 4, 3, 2, 4))
    before = lstm_layer_scan.launches
    lstm_layer_scan(*case)  # a CPU tensor takes the plain version
    assert lstm_layer_scan.launches == before


def test_scan_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="cpu or cuda"):
        lstm_layer_scan(*(a.to("meta") for a in
                          _torch(_layer_case(11, 4, 3, 2, 4))))


@pytest.mark.parametrize("batch", [1, 4])
def test_small_batch_encoder_matches_jax(batch):
    """Batches below 8 take the per-layer path (fault: they raised on CUDA
    before the scan kernel); in float32 it equals bilstm_encoder_xla."""
    x, params = _encoder_case(12, batch, 5, 7, 128)
    enc = BiLSTMEncoder(7, hidden=128, num_layers=3)
    with torch.no_grad():
        for i, side in enumerate("fb"):
            for layer in range(3):
                m = getattr(enc, f"{'fw' if side == 'f' else 'bw'}_{layer}")
                m.kernel.copy_(torch.from_numpy(params[6 * i + layer]))
                m.bias.copy_(torch.from_numpy(params[6 * i + 3 + layer]))
    with jax.default_matmul_precision("highest"):
        want = bilstm_encoder_xla(jnp.asarray(x),
                                  *_split(list(map(jnp.asarray, params))))
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
