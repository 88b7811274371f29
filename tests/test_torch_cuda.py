"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor deepsignal_tpu, so it also runs where
they are missing; on a machine with a GPU run it without the suite's
conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Without a GPU every test skips.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.models import layers
from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
from deepsignal_tpu_torch.ops.bilstm import (bilstm_encoder_fused_plain,
                                             bilstm_encoder_plain,
                                             lstm_scan_plain)
from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused
from deepsignal_tpu_torch.ops.cuda.lstm_scan import lstm_layer_scan

# kernel vs plain version on the same card: float32 sums in another order;
# bfloat16 h is rounded before every product, so one rounding step apart
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from deepsignal_tpu_torch.core.device import resolve_device
    return resolve_device("cuda")


def _encoder_case(seed, b, t, d, h, dtype, device):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.05):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    x = mk(b, t, d, scale=1.0)
    kf = [mk((d if i == 0 else h) + h, 4 * h) for i in range(3)]
    kb = [mk((d if i == 0 else h) + h, 4 * h) for i in range(3)]
    bf = [mk(4 * h) for _ in range(3)]
    bb = [mk(4 * h) for _ in range(3)]
    return x, kf, bf, kb, bb


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(300, 17, 131, 256), (8, 5, 7, 128),
                                   (3616, 17, 131, 256), (3616, 17, 131, 128),
                                   (9, 17, 131, 256), (9, 5, 7, 128)])
def test_encoder_kernel_matches_plain(cuda_device, dtype, shape):
    # 300, 9 and 8 are not multiples of the kernel's 64-row (bfloat16) or
    # 32-row (float32) batch tile, and 8 and 9 leave most of one tile
    # empty; 3616 is the call path's tail batch (a ragged bfloat16 tile);
    # hidden 128 takes clusters of 2 CTAs, 256 clusters of 4
    case = _encoder_case(6, *shape, dtype, cuda_device)
    before = bilstm_encoder_fused.launches
    got = bilstm_encoder_fused(*case)
    want = bilstm_encoder_fused_plain(*case)
    torch.cuda.synchronize()
    assert bilstm_encoder_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (shape[0], 2 * shape[3])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_encoder_kernel_rejects_what_it_does_not_take(cuda_device):
    x, kf, bf, kb, bb = _encoder_case(7, 8, 5, 7, 384, torch.float32,
                                      cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        bilstm_encoder_fused(x, kf, bf, kb, bb)
    x, kf, bf, kb, bb = _encoder_case(7, 8, 5, 7, 128, torch.float32,
                                      cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        bilstm_encoder_fused(x, kf, bf, kb, [b.half() for b in bb])


@pytest.mark.cuda
def test_model_on_cuda_matches_cpu(cuda_device):
    cfg = ModelConfig(inception_times=2, inception_blocks=(1, 1, 1),
                      kmer_len=9, cent_signals_len=41)
    torch.manual_seed(0)
    model = DeepSignalNet(cfg).eval()
    rng = np.random.default_rng(8)
    b = 64
    inputs = [torch.from_numpy(a) for a in (
        rng.integers(0, 5, (b, 9)).astype(np.int32),
        rng.normal(0, 1, (b, 9)).astype(np.float32),
        np.abs(rng.normal(0, 1, (b, 9))).astype(np.float32),
        rng.integers(1, 40, (b, 9)).astype(np.float32),
        rng.normal(0, 1, (b, 41)).astype(np.float32))]
    with torch.inference_mode():
        want = model(*inputs)
        before = bilstm_encoder_fused.launches
        got = model.to(cuda_device)(*(a.to(cuda_device) for a in inputs))
    assert bilstm_encoder_fused.launches == before + 1
    # float32 on two devices: cuDNN/cuBLAS and the CPU sum in other orders
    # through a dozen layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


def _scan_case(seed, b, t, d, h, dtype, device):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(
            np.float32)).to(device=device, dtype=dtype)

    return mk(b, t, d, scale=1.0), mk(d + h, 4 * h, scale=0.05), \
        mk(4 * h, scale=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("shape", [(512, 17, 131, 256), (512, 17, 256, 256),
                                   (9, 17, 256, 256), (4, 17, 131, 256),
                                   (33, 3, 8, 128), (13, 6, 5, 98),
                                   (3, 5, 7, 100), (9, 5, 16, 512),
                                   (3, 4, 7, 512)])
def test_scan_kernel_matches_plain(cuda_device, dtype, reverse, shape):
    # the train shapes (layer 0 and layers 1-2), a ragged tile, the
    # call_mods small-batch path and H 128 take the resident kernel;
    # hidden 98 and 100 (not multiples of 4 and 64) and 512 (the largest
    # either kernel takes) the streaming one, batches 13, 9 and 3 leave a
    # ragged tile
    case = _scan_case(9, *shape, dtype, cuda_device)
    variant = "resident" if shape[3] in (128, 256) else "streaming"
    before = lstm_layer_scan.launches
    by_variant = lstm_layer_scan.launches_by_variant[variant]
    got = lstm_layer_scan(*case, reverse=reverse)
    want = lstm_scan_plain(*case, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_layer_scan.launches == before + 1
    assert lstm_layer_scan.launches_by_variant[variant] == by_variant + 1
    assert got.dtype == dtype and got.shape == (*shape[:2], shape[3])
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_scan_kernel_rejects_what_it_does_not_take(cuda_device):
    x, k, b = _scan_case(10, 2, 3, 5, 520, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        lstm_layer_scan(x, k, b)
    x, k, b = _scan_case(10, 2, 3, 5, 16, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="dtype"):
        lstm_layer_scan(x, k, b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        lstm_layer_scan(x.transpose(0, 1).contiguous().transpose(0, 1), k, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["fused", "scan"])
def test_kernel_gradients_match_autograd_through_plain(cuda_device, kernel,
                                                       dtype):
    """Each Function's backward is autograd through its plain version, so
    with a loss linear in the output the gradients are the same numbers."""
    if kernel == "fused":
        x, kf, bf, kb, bb = _encoder_case(11, 512, 17, 131, 256, dtype,
                                          cuda_device)
        arrays = [x, *kf, *bf, *kb, *bb]

        def fn(x, *p):
            return bilstm_encoder_fused(x, p[0:3], p[3:6], p[6:9], p[9:12])

        def plain(x, *p):
            return bilstm_encoder_plain(x, p[0:3], p[3:6], p[6:9], p[9:12])
    else:
        arrays = list(_scan_case(12, 512, 17, 131, 256, dtype, cuda_device))

        def fn(*a):
            return lstm_layer_scan(*a, reverse=True)

        def plain(*a):
            return lstm_scan_plain(*a, reverse=True)
    grads = []
    for f in (fn, plain):
        args = [a.detach().clone().requires_grad_(True) for a in arrays]
        out = f(*args)
        weights = torch.linspace(-1, 1, out.numel(), device=cuda_device)
        (out.float() * weights.reshape(out.shape)).sum().backward()
        grads.append([a.grad.float() for a in args])
    # the same arithmetic on one card: equal up to the order of sums that
    # the libraries may change between calls
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_batch_encoder_launches_the_scan_kernel(cuda_device, dtype):
    """Batch 4 is below the fused kernel's rule: the encoder takes the
    per-layer path, six launches of the scan kernel."""
    enc = layers.BiLSTMEncoder(131, 256, 3).to(cuda_device)
    with torch.no_grad():
        for p in enc.parameters():
            p.uniform_(-0.07, 0.07)
    x = torch.randn(4, 17, 131, device=cuda_device).to(dtype)
    scans, fused = lstm_layer_scan.launches, bilstm_encoder_fused.launches
    resident = lstm_layer_scan.launches_by_variant["resident"]
    with torch.no_grad():
        got = enc(x)
        with mock.patch.object(layers, "lstm_layer_scan", lstm_scan_plain):
            want = enc(x)
    torch.cuda.synchronize()
    assert lstm_layer_scan.launches == scans + 6
    assert lstm_layer_scan.launches_by_variant["resident"] == resident + 6
    assert bilstm_encoder_fused.launches == fused
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=0,
                               atol=TOL[dtype])
