"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor deepsignal_tpu, so it also runs where
they are missing; on a machine with a GPU run it without the suite's
conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Without a GPU every test skips.
"""

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.core.config import ModelConfig
from deepsignal_tpu_torch.models.deepsignal import DeepSignalNet
from deepsignal_tpu_torch.ops.bilstm import bilstm_encoder_fused_plain
from deepsignal_tpu_torch.ops.cuda.lstm import bilstm_encoder_fused

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
@pytest.mark.parametrize("shape", [(300, 17, 131, 256), (8, 5, 7, 128)])
def test_encoder_kernel_matches_plain(cuda_device, dtype, shape):
    # batch 300 is not a multiple of the kernel's 16-row tile
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
