"""The port's CUDA kernels against their plain versions, on the card.

This file imports neither JAX nor deepsignal_tpu, so it also runs where
they are missing; on a machine with a GPU run it without the suite's
conftest (which imports JAX):

    python -m pytest -p no:cacheprovider --noconftest tests/test_torch_cuda.py

Without a GPU every test skips.
"""

import contextlib
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [512, 45])
def test_encoder_kernel_matches_plain_at_depth_3(cuda_device, dtype, batch):
    # denoise's RNN-only model: the encoder's input is the three per-base
    # signal features; 512 is its scoring batch, 45 a ragged tail
    case = _encoder_case(13, batch, 17, 3, 256, dtype, cuda_device)
    before = bilstm_encoder_fused.launches
    got = bilstm_encoder_fused(*case)
    want = bilstm_encoder_fused_plain(*case)
    torch.cuda.synchronize()
    assert bilstm_encoder_fused.launches == before + 1
    assert got.dtype == dtype and got.shape == (batch, 512)
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
                                   (512, 17, 3, 256), (45, 17, 3, 256),
                                   (33, 3, 8, 128), (13, 6, 5, 98),
                                   (3, 5, 7, 100), (9, 5, 16, 512),
                                   (3, 4, 7, 512)])
def test_scan_kernel_matches_plain(cuda_device, dtype, reverse, shape):
    # the train shapes (layer 0 and layers 1-2; layer 0 of denoise's
    # RNN-only model at depth 3, its batch and a ragged one), a ragged tile,
    # the call_mods small-batch path and H 128 take the resident kernel;
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


def _counted(name, t0):
    import time

    from deepsignal_tpu_torch.core.logging import RECORD
    return sum(RECORD.counted(name, t0, time.perf_counter()))


# the fused encoder at the call shape; the scan at the train shapes (layer
# 0 of both models at depths 3 and 131, layers 1-2 at 256), both
# directions, at the train batch and at a batch that is a multiple of no
# batch tile
GRADIENT_CASES = [("fused", (512, 17, 131, 256), False)] + [
    ("scan", (b, 17, d, 256), reverse) for b in (512, 500)
    for d in (3, 131, 256) for reverse in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel, shape, reverse", GRADIENT_CASES)
def test_kernel_gradients_match_autograd_through_plain(cuda_device, kernel,
                                                       shape, reverse, dtype):
    """Each Function's gradient is that of its plain version: the fused
    encoder's and the bfloat16 scan's backward is autograd through it; the
    float32 scan's is the backward kernel (one launch, one
    ``lstm.backward_kernel`` count), the same function summed in another
    order.  With a loss linear in the output both get the same
    cotangent."""
    import time
    if kernel == "fused":
        x, kf, bf, kb, bb = _encoder_case(11, *shape, dtype, cuda_device)
        arrays = [x, *kf, *bf, *kb, *bb]

        def fn(x, *p):
            return bilstm_encoder_fused(x, p[0:3], p[3:6], p[6:9], p[9:12])

        def plain(x, *p):
            return bilstm_encoder_plain(x, p[0:3], p[3:6], p[6:9], p[9:12])
    else:
        arrays = list(_scan_case(12, *shape, dtype, cuda_device))

        def fn(*a):
            return lstm_layer_scan(*a, reverse=reverse)

        def plain(*a):
            return lstm_scan_plain(*a, reverse=reverse)
    grads = []
    for f in (fn, plain):
        args = [a.detach().clone().requires_grad_(True) for a in arrays]
        out = f(*args)
        weights = torch.linspace(-1, 1, out.numel(), device=cuda_device)
        launches, t0 = lstm_layer_scan.backward_launches, time.perf_counter()
        (out.float() * weights.reshape(out.shape)).sum().backward()
        grads.append([a.grad.float() for a in args])
        if f is fn and kernel == "scan":
            by_kernel = dtype == torch.float32
            assert lstm_layer_scan.backward_launches - launches == by_kernel
            assert _counted("lstm.backward_kernel", t0) == by_kernel
            assert _counted("lstm.backward_plain", t0) == (not by_kernel)
    # the same function on one card: equal up to the order of sums
    for got, want in zip(*grads):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-5 * scale


@pytest.mark.cuda
def test_encoder_train_step_launches_six_backward_kernels(cuda_device):
    """A float32 train step of the encoder with live dropout: six scan
    launches forward and six backward kernels, no plain recompute."""
    import time
    enc = layers.BiLSTMEncoder(131, 256, 3).to(cuda_device)
    with torch.no_grad():
        for p in enc.parameters():
            p.uniform_(-0.07, 0.07)
    x = torch.randn(512, 17, 131, device=cuda_device, requires_grad=True)
    gen = torch.Generator(cuda_device).manual_seed(5)
    scans, backward = (lstm_layer_scan.launches,
                       lstm_layer_scan.backward_launches)
    t0 = time.perf_counter()
    enc(x, train=True, keep_prob=0.5, generator=gen).square().sum().backward()
    torch.cuda.synchronize()
    assert lstm_layer_scan.launches - scans == 6
    assert lstm_layer_scan.backward_launches - backward == 6
    assert _counted("lstm.backward_kernel", t0) == 6
    assert _counted("lstm.backward_plain", t0) == 0
    for p in (x, *enc.parameters()):
        assert bool(torch.isfinite(p.grad).all())


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


@pytest.mark.cuda
def test_denoise_runs_both_kernels_on_the_card(cuda_device, tmp_path):
    """A small denoise on the card: RNN-only at hidden 128 (the fused
    kernel takes it), 120 rows in halves of 60, batch 16: per half 4 train
    steps of 6 scan launches each and 4 scoring batches of one fused
    launch."""
    from deepsignal_tpu_torch.core.config import DenoiseConfig
    from deepsignal_tpu_torch.io.feature_codec import format_feature_row
    from deepsignal_tpu_torch.train.denoise import denoise

    rng = np.random.default_rng(14)
    k, s = 17, 24
    train_f = tmp_path / "train.tsv"
    with open(train_f, "w") as f:
        for i in range(120):
            label = i % 2
            f.write(format_feature_row(
                "chr1", i, "+", i, f"r{i}", "t",
                "".join(rng.choice(list("ACGT"), k)),
                rng.normal(label - 0.5, 1, k), np.abs(rng.normal(0, 1, k)),
                rng.integers(1, 30, k), np.around(rng.normal(0, 1, s), 6),
                label) + "\n")
    cfg = ModelConfig(lstm_hidden=128, kmer_len=k, cent_signals_len=s,
                      is_cnn=False, is_base=False)
    dcfg = DenoiseConfig(iterations=1, rounds=1, epoch_num=1, batch_size=16,
                         step_interval=1)
    scans, fused = lstm_layer_scan.launches, bilstm_encoder_fused.launches
    resident = lstm_layer_scan.launches_by_variant["resident"]
    out = denoise(str(train_f), cfg, dcfg, seed=3)
    torch.cuda.synchronize()
    assert lstm_layer_scan.launches - scans == 2 * 4 * 6
    assert lstm_layer_scan.launches_by_variant["resident"] - resident == 48
    assert bilstm_encoder_fused.launches - fused == 2 * 4
    labels = [int(line.rsplit("\t", 1)[1]) for line in open(out)]
    assert 0 < sum(labels) < len(labels)


# --------------------------------------------------------------------------
# the reads path and the golden float32 calls


def _tiny():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_tiny
    return torch_tiny


# the card's float32 calls against the JAX package's on the CPU: the
# fused-encoder kernel's float32 tolerance (2e-5 on h) carried through the
# joint head, with a margin; every golden call has |p1 - p0| >= 0.015, far
# outside it, so the labels must be equal
GOLDEN_PROB_TOL = 1e-4


@pytest.mark.cuda
def test_card_f32_calls_match_the_golden_jax_calls(cuda_device, tmp_path):
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    from deepsignal_tpu_torch.train.checkpoints import (
        save_checkpoint, state_dict_to_variables)
    tt = _tiny()
    cfg = tt.tiny_cfg()
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), cfg,
                           state_dict_to_variables(cfg, tt.tiny_state_dict()))
    before = bilstm_encoder_fused.launches
    run_call_mods(tt.FEATURES, ckpt, str(tmp_path / "calls.tsv"),
                  batch_size=16, f5_batch_num=3, compute_dtype="float32")
    assert bilstm_encoder_fused.launches - before == -(-tt.N_ROWS // 16)
    got = [r.split("\t") for r in
           (tmp_path / "calls.tsv").read_text().splitlines()]
    with open(tt.CALLS_F32) as f:
        want = [r.split("\t") for r in f.read().splitlines()]
    assert len(got) == len(want) == tt.N_ROWS
    for g, w in zip(got, want):
        assert g[:6] + g[8:] == w[:6] + w[8:]
    dprob = np.abs(np.float32([g[6:8] for g in got])
                   - np.float32([w[6:8] for w in want])).max()
    print(f"card vs the golden JAX calls, float32: max |dprob| {dprob:.3e}, "
          f"{sum(g == w for g, w in zip(got, want))}/{tt.N_ROWS} lines "
          f"byte-identical")
    assert dprob <= GOLDEN_PROB_TOL


def _reads(n, bases, seed):
    from deepsignal_tpu_torch.io.fast5 import synthetic_read
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, bases)])
        lengths = rng.integers(3, 22, size=bases)
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920, size=int(lengths.sum())).astype(np.int16)
        out.append(synthetic_read(f"r{i}", raw, starts, lengths, seq, "chr1",
                                  bases * i, "+-"[i % 2]))
    return out


@pytest.mark.cuda
def test_reads_to_calls_launch_the_encoder_kernel(cuda_device, tmp_path):
    """6 reads of 600 bases featurized by 2 extract workers and called on
    the card with the tiny model, float32: K1 once per device batch, and the
    calls those of the same stream on the CPU."""
    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.runtime.caller import (ModCaller,
                                                     call_mods_on_batches)
    from deepsignal_tpu_torch.runtime.pipeline import \
        stream_read_feature_batches
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables
    tt = _tiny()
    cfg = tt.tiny_cfg()
    variables = state_dict_to_variables(cfg, tt.tiny_state_dict())
    fcfg = FeatureConfig(kmer_len=tt.K, cent_signals_len=tt.S)
    reads = _reads(6, 600, seed=12)
    out = {}
    for dev in ("cuda", "cpu"):
        stats = {}
        stream = stream_read_feature_batches(reads, fcfg, nproc=3,
                                             f5_batch_num=2, stats=stats)
        caller = ModCaller(cfg, variables, batch_size=64, device=dev)
        before = bilstm_encoder_fused.launches
        try:
            n = call_mods_on_batches(caller, stream,
                                     str(tmp_path / f"{dev}.tsv"))
        finally:
            stream.close()
        torch.cuda.synchronize()
        launched = bilstm_encoder_fused.launches - before
        assert stats["errors"] == stats["lost_batches"] == 0
        assert launched == (-(-n // 64) if dev == "cuda" else 0)
        out[dev] = sorted(r.split("\t") for r in
                          (tmp_path / f"{dev}.tsv").read_text().splitlines())
    assert len(out["cuda"]) == len(out["cpu"]) > 64
    for g, w in zip(out["cuda"], out["cpu"]):
        assert g[:6] + g[9:] == w[:6] + w[9:]
        p, q = np.float32(g[6:8]), np.float32(w[6:8])
        np.testing.assert_allclose(p, q, rtol=0, atol=GOLDEN_PROB_TOL)
        if abs(q[1] - q[0]) > 2 * GOLDEN_PROB_TOL:
            assert g[8] == w[8]


@pytest.mark.cuda
def test_native_featurizer_matches_plain_on_the_card_host(cuda_device):
    """On the card's machine: the native segment statistics and 6-decimal
    text give the plain version's rows byte for byte, and the golden
    fixture's rows are those of tests/golden/features_golden.tsv."""
    import os
    from unittest import mock

    from deepsignal_tpu_torch.core.config import FeatureConfig
    from deepsignal_tpu_torch.featurize import extractor, signal
    from deepsignal_tpu_torch.io.fast5 import synthetic_read
    reads = _reads(3, 1500, seed=13)
    cfg = FeatureConfig()
    native_rows = [r for read in reads for r in
                   extractor.extract_read_features(read, ["CG"], cfg)
                   .to_tsv_rows()]
    with mock.patch.object(extractor, "segment_stats",
                           signal.segment_stats_plain):
        plain_rows = [r for read in reads for r in
                      extractor.extract_read_features(read, ["CG"], cfg)
                      .to_tsv_rows_plain()]
    assert len(native_rows) > 100 and native_rows == plain_rows

    rng = np.random.default_rng(424242)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    golden = []
    for i, strand in enumerate(["+", "-", "+"]):
        seq = genome[700 * i:700 * i + 250]
        lengths = rng.integers(3, 22, size=len(seq))
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920, size=int(lengths.sum()) + 7)
        golden.append(synthetic_read(f"golden-{i}", raw, starts, lengths, seq,
                                     "chrG", 700 * i, strand,
                                     read_start_rel_to_raw=4))
    feats, errors = extractor.extract_fast5_batch(
        golden, ["CG"], FeatureConfig(central_sample_seed=99),
        chrom2len={"chrG": 3000})
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "features_golden.tsv")) as f:
        want = f.read().splitlines()
    assert errors == 0
    assert [r for f in feats for r in f.to_tsv_rows()] == want


# --------------------------------------------------------------------------
# TF1 import and the host tools on the card's calls


def _tf1_slotted_npz(tt, cfg, path):
    """The tiny model's weights in the TF1 name space, with the optimizer
    slots and bookkeeping a ``tf.train.Saver`` of an Adam run stores."""
    from deepsignal_tpu_torch.models.tf1_import import export_tf1_style_arrays
    from deepsignal_tpu_torch.train.checkpoints import state_dict_to_variables
    arrs = export_tf1_style_arrays(
        state_dict_to_variables(cfg, tt.tiny_state_dict()), cfg)
    for name, a in list(arrs.items()):
        arrs[name + "/Adam"] = a + 1
        arrs[name + "/Adam_1"] = a * a
    arrs.update(beta1_power=np.float32(0.9), beta2_power=np.float32(0.999),
                global_step=np.int64(7))
    np.savez(path, **arrs)
    return path


# the fused-encoder kernel against the plain encoder, float32, carried
# through the tiny joint head
TF1_PROB_TOL = 1e-5


@pytest.mark.cuda
def test_tf1_import_calls_through_the_encoder_kernel(cuda_device, tmp_path):
    """A slot-bearing TF1 .npz of the tiny model -> ``import_tf1_npz`` ->
    ``save_checkpoint`` -> ``run_call_mods`` on the golden tiny features in
    float32, through K1: the calls equal those of the same checkpoint with
    the plain encoder on the card within TF1_PROB_TOL."""
    from deepsignal_tpu_torch.models.tf1_import import import_tf1_npz
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    from deepsignal_tpu_torch.train.checkpoints import save_checkpoint
    tt = _tiny()
    cfg = tt.tiny_cfg()
    npz = _tf1_slotted_npz(tt, cfg, str(tmp_path / "tf1.npz"))
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), cfg,
                           import_tf1_npz(npz, cfg))
    rows = {}
    for encoder in ("kernel", "plain"):
        before = bilstm_encoder_fused.launches
        patch = mock.patch.object(layers, "bilstm_encoder_fused",
                                  bilstm_encoder_fused_plain) \
            if encoder == "plain" else contextlib.nullcontext()
        with patch:
            n = run_call_mods(tt.FEATURES, ckpt,
                              str(tmp_path / f"{encoder}.tsv"),
                              batch_size=16, f5_batch_num=3,
                              compute_dtype="float32")
        torch.cuda.synchronize()
        assert n == tt.N_ROWS
        assert bilstm_encoder_fused.launches - before == (
            -(-tt.N_ROWS // 16) if encoder == "kernel" else 0)
        rows[encoder] = [r.split("\t") for r in (
            tmp_path / f"{encoder}.tsv").read_text().splitlines()]
    for g, w in zip(rows["kernel"], rows["plain"]):
        assert g[:6] + g[9:] == w[:6] + w[9:]
        p, q = np.float32(g[6:8]), np.float32(w[6:8])
        np.testing.assert_allclose(p, q, rtol=0, atol=TF1_PROB_TOL)
        if abs(q[1] - q[0]) > 2 * TF1_PROB_TOL:
            assert g[8] == w[8]


@pytest.mark.cuda
def test_call_freq_on_the_card_calls(cuda_device, tmp_path):
    """``call_freq`` on the calls the card writes (bfloat16, the default):
    every call counted once, at its site."""
    from deepsignal_tpu_torch.runtime.caller import run_call_mods
    from deepsignal_tpu_torch.tools.frequency import \
        call_mods_frequency_to_file
    from deepsignal_tpu_torch.train.checkpoints import (
        save_checkpoint, state_dict_to_variables)
    tt = _tiny()
    cfg = tt.tiny_cfg()
    ckpt = save_checkpoint(str(tmp_path / "m.ckpt"), cfg,
                           state_dict_to_variables(cfg, tt.tiny_state_dict()))
    calls = str(tmp_path / "calls.tsv")
    assert run_call_mods(tt.FEATURES, ckpt, calls, batch_size=16) == \
        tt.N_ROWS
    labels = [int(r.split("\t")[8]) for r in open(calls)]
    stats = call_mods_frequency_to_file([calls], str(tmp_path / "f.tsv"),
                                        is_sort=True)
    freq = [r.split("\t") for r in open(tmp_path / "f.tsv")]
    assert len(freq) == len(stats) == tt.N_ROWS  # one call a site
    assert sum(int(r[8]) for r in freq) == tt.N_ROWS
    assert sum(int(r[6]) for r in freq) == sum(labels)
    assert [int(r[1]) for r in freq] == sorted(int(r[1]) for r in freq)


# --------------------------------------------------------------------------
# InceptionNet's CUDA graph: an inference forward with autograd off replays
# a graph of the eager forward (``layers.graph_takes``)


def _inception(device, seed=0):
    """The published InceptionNet (360 signals, x16, blocks 3/5/3) with
    seeded weights and batch-norm statistics away from zero and one."""
    net = layers.InceptionNet(360)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict(keep_vars=True).items():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("scale", "var"):
                t.uniform_(0.5, 2.0, generator=gen)
            elif leaf in ("bias", "mean"):
                t.normal_(0.0, 0.3, generator=gen)
            else:
                t.normal_(0.0, t[0].numel() ** -0.5, generator=gen)
    return net.to(device)


def _signals(batch, dtype, device, seed, length=360):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 1, length, generator=gen).to(device, dtype)


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _paths(t0):
    return (_counted("inception.graph_replay", t0),
            _counted("inception.eager", t0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [4096, 37])
def test_inception_graph_replay_equals_eager_bits(cuda_device, dtype, batch):
    """The capture's first replay and a later one give the eager forward's
    bits: the same cuDNN and PyTorch kernels, launched from a graph."""
    net = _inception(cuda_device)
    x = _signals(batch, dtype, cuda_device, 1)
    with torch.inference_mode():
        want = net._eager(x, False)
        got = net(x)
        again = net(x)
    assert len(net._graphs) == 1
    assert _same_bits(got, want) and _same_bits(again, want)


@pytest.mark.cuda
def test_inception_graph_outputs_held_at_once_stay_distinct(cuda_device):
    net = _inception(cuda_device)
    x1, x2 = (_signals(64, torch.bfloat16, cuda_device, s) for s in (2, 3))
    with torch.inference_mode():
        want1, want2 = net._eager(x1, False), net._eager(x2, False)
        got1 = net(x1)
        got2 = net(x2)
    assert got1.data_ptr() != got2.data_ptr()
    assert _same_bits(got1, want1) and _same_bits(got2, want2)
    assert not torch.equal(got1, got2)


@pytest.mark.cuda
def test_inception_graph_sees_parameters_changed_in_place(cuda_device):
    """An in-place update (an optimizer's step, batch norm's running
    statistics) shows at the next replay, with no new capture."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 4)
    with torch.inference_mode():
        before = net(x)
    with torch.no_grad():
        net.conv_layer1.weight.mul_(1.5)
        net.incp_layer2.branch2_conv0b.bn.mean.add_(0.25)
    with torch.inference_mode():
        got = net(x)
        want = net._eager(x, False)
    assert len(net._graphs) == 1
    assert _same_bits(got, want) and not torch.equal(got, before)


@pytest.mark.cuda
def test_inception_graph_recaptures_for_assigned_parameters(cuda_device):
    """``load_state_dict(..., assign=True)`` puts new tensors in place: the
    next forward captures anew and reads them."""
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 5)
    with torch.inference_mode():
        before = net(x)
    state = {k: v.clone() * (1.25 if k.endswith("weight") else 1.0)
             for k, v in net.state_dict().items()}
    net.load_state_dict(state, assign=True)
    with torch.inference_mode():
        got = net(x)
        want = net._eager(x, False)
    assert len(net._graphs) == 2
    assert _same_bits(got, want) and not torch.equal(got, before)


@pytest.mark.cuda
def test_inception_graph_cache_keeps_the_newest(cuda_device):
    net = _inception(cuda_device)
    with torch.inference_mode():
        for batch in range(8, 8 + layers.GRAPHS_KEPT + 1):
            net(_signals(batch, torch.bfloat16, cuda_device, batch))
    assert [k[0][0] for k in net._graphs] == list(
        range(9, 9 + layers.GRAPHS_KEPT))


@pytest.mark.cuda
def test_inception_training_and_autograd_never_replay(cuda_device):
    """Training forwards never replay the inference graph and count no
    inference path: with autograd on one replays the training graphs
    (``inception.train_graph_replay``), under ``no_grad`` one runs eagerly
    (``inception.train_eager``); an inference forward with autograd on
    runs eagerly and counts as ``eager``."""
    import time
    net = _inception(cuda_device)
    x = _signals(64, torch.float32, cuda_device, 6)
    t0 = time.perf_counter()
    net(x, train=True).sum().backward()
    with torch.no_grad():
        net(x, train=True)
    assert _paths(t0) == (0, 0)
    assert (_counted("inception.train_graph_replay", t0),
            _counted("inception.train_eager", t0)) == (1, 1)
    assert len(net._train_graphs) == 1
    t0 = time.perf_counter()
    got = net(x)
    assert got.requires_grad
    assert _paths(t0) == (0, 1)
    assert len(net._graphs) == 0


@pytest.mark.cuda
def test_inception_counts_each_inference_forward_by_path(cuda_device):
    import time
    net = _inception(cuda_device)
    x = _signals(64, torch.bfloat16, cuda_device, 7)
    t0 = time.perf_counter()
    with torch.inference_mode():
        net(x)
        net(x)
    with torch.no_grad():
        net(x)
    net(x)
    assert _paths(t0) == (3, 1)


@pytest.mark.cuda
def test_call_block_is_the_same_with_graph_and_eager_forwards(cuda_device):
    """A ``ModCaller`` call block in bfloat16 is byte for byte the same
    whether Inception replays its graph or runs eagerly."""
    import dataclasses
    import time

    from deepsignal_tpu_torch.io.feature_codec import parse_feature_lines
    from deepsignal_tpu_torch.runtime.caller import ModCaller
    from deepsignal_tpu_torch.train.checkpoints import state_dict_to_variables
    tt = _tiny()
    cfg = dataclasses.replace(tt.tiny_cfg(), compute_dtype="bfloat16")
    with open(tt.FEATURES) as f:
        fb = parse_feature_lines(f.read().splitlines())
    caller = ModCaller(cfg, state_dict_to_variables(cfg, tt.tiny_state_dict()),
                       batch_size=16, device=cuda_device)
    batches = -(-len(fb) // 16)
    t0 = time.perf_counter()
    graph_block = caller.collect_block(caller.dispatch_feature_batch(fb))[0]
    assert _paths(t0) == (batches, 0)
    t0 = time.perf_counter()
    with mock.patch.object(layers, "graph_takes", lambda *a: False):
        eager_block = caller.collect_block(
            caller.dispatch_feature_batch(fb))[0]
    assert _paths(t0) == (0, batches)
    assert len(graph_block.splitlines()) == len(fb)
    assert graph_block == eager_block


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_on_the_card_bits_equal_the_new_tensor_formula(
        cuda_device, dtype, train):
    """Batch norm's epsilon, filled on the card, gives the bits of
    ``var.new_tensor(eps)``, output and gradients (the CPU test's case on
    the card, where a Python-scalar epsilon would add in float32)."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import test_torch_inception_graph as on_cpu
    bn, gen = on_cpu._bn(3)
    bn = bn.to(cuda_device)
    x = (torch.randn(16, 512, 9, generator=gen) * 0.01).to(cuda_device, dtype)
    outs, grads = [], []
    for fn in (lambda x: bn(x, train),
               lambda x: on_cpu._bn_before(bn, x, train)):
        xi = x.clone().requires_grad_(train)
        outs.append(fn(xi))
        if train:
            bn.zero_grad()
            outs[-1].float().square().sum().backward()
            grads.append([xi.grad, bn.scale.grad, bn.bias.grad])
    assert _same_bits(*outs)
    for got, want in zip(*grads):
        assert _same_bits(got, want)
