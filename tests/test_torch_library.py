"""The JAX package's library calls in the port, each held against the JAX
function on the CPU: ``ModCaller.call_feature_batch``/``collect``,
``ModRecord.to_line``, the batch metrics, ``forward_with_loss``,
``parse_feature_lines``' widths, ``extract_fast5_batch``'s ``fast5_paths``
and the subpackages' exports."""

import functools
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsignal_tpu.core.config import ModelConfig as JaxModelConfig
from deepsignal_tpu.featurize import extractor as jax_extractor
from deepsignal_tpu.io import calls_codec as jax_calls
from deepsignal_tpu.io import feature_codec as jax_features
from deepsignal_tpu.models import deepsignal as jax_model
from deepsignal_tpu.runtime.caller import ModCaller as JaxModCaller
from deepsignal_tpu.train import checkpoints as jax_checkpoints
from deepsignal_tpu.train import metrics as jax_metrics
from deepsignal_tpu_torch.core.config import FeatureConfig
from deepsignal_tpu_torch.core.constants import get_motif_seqs
from deepsignal_tpu_torch.featurize.extractor import extract_fast5_batch
from deepsignal_tpu_torch.io.calls_codec import ModRecord
from deepsignal_tpu_torch.io.feature_codec import (parse_feature_lines,
                                                   parse_feature_lines_plain)
from deepsignal_tpu_torch.models import forward_with_loss
from deepsignal_tpu_torch.runtime.caller import ModCaller
from deepsignal_tpu_torch.train import checkpoints
from deepsignal_tpu_torch.train import metrics
from tests import torch_tiny as tt
from tests.test_torch_api_parity import api

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
FAST5 = REPO / "tests" / "fixtures" / "fast5" / "tombo_like.fast5"
PROB_TOL = 1e-5  # float32 sums in another order
LOSS_RTOL = 1e-6
# bfloat16 keeps 8 significant bits and both sides round after each
# elementwise op, XLA's fusion and torch's kernels not always after the same
# ones: the mean may come out one bfloat16 ulp apart (2**-7 relative at
# most)
LOSS_ULPS_BF16 = 1


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny model's weights in a checkpoint written by the JAX
    package."""
    cfg = tt.tiny_cfg()
    path = tmp_path_factory.mktemp("library") / "model.ckpt"
    return jax_checkpoints.save_checkpoint(
        str(path), JaxModelConfig(**tt.TINY),
        checkpoints.state_dict_to_variables(cfg, tt.tiny_state_dict()))


@pytest.fixture(scope="module")
def lines():
    return tt.tiny_feature_rows()


@functools.cache
def _jax_caller(path: str) -> JaxModCaller:
    cfg, variables = jax_checkpoints.load_checkpoint(path)
    return JaxModCaller(cfg, variables, batch_size=4096)


def _port_caller(path: str, batch_size: int) -> ModCaller:
    cfg, variables = checkpoints.load_checkpoint(path)
    return ModCaller(cfg, variables, batch_size=batch_size, device="cpu")


@pytest.mark.parametrize("batch_size,is_dna", [(4096, True), (8, True),
                                               (4096, False)])
def test_call_feature_batch_matches_jax(ckpt, lines, batch_size, is_dna):
    rows, pred, (p0, p1) = _port_caller(ckpt, batch_size).call_feature_batch(
        parse_feature_lines(lines), is_dna=is_dna)
    want_rows, want_pred, (w0, w1) = _jax_caller(ckpt).call_feature_batch(
        jax_features.parse_feature_lines(lines), is_dna=is_dna)
    assert len(rows) == len(want_rows) == tt.N_ROWS
    assert pred.dtype == np.int64 and p0.dtype == p1.dtype == np.float32
    np.testing.assert_array_equal(pred, np.asarray(want_pred))
    np.testing.assert_allclose(p0, w0, rtol=0, atol=PROB_TOL)
    np.testing.assert_allclose(p1, w1, rtol=0, atol=PROB_TOL)
    for got, want, i in zip(rows, want_rows, range(len(rows))):
        assert "\n" not in got
        g, w = got.split("\t"), want.split("\t")
        assert len(g) == 10 and g[:6] + g[8:] == w[:6] + w[8:]
        assert g[6:8] == [str(p0[i]), str(p1[i])]
    assert 0 < pred.sum() < len(pred)
    if not is_dna:
        assert any("U" in r.split("\t")[9] for r in rows)


def test_collect_and_collect_block_share_a_handle(ckpt, lines):
    caller = _port_caller(ckpt, 16)
    handle = caller.dispatch_feature_batch(parse_feature_lines(lines))
    rows, pred, (p0, p1) = caller.collect(handle)
    block, pred_b, (q0, q1) = caller.collect_block(handle)
    again, _, _ = caller.collect(handle)
    assert "".join(r + "\n" for r in rows).encode() == block
    assert again == rows
    for a, b in ((pred, pred_b), (p0, q0), (p1, q1)):
        np.testing.assert_array_equal(a, b)


def test_call_mods_on_batches_still_writes_through_collect_block(
        ckpt, lines, tmp_path, monkeypatch):
    from deepsignal_tpu_torch.runtime import caller as caller_mod
    caller = _port_caller(ckpt, 16)
    monkeypatch.setattr(caller, "collect", None)  # the path must not use it
    out = tmp_path / "calls.tsv"
    n = caller_mod.call_mods_on_batches(caller, [parse_feature_lines(lines)],
                                        str(out))
    rows, _, _ = _port_caller(ckpt, 16).call_feature_batch(
        parse_feature_lines(lines))
    assert n == len(rows)
    assert out.read_text() == "".join(r + "\n" for r in rows)


def _golden_rows() -> list:
    with open(tt.CALLS_F32) as f:
        return f.read().splitlines()


HAND_ROWS = [
    "chr1\t7\t+\t7\tr0\tt\t1e-05\t0.99999\t1\tACGTA",
    "chr1\t8\t-\t3\tr0\tc\t0.1\t0.9\t1\tCGCGT",
    "chrM\t9\t+\t9\tr1\tt\t1.0\t0.0\t0\tNNNNN",
    "chr2\t10\t+\t10\tr1\tt\t0.30000001\t0.69999999\t1\tACGTU",
    "chr2\t11\t-\t11\tr2\tt\t1.2345e-07\t0.99999988\t1\tTTTTT",
    "chr3\t0\t+\t0\tr2\tt\t0.5\t0.5\t0\tGGGGG",
]


@pytest.mark.parametrize("case", ["golden", *range(len(HAND_ROWS))])
def test_mod_record_to_line_matches_jax(case):
    rows = _golden_rows() if case == "golden" else [HAND_ROWS[case]]
    assert rows
    for row in rows:
        words = row.split("\t")
        got = ModRecord.from_fields(words).to_line()
        assert got == jax_calls.ModRecord.from_fields(words).to_line()
        # a row written from float32 probabilities reads back as itself
        assert got == row


def _label_cases(rng):
    y = rng.integers(0, 2, 64)
    return {
        "random": (y, rng.integers(0, 2, 64)),
        "all_negatives": (np.zeros(64, np.int64), rng.integers(0, 2, 64)),
        "no_predicted_positives": (y, np.zeros(64, np.int64)),
        "all_correct": (y, y.copy()),
    }


METRIC_CASES = ["random", "all_negatives", "no_predicted_positives",
                "all_correct"]


@pytest.mark.parametrize("case", METRIC_CASES)
@pytest.mark.parametrize("name", ["accuracy", "binary_recall",
                                  "binary_precision"])
def test_host_metrics_match_jax(case, name):
    y_true, y_pred = _label_cases(np.random.default_rng(5))[case]
    got = getattr(metrics, name)(y_true, y_pred)
    assert type(got) is float
    assert got == getattr(jax_metrics, name)(y_true, y_pred)
    assert got == getattr(metrics, name)(list(y_true), list(y_pred))


@pytest.mark.parametrize("case", METRIC_CASES)
@pytest.mark.parametrize("class_num", [2, 3])
def test_batch_metrics_match_jax_and_the_counts(case, class_num):
    rng = np.random.default_rng(7)
    y_true, y_pred = _label_cases(rng)[case]
    if class_num == 3 and case == "random":
        y_true, y_pred = rng.integers(0, 3, 64), rng.integers(0, 3, 64)
    got = metrics.batch_metrics(y_true, y_pred, class_num)
    assert got == jax_metrics.batch_metrics(y_true, y_pred, class_num)
    counts = metrics.metric_counts(torch.from_numpy(y_pred),
                                   torch.from_numpy(y_true),
                                   torch.ones(len(y_true)))
    assert got == metrics.counts_to_metrics(counts, class_num)


@functools.cache
def _jax_loss():
    return jax.jit(jax_model.forward_with_loss, static_argnums=(2, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos_weight", [1.0, 2.5])
def test_forward_with_loss_matches_jax(dtype, pos_weight):
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 3, (257, 2)).astype(np.float32)
    labels = rng.integers(0, 2, 257)
    got = forward_with_loss(
        torch.from_numpy(logits).to(getattr(torch, dtype)),
        torch.from_numpy(labels), 2, pos_weight)
    want = _jax_loss()(jnp.asarray(logits, dtype=dtype), jnp.asarray(labels),
                       2, pos_weight)
    assert got.dtype == getattr(torch, dtype) and got.shape == ()
    assert str(want.dtype) == dtype
    got, want = float(got), float(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(abs(want))) - 7)
        assert abs(got - want) <= LOSS_ULPS_BF16 * ulp


def test_forward_with_loss_forms_differ():
    """The pos_weight rule picks the form: at 1.0 the one-hot grid, else
    the class-1 logit alone."""
    logits = torch.tensor([[2.0, -1.0], [0.5, 0.25]])
    labels = torch.tensor([1, 0])
    one_hot = forward_with_loss(logits, labels, 2, 1.0)
    class1 = forward_with_loss(logits, labels, 2, 1.0 + 1e-9)
    assert abs(float(one_hot) - float(class1)) > 0.1


def _batches_equal(got, want) -> None:
    assert got.sampleinfo == want.sampleinfo
    for name in ("kmers", "means", "stds", "lens", "signals", "labels"):
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _jax_parse(lines, native: bool, **widths):
    if native:
        pytest.importorskip("deepsignal_tpu._fastparse")
        return jax_features.parse_feature_lines(lines, **widths)
    saved = jax_features._native
    jax_features._native = None
    try:
        return jax_features.parse_feature_lines(lines, **widths)
    finally:
        jax_features._native = saved


WIDTHS = {
    "given": dict(kmer_len=tt.K, signal_len=tt.S),
    "probed": {},
    "one_given": dict(kmer_len=tt.K - 2),
    "narrower": dict(kmer_len=tt.K - 2, signal_len=tt.S - 5),
    "kmer_wider": dict(kmer_len=tt.K + 1, signal_len=tt.S),
    "signal_wider": dict(kmer_len=tt.K, signal_len=tt.S + 1),
}


@pytest.mark.parametrize("parser", ["native", "plain"])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_parse_feature_lines_widths_match_jax(lines, parser, widths):
    kw = WIDTHS[widths]
    port = parse_feature_lines if parser == "native" else \
        parse_feature_lines_plain
    try:
        want = _jax_parse(lines, parser == "native", **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port(lines, **kw)
        assert str(got.value) == str(e)
        return
    got = port(lines, **kw)
    _batches_equal(got, want)
    if parser == "native" and widths == "narrower":
        assert got.kmers.shape == (tt.N_ROWS, tt.K - 2)
        assert got.signals.shape == (tt.N_ROWS, tt.S - 5)
    elif parser == "native" and widths.endswith("wider"):
        pytest.fail("the JAX native parser took rows narrower than asked")
    else:
        assert got.signals.shape == (tt.N_ROWS, tt.S)


def test_extract_fast5_batch_takes_fast5_paths_by_keyword():
    cfg = FeatureConfig(central_sample_seed=99)
    motifs = get_motif_seqs("CG")
    by_kw, errors = extract_fast5_batch(fast5_paths=[str(FAST5)],
                                        motif_seqs=motifs, cfg=cfg)
    by_pos, _ = extract_fast5_batch([str(FAST5)], motifs, cfg)
    want, want_errors = jax_extractor.extract_fast5_batch(
        fast5_paths=[str(FAST5)], motif_seqs=motifs, cfg=cfg)
    rows = [r for f in by_kw for r in f.to_tsv_rows()]
    assert errors == want_errors == 0 and rows
    assert rows == [r for f in by_pos for r in f.to_tsv_rows()]
    assert rows == [r for f in want for r in f.to_tsv_rows()]


def _jax_exports() -> dict:
    """{subpackage: names its ``__init__.py`` exports} of the JAX package,
    read with ``ast``."""
    out = {}
    for init in sorted((REPO / "deepsignal_tpu").glob("*/__init__.py")):
        names = list(api(init, with_imports=False))
        if names:
            out[init.parent.name] = names
    return out


EXPORTS = _jax_exports()
# what the spawned extract workers and reader process import: no torch
HOST_ONLY = ("core", "featurize", "io", "ops", "parallel", "runtime",
             "tools", "train")


def test_the_jax_package_exports_what_the_port_mirrors():
    assert EXPORTS == {
        "core": ["constants", "config"], "featurize": ["signal", "central"],
        "io": ["fasta", "feature_codec", "calls_codec"],
        "models": ["DeepSignalNet", "forward_with_loss", "predictions"],
        "ops": ["bilstm"], "parallel": ["mesh"],
        "runtime": ["caller", "pipeline"], "tools": ["frequency", "dataset"],
        "train": ["checkpoints"]}


@pytest.mark.parametrize("package", sorted(EXPORTS))
def test_subpackage_exports_in_a_fresh_interpreter(package):
    """Each subpackage imports alone, loads and builds no native library,
    imports no JAX (and, where the spawned host processes import it, no
    torch), and every name the JAX package's ``__init__.py`` exports is
    reachable under the same name."""
    build = REPO / "build" / "deepsignal_tpu_torch"
    before = sorted(os.listdir(build)) if build.is_dir() else []
    code = (
        "import importlib, sys\n"
        f"pkg = importlib.import_module('deepsignal_tpu_torch.{package}')\n"
        "mods = sorted(sys.modules)\n"
        "from deepsignal_tpu_torch.ops.cuda import build\n"
        "from deepsignal_tpu_torch.io import native\n"
        "loaded = [f.__name__ for f in (native._fastparse, native._callfmt,\n"
        "          native._featkernel) if f.cache_info().currsize]\n"
        "print(sorted(build._loaded), loaded,\n"
        "      [m for m in mods if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'deepsignal_tpu')], 'torch' in mods)\n"
        f"for name in {EXPORTS[package]!r}:\n"
        "    obj = getattr(pkg, name)\n"
        "    assert obj is getattr(importlib.import_module(\n"
        f"        'deepsignal_tpu_torch.{package}'), name), name\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    torch_in = package not in HOST_ONLY
    assert out.stdout.strip() == f"[] [] [] {torch_in}"
    after = sorted(os.listdir(build)) if build.is_dir() else []
    assert after == before
    pkg = importlib.import_module(f"deepsignal_tpu_torch.{package}")
    for name in EXPORTS[package]:
        assert getattr(pkg, name) is not None
