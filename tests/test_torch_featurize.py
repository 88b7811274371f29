"""The port's featurizer against the JAX package's, piece by piece, bit for
bit: the motif helpers, the signal normalization, the per-event statistics
(native and plain), the central-signal window with its subsample, the
6-decimal text (native and plain), whole reads, and the golden rows of
``tests/golden/features_golden.tsv`` from fast5 files and from in-memory
reads."""

import os
import random

import numpy as np
import pytest
import torch

from deepsignal_tpu import _featkernel as jax_featkernel
from deepsignal_tpu.core import constants as jax_constants
from deepsignal_tpu.core.config import FeatureConfig as JaxFeatureConfig
from deepsignal_tpu.featurize import central as jax_central
from deepsignal_tpu.featurize import extractor as jax_extractor
from deepsignal_tpu.featurize import signal as jax_signal
from deepsignal_tpu.io import fasta as jax_fasta
from deepsignal_tpu.io.fast5 import \
    read_resquiggled_fast5 as jax_read_fast5
from deepsignal_tpu_torch.core import constants
from deepsignal_tpu_torch.core.config import FeatureConfig
from deepsignal_tpu_torch.featurize import central, extractor, signal
from deepsignal_tpu_torch.io import fasta, native
from deepsignal_tpu_torch.io.fast5 import (read_resquiggled_fast5,
                                           synthetic_read,
                                           write_synthetic_fast5)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "features_golden.tsv")


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def _read_args(rng, i, n_bases, strand="+", chrom="chr1"):
    seq = "".join(np.array(list("ACGT"))[rng.integers(0, 4, n_bases)])
    lengths = rng.integers(3, 22, size=n_bases)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    raw = rng.integers(380, 920, size=int(lengths.sum()) + 5).astype(np.int16)
    return dict(read_id=f"read-{i}", raw_signal=raw, event_starts_rel=starts,
                event_lengths=lengths, seq=seq, mapped_chrom=chrom,
                mapped_start=500 * i, mapped_strand=strand,
                read_start_rel_to_raw=2)


# --------------------------------------------------------------------------
# motif and sequence helpers


@pytest.mark.parametrize("motifs,is_dna", [
    ("CG", True), ("CHG,CHH", True), ("GATC, CG", True), ("RRACH", True),
    ("DRACH", False), ("cg", True), ("NNCGN", True)])
def test_motif_seqs_match_jax(motifs, is_dna):
    assert constants.get_motif_seqs(motifs, is_dna) == \
        jax_constants.get_motif_seqs(motifs, is_dna)


def test_bad_iupac_letter_raises_as_in_jax():
    for mod in (constants, jax_constants):
        with pytest.raises(KeyError, match="invalid IUPAC letter"):
            mod.get_motif_seqs("CXG")


@pytest.mark.parametrize("is_dna", [True, False])
@pytest.mark.parametrize("motifs,mod_loc", [("CG", 0), ("CHG", 0),
                                            ("GATC", 1), ("DRACH", 2)])
def test_motif_sites_match_jax(is_dna, motifs, mod_loc):
    rng = np.random.default_rng(3)
    letters = list("ACGT" if is_dna else "ACGU") + ["N"]
    seq = "".join(rng.choice(letters, 2000, p=[.24, .24, .24, .24, .04]))
    if not is_dna:
        motifs = motifs.replace("T", "U")
    mseqs = constants.get_motif_seqs(motifs, is_dna)
    got = constants.motif_sites_in_seq(seq, mseqs, mod_loc, is_dna)
    want = jax_constants.motif_sites_in_seq(seq, mseqs, mod_loc, is_dna)
    assert got.size and _bits_equal(got, want)
    codes = constants.encode_seq(seq, is_dna)
    assert _bits_equal(codes, jax_constants.encode_seq(seq, is_dna))
    assert constants.decode_seq(codes, is_dna) == \
        jax_constants.decode_seq(codes, is_dna)
    kind = "DNA" if is_dna else "RNA"
    assert constants.complement_seq(seq, kind) == \
        jax_constants.complement_seq(seq, kind)


def test_motifs_of_other_lengths_raise():
    with pytest.raises(ValueError, match="same length"):
        constants.motif_sites_in_seq("ACGT", ["CG", "CHG"])


def test_feature_config_defaults_and_checks_match_jax():
    import dataclasses
    assert dataclasses.asdict(FeatureConfig()) == \
        dataclasses.asdict(JaxFeatureConfig())
    for bad in (dict(kmer_len=16), dict(normalize_method="median")):
        with pytest.raises(ValueError):
            FeatureConfig(**bad)


def test_fasta_matches_jax(tmp_path):
    path = tmp_path / "ref.fa"
    path.write_text(">chr1 first contig\nacgt\nNNCG\n>chr2\nGGCC\n>empty\n")
    assert fasta.read_fasta(str(path)) == jax_fasta.read_fasta(str(path))
    assert fasta.get_contig2len(str(path)) == \
        jax_fasta.get_contig2len(str(path)) == {"chr1": 8, "chr2": 4,
                                                "empty": 0}


# --------------------------------------------------------------------------
# signal math


@pytest.mark.parametrize("method", ["mad", "zscore"])
@pytest.mark.parametrize("n", [1, 2, 101, 5000])
def test_normalize_signals_match_jax(method, n):
    rng = np.random.default_rng(n)
    raw = rng.integers(380, 920, n).astype(np.int16)
    pa = signal.rescale_signals(raw, 1402.882 / 8192.0, 6.0)
    assert _bits_equal(pa, jax_signal.rescale_signals(raw, 1402.882 / 8192.0,
                                                      6.0))
    with np.errstate(all="ignore"):
        got = signal.normalize_signals(pa, method)
        want = jax_signal.normalize_signals(pa, method)
    assert _bits_equal(got, want)


@pytest.mark.parametrize("n", [11, 100, 1000, 1001])
def test_native_normalize_mad_matches_jax_and_numpy(n):
    x = np.random.default_rng(n).standard_normal(n) * 40 + 420
    got = native.normalize_mad(x)
    assert _bits_equal(got, jax_featkernel.normalize_mad(x))
    assert _bits_equal(got, signal.normalize_signals(x, "mad"))


def test_segment_stats_native_plain_and_jax_agree():
    rng = np.random.default_rng(5)
    lengths = np.concatenate([np.array(signal.PROBE_LENGTHS),
                              rng.integers(1, 300, 400)]).astype(np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    norm = np.round(rng.standard_normal(int(lengths.sum())), 6)
    order = rng.permutation(len(starts))  # segments in any order
    got = signal.segment_stats(norm, starts[order], lengths[order])
    plain = signal.segment_stats_plain(norm, starts[order], lengths[order])
    want = jax_signal.segment_stats(norm, starts[order], lengths[order])
    for g, p, w in zip(got, plain, want):
        assert _bits_equal(g, p) and _bits_equal(g, w)


@pytest.mark.parametrize("starts,lengths,match", [
    ([0, 3], [3, 0], "positive"), ([0, 8], [3, 3], "past end")])
def test_segment_stats_refuse_bad_segments(starts, lengths, match):
    norm = np.zeros(10)
    for fn in (signal.segment_stats, signal.segment_stats_plain):
        with pytest.raises(ValueError, match=match):
            fn(norm, np.array(starts), np.array(lengths))
    with pytest.raises(ValueError, match="out of bounds"):
        native.segment_stats(norm, np.array(starts), np.array(lengths))


def test_segment_stats_counts_its_calls_but_not_the_check():
    signal.featurizer_checked.cache_clear()
    before = native.segment_stats.calls
    signal.segment_stats(np.zeros(4), np.array([0, 2]), np.array([2, 2]))
    assert native.segment_stats.calls == before + 1


# --------------------------------------------------------------------------
# the central window


def _windows(rng, n_events, k, oversized=()):
    lengths = rng.integers(1, 12, n_events).astype(np.int64)
    for i in oversized:
        lengths[i] = 40 + i
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    norm = np.round(rng.standard_normal(int(lengths.sum())), 6)
    half = k // 2
    sites = np.arange(half, n_events - half)
    win = sites[:, None] + np.arange(-half, half + 1)[None, :]
    return norm, starts, lengths, win


@pytest.mark.parametrize("cent_len", [24, 40, 360])
def test_central_signals_match_jax_with_the_subsample(cent_len):
    rng = np.random.default_rng(cent_len)
    # a middle base of 40+ signals is oversized for 24 and 40: the subsample
    norm, starts, lengths, win = _windows(rng, 60, 5, oversized=(10, 31))
    got = central.central_signals_batch(norm, starts, lengths, win, cent_len,
                                        random.Random("7:r"))
    want = jax_central.central_signals_batch(norm, starts, lengths, win,
                                             cent_len, random.Random("7:r"))
    assert _bits_equal(got, want)
    # the scalar rule of the reference's list API agrees, site by site
    rng_a, rng_b = random.Random(1), random.Random(1)
    for w in win[:12]:
        segs = [norm[s:s + n] for s, n in zip(starts[w], lengths[w])]
        assert _bits_equal(
            central.get_central_signals(segs, cent_len, rng_a),
            jax_central.get_central_signals(segs, cent_len, rng_b))


def test_central_signals_of_a_read_shorter_than_the_window():
    rng = np.random.default_rng(2)
    norm, starts, lengths, win = _windows(rng, 9, 5)
    got = central.central_signals_batch(norm, starts, lengths, win, 360)
    assert _bits_equal(got, jax_central.central_signals_batch(
        norm, starts, lengths, win, 360))


# --------------------------------------------------------------------------
# the 6-decimal text


def _text_probe():
    rng = np.random.RandomState(4)
    lo, hi = native.positional_range(np.float64)
    return np.concatenate([np.around(np.concatenate([
        rng.standard_normal(512) * 10, rng.standard_normal(64) * 1e-4,
        rng.uniform(1e8, 2e9, 64), -rng.uniform(1e8, 2e9, 64),
        np.array([0.0, -0.0, 1e-7, -1e-7, 2.0, 0.25, 1e-4, -1e-4, 9.9999e-5,
                  1e9, 1e15, 1e16, 1e17, 123456789.123456, 1e300, 5e-324,
                  np.inf, -np.inf, np.nan])]), 6),
        [np.nextafter(v, to) for v in (lo, hi, 1e-4, 1e9)
         for to in (0.0, np.inf)]])


def test_format_rows6_matches_jax_and_str():
    probe = _text_probe()
    x = np.resize(probe, (-(-probe.size // 4), 4))
    got = native.format_rows6(x)
    assert got == jax_featkernel.format_rows6(x)
    assert got == signal.format_rows6_plain(x)
    assert native.format_rows6(np.zeros((0, 3))) == []


def test_format_rows6_counts_its_calls():
    before = native.format_rows6.calls
    native.format_rows6(np.ones((2, 2)))
    assert native.format_rows6.calls == before + 1


def test_positional_range_of_float64_is_numpys():
    lo, hi = native.positional_range(np.float64)
    for v in (lo, np.nextafter(hi, 0.0)):
        assert "e" not in str(np.float64(v))
    for v in (np.nextafter(lo, 0.0), hi):
        assert "e" in str(np.float64(v))


def test_a_native_featurizer_that_differs_raises(monkeypatch):
    real = native.segment_stats

    def off_by_one_ulp(*args):
        means, stds = real(*args)
        return np.nextafter(means, np.inf), stds
    off_by_one_ulp.calls = 0
    monkeypatch.setattr(native, "segment_stats", off_by_one_ulp)
    signal.featurizer_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="segment mean differs"):
            signal.segment_stats(np.zeros(4), np.array([0]), np.array([2]))
    finally:
        monkeypatch.undo()
        signal.featurizer_checked.cache_clear()


def test_a_float64_positional_range_other_than_numpys_raises(monkeypatch):
    installed = native.positional_range
    monkeypatch.setattr(native, "positional_range",
                        lambda dtype=np.float32: (1e-4, 1e8)
                        if dtype is np.float64 else installed(dtype))
    signal.featurizer_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="6-decimal text differs"):
            signal.featurizer_checked()
    finally:
        monkeypatch.undo()
        signal.featurizer_checked.cache_clear()


# --------------------------------------------------------------------------
# whole reads


def _golden_args():
    """The three reads of tests/test_golden.py's fixture, drawn as it draws
    them."""
    rng = np.random.default_rng(424242)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 3000)])
    out = []
    for i, strand in enumerate(["+", "-", "+"]):
        start = 700 * i
        seq = genome[start:start + 250]
        lengths = rng.integers(3, 22, size=len(seq))
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        raw = rng.integers(380, 920,
                           size=int(lengths.sum()) + 7).astype(np.int16)
        out.append(dict(read_id=f"golden-{i}", raw_signal=raw,
                        event_starts_rel=starts, event_lengths=lengths,
                        seq=seq, mapped_chrom="chrG", mapped_start=start,
                        mapped_strand=strand, read_start_rel_to_raw=4))
    return out


@pytest.mark.parametrize("source", ["fast5", "memory"])
def test_golden_rows(tmp_path, source):
    items = []
    for i, kw in enumerate(_golden_args()):
        if source == "fast5":
            path = str(tmp_path / f"g{i}.fast5")
            write_synthetic_fast5(path, **kw)
            items.append(path)
        else:
            items.append(synthetic_read(**kw))
    feats, errors = extractor.extract_fast5_batch(
        items, constants.get_motif_seqs("CG"),
        FeatureConfig(central_sample_seed=99), chrom2len={"chrG": 3000})
    assert errors == 0
    with open(GOLDEN) as f:
        want = f.read().splitlines()
    assert [r for f in feats for r in f.to_tsv_rows()] == want
    assert [r for f in feats for r in f.to_tsv_rows_plain()] == want


def test_fast5_reader_matches_jax_and_the_in_memory_read(tmp_path):
    kw = _read_args(np.random.default_rng(9), 3, 200, strand="-")
    path = str(tmp_path / "r.fast5")
    write_synthetic_fast5(path, **kw)
    got = read_resquiggled_fast5(path)
    want = jax_read_fast5(path)
    mem = synthetic_read(**kw)
    for name in ("raw_signal", "event_starts", "event_lengths"):
        assert _bits_equal(getattr(got, name), getattr(want, name))
        assert _bits_equal(getattr(got, name), getattr(mem, name))
    for name in ("read_id", "seq", "read_strand", "align_strand", "chrom",
                 "chrom_start", "scaling", "offset"):
        assert getattr(got, name) == getattr(want, name) == getattr(mem, name)


def test_a_fast5_without_alignment_reads_as_none(tmp_path):
    kw = _read_args(np.random.default_rng(1), 0, 50)
    path = str(tmp_path / "r.fast5")
    write_synthetic_fast5(path, corrected_group="Other_000", **kw)
    assert read_resquiggled_fast5(path) is None
    feats, errors = extractor.extract_fast5_batch(
        [path, str(tmp_path / "missing.fast5")],
        constants.get_motif_seqs("CG"), FeatureConfig())
    assert feats == [] and errors == 2


@pytest.mark.parametrize("cfg_kwargs,with_ref,with_positions", [
    (dict(kmer_len=5, cent_signals_len=24), True, False),
    (dict(kmer_len=5, cent_signals_len=24, normalize_method="zscore"), False,
     True),
    (dict(kmer_len=7, cent_signals_len=24, motifs="CHG", mod_loc=0), True,
     True),
    (dict(kmer_len=5, cent_signals_len=24, is_dna=False, motifs="DRACH",
          mod_loc=2), False, False),
    (dict(kmer_len=17, cent_signals_len=360, central_sample_seed=None), True,
     False),
])
def test_read_features_match_jax(cfg_kwargs, with_ref, with_positions):
    rng = np.random.default_rng(21)
    is_dna = cfg_kwargs.get("is_dna", True)
    cfg, jcfg = FeatureConfig(**cfg_kwargs), JaxFeatureConfig(**cfg_kwargs)
    mseqs = constants.get_motif_seqs(cfg.motifs, is_dna)
    chrom2len = {"chr1": 10 ** 6} if with_ref else None
    for i, strand in enumerate("+-"):
        kw = _read_args(rng, i, 400, strand=strand)
        if not is_dna:
            kw["seq"] = kw["seq"].replace("T", "U")
        read = synthetic_read(**kw)
        positions = None
        if with_positions:
            allp = jax_extractor.extract_read_features(
                read, mseqs, jcfg, chrom2len).pos
            positions = {f"chr1||{p}||{strand}" for p in allp[::3]}
        # a seed of None draws from the global random module: the same state
        # for both
        random.seed(5)
        got = extractor.extract_read_features(read, mseqs, cfg, chrom2len,
                                              positions)
        random.seed(5)
        want = jax_extractor.extract_read_features(read, mseqs, jcfg,
                                                   chrom2len, positions)
        assert got is not None and len(got) == len(want) > 0
        for name in ("pos", "pos_in_strand", "kmers", "means", "stds", "lens",
                     "cent_signals"):
            assert _bits_equal(getattr(got, name), getattr(want, name)), name
        assert got.to_tsv_rows() == want.to_tsv_rows()
        assert got.to_tsv_rows_plain() == want.to_tsv_rows()
        fb, jfb = (extractor.read_features_to_batch([got, got]),
                   jax_extractor.read_features_to_batch([want, want]))
        assert fb.sampleinfo == jfb.sampleinfo
        for name in ("kmers", "means", "stds", "lens", "signals", "labels"):
            assert _bits_equal(getattr(fb, name), getattr(jfb, name)), name


def test_stream_batch_keeps_unrounded_float32_means():
    read = synthetic_read(**_read_args(np.random.default_rng(4), 0, 300))
    feats = extractor.extract_read_features(
        read, ["CG"], FeatureConfig(kmer_len=5, cent_signals_len=24))
    fb = extractor.read_features_to_batch([feats])
    assert _bits_equal(fb.means, feats.means.astype(np.float32))
    assert not _bits_equal(fb.means,
                           np.around(feats.means, 6).astype(np.float32))
    assert extractor.read_features_to_batch([]) is None


def test_position_file_matches_jax(tmp_path):
    path = tmp_path / "pos.tsv"
    path.write_text("chr1\t10\t+\nchr2\t7\t-\textra\n")
    assert extractor.read_position_file(str(path)) == \
        jax_extractor.read_position_file(str(path)) == \
        {"chr1||10||+", "chr2||7||-"}
