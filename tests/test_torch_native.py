"""The port's host C++ code (``io/native.py``: the block parser of
``csrc/fastparse.cpp`` and the call-row formatter of ``csrc/callfmt.cpp``)
against the JAX package's native modules and against the port's own plain
versions, bit for bit and byte for byte."""

import numpy as np
import pytest

from deepsignal_tpu import _featkernel as jax_featkernel
from deepsignal_tpu import _fastparse as jax_fastparse
from deepsignal_tpu_torch.io import calls_codec, feature_codec, native
from deepsignal_tpu_torch.io.feature_codec import format_feature_row
from deepsignal_tpu_torch.ops.cuda import build

K, S = 17, 360


def _rows(rng, n, k=K, s=S):
    bases = np.array(list("ACGTN"))
    return [format_feature_row(
        "chr1", 100 + i, "+-"[i % 2], 100 + i, f"read{i // 7}", "t",
        "".join(bases[rng.integers(0, 5, k)]), rng.normal(0, 1, k),
        np.abs(rng.normal(0.3, 0.1, k)), rng.integers(1, 60, k),
        np.around(rng.normal(0, 1, s), 6), i % 2) for i in range(n)]


def _bits(a):
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_same(port, jax_out):
    """A port FeatureBatch and a JAX ``parse_feature_block`` tuple are equal
    array for array: float32 by their bits, sampleinfo as strings."""
    assert port.sampleinfo == jax_out[0]
    for got, want in zip((port.kmers, port.means, port.stds, port.lens,
                          port.signals, port.labels), jax_out[1:]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_parser_matches_jax_and_plain_on_seeded_rows():
    rows = _rows(np.random.default_rng(3), 300)
    block = ("\n".join(rows) + "\n").encode()
    got = feature_codec.parse_feature_bytes(block)
    _assert_same(got, jax_fastparse.parse_feature_block(block, K, S))
    plain = feature_codec.parse_feature_lines_plain(rows)
    assert got.sampleinfo == plain.sampleinfo
    for a, b in ((got.kmers, plain.kmers), (got.means, plain.means),
                 (got.stds, plain.stds), (got.lens, plain.lens),
                 (got.signals, plain.signals), (got.labels, plain.labels)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    lines = feature_codec.parse_feature_lines(rows)
    _assert_same(lines, jax_fastparse.parse_feature_block(block, K, S))


# values that take from_chars, and values that take strtof (leading blank or
# '+', hex, specials, out of range, subnormal); the last four are accepted
# only as a field's last value, where the parser looks no further
EDGE = ["1.5", "-2.25e-3", "3E5", "-0.0", "0.0", "1e-38", "1.17549435e-38",
        "1e-45", "1.4e-45", "3.4028235e38", ".5", "-.5", "5.", "0.000001",
        "123456789.123", "1.00000005960464477539", "1.00000017881393432617",
        "nan", "-nan", "inf", "-inf", "Infinity", "NAN", " 1.5", "  -7",
        "+2.5", "+.25", "-0x1p-3", "0x1.8p1", "1e50", "-1e50", "1e-50",
        "1e+05", "0000.1250"]
LAST_ONLY = ["1.5e", "2.5e+", "0x", "7.0abc"]
# numpy reads a float32 through float64: a value near a float32 midpoint
# rounds twice (1.00000017881393432617 -> 0x3f800002, strtof 0x3f800001),
# one out of float32's range warns; "-nan" keeps its sign in both, but
# hex is not numpy's
NOT_PLAIN = ("1.00000017881393432617", "1e50", "-1e50", "-0x1p-3", "0x1.8p1")


def _edge_row(vals):
    k = len(vals)
    return "\t".join(["chr1", "5", "+", "5", "r0", "t", ("ACGTN" * k)[:k],
                      ",".join(vals), ",".join(vals), ",".join(["3"] * k),
                      ",".join(vals), "1"])


@pytest.mark.parametrize("value", EDGE + LAST_ONLY)
def test_parser_edge_values_match_jax(value):
    # the value in every float column, first and last of its field
    for vals in (["0.5", value], [value, "0.5"]):
        if value in LAST_ONLY and vals[0] == value:
            continue
        block = (_edge_row(vals) + "\n").encode()
        got = feature_codec.parse_feature_bytes(block, 2, 2)
        _assert_same(got, jax_fastparse.parse_feature_block(block, 2, 2))


def test_parser_edge_values_match_plain_where_numpy_reads_them_alike():
    vals = [v for v in EDGE if v not in NOT_PLAIN]
    row = _edge_row(vals)
    got = feature_codec.parse_feature_bytes((row + "\n").encode())
    plain = feature_codec.parse_feature_lines_plain([row])
    for a, b in ((got.means, plain.means), (got.stds, plain.stds),
                 (got.signals, plain.signals)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    twice = feature_codec.parse_feature_bytes(
        (_edge_row(["1.00000017881393432617"]) + "\n").encode(), 1, 1)
    assert twice.means.view(np.uint32)[0, 0] == 0x3f800001


@pytest.mark.parametrize("block", [
    b"only\tthree\tcols\n",
    b"c\t1\t+\t1\tr\tt\tACG\t1,2,x\t1,2,3\t1,2,3\t1,2\t1\n",
    b"c\t1\t+\t1\tr\tt\tACG\t1,2\t1,2,3\t1,2,3\t1,2\t1\n",
    b"c\t1\t+\t1\tr\tt\tACG\t1,2,3\t1,2,3\t1,2,y\t1,2\t1\n",
    b"c\t1\t+\t1\tr\tt\tACG\t1,2,3\t1,2,3\t1,2,3\t1,2\tlabel\n",
    b"c\t1\t+\t1\tr\tt\tACG\t1,2,3\t1,2,3\t1,2,3\t1,2\t1\n" b"broken\t1\n",
], ids=["columns", "float", "short", "int", "label", "second_row"])
def test_malformed_rows_raise_as_in_jax(block):
    with pytest.raises(ValueError) as jax_err:
        jax_fastparse.parse_feature_block(block, 3, 2)
    with pytest.raises(ValueError) as port_err:
        native.parse_feature_block(block, 3, 2)
    assert str(port_err.value) == str(jax_err.value)


def test_parser_skips_blank_lines_and_takes_crlf():
    rows = _rows(np.random.default_rng(4), 3)
    block = ("\n" + "\r\n\n".join(rows)).encode()
    got = feature_codec.parse_feature_bytes(block)
    assert len(got) == 3
    _assert_same(got, jax_fastparse.parse_feature_block(block, K, S))
    empty = feature_codec.parse_feature_bytes(b"\n\n")
    assert len(empty) == 0


def test_parser_counts_its_calls():
    block = (_rows(np.random.default_rng(5), 2)[0] + "\n").encode()
    before = native.parse_feature_block.calls
    feature_codec.parse_feature_bytes(block)
    assert native.parse_feature_block.calls == before + 1


def test_native_parser_is_faster_than_plain():
    import time
    rows = _rows(np.random.default_rng(6), 400)
    feature_codec.parse_feature_lines(rows[:2])  # built and loaded
    t0 = time.perf_counter()
    feature_codec.parse_feature_lines(rows)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feature_codec.parse_feature_lines_plain(rows)
    plain_s = time.perf_counter() - t0
    assert native_s < plain_s


# --------------------------------------------------------------------------
# the call-row formatter


def test_repr_f32_matches_jax_on_random_bits():
    rng = np.random.default_rng(2024)
    bits = rng.integers(0, 2**32, 200_000, dtype=np.uint64).astype(np.uint32)
    vals = bits.view(np.float32)
    assert native.repr_f32(vals) == jax_featkernel.repr_f32(vals)


def test_repr_f32_matches_jax_and_numpy_at_the_boundaries():
    probe = np.array([0.5, 0.1, 1e-4, 9.9999e-5, 1e-5, 1.2345e-7, 1e-38,
                      1.4e-45, 0.0, -0.0, 1.0, 0.9999999, 123456.0, 1e8,
                      9.999999e15, 1e16, 2 / 3, 1 / 3, np.inf, -np.inf,
                      np.nan, -1.17549435e-38, -0.5, 1.0000001e-4, 3.4e38,
                      -9.999999e15, 1e-45], dtype=np.float32)
    got = native.repr_f32(probe)
    assert got == jax_featkernel.repr_f32(probe) == [str(v) for v in probe]
    assert native.repr_f32(np.zeros(0, np.float32)) == []


@pytest.mark.parametrize("is_dna", [True, False])
def test_format_call_block_matches_jax_and_plain(is_dna):
    rng = np.random.default_rng(7)
    n, k = 500, 17
    info = [f"chr{i % 3}\t{i}\t+\t{i}\tread{i // 50}\tt" for i in range(n)]
    info[3] = "chrÜ\t3\t-\t3\tréad\tc"  # utf-8 beyond ascii
    p1 = rng.random(n).astype(np.float32)
    p1[:8] = np.array([0.0, 1.0, 1e-7, 0.9999999, 0.5, 1e-38, np.nan, 0.25],
                      dtype=np.float32)
    p0 = np.float32(1.0) - p1
    pred = (p1 > 0.5).astype(np.int64)
    pred[9] = -12345678901
    kmers = rng.integers(0, 5, (n, k)).astype(np.int32)
    lut = calls_codec.KMER_LUT_DNA if is_dna else calls_codec.KMER_LUT_RNA
    got = calls_codec.format_call_block(info, p0, p1, pred, kmers, is_dna)
    assert got == jax_featkernel.format_call_block(info, p0, p1, pred, kmers,
                                                   lut.tobytes())
    assert got == calls_codec.format_call_block_plain(info, p0, p1, pred,
                                                      kmers, is_dna)
    empty = calls_codec.format_call_block([], p0[:0], p1[:0], pred[:0],
                                          kmers[:0], is_dna)
    assert empty == b""


def test_repr_f32_follows_a_lower_scientific_bound():
    # numpy after 2.0 prints float32 from 1e8 (or lower) in scientific
    # notation; the formatter takes the bounds it is given
    vals = np.array([123456.0, 99999992.0, 1e8, -3e9, 9.999999e15, 0.25,
                     1e-4, 1.0000001e-4], dtype=np.float32)
    got = native.repr_f32(vals, positional=(1e-4, 1e8))
    want = [str(v) if 1e-4 <= abs(float(v)) < 1e8 else
            np.format_float_scientific(v, trim="-", exp_digits=2)
            for v in vals]
    assert got == want
    assert got[2] == "1e+08" and got[1] == "99999990.0"
    with pytest.raises(ValueError, match="positional range"):
        native.repr_f32(vals, positional=(1e-4, 1e17))


def test_positional_range_is_numpys():
    lo, hi = native.positional_range()
    for v in (lo, hi):
        for to in (0, np.inf):
            x = np.nextafter(np.float32(v), np.float32(to))
            assert ("e" not in str(x)) == (lo <= abs(float(x)) < hi)


def test_format_call_block_rejects_ragged_inputs():
    p = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="length mismatch"):
        native.format_call_block(["a"], p, p, p, np.zeros((2, 3)),
                                 calls_codec.KMER_LUT_DNA)


def test_count_read_runs_matches_jax_and_plain():
    rng = np.random.default_rng(8)
    reads = [f"read{i}" for i in rng.integers(0, 12, 300)]
    info = [f"chr1\t{i}\t+\t{i}\t{r}\tt" for i, r in enumerate(reads)]
    got = calls_codec.count_read_runs(info)
    assert got == jax_featkernel.count_read_runs(info)
    assert got == calls_codec.count_read_runs_plain(info)
    assert got[0] == 1 + sum(a != b for a, b in zip(reads, reads[1:]))
    assert calls_codec.count_read_runs([]) == \
        jax_featkernel.count_read_runs([]) == (0, "", "")
    # a sampleinfo without its 6 fields: both refuse it (the JAX native code
    # reads an empty or a partial read name there, and its plain version
    # raises IndexError)
    for short in (["a\tb", "a\tb\tc\td\tr1", "x"],
                  ["chr1\t7\t+\t7", "a\tb\tc\td\tr1\tt"],
                  ["a\tb\tc\td\tr1\tt", "a\tb\tc\td\tr1"]):
        with pytest.raises(ValueError, match="fewer than 6 fields"):
            native.count_read_runs(short)
        with pytest.raises(ValueError, match="fewer than 6 fields"):
            calls_codec.count_read_runs_plain(short)


def test_a_native_formatter_that_differs_raises(monkeypatch):
    monkeypatch.setattr(native, "repr_f32",
                        lambda x: [str(v) + "0" for v in x])
    calls_codec.native_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="float32 repr differs"):
            calls_codec.format_call_block(["a\tb\tc\td\te\tf"],
                                          np.float32([0.5]), np.float32([0.5]),
                                          np.int64([1]), np.zeros((1, 3)))
        with pytest.raises(RuntimeError, match="float32 repr differs"):
            calls_codec.count_read_runs(["a\tb\tc\td\te\tf"])
    finally:
        monkeypatch.undo()
        calls_codec.native_checked.cache_clear()
    assert calls_codec.count_read_runs(["a\tb\tc\td\te\tf"]) == (1, "e", "e")


def test_a_read_run_counter_that_takes_short_rows_raises(monkeypatch):
    # the counter as the JAX native code has it: an empty or partial read
    # name for a sampleinfo without its 6 fields
    def lenient(sampleinfo):
        names = [(s.split("\t") + [""] * 5)[4] for s in sampleinfo]
        runs = sum(a != b for a, b in zip([None] + names, names))
        return runs, names[0] if names else "", names[-1] if names else ""
    lenient.calls = 0
    monkeypatch.setattr(native, "count_read_runs", lenient)
    calls_codec.native_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="without its 6 fields"):
            calls_codec.native_checked()
    finally:
        monkeypatch.undo()
        calls_codec.native_checked.cache_clear()


def test_package_data_ships_every_native_source():
    import pathlib
    import tomllib
    repo = pathlib.Path(__file__).resolve().parents[1]
    with open(repo / "pyproject.toml", "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    csrc = repo / "deepsignal_tpu_torch" / "csrc"
    shipped = {p for pattern in data["deepsignal_tpu_torch"]
               for p in (repo / "deepsignal_tpu_torch").glob(pattern)}
    sources = set(csrc.glob("*.cu")) | set(csrc.glob("*.cpp"))
    assert {"fastparse.cpp", "callfmt.cpp", "featkernel.cpp",
            "lstm_encoder.cu"} <= {p.name for p in sources}
    assert sources <= shipped


def test_a_positional_range_other_than_numpys_raises(monkeypatch):
    # the fault of a formatter that hardcodes numpy 2.0's range on a machine
    # whose numpy prints 1e8 as "1e+08"
    other = (1e-4, 1e8) if native.positional_range()[1] > 1e8 else \
        (1e-4, 1e16)
    monkeypatch.setattr(native, "positional_range", lambda: other)
    calls_codec.native_checked.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="differs from numpy's"):
            calls_codec.native_checked()
    finally:
        monkeypatch.undo()
        calls_codec.native_checked.cache_clear()


def test_the_formatter_check_is_not_counted():
    calls_codec.native_checked.cache_clear()
    before = (native.format_call_block.calls, native.count_read_runs.calls)
    calls_codec.native_checked()
    assert (native.format_call_block.calls,
            native.count_read_runs.calls) == before


# --------------------------------------------------------------------------
# the host build


def test_host_build_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "csrc").mkdir()
    src = tmp_path / "csrc" / "probe.cpp"
    src.write_text('extern "C" int ds_probe() { return 7; }\n')
    first = build.library_path("probe")
    build.build_libraries(["probe"])
    assert first.exists() and first.parent == tmp_path / "build"
    src.write_text('extern "C" int ds_probe() { return 8; }\n')
    assert build.library_path("probe") != first
    monkeypatch.setattr(build, "CXX_FLAGS", build.CXX_FLAGS + ("-g",))
    assert build.library_path("probe") != first


def test_a_failed_host_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="native build failed"):
        build.build_libraries(["broken"])
    assert not list((tmp_path / "build").glob("*.so"))
