"""Call-TSV codec (port of deepsignal_tpu/io/calls_codec.py).

Call rows are formatted, and a batch's reads counted, by the native
formatter (``io/native.py``, ``csrc/callfmt.cpp``); the pure-Python
versions stay as its plain versions (``*_plain``).  Where the JAX package
checks its native formatter once at import and falls back to Python in
silence, the port checks it once, at first use, and raises when its bytes
differ from the plain ones.  The record half (``ModRecord``, ``SiteStats``,
``iter_call_records``, ``format_frequency_row``) reads call rows back for
the frequency tools.

call_mods output TSV, 10 columns (call_modifications.py:184-190):
  chrom, pos, strand, pos_in_strand, readname, read_strand, prob_0, prob_1,
  called_label, k_mer     with prob_i = sigmoid_i / (sigmoid_0 + sigmoid_1).

Frequency TSV, 11 columns (scripts/call_modification_frequency.py:70-76):
  chrom, pos, strand, pos_in_strand, prob_0_sum, prob_1_sum, count_modified,
  count_unmodified, coverage, modification_frequency, k_mer
bedMethyl alternative at call_modification_frequency.py:64-68.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
from typing import Iterator

import numpy as np

from ..core.constants import CODE2BASE_DNA, CODE2BASE_RNA, KEY_SEP
from . import native


def _make_kmer_lut(code2base: dict) -> np.ndarray:
    lut = np.zeros(256, dtype=np.uint8)
    for code, base in code2base.items():
        lut[code] = ord(base)
    return lut


KMER_LUT_DNA = _make_kmer_lut(CODE2BASE_DNA)
KMER_LUT_RNA = _make_kmer_lut(CODE2BASE_RNA)


def decode_kmer_strings(kmers: np.ndarray, is_dna: bool = True) -> list:
    """[N, K] code matrix -> list of K-char k-mer strings."""
    n, k = kmers.shape
    lut = KMER_LUT_DNA if is_dna else KMER_LUT_RNA
    flat = lut[kmers.astype(np.intp)].tobytes()
    return [flat[i * k:(i + 1) * k].decode("ascii") for i in range(n)]


def format_call_row(sampleinfo: str, prob_0_norm, prob_1_norm,
                    called_label: int, k_mer: str) -> str:
    """One call row as _call_mods writes it (call_modifications.py:188-190);
    the probs are numpy float32 scalars, stringified with ``str``."""
    return "\t".join([sampleinfo, str(prob_0_norm), str(prob_1_norm),
                      str(called_label), k_mer])


def format_call_block(sampleinfo: list, p0: np.ndarray, p1: np.ndarray,
                      pred: np.ndarray, kmers: np.ndarray,
                      is_dna: bool = True) -> bytes:
    """All call rows of a batch as one newline-terminated utf-8 block,
    through the native formatter."""
    native_checked()
    lut = KMER_LUT_DNA if is_dna else KMER_LUT_RNA
    return native.format_call_block(sampleinfo, p0, p1, pred, kmers, lut)


def format_call_rows(sampleinfo: list, p0: np.ndarray, p1: np.ndarray,
                     pred: np.ndarray, kmers: np.ndarray,
                     is_dna: bool = True) -> list:
    """All call rows of a batch, one ``format_call_row`` per site, each
    without its newline."""
    p0 = np.ascontiguousarray(p0, dtype=np.float32)
    p1 = np.ascontiguousarray(p1, dtype=np.float32)
    kmer_strs = decode_kmer_strings(kmers, is_dna)
    return [format_call_row(sampleinfo[i], p0[i], p1[i], int(pred[i]),
                            kmer_strs[i])
            for i in range(len(sampleinfo))]


def format_call_block_plain(sampleinfo: list, p0: np.ndarray, p1: np.ndarray,
                            pred: np.ndarray, kmers: np.ndarray,
                            is_dna: bool = True) -> bytes:
    """The plain version of ``format_call_block``: the rows of
    ``format_call_rows``, each with its newline."""
    rows = format_call_rows(sampleinfo, p0, p1, pred, kmers, is_dna)
    return "".join(r + "\n" for r in rows).encode("utf-8")


def count_read_runs(sampleinfo: list):
    """(n_runs, first_read, last_read) over the contiguous same-read runs of
    a batch's sampleinfo (read name = 5th tab field), natively."""
    native_checked()
    return native.count_read_runs(sampleinfo)


def count_read_runs_plain(sampleinfo: list):
    """The plain version of ``count_read_runs``."""
    runs = 0
    prev = None
    first = ""
    for i, s in enumerate(sampleinfo):
        fields = s.split("\t", 5)
        if len(fields) < 6:
            raise ValueError(f"sampleinfo {i} has fewer than 6 fields: "
                             f"{s!r}")
        name = fields[4]
        if name != prev:
            runs += 1
            if runs == 1:
                first = name
        prev = name
    return runs, first, prev if prev is not None else ""


@functools.cache
def native_checked() -> None:
    """Hold the native formatter against the plain versions once per
    process, on values from every formatting regime (the probe of the JAX
    package's import-time check: positional and scientific, their
    boundaries, subnormals, signed zeros and the specials), the float32
    next to the installed numpy's positional range, and 4096 seeded random
    bit patterns; and the read-run counter on rows with and without their 6
    fields.  Raises RuntimeError on any difference; nothing falls back.  The check's own calls are not counted as calls of the path."""
    lo, hi = native.positional_range()
    edges = [np.nextafter(np.float32(v), np.float32(to)) for v in (lo, hi)
             for to in (0, np.inf)]
    bits = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    probe = np.concatenate([
        np.array([0.5, 0.1, 1e-4, 9.9999e-5, 1e-5, 1.2345e-7, 1e-38,
                  1.4e-45, 0.0, -0.0, 1.0, 0.9999999, 123456.0, 1e8,
                  9.999999e15, 1e16, 2 / 3, 1 / 3, np.inf, -np.inf, np.nan,
                  -1.17549435e-38, -0.5, lo, hi, *edges], dtype=np.float32),
        bits.astype(np.uint32).view(np.float32)])
    got, want = native.repr_f32(probe), [str(v) for v in probe]
    if got != want:
        diff = [(g, w) for g, w in zip(got, want) if g != w]
        raise RuntimeError(f"the native float32 repr differs from numpy's "
                           f"(positional for {lo:g} <= |x| < {hi:g}) at "
                           f"{len(diff)} values: {diff[:8]}")
    info = ["chr1\t7\t+\t7\tread0\tt", "chrM\t9\t-\t1\tread1\tc"]
    args = (info, np.array([0.25, 1e-6], dtype=np.float32),
            np.array([0.75, 0.999999], dtype=np.float32),
            np.array([1, 1], dtype=np.int64),
            np.array([[0, 1, 2, 3, 4]] * 2, dtype=np.int32))
    counted = (native.format_call_block, native.count_read_runs)
    calls = [fn.calls for fn in counted]
    try:
        for is_dna in (True, False):
            lut = KMER_LUT_DNA if is_dna else KMER_LUT_RNA
            got = native.format_call_block(*args, lut)
            want = format_call_block_plain(*args, is_dna)
            if got != want:
                raise RuntimeError(f"the native call-row formatter differs "
                                   f"from the plain one: {got!r} != {want!r}")
        got, want = native.count_read_runs(info), count_read_runs_plain(info)
        if got != want:
            raise RuntimeError(f"the native read-run count differs from the "
                               f"plain one: {got} != {want}")
        for short in (["chr1\t7\t+\t7", "a\tb\tc\td\tr1\tt"],
                      ["a\tb\tc\td\tr1\tt", "a\tb\tc\td\tr1"]):
            try:
                got = native.count_read_runs(short)
            except ValueError:
                continue
            raise RuntimeError(f"the native read-run count takes a "
                               f"sampleinfo without its 6 fields, which the "
                               f"plain one refuses: {short!r} -> {got}")
    finally:
        for fn, n in zip(counted, calls):
            fn.calls = n


@dataclasses.dataclass
class ModRecord:
    """One per-read call row (scripts/txt_formater.py:8-27)."""

    chromosome: str
    pos: int
    strand: str
    pos_in_strand: int
    readname: str
    read_strand: str
    prob_0: float
    prob_1: float
    called_label: int
    kmer: str

    @property
    def site_key(self) -> str:
        return KEY_SEP.join([self.chromosome, str(self.pos)])

    def is_record_callable(self, prob_threshold: float) -> bool:
        """Ambiguity filter (txt_formater.py:23-27): drop the call when
        |prob_0 - prob_1| < threshold."""
        return abs(self.prob_0 - self.prob_1) >= prob_threshold

    @staticmethod
    def from_fields(words: list) -> "ModRecord":
        return ModRecord(words[0], int(words[1]), words[2], int(words[3]),
                         words[4], words[5], float(words[6]), float(words[7]),
                         int(words[8]), words[9])

    def to_line(self) -> str:
        """The row's ten fields joined by tabs, with ``str`` of the numbers:
        the probabilities as the Python floats they were read as (their
        repr, not numpy's float32 one)."""
        return "\t".join([self.chromosome, str(self.pos), self.strand,
                          str(self.pos_in_strand), self.readname,
                          self.read_strand, str(self.prob_0), str(self.prob_1),
                          str(self.called_label), self.kmer])


@dataclasses.dataclass
class SiteStats:
    """Accumulator for one genomic site (scripts/txt_formater.py:34-46)."""

    strand: str
    pos_in_strand: int
    kmer: str
    prob_0: float = 0.0
    prob_1: float = 0.0
    met: int = 0
    unmet: int = 0
    coverage: int = 0


def split_key(key: str):
    words = key.split(KEY_SEP)
    return words[0], int(words[1])


def iter_call_records(path: str) -> Iterator[ModRecord]:
    """ModRecords of a call TSV, gzip-compressed when its name ends in
    ``.gz`` (call_modification_frequency.py:22-27)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as rf:
        for line in rf:
            yield ModRecord.from_fields(line.strip().split("\t"))


def format_frequency_row(chrom: str, pos: int, stats: SiteStats,
                         is_bed: bool = False) -> str:
    """One frequency row (call_modification_frequency.py:64-76): the sums
    are Python floats added in file order, printed with %.3f and the rate
    with %.4f; bedMethyl rounds the percentage with ``round(x, 0)``."""
    rmet = float(stats.met) / stats.coverage
    if is_bed:
        return "\t".join([chrom, str(pos), str(pos + 1), ".",
                          str(stats.coverage), stats.strand, str(pos),
                          str(pos + 1), "0,0,0", str(stats.coverage),
                          str(int(round(rmet * 100, 0)))])
    return "%s\t%d\t%s\t%d\t%.3f\t%.3f\t%d\t%d\t%d\t%.4f\t%s" % (
        chrom, pos, stats.strand, stats.pos_in_strand, stats.prob_0,
        stats.prob_1, stats.met, stats.unmet, stats.coverage, rmet, stats.kmer)
