"""Call-TSV codec (port of deepsignal_tpu/io/calls_codec.py, pure Python).

call_mods output TSV, 10 columns (call_modifications.py:184-190):
  chrom, pos, strand, pos_in_strand, readname, read_strand, prob_0, prob_1,
  called_label, k_mer     with prob_i = sigmoid_i / (sigmoid_0 + sigmoid_1).
"""

from __future__ import annotations

import numpy as np

from ..core.constants import CODE2BASE_DNA, CODE2BASE_RNA


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
    """All call rows of a batch as one newline-terminated utf-8 block."""
    p0 = np.ascontiguousarray(p0, dtype=np.float32)
    p1 = np.ascontiguousarray(p1, dtype=np.float32)
    kmer_strs = decode_kmer_strings(kmers, is_dna)
    rows = [format_call_row(sampleinfo[i], p0[i], p1[i], int(pred[i]),
                            kmer_strs[i])
            for i in range(len(sampleinfo))]
    return "".join(r + "\n" for r in rows).encode("utf-8")


def count_read_runs(sampleinfo: list):
    """(n_runs, first_read, last_read) over the contiguous same-read runs of
    a batch's sampleinfo (read name = 5th tab field)."""
    runs = 0
    prev = None
    first = ""
    for s in sampleinfo:
        name = s.split("\t", 5)[4]
        if name != prev:
            runs += 1
            if runs == 1:
                first = name
        prev = name
    return runs, first, prev if prev is not None else ""
