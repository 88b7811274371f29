"""Feature-TSV codec (port of deepsignal_tpu/io/feature_codec.py, pure
Python).

TSV columns (extract_features.py:1-4,289-303):
  chrom, pos, strand, pos_in_strand, readname, read_strand, k_mer,
  signal_means (k csv, 6dp), signal_stds (k csv, 6dp), signal_lens (k csv int),
  cent_signals (s csv), methy_label
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from ..core.constants import BASE2CODE_DNA

# k-mer encode table: A/C/G/T as the DNA codes, U as 3 (RNA k-mers), anything
# else N=4; the alphabet is chosen when the k-mer is decoded again
_PARSE_CODE_LUT = np.full(256, BASE2CODE_DNA["N"], dtype=np.int32)
for _b, _c in BASE2CODE_DNA.items():
    _PARSE_CODE_LUT[ord(_b)] = _c
_PARSE_CODE_LUT[ord("U")] = BASE2CODE_DNA["T"]


def _encode_kmer_col(kmer: str) -> np.ndarray:
    raw = np.frombuffer(kmer.encode("ascii", errors="replace"), dtype=np.uint8)
    return _PARSE_CODE_LUT[raw]


@dataclasses.dataclass
class FeatureBatch:
    """Struct-of-arrays batch of feature rows; ``sampleinfo`` keeps the
    first six TSV columns joined by tabs (call_modifications.py:51,113)."""

    sampleinfo: list         # list[str], len N
    kmers: np.ndarray        # [N, K] int
    means: np.ndarray        # [N, K] float32
    stds: np.ndarray         # [N, K] float32
    lens: np.ndarray         # [N, K] int  (signal point count per base)
    signals: np.ndarray      # [N, S] float32 (central raw signals)
    labels: np.ndarray       # [N] int

    def __len__(self) -> int:
        return len(self.sampleinfo)

    def __getitem__(self, idx) -> "FeatureBatch":
        sl = idx if isinstance(idx, slice) else slice(idx, idx + 1)
        return FeatureBatch(self.sampleinfo[sl], self.kmers[sl], self.means[sl],
                            self.stds[sl], self.lens[sl], self.signals[sl],
                            self.labels[sl])

    @staticmethod
    def concat(batches: list["FeatureBatch"]) -> "FeatureBatch":
        return FeatureBatch(
            sampleinfo=[s for b in batches for s in b.sampleinfo],
            kmers=np.concatenate([b.kmers for b in batches]),
            means=np.concatenate([b.means for b in batches]),
            stds=np.concatenate([b.stds for b in batches]),
            lens=np.concatenate([b.lens for b in batches]),
            signals=np.concatenate([b.signals for b in batches]),
            labels=np.concatenate([b.labels for b in batches]),
        )


def parse_feature_lines(lines) -> FeatureBatch:
    """Parse TSV feature lines (call_modifications.py:51-57)."""
    sampleinfo = []
    kmers, means, stds, lens, signals, labels = [], [], [], [], [], []
    for line in lines:
        words = line.rstrip("\n").split("\t")
        sampleinfo.append("\t".join(words[0:6]))
        kmers.append(_encode_kmer_col(words[6]))
        means.append(np.array(words[7].split(","), dtype=np.float32))
        stds.append(np.array(words[8].split(","), dtype=np.float32))
        lens.append(np.array(words[9].split(","), dtype=np.int32))
        signals.append(np.array(words[10].split(","), dtype=np.float32))
        labels.append(int(words[11]))
    return FeatureBatch(
        sampleinfo=sampleinfo,
        kmers=np.asarray(kmers, dtype=np.int32),
        means=np.asarray(means, dtype=np.float32),
        stds=np.asarray(stds, dtype=np.float32),
        lens=np.asarray(lens, dtype=np.int32),
        signals=np.asarray(signals, dtype=np.float32),
        labels=np.asarray(labels, dtype=np.int32),
    )


def iter_feature_batches_by_read(features_file: str,
                                 reads_per_batch: int = 50
                                 ) -> Iterator[FeatureBatch]:
    """Stream a feature TSV grouped by read (call_modifications.py:35-91):
    a read's rows stay in one batch; a batch is emitted whenever
    ``reads_per_batch`` distinct reads have completed."""
    pending: list[str] = []
    readid_pre: Optional[str] = None
    r_num = 0
    with open(features_file, "r") as rf:
        for line in rf:
            readid = line.split("\t", 5)[4]
            if readid_pre is None:
                readid_pre = readid
            elif readid != readid_pre:
                r_num += 1
                readid_pre = readid
                if r_num % reads_per_batch == 0:
                    yield parse_feature_lines(pending)
                    pending = []
            pending.append(line)
    if pending:
        yield parse_feature_lines(pending)


def format_feature_row(chrom: str, pos: int, strand: str, pos_in_strand: int,
                       readname: str, read_strand: str, k_mer: str,
                       signal_means, signal_stds, signal_lens,
                       cent_signals, methy_label: int) -> str:
    """One feature row as ``_features_to_str`` writes it
    (extract_features.py:289-303): means/stds rounded to 6 decimals and
    stringified with numpy float64 repr."""
    means_text = ",".join(str(x) for x in np.around(signal_means, decimals=6))
    stds_text = ",".join(str(x) for x in np.around(signal_stds, decimals=6))
    lens_text = ",".join(str(int(x)) for x in signal_lens)
    cent_text = ",".join(str(x) for x in np.asarray(cent_signals))
    return "\t".join([chrom, str(pos), strand, str(pos_in_strand), readname,
                      read_strand, k_mer, means_text, stds_text, lens_text,
                      cent_text, str(methy_label)])
