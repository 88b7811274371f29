"""Per-read feature extraction: resquiggled read -> per-motif-site features
(port of deepsignal_tpu/featurize/extractor.py).

The reference's ``_extract_features`` (extract_features.py:215-286) loops
over sites in Python; here each read's per-event statistics are computed
once and the k-mer windows gathered with numpy indexing.  Coordinates
follow extract_features.py:254-261 and the TSV row format :289-303.

Two outputs of one read's features, kept apart as in the JAX package:

- ``ReadFeatures.to_tsv_rows`` (the TSV of ``extract``) rounds the means
  and stds to 6 decimals and writes numpy's ``str()`` of each value, by the
  native ``format_rows6``; ``to_tsv_rows_plain`` is its plain version
  (``format_feature_row``);
- ``read_features_to_batch`` (the stream of ``call_mods``) casts the
  unrounded float64 means and stds to float32.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

import numpy as np

from ..core.config import FeatureConfig
from ..core.constants import (KEY_SEP, decode_seq, encode_seq,
                              motif_sites_in_seq)
from ..io import native
from ..io.fast5 import ResquiggledRead, read_resquiggled_fast5
from ..io.feature_codec import FeatureBatch, format_feature_row
from .central import central_signals_batch
from .signal import (featurizer_checked, normalize_signals, rescale_signals,
                     segment_stats)


@dataclasses.dataclass
class ReadFeatures:
    """Struct-of-arrays features for all motif sites of one read."""

    chrom: str
    align_strand: str
    readname: str
    read_strand: str
    pos: np.ndarray            # [S] genome coordinate (fwd strand, 0-based)
    pos_in_strand: np.ndarray  # [S] legacy strand coordinate (-1 if no ref)
    kmers: np.ndarray          # [S, K] int codes
    means: np.ndarray          # [S, K] float64
    stds: np.ndarray           # [S, K] float64
    lens: np.ndarray           # [S, K] int64
    cent_signals: np.ndarray   # [S, cent_len] float64
    methy_label: int
    is_dna: bool = True        # decode alphabet (U vs T) for kmer strings

    def __len__(self) -> int:
        return self.pos.shape[0]

    def to_tsv_rows(self) -> list:
        """The reference's feature rows (extract_features.py:289-303), the
        float columns by the native ``format_rows6``.  RNA reads decode
        code 3 back to 'U' (the reference writes the event bases as they
        are)."""
        featurizer_checked()
        means_txt = native.format_rows6(np.around(self.means, 6))
        stds_txt = native.format_rows6(np.around(self.stds, 6))
        cent_txt = native.format_rows6(self.cent_signals)  # rounded already
        label = str(self.methy_label)
        rows = []
        for i, (p, q) in enumerate(zip(self.pos.tolist(),
                                       self.pos_in_strand.tolist())):
            rows.append("\t".join([
                self.chrom, str(p), self.align_strand, str(q),
                self.readname, self.read_strand,
                decode_seq(self.kmers[i], self.is_dna), means_txt[i],
                stds_txt[i], ",".join(map(str, self.lens[i].tolist())),
                cent_txt[i], label]))
        return rows

    def to_tsv_rows_plain(self) -> list:
        """The plain version of ``to_tsv_rows``: one
        ``format_feature_row`` a site."""
        return [format_feature_row(
            self.chrom, int(self.pos[i]), self.align_strand,
            int(self.pos_in_strand[i]), self.readname, self.read_strand,
            decode_seq(self.kmers[i], self.is_dna), self.means[i],
            self.stds[i], self.lens[i], self.cent_signals[i],
            self.methy_label) for i in range(len(self))]


def extract_read_features(read: ResquiggledRead, motif_seqs: list,
                          cfg: FeatureConfig,
                          chrom2len: Optional[dict] = None,
                          positions: Optional[set] = None,
                          rng: Optional[random.Random] = None,
                          ) -> Optional[ReadFeatures]:
    """Featurize one read; None when no site passes the filters.

    Steps (extract_features.py:224-280): rescale to pA, normalize the whole
    read, per-event statistics, motif scan, per-site window gather."""
    kmer_len = cfg.kmer_len
    num_bases = (kmer_len - 1) // 2
    if rng is None and cfg.central_sample_seed is not None:
        # derived from the seed and the read, so that any worker draws the
        # same subsample for a read, whatever the worker count or order
        rng = random.Random(f"{cfg.central_sample_seed}:{read.read_id}")

    norm = normalize_signals(
        rescale_signals(read.raw_signal, read.scaling, read.offset),
        cfg.normalize_method)

    starts = read.event_starts
    lengths = read.event_lengths
    n_events = starts.shape[0]

    ev_means, ev_stds = segment_stats(norm, starts, lengths)

    seq_codes = encode_seq(read.seq, cfg.is_dna)
    tsite_locs = motif_sites_in_seq(seq_codes, motif_seqs, cfg.mod_loc,
                                    cfg.is_dna)
    # keep sites with a full k-mer window (extract_features.py:255)
    tsite_locs = tsite_locs[(tsite_locs >= num_bases)
                            & (tsite_locs < n_events - num_bases)]
    if tsite_locs.size == 0:
        return None

    # genome coordinates (extract_features.py:256-261)
    chromlen = None
    if chrom2len is not None:
        chromlen = chrom2len.get(read.chrom)
        if chromlen is None:
            print("warning - chrom_name in fast5 not in provided reference genome!")
    if read.align_strand == "-":
        pos = read.chrom_start + n_events - 1 - tsite_locs
    else:
        pos = read.chrom_start + tsite_locs
    if chromlen is not None:
        pos_in_strand = (chromlen - 1 - pos) if read.align_strand == "-" else pos
    else:
        pos_in_strand = np.full_like(pos, -1)

    if positions is not None:
        keep = np.fromiter(
            (KEY_SEP.join([read.chrom, str(int(p)), read.align_strand])
             in positions for p in pos),
            dtype=bool, count=pos.shape[0])
        tsite_locs, pos, pos_in_strand = (tsite_locs[keep], pos[keep],
                                          pos_in_strand[keep])
        if tsite_locs.size == 0:
            return None

    # window gather: [S, K] index matrix over events
    win = tsite_locs[:, None] + np.arange(-num_bases, num_bases + 1)[None, :]
    cent = central_signals_batch(norm, starts, lengths, win,
                                 cfg.cent_signals_len, rng)
    return ReadFeatures(
        chrom=read.chrom, align_strand=read.align_strand,
        readname=read.read_id, read_strand=read.read_strand,
        pos=pos, pos_in_strand=pos_in_strand, kmers=seq_codes[win],
        means=ev_means[win], stds=ev_stds[win], lens=lengths[win],
        cent_signals=cent, methy_label=cfg.methy_label, is_dna=cfg.is_dna)


def extract_fast5_batch(fast5_paths: list, motif_seqs: list,
                        cfg: FeatureConfig,
                        chrom2len: Optional[dict] = None,
                        positions: Optional[set] = None,
                        rng: Optional[random.Random] = None):
    """Featurize a batch of reads, each item of ``fast5_paths`` a fast5 path
    (read with ``read_resquiggled_fast5``) or a ``ResquiggledRead`` (taken
    as it is), with per-read fault isolation (extract_features.py:224-283:
    failures counted, extraction continues).  Returns (list[ReadFeatures],
    error_count).  A fast5 without the corrected Alignment group counts as
    an error, as the reference's blanket except does.

    A native featurizer that disagrees with numpy is not a read's fault:
    the check's RuntimeError (run here, before any read) is raised.  A file
    that the HDF5 reader refuses (``io/hdf5.py``: VBZ, dense storage, ...)
    is counted as a failed read, as an unreadable file is."""
    featurizer_checked()
    out = []
    errors = 0
    for item in fast5_paths:
        try:
            read = item if isinstance(item, ResquiggledRead) else \
                read_resquiggled_fast5(item, cfg.corrected_group,
                                       cfg.basecall_subgroup)
            if read is None:
                errors += 1
                continue
            feats = extract_read_features(read, motif_seqs, cfg, chrom2len,
                                          positions, rng)
            if feats is not None:
                out.append(feats)
        except Exception:
            errors += 1
    return out, errors


def read_features_to_batch(feats_list: list) -> Optional[FeatureBatch]:
    """Pack per-read features into one FeatureBatch for the caller, each
    read's sites kept contiguous (the read-grouping contract of
    call_modifications.py:100-122); means, stds and signals cast from
    float64 to float32 in the copy."""
    if not feats_list:
        return None
    sampleinfo = []
    for f in feats_list:
        head = f.chrom + "\t"
        mid = "\t" + f.align_strand + "\t"
        tail = "\t" + f.readname + "\t" + f.read_strand
        sampleinfo += [head + str(p) + mid + str(q) + tail
                       for p, q in zip(f.pos.tolist(),
                                       f.pos_in_strand.tolist())]
    counts = [len(f) for f in feats_list]
    return FeatureBatch(
        sampleinfo=sampleinfo,
        kmers=np.concatenate([f.kmers for f in feats_list], dtype=np.int32),
        means=np.concatenate([f.means for f in feats_list], dtype=np.float32),
        stds=np.concatenate([f.stds for f in feats_list], dtype=np.float32),
        lens=np.concatenate([f.lens for f in feats_list], dtype=np.int32),
        signals=np.concatenate([f.cent_signals for f in feats_list],
                               dtype=np.float32),
        labels=np.repeat(np.asarray([f.methy_label for f in feats_list],
                                    dtype=np.int32), counts),
    )


def read_position_file(position_file: str) -> set:
    """Positions filter file: TSV chrom, fwd-pos, strand
    (extract_features.py:388-394)."""
    positions = set()
    with open(position_file, "r") as rf:
        for line in rf:
            words = line.strip().split("\t")
            positions.add(KEY_SEP.join(words[:3]))
    return positions
