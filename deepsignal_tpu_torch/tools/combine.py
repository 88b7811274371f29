"""Strand combining of palindromic-motif frequencies (port of
deepsignal_tpu/tools/combine.py).

Equivalent of ``scripts/combine_two_strands_frequency.py``: merge the + and
- strand frequencies of palindromic (CG) sites onto forward-strand
positions, for frequency-TSV (combine_fb_of_freqtxt, :50-85) or bedMethyl
input (combine_fb_of_bed, :88-120); the genome is scanned for every motif
position first (:160-172).  Host code only: no torch.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

from ..core.constants import get_motif_seqs, motif_sites_in_seq
from ..io.fasta import read_fasta


def genome_motif_positions(ref_fp: str, motif: str = "CG", mod_loc: int = 0,
                           contig: str = "") -> set:
    """Every (contig, forward pos) motif position of the reference."""
    contigs = read_fasta(ref_fp)
    poses = set()
    names = [contig] if contig else list(contigs.keys())
    motif_seqs = get_motif_seqs(motif)
    for name in names:
        for p in motif_sites_in_seq(contigs[name], motif_seqs, mod_loc):
            poses.add((name, int(p)))
    return poses


def combine_fb_of_freqtxt(report_fp: str, cgposes: set) -> list:
    """Merge the strands of an 11-column frequency file; a '-' row maps
    onto pos - 1 (its palindrome partner).  Returns the combined rows,
    sorted."""
    pos2info: dict = {pos: [0.0, 0.0, 0, 0, 0, 0.0, "-"] for pos in cgposes}
    with open(report_fp, "r") as rf:
        for line in rf:
            words = line.strip().split("\t")
            key = (words[0], int(words[1]))
            if words[2] == "-":
                key = (words[0], int(words[1]) - 1)
                if key not in cgposes:
                    print("{}, not in selected motif poses of the genome"
                          .format(words))
                    continue
            else:
                if key not in cgposes:
                    print("{}, not in selected motif poses of the genome"
                          .format(words))
                    continue
                pos2info[key][6] = words[10]
            prob0, prob1 = float(words[4]), float(words[5])
            met, unmet, coverage = int(words[6]), int(words[7]), int(words[8])
            pos2info[key][0] += prob0
            pos2info[key][1] += prob1
            pos2info[key][2] += met
            pos2info[key][3] += unmet
            pos2info[key][4] += coverage
    out = []
    for pos, info in pos2info.items():
        if info[4] == 0:
            continue
        info[5] = float(info[2]) / info[4]
        out.append(list(pos) + ["+", pos[1]] + info)
    return sorted(out, key=lambda x: (x[0], x[1]))


def combine_fb_of_bed(report_fp: str, cgposes: set) -> list:
    """The bedMethyl version (combine_two_strands_frequency.py:88-120).

    The percentage is ``int(round(rate, 2) * 100)``, which truncates (a
    rate of 0.29 gives 28), as the JAX package and the reference write
    it."""
    pos2info: dict = {pos: [0, 0.0, 0.0] for pos in cgposes}
    with open(report_fp, "r") as rf:
        for line in rf:
            words = line.strip().split("\t")
            key = (words[0], int(words[1]))
            if words[5] == "-":
                key = (words[0], int(words[1]) - 1)
            if key not in cgposes:
                print("{}, not in selected motif poses of the genome"
                      .format(words))
                continue
            coverage = int(words[9])
            met = float(words[10]) / 100 * coverage
            pos2info[key][0] += coverage
            pos2info[key][1] += met
    out = []
    for pos, info in pos2info.items():
        if info[0] == 0:
            continue
        info[2] = float(info[1]) / info[0]
        chrom, fpos = pos
        out.append([chrom, fpos, fpos + 1, ".", info[0], "+", fpos, fpos + 1,
                    "0,0,0", info[0], int(round(info[2], 2) * 100)])
    return sorted(out, key=lambda x: (x[0], x[1]))


def write_combined_rows(rows: Iterable, reportfp: str) -> None:
    with open(reportfp, "w") as wf:
        for row in rows:
            wf.write("\t".join(map(str, row)) + "\n")


def combine_two_strands_frequency(report_fp: str, ref_fp: str,
                                  out_fp: Optional[str] = None,
                                  contig: str = "", motif: str = "CG",
                                  mod_loc: int = 0) -> str:
    """``combine_strands``: a frequency TSV, or a ``.bed``, -> its
    ``.fb_combined`` file beside it (or ``out_fp``); returns the path."""
    cgposes = genome_motif_positions(ref_fp, motif, mod_loc, contig)
    if out_fp is None:
        fname, fext = os.path.splitext(report_fp)
        out_fp = fname + ".fb_combined" + fext
    if str(report_fp).lower().endswith(".bed"):
        rows = combine_fb_of_bed(report_fp, cgposes)
    else:
        rows = combine_fb_of_freqtxt(report_fp, cgposes)
    write_combined_rows(rows, out_fp)
    return out_fp
