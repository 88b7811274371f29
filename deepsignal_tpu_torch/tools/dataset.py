"""Dataset preparation tools (port of deepsignal_tpu/tools/dataset.py):
row counting, random row selection and splitting, a streaming
shuffle-concat, an external shuffle of a big file, k-mer counting and
distribution-matched negative selection, and the label and position
filters (process_utils.py:162-478 and scripts/).  Host code only: no
torch.

Each random function takes its generator explicitly: a ``random.Random``
where the JAX package draws from the module ``random``, a numpy
``Generator`` where it makes one.  The draws come in the JAX package's
order, so ``random.Random(s)`` gives the files that the JAX package writes
after ``random.seed(s)``.
"""

from __future__ import annotations

import math
import os
import random
from typing import Optional, Tuple

import numpy as np


def count_line_num(path: str, fheader: bool = False) -> int:
    count = 0
    with open(path, "r") as rf:
        if fheader:
            next(rf)
        for _ in rf:
            count += 1
    return count


def _choose_rows(ori_file: str, maxrownum: int, header: bool,
                 rng: random.Random) -> np.ndarray:
    """A mask over the data rows of ``ori_file``: ``maxrownum`` of them (or
    all), drawn with one ``rng.sample``."""
    nrows = count_line_num(ori_file, header)
    chosen = np.zeros(nrows, dtype=bool)
    chosen[rng.sample(range(nrows), min(maxrownum, nrows))] = True
    return chosen


def random_select_file_rows(ori_file: str, w_file: str,
                            w_other_file: Optional[str] = None,
                            maxrownum: int = 100000000, header: bool = False,
                            *, rng: random.Random) -> int:
    """Random row selection (process_utils.py:173-223): the chosen rows go
    to ``w_file`` in file order, the rest to ``w_other_file`` when it is
    given.  Returns the number chosen."""
    chosen = _choose_rows(ori_file, maxrownum, header, rng)
    with open(ori_file) as rf, open(w_file, "w") as wf:
        wlf = open(w_other_file, "w") if w_other_file else None
        try:
            if header:
                h = next(rf)
                wf.write(h)
                if wlf:
                    wlf.write(h)
            for i, line in enumerate(rf):
                if chosen[i]:
                    wf.write(line)
                elif wlf:
                    wlf.write(line)
        finally:
            if wlf:
                wlf.close()
    return int(chosen.sum())


def random_select_file_rows_s(ori_file: str, w_file: str, w_other_file: str,
                              maxrownum: int = 100000000,
                              header: bool = False, *,
                              rng: random.Random) -> Tuple[list, list]:
    """Random split into two files, returning the original line indexes of
    each side (process_utils.py:226-279): the denoiser maps validation
    probabilities back to source lines with them."""
    chosen = _choose_rows(ori_file, maxrownum, header, rng)
    lidxs1, lidxs2 = [], []
    with open(ori_file) as rf, open(w_file, "w") as wf, \
            open(w_other_file, "w") as wlf:
        if header:
            h = next(rf)
            wf.write(h)
            wlf.write(h)
        for i, line in enumerate(rf):
            if chosen[i]:
                wf.write(line)
                lidxs1.append(i)
            else:
                wlf.write(line)
                lidxs2.append(i)
    return lidxs1, lidxs2


def concat_two_files(file1: str, file2: str, concated_fp: str,
                     shuffle_lines_num: int = 2000000,
                     lines_num: int = 1000000000000,
                     isheader: bool = False, *,
                     rng: np.random.Generator) -> None:
    """Streaming ratio-matched shuffle-concat (process_utils.py:320-352):
    read proportional chunks of both files, shuffle, append."""
    open(concated_fp, "w").close()
    with open(file1) as rf1, open(file2) as rf2, \
            open(concated_fp, "a") as wf:
        if isheader:
            wf.write(next(rf1))
        n1 = count_line_num(file1, isheader)
        n2 = count_line_num(file2, False)
        chunk2 = round((float(n2) / n1) * shuffle_lines_num) + 1 if n1 else 1
        read1 = read2 = 0
        while read1 < lines_num or read2 < lines_num:
            lines1 = _read_chunk(rf1, min(shuffle_lines_num,
                                          lines_num - read1))
            lines2 = _read_chunk(rf2, min(chunk2, lines_num - read2))
            read1 += len(lines1)
            read2 += len(lines2)
            if not lines1 and not lines2:
                break
            merged = lines1 + lines2
            rng.shuffle(merged)
            wf.writelines(merged)


def _read_chunk(rf, n: int) -> list:
    lines = []
    for _ in range(max(n, 0)):
        line = rf.readline()
        if not line:
            break
        if not line.endswith("\n"):
            line += "\n"
        lines.append(line)
    return lines


def shuffle_big_file(fp: str, out_fp: Optional[str] = None,
                     num_lines_shuffle: int = 3000000,
                     temp_dir: str = "/tmp", *,
                     rng: np.random.Generator) -> str:
    """External-memory shuffle (scripts/shuffle_a_big_file.py:98-142):
    split into head and tail halves under ``temp_dir``, then shuffle-concat
    them in chunks.  Returns the output path (``<name>.shuffle<ext>``
    beside ``fp`` by default)."""
    if out_fp is None:
        fname, fext = os.path.splitext(fp)
        out_fp = fname + ".shuffle" + fext
    n = count_line_num(fp, False)
    head_num = n // 2
    base = os.path.basename(fp)
    head_fp = os.path.join(temp_dir, base + ".head.tmp")
    tail_fp = os.path.join(temp_dir, base + ".tail.tmp")
    with open(fp) as rf, open(head_fp, "w") as hf, open(tail_fp, "w") as tf:
        for i, line in enumerate(rf):
            (hf if i < head_num else tf).write(line)
    try:
        concat_two_files(head_fp, tail_fp, out_fp,
                         shuffle_lines_num=num_lines_shuffle, rng=rng)
    finally:
        os.remove(head_fp)
        os.remove(tail_fp)
    return out_fp


def count_kmers_of_feafile(feafile: str) -> dict:
    kmer_count: dict = {}
    with open(feafile, "r") as rf:
        for line in rf:
            kmer = line.split("\t", 7)[6]
            kmer_count[kmer] = kmer_count.get(kmer, 0) + 1
    return kmer_count


def kmer_ratios(kmer_count: dict) -> Tuple[dict, int]:
    total = sum(kmer_count.values())
    return {k: float(c) / total for k, c in kmer_count.items()}, total


def write_kmer_distribution(feafile: str, wfile: Optional[str] = None) -> str:
    """The ``.kmer_distri`` TSV of a feature file: k-mer, count, ratio, by
    count, largest first (scripts/get_kmer_dist_of_feafile.py:39-55)."""
    if wfile is None:
        fname, fext = os.path.splitext(feafile)
        wfile = fname + ".kmer_distri" + fext
    counts = count_kmers_of_feafile(feafile)
    total = sum(counts.values())
    rows = sorted(((k, c, float(c) / total) for k, c in counts.items()),
                  key=lambda x: x[1], reverse=True)
    with open(wfile, "w") as wf:
        for row in rows:
            wf.write("\t".join(map(str, row)) + "\n")
    return wfile


def _kmer2lines(feafile: str) -> dict:
    kmer2lines: dict = {}
    with open(feafile, "r") as rf:
        for lcnt, line in enumerate(rf):
            kmer = line.split("\t", 7)[6]
            kmer2lines.setdefault(kmer, []).append(lcnt)
    return kmer2lines


def select_negsamples_asposkmer(pos_file: str, totalneg_file: str,
                                seled_neg_file: str, *,
                                rng: random.Random) -> int:
    """Select negatives matching the positive file's k-mer distribution
    (process_utils.py:418-478).  Returns the number of selected lines.

    The k-mers the positives lack are visited as a set, as the JAX package
    visits them, so within one process both draw in the same order."""
    kmer_count = count_kmers_of_feafile(pos_file)
    kmer2ratio, totalline = kmer_ratios(kmer_count)
    kmer2lines = _kmer2lines(totalneg_file)

    selected: list = []
    unratioed = set()
    cnts = 0
    for kmer, lines in kmer2lines.items():
        if kmer in kmer2ratio:
            linenum = int(math.ceil(totalline * kmer2ratio[kmer]))
            if len(lines) <= linenum:
                selected += lines
                cnts += linenum - len(lines)
            else:
                selected += rng.sample(lines, linenum)
        else:
            unratioed.add(kmer)
    print("for {} common kmers, fill {} samples, {} samples that can't "
          "filled".format(len(kmer2lines) - len(unratioed), len(selected),
                          cnts))
    unfilled = totalline - len(selected)
    print("totalline: {}, need to fill: {}".format(totalline, unfilled))
    if unratioed:
        minlinenum = int(math.ceil(float(unfilled) / len(unratioed)))
        got = 0
        for kmer in unratioed:
            lines = kmer2lines[kmer]
            if len(lines) <= minlinenum:
                selected += lines
                got += len(lines)
            else:
                selected += rng.sample(lines, minlinenum)
                got += minlinenum
        print("extract {} samples from {} diff kmers".format(got,
                                                             len(unratioed)))
    chosen = set(selected)
    with open(totalneg_file) as rf, open(seled_neg_file, "w") as wf:
        for i, line in enumerate(rf):
            if i in chosen:
                wf.write(line)
    return len(chosen)


def _input_files(path: str, unique_fid: str) -> list:
    """A file, or the entries of a directory (``os.listdir`` order) whose
    name contains ``unique_fid``."""
    if os.path.isdir(path):
        return [os.path.join(path, f) for f in os.listdir(path)
                if f.find(unique_fid) != -1]
    return [path]


def filter_samples_by_label(input_path: str, out_fp: str, label: int,
                            unique_fid: str = ".tsv") -> int:
    """Keep the feature rows whose methy_label is ``label``; a file or a
    directory.  Returns the rows kept."""
    kept = 0
    with open(out_fp, "w") as wf:
        for fp in _input_files(input_path, unique_fid):
            with open(fp) as rf:
                for line in rf:
                    if int(line.rstrip("\n").rsplit("\t", 1)[1]) == label:
                        wf.write(line)
                        kept += 1
    return kept


def filter_samples_by_positions(sf_fp: str, pos_fp: str, out_fp: str,
                                label: str = "1", chrom_col: int = 1,
                                pos_col: int = 2, header: bool = False,
                                unique_fid: str = ".tsv") -> int:
    """Keep the rows whose (chrom, pos) is in the positions file, their
    label column set to ``label``
    (scripts/filter_samples_by_positions.py:22-43).  Returns the rows
    kept."""
    positions = set()
    with open(pos_fp) as rf:
        if header:
            next(rf)
        for line in rf:
            words = line.strip().split("\t")
            positions.add(" ".join([words[0], words[1]]))
    kept = 0
    with open(out_fp, "w") as wf:
        for fp in _input_files(sf_fp, unique_fid):
            with open(fp) as rf:
                for line in rf:
                    words = line.strip().split("\t")
                    key = " ".join([words[chrom_col - 1],
                                    str(int(words[pos_col - 1]))])
                    if key in positions:
                        wf.write("\t".join(words[:-1] + [label]) + "\n")
                        kept += 1
    return kept
