"""The dataset tools denoise needs (port of part of
deepsignal_tpu/tools/dataset.py): row counting, a random split of a file
into two, k-mer counting, negatives drawn to the positives' k-mer
distribution, and a streaming shuffle-concat (process_utils.py:162-478).

Each random function takes its generator explicitly: a ``random.Random``
where the JAX package draws from the module ``random``, a numpy
``Generator`` where it makes one.  The draws come in the JAX package's
order, so ``random.Random(s)`` gives the files that the JAX package writes
after ``random.seed(s)``.
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np


def count_line_num(path: str, fheader: bool = False) -> int:
    count = 0
    with open(path, "r") as rf:
        if fheader:
            next(rf)
        for _ in rf:
            count += 1
    return count


def random_select_file_rows_s(ori_file: str, w_file: str, w_other_file: str,
                              maxrownum: int = 100000000,
                              header: bool = False, *,
                              rng: random.Random) -> Tuple[list, list]:
    """Random split into two files, returning the original line indexes of
    each side (process_utils.py:226-279): the denoiser maps validation
    probabilities back to source lines with them."""
    nrows = count_line_num(ori_file, header)
    actual = min(maxrownum, nrows)
    chosen = np.zeros(nrows, dtype=bool)
    chosen[rng.sample(range(nrows), actual)] = True
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
