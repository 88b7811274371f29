"""Per-site modification frequency (port of deepsignal_tpu/tools/frequency.py).

Equivalent of ``scripts/call_modification_frequency.py``: stream per-read
call TSVs (files, directories, ``.gz``), drop ambiguous calls
(|p1 - p0| < prob_cf), sum per (chrom, pos) the probabilities, the
modified and unmodified counts and the coverage, and write the 11-column
frequency TSV or bedMethyl (formats in ``io/calls_codec.py``).  Host code
only: no torch.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

from ..io.calls_codec import (SiteStats, format_frequency_row,
                              iter_call_records, split_key)


def collect_mods_files(input_paths: Iterable[str],
                       file_uid: Optional[str] = None) -> list:
    """Files and directories -> the list of call files
    (call_modification_frequency.py:107-120): a directory's entries in
    ``os.listdir`` order, those whose name contains ``file_uid`` when it
    is given."""
    mods_files = []
    for ipath in input_paths:
        input_path = os.path.abspath(ipath)
        if os.path.isdir(input_path):
            for ifile in os.listdir(input_path):
                if file_uid is None or ifile.find(file_uid) != -1:
                    mods_files.append("/".join([input_path, ifile]))
        elif os.path.isfile(input_path):
            mods_files.append(input_path)
        else:
            raise ValueError(f"{ipath} is neither a file nor a directory")
    return mods_files


def calculate_mods_frequency(mods_files: Iterable[str],
                             prob_cf: float = 0.0) -> dict:
    """site_key -> SiteStats (call_modification_frequency.py:16-46)."""
    sitekey2stats: dict = {}
    count, used = 0, 0
    for mods_file in mods_files:
        for rec in iter_call_records(mods_file):
            count += 1
            if not rec.is_record_callable(prob_cf):
                continue
            stats = sitekey2stats.get(rec.site_key)
            if stats is None:
                stats = SiteStats(rec.strand, rec.pos_in_strand, rec.kmer)
                sitekey2stats[rec.site_key] = stats
            stats.prob_0 += rec.prob_0
            stats.prob_1 += rec.prob_1
            stats.coverage += 1
            if rec.called_label == 1:
                stats.met += 1
            else:
                stats.unmet += 1
            used += 1
    if count:
        print("{:.2f}% ({} of {}) calls used..".format(
            used / float(count) * 100, used, count))
    return sitekey2stats


def write_sitekey2stats(sitekey2stats: dict, result_file: str,
                        is_sort: bool = False, is_bed: bool = False) -> None:
    """(call_modification_frequency.py:49-78): sites in first-seen order,
    or by (chrom, pos) with ``is_sort``."""
    keys = list(sitekey2stats.keys())
    if is_sort:
        keys = sorted(keys, key=split_key)
    with open(result_file, "w") as wf:
        for key in keys:
            chrom, pos = split_key(key)
            stats = sitekey2stats[key]
            if stats.coverage > 0:
                wf.write(format_frequency_row(chrom, pos, stats, is_bed)
                         + "\n")
            else:
                print("{} {} has no coverage..".format(chrom, pos))


def call_mods_frequency_to_file(input_paths, result_file: str,
                                prob_cf: float = 0.0,
                                file_uid: Optional[str] = None,
                                is_sort: bool = False,
                                is_bed: bool = False) -> dict:
    """``call_freq``: the call files of ``input_paths`` -> ``result_file``;
    returns the per-site stats."""
    mods_files = collect_mods_files(input_paths, file_uid)
    print("get {} input file(s)..".format(len(mods_files)))
    stats = calculate_mods_frequency(mods_files, prob_cf)
    write_sitekey2stats(stats, result_file, is_sort, is_bed)
    return stats


def combine_freq_files(freqfiles: Iterable[str], wfile: str) -> dict:
    """Sum 11-column frequency files per (chrom, pos, strand)
    (scripts/combine_call_mods_freq_files.py:24-55), written sorted, the
    rate with %.3f."""
    freqinfo: dict = {}
    for ffile in freqfiles:
        with open(ffile, "r") as rf:
            for line in rf:
                words = line.strip().split("\t")
                key = (words[0], int(words[1]), words[2])
                if key not in freqinfo:
                    freqinfo[key] = [-1, 0.0, 0.0, 0, 0, 0, 0.0, ""]
                fi = freqinfo[key]
                fi[0] = int(words[3])
                fi[1] += float(words[4])
                fi[2] += float(words[5])
                fi[3] += int(words[6])
                fi[4] += int(words[7])
                fi[5] += int(words[8])
                fi[6] = fi[3] / float(fi[5])
                fi[7] = words[10]
    with open(wfile, "w") as wf:
        for key in sorted(freqinfo.keys()):
            t = list(key) + freqinfo[key]
            wf.write("%s\t%d\t%s\t%d\t%.3f\t%.3f\t%d\t%d\t%d\t%.3f\t%s\n"
                     % tuple(t))
    return freqinfo
