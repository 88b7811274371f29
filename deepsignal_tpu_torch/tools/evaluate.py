"""Offline call evaluation (port of deepsignal_tpu/tools/evaluate.py).

Equivalent of ``scripts/evaluate_mods_call.py``: given the calls of a
known-methylated and of a known-unmethylated truth set, compute
tp/fp/tn/fn, accuracy, recall, specificity, precision, fallout, miss rate,
FDR, NPV and AUC over a prob_cf grid 0 -> 0.675, step 0.025 (:19-20,
40-110).  Host code only: no torch.

The records are shuffled with the ``random.Random`` the caller passes, in
the JAX package's order: ``random.Random(s)`` gives the file the JAX
package writes after ``random.seed(s)``.
"""

from __future__ import annotations

import random
from collections import namedtuple

import numpy as np

from ..io.calls_codec import ModRecord

NUM_SITES = [100000]
# np.arange, as the JAX package and the reference make it: the >= cut-offs
# depend on these float64 values (the fourth is 0.07500000000000001, so a
# |p1 - p0| of exactly 0.075 is not called there)
PROB_CFS = np.arange(0, 0.70, 0.025)

CallRecord = namedtuple("CallRecord", ["key", "predicted_label",
                                       "is_true_methylated", "prob0",
                                       "prob1"])

HEADER = ("tested_type\tprob_cf\ttrue_positive\tfalse_positive\t"
          "true_negative\tfalse_negative\taccuracy\trecall\tspecificity\t"
          "precision\tfallout\tmiss_rate\tFDR\tNPV\tauc\ttotal_num\t"
          "called_num\tcalled_ratio\tcalled_accuracy")


def roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """AUROC by the rank statistic, tied scores at their average rank (the
    trapezoidal ROC, sklearn's ``roc_auc_score``)."""
    y_true = np.asarray(y_true, dtype=bool)
    y_score = np.asarray(y_score, dtype=np.float64)
    n_pos = int(y_true.sum())
    n_neg = y_true.shape[0] - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("only one class present")
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty_like(y_score)
    sorted_scores = y_score[order]
    ranks_sorted = np.arange(1, len(y_score) + 1, dtype=np.float64)
    i = 0
    while i < len(sorted_scores):
        j = i
        while j + 1 < len(sorted_scores) and \
                sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks_sorted[i:j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = ranks_sorted
    return (ranks[y_true].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def sample_sites(filename: str, is_methylated: bool, *,
                 rng: random.Random) -> list:
    """Load and shuffle the call records of one truth set
    (evaluate_mods_call.py:25-37)."""
    all_crs = []
    with open(filename) as rf:
        for line in rf:
            r = ModRecord.from_fields(line.rstrip().split())
            all_crs.append(CallRecord(r.site_key, r.called_label,
                                      is_methylated, r.prob_0, r.prob_1))
    print("there are {} basemod candidates totally".format(len(all_crs)))
    rng.shuffle(all_crs)
    return all_crs


def evaluate_sites(tested_sites: list, prob_cf: float) -> str:
    """One line of the metric table (evaluate_mods_call.py:40-110)."""
    tp = fp = tn = fn = 0
    called = correct = 0
    y_true, y_scores = [], []
    for s in tested_sites:
        tp += bool(s.predicted_label) and s.is_true_methylated
        fp += bool(s.predicted_label) and not s.is_true_methylated
        tn += not s.predicted_label and not s.is_true_methylated
        fn += not s.predicted_label and s.is_true_methylated
        y_true.append(s.is_true_methylated)
        y_scores.append(s.prob1)
        diff = s.prob1 - s.prob0
        if abs(diff) >= prob_cf:
            called += 1
            if (diff >= prob_cf) == s.is_true_methylated:
                correct += 1

    precision = recall = specificity = accuracy = 0
    fall_out = miss_rate = fdr = npv = 0
    auroc = 0
    called_accuracy = 0
    n = len(tested_sites)
    if n > 0:
        accuracy = float(tp + tn) / n
        if tp + fp > 0:
            precision = float(tp) / (tp + fp)
            fdr = float(fp) / (tp + fp)
        if tp + fn > 0:
            recall = float(tp) / (tp + fn)
            miss_rate = float(fn) / (tp + fn)
        if tn + fp > 0:
            specificity = float(tn) / (tn + fp)
            fall_out = float(fp) / (fp + tn)
        if tn + fn > 0:
            npv = float(tn) / (tn + fn)
        if called > 0:
            called_accuracy = float(correct) / called
        try:
            auroc = roc_auc(np.array(y_true), np.array(y_scores))
        except ValueError:
            auroc = 0
    return ("%d\t%d\t%d\t%d\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f\t%.3f"
            "\t%.3f\t%d\t%d\t%.3f\t%.3f"
            % (tp, fp, tn, fn, accuracy, recall, specificity, precision,
               fall_out, miss_rate, fdr, npv, auroc, n, called,
               float(called) / n if n else 0.0, called_accuracy))


def evaluate_mods_call(methylated_file: str, unmethylated_file: str,
                       result_file: str, *, rng: random.Random) -> None:
    """The whole sweep (evaluate_mods_call.py:113-140): the unmethylated
    set is shuffled first, then the methylated one."""
    unmeth = sample_sites(unmethylated_file, False, rng=rng)
    meth = sample_sites(methylated_file, True, rng=rng)
    with open(result_file, "w") as wf:
        wf.write(HEADER + "\n")
        for site_num in NUM_SITES:
            tested = meth[:site_num] + unmeth[:site_num]
            for prob_cf in PROB_CFS:
                wf.write("\t".join(["_" + str(site_num), "%.3f" % prob_cf,
                                    evaluate_sites(tested, prob_cf)]) + "\n")
        tested = meth + unmeth
        wf.write("\t".join(["all_sites", "0.000",
                            evaluate_sites(tested, 0.0)]) + "\n")
