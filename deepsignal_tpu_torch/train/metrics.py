"""Batch metrics with the reference's sklearn semantics
(train_model.py:163-174): binary accuracy/recall/precision for
class_num == 2, micro-averaged otherwise (micro recall == micro precision ==
accuracy).  The device reduces a batch to five counts (``metric_counts``);
the host derives the metrics from them (``counts_to_metrics``)."""

from __future__ import annotations

import torch


def metric_counts(preds: torch.Tensor, labels: torch.Tensor,
                  valid_mask: torch.Tensor) -> torch.Tensor:
    """[valid, correct, tp, fp, fn] over the batch, on its device, int64."""
    m = valid_mask > 0
    pos_t = labels == 1
    pos_p = preds == 1
    return torch.stack([m.sum(), ((preds == labels) & m).sum(),
                        (pos_t & pos_p & m).sum(), (~pos_t & pos_p & m).sum(),
                        (pos_t & ~pos_p & m).sum()])


def counts_to_metrics(counts, class_num: int = 2):
    """(accuracy, recall, precision) from [valid, correct, tp, fp, fn]:
    recall 0.0 without positives, precision 0.0 without predicted
    positives (sklearn's zero_division)."""
    valid, correct, tp, fp, fn = (int(c) for c in counts)
    acc = correct / valid if valid > 0 else 0.0
    if class_num == 2:
        rec = tp / (tp + fn) if (tp + fn) > 0 else 0.0
        prec = tp / (tp + fp) if (tp + fp) > 0 else 0.0
        return acc, rec, prec
    return acc, acc, acc
