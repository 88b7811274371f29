"""Batch metrics with the reference's sklearn semantics
(train_model.py:163-174): binary accuracy/recall/precision for
class_num == 2, micro-averaged otherwise (micro recall == micro precision ==
accuracy).  The device reduces a batch to five counts (``metric_counts``);
the host derives the metrics from them (``counts_to_metrics``).  The host
functions ``accuracy``, ``binary_recall``, ``binary_precision`` and
``batch_metrics`` take the labels and predictions themselves, as numpy
arrays or anything ``np.asarray`` takes, and give the same numbers."""

from __future__ import annotations

import numpy as np
import torch


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def binary_recall(y_true, y_pred) -> float:
    """sklearn's recall_score: 0.0 without positives."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    fn = int(np.sum((y_true == 1) & (y_pred == 0)))
    return tp / (tp + fn) if (tp + fn) > 0 else 0.0


def binary_precision(y_true, y_pred) -> float:
    """sklearn's precision_score: 0.0 without predicted positives."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = int(np.sum((y_true == 1) & (y_pred == 1)))
    fp = int(np.sum((y_true == 0) & (y_pred == 1)))
    return tp / (tp + fp) if (tp + fp) > 0 else 0.0


def batch_metrics(y_true, y_pred, class_num: int = 2):
    """(accuracy, recall, precision) per the reference's branch
    (train_model.py:165-174): binary for class_num == 2, else micro, where
    all three are the accuracy."""
    acc = accuracy(y_true, y_pred)
    if class_num == 2:
        return (acc, binary_recall(y_true, y_pred),
                binary_precision(y_true, y_pred))
    return acc, acc, acc


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
