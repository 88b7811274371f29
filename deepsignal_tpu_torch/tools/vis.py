"""Training-log plots (port of deepsignal_tpu/tools/vis.py; the
reference's scripts/visualize_log.py).

Parses the train.txt / valid.txt lines that ``train`` writes,
``epoch:0, iterid:100, loss:3.545, accuracy:0.501, recall:0.378,
precision:0.511``, and draws the 2x2 loss/accuracy/recall/precision panel.
matplotlib is imported at the first draw; without it ``draw_log`` raises
RuntimeError.
"""

from __future__ import annotations

import os
from typing import Optional

METRICS = ("loss", "accuracy", "recall", "precision")


def parse_log_file(path: str) -> dict:
    """metric -> its values, in line order; lines of another shape are
    skipped."""
    out = {key: [] for key in METRICS}
    with open(path, "r") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) != 6:
                continue
            for key, part in zip(METRICS, parts[2:]):
                out[key].append(float(part.split(":")[-1].strip(",")))
    return out


def draw_log(logdir: str, out_fp: Optional[str] = None,
             train_log_txt: str = "train.txt",
             valid_log_txt: str = "valid.txt") -> str:
    """Plot ``logdir``'s train and valid curves into ``out_fp`` (default
    ``<logdir>/train_valid_curves.png``); returns the path."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError(
            "matplotlib is required for log visualization") from e

    train = parse_log_file(os.path.join(logdir, train_log_txt))
    valid = parse_log_file(os.path.join(logdir, valid_log_txt))
    if out_fp is None:
        out_fp = os.path.join(logdir, "train_valid_curves.png")

    fig, axes = plt.subplots(2, 2, figsize=(10, 8))
    for ax, key in zip(axes.flat, METRICS):
        ax.plot(range(len(train[key])), train[key], "orange", label="train")
        ax.plot(range(len(valid[key])), valid[key], "blue", label="valid")
        ax.set_title(key)
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_fp)
    plt.close(fig)
    return out_fp
