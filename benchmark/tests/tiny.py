"""A copy of the benchmark at tiny widths, for runs on the CPU: every
configuration shrunk (3-layer BiLSTM at H 16 over 7-mers, Inception x2 with
one block a stage over 60 signals) and every traffic cut to batches of 64,
in a directory of its own whose checkout links the port."""

import json
import os
import pathlib
import shutil

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
TINY_MODEL = {"kmer_len": 7, "cent_signals_len": 60, "vocab_size": 16,
              "embedding_size": 8, "lstm_hidden": 16, "inception_times": 2,
              "inception_blocks": [1, 1, 1]}
TINY_TRAFFIC = {"batch_rows": 64, "pool_batches": 4, "block_rows": 500,
                "reads_per_batch": 5, "settle_rows": 32,
                "warmup_batches": 2, "warmup_steps": 2, "warmup_max_s": 3,
                "reads": {"median": 6, "sigma": 1.0, "max": 60}}


def tiny_tree(root: pathlib.Path) -> tuple:
    """(checkout root, benchmark dir) of a tiny copy under ``root``."""
    base = root / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    os.symlink(REPO / "deepsignal_tpu_torch", root / "deepsignal_tpu_torch")
    for path in (base / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["model"].update(TINY_MODEL)
        path.write_text(json.dumps(cfg))
    for path in (base / "traffic").glob("*.json"):
        tp = json.loads(path.read_text())
        tp.update(TINY_TRAFFIC)
        path.write_text(json.dumps(tp))
    return root, base
