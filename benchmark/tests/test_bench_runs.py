"""Whole runs of the harness: it refuses to run without a card, and with
the look for a card skipped (a tiny copy on the CPU) every cell's
comparison passes a sound run and fails each fault its cell can have."""

import json
import os
import subprocess
import sys

import pytest

from tiny import BENCH, REPO

CELLS = ("cpg.call-features", "cpg.call-tsv", "rnn.train", "cpg.train")


def test_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cpg.call-features", "--seed", "1", "--seconds", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_refuses_outside_a_checkout(tmp_path):
    shutil = __import__("shutil")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "cpg.call-features", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "{" not in out.stdout


def _run(tiny, cell, fault=None, seed=2**31 + 7):
    import run
    root, base = tiny
    out, checks = run.measure(
        ["--workload", cell, "--seed", str(seed), "--seconds", "0.5"],
        device="cpu", fault=fault, base=str(base), root=str(root))
    assert list(out)[-1] == "checks"
    json.dumps(out)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {}  # no metric from a run on the CPU


@pytest.mark.parametrize("cell,fault", [
    ("cpg.call-features", "altered_answer"),
    ("cpg.call-tsv", "altered_answer"),
    ("rnn.train", "unchanged_state"), ("rnn.train", "half_batch"),
    ("cpg.train", "unchanged_state"), ("cpg.train", "half_batch")])
def test_a_fault_is_not_correct(tiny, cell, fault):
    from dsbench import faults
    entry = "call" if "call" in cell else "train"
    out = _run(tiny, cell, faults.FAULTS[entry][fault])
    assert not out["correct"], out["checks"]
