"""BENCHMARK.json keeps the contract's shape, every name in it is found as
a file, and a cell, a configuration, a traffic mix and a metric added as
files alone are found by name and run."""

import json
import re
import shutil


from tiny import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert (REPO / c["file"]).exists()
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        names.add(m["name"])
    assert len(names) == len(b["end_to_end"]) + len(b["per_layer"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved


def test_every_cell_has_its_files_and_metrics():
    from dsbench import spec
    b = bench()
    for w in b["workloads"]:
        cell = spec.Cell(w["name"], b)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        assert set(cell.limits["numbers"])


def _add_cell(root):
    """A configuration, a traffic mix, a cell, its limits and a metric,
    added as files and entries only."""
    base = root / "benchmark"
    cfg = json.loads((base / "configs" / "deepsignal-rnn.json").read_text())
    cfg["name"] = "deepsignal-rnn-h128"
    cfg["model"]["lstm_hidden"] = 8
    (base / "configs" / "deepsignal-rnn-h128.json").write_text(
        json.dumps(cfg))
    tp = json.loads((base / "traffic" / "train.json").read_text())
    tp["keep_prob"] = 1.0
    (base / "traffic" / "train-nodrop.json").write_text(json.dumps(tp))
    shutil.copy(base / "limits" / "rnn.train.json",
                base / "limits" / "rnn128.train-nodrop.json")
    (base / "metrics" / "steps_in_window.train.py").write_text(
        "def read(res, cell):\n    return res['completed']\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "deepsignal-rnn-h128", "source": "x",
                         "file": "benchmark/configs/deepsignal-rnn-h128.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "rnn128.train-nodrop",
                           "config": "deepsignal-rnn-h128",
                           "traffic": "train-nodrop", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "steps_in_window.train", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train.trainer",
                           "moves": "train_sites_per_s",
                           "workloads": ["rnn128.train-nodrop"]})
    for m in b["end_to_end"]:
        if m["name"] == "train_sites_per_s":
            m["workloads"].append("rnn128.train-nodrop")
    (root / "BENCHMARK.json").write_text(json.dumps(b))


def test_a_cell_added_as_files_is_found_and_runs(tiny, tmp_path):
    import run
    from dsbench import spec
    src_root, _ = tiny
    root = tmp_path / "added"
    shutil.copytree(src_root, root, symlinks=True)
    _add_cell(root)
    base = root / "benchmark"
    cell = spec.Cell("rnn128.train-nodrop", spec.benchmark(root), base)
    assert cell.sizes["lstm_hidden"] == 8
    assert cell.traffic["keep_prob"] == 1.0
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window.train"]
    assert cell.reader("steps_in_window.train").read(
        {"completed": 3}, cell) == 3
    assert cell.count("encoder", 4)[0] > 0
    out, checks = run.measure(
        ["--workload", "rnn128.train-nodrop", "--seed", "5", "--seconds",
         "0.5"], device="cpu", base=str(base), root=str(root))
    assert out["correct"], checks
    assert out["attempted"] >= 1
