"""The port's spans and counters (``core/logging.py``): what a span
records, the record's bound, the profiler ranges a span opens only under a
profiler, and the spans of the call path, the train step and the feature
reader, on the CPU."""

import ast
import json
import os
import pathlib
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from deepsignal_tpu_torch.core import logging
from deepsignal_tpu_torch.core.config import TrainConfig
from deepsignal_tpu_torch.core.logging import RECORD, Record, count, span
from deepsignal_tpu_torch.io.feature_codec import (FeatureBatch,
                                                   parse_feature_lines)
from deepsignal_tpu_torch.runtime import pipeline
from deepsignal_tpu_torch.runtime.caller import (ModCaller,
                                                 call_mods_on_batches)
from deepsignal_tpu_torch.train.checkpoints import state_dict_to_variables
from deepsignal_tpu_torch.train.trainer import Trainer
from tests import torch_tiny as tt

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "deepsignal_tpu_torch"
PREFIXES = ("pipeline.", "reader.", "caller.", "model.", "trainer.",
            "lstm.", "inception.", "bn.", "pool.", "conv.")
# the ranges the benchmark's harness opens around the objects it drives
HARNESS_RANGES = {"read_wait", "dispatch", "collect", "forward", "encoder",
                  "inception", "head", "step", "resolve", "stage"}
STEP_CHILDREN = ["trainer.zero_grad", "model.forward", "trainer.loss",
                 "trainer.backward", "trainer.optimizer", "trainer.metrics"]
CALLER_SPANS = ("caller.dispatch", "caller.wire", "caller.forward",
                "caller.wait", "caller.format", "caller.write")
MAX_SPANS = 16  # per device batch and per train step


def _recorded(t0: float, t1: float) -> list:
    """(start, name, parent, seconds) of every span of this process that
    started in [t0, t1), in order."""
    return sorted((t, name, p, d) for name, q in list(RECORD.spans.items())
                  for p, t, d in list(q) if t0 <= t < t1)


def test_a_span_records_name_parent_start_and_seconds():
    before = time.perf_counter()
    with span("test.outer"):
        with span("test.inner"):
            time.sleep(0.01)
    after = time.perf_counter()
    (p_out, t_out, d_out), = RECORD.spans["test.outer"]
    (p_in, t_in, d_in), = RECORD.spans["test.inner"]
    assert p_out is None and p_in == "test.outer"
    assert before <= t_out <= t_in and t_in + d_in <= t_out + d_out <= after
    assert d_in >= 0.01
    assert RECORD.within("test.inner", before, after) == [d_in]
    assert RECORD.within("test.inner", before, after, parent=None) == []
    assert RECORD.within("test.inner", after, after + 1) == []
    assert RECORD.within("test.outer", before, after, parent=None) == [d_out]


def test_a_span_left_by_an_exception_is_recorded_and_closed():
    with pytest.raises(ValueError):
        with span("test.raises"):
            raise ValueError("x")
    with span("test.after"):
        pass
    assert len(RECORD.spans["test.raises"]) == 1
    assert RECORD.spans["test.after"][-1][0] is None


def test_the_parent_is_the_innermost_span_of_the_same_thread():
    seen = []

    def other():
        with span("test.thread"):
            seen.append(True)

    with span("test.main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen
    assert RECORD.spans["test.thread"][-1][0] is None


def test_counts_are_recorded_with_their_time():
    t0 = time.perf_counter()
    count("test.rows", 7)
    count("test.rows", 5)
    assert RECORD.counted("test.rows", t0, time.perf_counter()) == [7, 5]
    assert RECORD.counted("test.rows", 0, t0) == []


def test_the_record_is_bounded_per_name():
    assert logging.RECORD_LEN >= 4096 and RECORD.maxlen == logging.RECORD_LEN
    n = RECORD.maxlen + 10
    for _ in range(n):
        with span("test.bounded"):
            pass
        count("test.bounded", 1)
    assert len(RECORD.spans["test.bounded"]) == RECORD.maxlen
    assert len(RECORD.counts["test.bounded"]) == RECORD.maxlen
    small = Record(maxlen=3)
    for i in range(5):
        small.add_span("a", None, float(i), 1.0)
    assert [t for _, t, _ in small.spans["a"]] == [2.0, 3.0, 4.0]


def test_take_empties_the_record_and_extend_files_it():
    src, dst = Record(), Record()
    src.add_span("reader.parse", None, 1.0, 0.5)
    src.add_count("reader.rows", 1.5, 40)
    taken = src.take()
    assert src.spans == {} and src.counts == {}
    t0 = time.perf_counter()
    dst.extend(taken)
    dst.extend(taken)
    t1 = time.perf_counter()
    # by the sender's stamps, and by the time they were received
    assert dst.within("reader.parse", 0, 2) == [0.5, 0.5]
    assert dst.counted("reader.rows", 0, 2) == [40, 40]
    assert dst.within("reader.parse", t0, t1, received=True) == [0.5, 0.5]
    assert dst.counted("reader.rows", t0, t1, received=True) == [40, 40]
    assert dst.within("reader.parse", 0, 2, received=True) == []
    assert dst.within("reader.parse", t0, t1) == []


def test_no_profiler_range_is_opened_outside_a_profiler(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    with span("test.unprofiled"):
        pass
    assert opened == []
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with span("test.profiled"):
            pass
    assert opened == ["test.profiled"]


def test_a_span_is_a_user_annotation_in_the_chrome_trace(tmp_path):
    with logging.trace(str(tmp_path / "prof"), "cpu") as path:
        with span("test.annotated"):
            with span("test.annotated_inner"):
                torch.ones(8).sum()
    events = json.loads(pathlib.Path(path).read_text())["traceEvents"]
    got = {e["name"]: e for e in events
           if e.get("cat") == "user_annotation"}
    assert {"test.annotated", "test.annotated_inner"} <= set(got)
    outer, inner = got["test.annotated"], got["test.annotated_inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _tiny_batch(rows: int, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    k, s = tt.K, tt.S
    return dict(kmer=rng.integers(0, 4, (rows, k)).astype(np.int32),
                means=rng.normal(0, 1, (rows, k)).astype(np.float32),
                stds=np.abs(rng.normal(0, 1, (rows, k))).astype(np.float32),
                sanums=rng.integers(1, 30, (rows, k)).astype(np.float32),
                signals=rng.normal(0, 1, (rows, s)).astype(np.float32),
                labels=rng.integers(0, 2, rows).astype(np.int32))


@pytest.fixture(scope="module")
def trainer():
    t0 = time.perf_counter()
    trainer = Trainer(tt.tiny_cfg(), TrainConfig(batch_size=16, seed=9),
                      device="cpu")
    trainer.restore(trainer.variables, trainer.train_state())
    return trainer, t0, time.perf_counter()


def test_the_trainer_set_up_records_its_stages(trainer):
    _, t0, t1 = trainer
    names = [name for _, name, _, _ in _recorded(t0, t1)
             if name.startswith("trainer.")]
    assert names == ["trainer.build", "trainer.build_optimizer",
                     "trainer.restore"]


def test_a_train_step_records_its_children_in_order(trainer):
    trainer, _, _ = trainer
    staged = trainer.stage_batch(_tiny_batch(16))
    t0 = time.perf_counter()
    handle = trainer.train_on_batch_async(staged, 1e-3)
    t1 = time.perf_counter()
    trainer.resolve_metrics(handle)
    spans = _recorded(t0, t1)
    (t_step, _, parent, d_step), = [s for s in spans
                                    if s[1] == "trainer.step"]
    assert parent is None
    children = [s for s in spans if s[2] == "trainer.step"]
    assert [name for _, name, _, _ in children] == STEP_CHILDREN
    for t, _, _, d in children:
        assert t_step <= t and t + d <= t_step + d_step
    ends = [t + d for t, _, _, d in children]
    assert all(a <= t for a, (t, *_) in zip(ends, children[1:]))
    under_model = [name for _, name, p, _ in spans if p == "model.forward"]
    assert under_model == ["model.encoder", "model.inception", "model.head"]
    assert len(spans) <= MAX_SPANS
    assert len(RECORD.within("trainer.resolve", t1, time.perf_counter())) \
        == 1


def test_an_unstaged_step_stages_its_batch_inside_the_step(trainer):
    trainer, _, _ = trainer
    t0 = time.perf_counter()
    trainer.train_on_batch(_tiny_batch(16, seed=4), 1e-3)
    spans = _recorded(t0, time.perf_counter())
    assert [name for _, name, p, _ in spans if p == "trainer.step"] == \
        ["trainer.stage"] + STEP_CHILDREN


def _feature_batches(n_rows: int) -> list:
    fb = parse_feature_lines(tt.tiny_feature_rows(n=n_rows))
    return [fb[i:i + 7] for i in range(0, n_rows, 7)]


def test_call_mods_records_each_caller_span_once_per_device_batch(tmp_path):
    t0 = time.perf_counter()
    caller = ModCaller(tt.tiny_cfg(), state_dict_to_variables(
        tt.tiny_cfg(), tt.tiny_state_dict()), batch_size=8, device="cpu")
    t1 = time.perf_counter()
    assert [name for _, name, _, _ in _recorded(t0, t1)
            if name.startswith("caller.")] == ["caller.build"]
    n_rows, bs = 40, 8
    written = call_mods_on_batches(caller, iter(_feature_batches(n_rows)),
                                   str(tmp_path / "calls.tsv"))
    t2 = time.perf_counter()
    assert written == n_rows
    n = n_rows // bs
    got = {name: len(RECORD.within(name, t1, t2)) for name in CALLER_SPANS}
    assert got == {name: n for name in CALLER_SPANS}
    # every pull from the input, and the last one that finds its end
    assert len(RECORD.within("caller.read_wait", t1, t2)) == \
        len(_feature_batches(n_rows)) + 1
    assert len(RECORD.within("caller.wire", t1, t2,
                             parent="caller.dispatch")) == n
    assert len(RECORD.within("model.forward", t1, t2,
                             parent="caller.forward")) == n
    assert len(RECORD.within("caller.wait", t1, t2, parent=None)) == n
    assert len(_recorded(t1, t2)) <= MAX_SPANS * n


def test_a_feature_batch_of_two_device_batches_waits_on_each(tmp_path):
    caller = ModCaller(tt.tiny_cfg(), state_dict_to_variables(
        tt.tiny_cfg(), tt.tiny_state_dict()), batch_size=16, device="cpu")
    fb = parse_feature_lines(tt.tiny_feature_rows(n=20))
    t0 = time.perf_counter()
    rows, _, _ = caller.call_feature_batch(fb)
    t1 = time.perf_counter()
    assert len(rows) == 20
    got = {name: len(RECORD.within(name, t0, t1)) for name in CALLER_SPANS}
    assert got == {"caller.dispatch": 1, "caller.wire": 2,
                   "caller.forward": 2, "caller.wait": 2,
                   "caller.format": 1, "caller.write": 0}


def _write_features(path: pathlib.Path, n_rows: int) -> str:
    path.write_text("\n".join(tt.tiny_feature_rows(n=n_rows)) + "\n")
    return str(path)


def test_the_reader_delivers_its_spans_with_each_batch(tmp_path):
    tsv = _write_features(tmp_path / "f.tsv", 40)
    t0 = time.perf_counter()
    stream = pipeline.stream_file_feature_batches(tsv, 1)
    got = []
    try:
        for i, fb in enumerate(stream, 1):
            now = time.perf_counter()
            got.append(len(fb))
            # the batch's own entries came with it, the end of file has
            # not been read yet
            assert len(RECORD.within("reader.parse", t0, now)) == i
            assert len(RECORD.within("reader.group", t0, now)) == i
            assert RECORD.counted("reader.rows", t0, now) == got
            assert len(RECORD.within("reader.put", t0, now)) == i - 1
            assert len(RECORD.within("pipeline.get", t0, now)) >= i
            assert RECORD.counted("reader.rows", t0, now,
                                  received=True) == got
    finally:
        stream.close()
    assert sum(got) == 40 and len(got) == 7  # 6 sites a read
    t1 = time.perf_counter()
    assert len(RECORD.within("reader.put", t0, t1)) == len(got)
    assert RECORD.within("reader.parse", t0, t1, parent=None) == \
        RECORD.within("reader.parse", t0, t1)


def test_the_reader_process_records_without_torch(tmp_path):
    """What the spawned reader runs, in a fresh interpreter: its items
    carry their entries, and torch is never imported."""
    tsv = _write_features(tmp_path / "f.tsv", 40)
    code = ("import pickle, sys\n"
            "from deepsignal_tpu_torch.runtime.pipeline import "
            "_file_reader_proc\n"
            "class Q(list):\n"
            "    def send_bytes(self, data):\n"
            "        self.append(pickle.loads(data))\n"
            "q = Q()\n"
            f"_file_reader_proc({tsv!r}, q, 1)\n"
            "print([(kind, len(taken[0].get('reader.parse', ())),\n"
            "        taken[1].get('reader.rows', [(0, 0)])[0][1])\n"
            "       for kind, _, taken in q])\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    items, has_torch = out.stdout.strip().splitlines()
    assert has_torch == "False"
    items = ast.literal_eval(items)
    assert [k for k, _, _ in items] == ["batch"] * 7 + ["done"]
    assert [n for _, n, _ in items[:7]] == [1] * 7
    assert sum(rows for _, _, rows in items[:7]) == 40


def test_the_in_process_reader_records_the_same_spans(tmp_path):
    from deepsignal_tpu_torch.io.feature_codec import \
        iter_feature_batches_by_read
    tsv = _write_features(tmp_path / "f.tsv", 40)
    t0 = time.perf_counter()
    got = list(iter_feature_batches_by_read(tsv, 2, (1, 2)))
    t1 = time.perf_counter()
    assert all(isinstance(fb, FeatureBatch) for fb in got)
    assert len(RECORD.within("reader.parse", t0, t1)) == len(got)
    assert RECORD.counted("reader.rows", t0, t1) == [len(fb) for fb in got]


def _span_names() -> dict:
    """Each literal span and count name in the port's sources, with the
    file it is in."""
    pattern = re.compile(r"\b(?:span|count)\(\"([^\"]+)\"")
    return {m: p.relative_to(REPO) for p in PORT.rglob("*.py")
            for m in pattern.findall(p.read_text())}


def _harness_ranges() -> set:
    names = set(HARNESS_RANGES)
    for path in (REPO / "benchmark" / "drivers").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Assign) and any(
                    getattr(t, "id", "") == "RANGES" for t in node.targets):
                names |= set(ast.literal_eval(node.value))
    return names


def test_no_program_span_takes_a_harness_range_name():
    names = _span_names()
    assert {"reader.group", "reader.parse", "reader.put", "reader.rows",
            "reader.read", "reader.chunk_wait", "reader.native",
            "reader.decode", "reader.pickle", "pipeline.recv",
            "caller.rechunk",
            "pipeline.get", "caller.read_wait", "caller.build",
            "model.forward", "model.encoder", "model.inception",
            "model.head", "trainer.step", "trainer.build",
            "trainer.build_optimizer",
            "trainer.restore", "trainer.resolve",
            "trainer.stage", "inception.graph_replay", "inception.eager",
            "inception.train_graph_replay", "inception.train_eager",
            "bn.kernel", "bn.plain", "pool.kernel", "pool.plain",
            "conv.merged", "conv.split",
            *CALLER_SPANS, *STEP_CHILDREN} <= set(names)
    assert [n for n in names if not n.startswith(PREFIXES)] == []
    assert set(names) & _harness_ranges() == set()
    assert "read_wait" in _harness_ranges()


def test_core_logging_imports_and_records_without_torch():
    code = ("import sys\n"
            "from deepsignal_tpu_torch.core.logging import RECORD, span\n"
            "with span('test.x'):\n"
            "    pass\n"
            "print(len(RECORD.spans['test.x']), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "False"]
