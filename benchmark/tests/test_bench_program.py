"""The readers of the program's own spans and counts: each one's arithmetic
on a synthetic record and trace, None for a program that keeps no record,
the device reader's thread rules on a CPU trace of one tiny step, and a
value from every host reader after a tiny run of each cell on the CPU."""

import math
import time
import types

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window


def _record():
    from deepsignal_tpu_torch.core.logging import Record

    rec = Record()
    # the reader's batches as the entry received them: the first done before
    # the window (a backlog), the last received after it
    for at, group, parse, rows in ((100.5, 0.2, 1.0, 3000),
                                   (102.5, 0.4, 2.0, 1000),
                                   (111.0, 3.0, 5.0, 7000)):
        taken = ({"reader.group": [(None, at - 2.0, group)],
                  "reader.parse": [(None, at - 1.0, parse)]},
                 {"reader.rows": [(at - 0.5, rows)]})
        rec.received.append((at, taken))
    spans = [  # (name, parent, start, seconds)
        ("caller.wire", "caller.dispatch", 101.0, 0.002),
        ("caller.wire", "caller.dispatch", 102.0, 0.004),
        ("caller.wire", "caller.dispatch", 111.0, 0.100),  # after it
        ("caller.forward", "caller.dispatch", 101.1, 0.010),
        ("caller.forward", "caller.dispatch", 102.1, 0.030),
        ("caller.wait", None, 101.5, 0.001),
        ("caller.wait", None, 102.5, 0.003),
        ("caller.format", None, 101.6, 0.005),
        ("caller.format", None, 102.6, 0.007),
        ("caller.write", None, 101.7, 0.001),
        ("caller.write", None, 102.7, 0.003),
        ("trainer.step", None, 103.0, 0.050),
        ("trainer.step", None, 104.0, 0.070),
        ("trainer.zero_grad", "trainer.step", 103.0, 0.001),
        ("trainer.zero_grad", "trainer.step", 104.0, 0.003),
        ("model.forward", "trainer.step", 103.01, 0.010),
        ("model.forward", "trainer.step", 104.01, 0.020),
        ("model.forward", None, 105.0, 0.500),     # an eval, not a step
        ("trainer.backward", "trainer.step", 103.02, 0.020),
        ("trainer.backward", "trainer.step", 104.02, 0.040),
        ("trainer.optimizer", "trainer.step", 103.04, 0.004),
        ("trainer.optimizer", "trainer.step", 104.04, 0.008),
        ("trainer.build", None, 50.0, 1.5),
        ("trainer.build_optimizer", None, 51.6, 7.5),
        ("trainer.restore", None, 52.0, 0.25),
        ("trainer.build", None, 120.0, 9.0),       # after set-up
    ]
    for name, parent, start, seconds in spans:
        rec.add_span(name, parent, start, seconds)
    return rec


EXPECT = {
    "parse_us_per_row.call": 1e6 * 3.0 / 4000,
    "group_us_per_row.call": 1e6 * 0.6 / 4000,
    "reader_busy_share.call": 100.0 * 3.6 / 10.0,
    "wire_ms.call": 3.0,
    "launch_ms.call": 20.0,
    "device_wait_ms.call": 2.0,
    "format_ms.call": (5 + 7 + 1 + 3) / 2,
    "forward_host_ms.train": 15.0,
    "backward_host_ms.train": 30.0,
    "optimizer_host_ms.train": (1 + 3 + 4 + 8) / 2,
    "trainer_build_s.train": 1.5,
    "trainer_restore_s.train": 0.25,
    "optimizer_build_s.train": 7.5,
}


def _reader(name):
    from dsbench import spec
    return spec.load("metrics", name, str(BENCH))


@pytest.fixture
def program_record(monkeypatch):
    from dsbench import program
    rec = _record()
    monkeypatch.setattr(program, "record", lambda: rec)
    return rec


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_a_reader_of_the_record(program_record, name):
    got = _reader(name).read({"window": (W0, W1)}, None)
    assert got == pytest.approx(EXPECT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECT) + ["backward_device_ms.train"])
def test_a_program_without_a_record_reads_nothing(monkeypatch, name):
    from deepsignal_tpu_torch.core.logging import Record
    from dsbench import program
    res = {"window": (W0, W1), "trace": None}
    monkeypatch.setattr(program, "record", lambda: None)
    assert _reader(name).read(res, None) is None
    monkeypatch.setattr(program, "record", Record)   # a record, but empty
    assert _reader(name).read(res, None) is None


def test_the_program_without_its_logging_module_reads_nothing(monkeypatch):
    import sys

    import deepsignal_tpu_torch.core
    from dsbench import program
    older = types.ModuleType("deepsignal_tpu_torch.core.logging")
    monkeypatch.setitem(sys.modules, older.__name__, older)
    monkeypatch.setattr(deepsignal_tpu_torch.core, "logging", older)
    assert program.record() is None


def test_backward_device_time_counts_every_thread_but_the_stage():
    trace = types.SimpleNamespace(
        annotations=[(100, 200, "trainer.backward", 1),
                     (150, 160, "trainer.stage", 2),
                     (300, 400, "trainer.backward", 1)],
        launched=sorted([(120, 1, 5_000_000),      # the step's thread
                         (130, 3, 7_000_000),      # the autograd thread
                         (155, 2, 11_000_000),     # staging the next batch
                         (170, 2, 13_000_000),     # thread 2, no stage
                         (250, 1, 1_000_000),      # between the two
                         (350, 3, 2_000_000)]))
    from dsbench.program import device_s_under
    assert device_s_under(trace, "trainer.backward", "trainer.stage") == \
        pytest.approx([0.025, 0.002])
    got = _reader("backward_device_ms.train").read({"trace": trace}, None)
    assert got == pytest.approx(13.5)


def test_a_cpu_trace_of_one_step_holds_the_program_spans():
    import numpy as np

    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.train.trainer import Trainer
    from dsbench.program import device_s_under
    from dsbench.tracing import DeviceTrace
    cfg = ModelConfig(kmer_len=5, cent_signals_len=25, vocab_size=16,
                      embedding_size=4, lstm_hidden=8, inception_times=1,
                      inception_blocks=(1, 1, 1))
    trainer = Trainer(cfg, TrainConfig(batch_size=8), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"kmer": rng.integers(0, 4, (8, 5)).astype(np.int32),
             "means": rng.normal(size=(8, 5)).astype(np.float32),
             "stds": rng.random((8, 5)).astype(np.float32),
             "sanums": rng.integers(1, 9, (8, 5)).astype(np.float32),
             "signals": rng.normal(size=(8, 25)).astype(np.float32),
             "labels": rng.integers(0, 2, 8).astype(np.int32)}
    tracer = DeviceTrace(("step",), cuda=False)
    tracer.start()
    trainer.resolve_metrics(trainer.train_on_batch_async(
        trainer.stage_batch(batch), 1e-3))
    data = tracer.stop()
    names = [n for _, _, n, _ in sorted(data.annotations)]
    for name in ("trainer.stage", "trainer.step", "model.forward",
                 "trainer.backward", "trainer.optimizer", "trainer.resolve"):
        assert names.count(name) == 1, name
    assert names.index("trainer.step") < names.index("trainer.backward")
    # the CPU launches nothing on a device: one call, no device time
    assert device_s_under(data, "trainer.backward", "trainer.stage") == [0.0]
    assert _reader("backward_device_ms.train").read({"trace": data},
                                                    None) is None


@pytest.mark.parametrize("cell", ["cpg.call-features", "cpg.call-tsv",
                                  "rnn.train"])
def test_every_host_reader_reads_a_tiny_run(tiny, cell):
    import run
    import torch
    from dsbench import spec
    root, base = tiny
    args = run.parse_args(["--workload", cell, "--seed", str(2**31 + 11),
                           "--seconds", "1"])
    spec_cell = spec.Cell(cell, spec.benchmark(root), str(base))
    res = spec_cell.driver.run(run.Context(spec_cell, args,
                                           torch.device("cpu")))
    assert res["failed"] == 0
    # from the window's start to the run's end: on a loaded CPU one tiny
    # device batch can outlast the 1 s window
    res["window"] = (res["window"][0], time.perf_counter())
    ours = [m for m in spec_cell.per_layer if m["source"] == "program_span"
            and m["name"] in EXPECT]
    assert ours
    for m in ours:
        value = spec_cell.reader(m["name"]).read(res, spec_cell)
        assert value is not None and math.isfinite(value) and value > 0, \
            m["name"]
