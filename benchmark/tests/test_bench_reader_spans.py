"""The readers of the TSV call path's finer spans: the feature reader's
chunk reads, chunk waits, native parse, decode and pickling, the
consumer's receipt and the caller's re-chunking.  Each one's arithmetic on
a hand-built record, None for a program that keeps no record or none of
its spans, and a value from each after a tiny run on the CPU."""

import math
import time

import pytest

from tiny import BENCH

W0, W1 = 100.0, 110.0   # the synthetic measured window
READER = {  # metric: the reader process's span it reads
    "chunk_read_us_per_row.call": "reader.read",
    "chunk_wait_us_per_row.call": "reader.chunk_wait",
    "native_parse_us_per_row.call": "reader.native",
    "decode_us_per_row.call": "reader.decode",
    "pickle_us_per_row.call": "reader.pickle",
}
NAMES = sorted(READER) + ["recv_us_per_row.call", "rechunk_ms.call"]
# each reader span's seconds in the four items below: one received before
# the window, two in it, one after it
ITEMS = ((99.0, 3000), (101.0, 1000), (105.0, 4000), (111.0, 7000))
SECONDS = {"reader.read": (0.5, 0.25, 0.125, 9.0),
           "reader.chunk_wait": (0.1, 0.15, 0.05, 9.0),
           "reader.native": (1.0, 0.75, 3.0, 9.0),
           "reader.decode": (0.2, 0.05, 0.25, 9.0),
           "reader.pickle": (0.3, 0.35, 0.5, 9.0)}


def _reader(name):
    from dsbench import spec
    return spec.load("metrics", name, str(BENCH))


def _planted():
    """A record as the entry holds it after three of the reader's items
    and its own spans: rows received in the window 1,000 + 4,000."""
    from deepsignal_tpu_torch.core.logging import Record

    rec = Record()
    for i, (at, rows) in enumerate(ITEMS):
        spans = {name: [(None, at - 1.0, s[i])]
                 for name, s in SECONDS.items()}
        rec.received.append((at, (spans, {"reader.rows": [(at - 0.5,
                                                           rows)]})))
    for name, parent, start, seconds in (
            ("pipeline.recv", "pipeline.get", 99.5, 0.5),     # before it
            ("pipeline.recv", "pipeline.get", 101.0, 0.002),
            ("pipeline.recv", "pipeline.get", 105.0, 0.003),
            ("pipeline.recv", "pipeline.get", 111.0, 0.5),    # after it
            ("caller.rechunk", None, 101.2, 0.004),
            ("caller.rechunk", None, 103.2, 0.002),
            ("caller.rechunk", None, 110.5, 0.5),             # after it
            ("caller.dispatch", None, 101.3, 0.010),
            ("caller.dispatch", None, 102.3, 0.010),
            ("caller.dispatch", None, 103.3, 0.010),
            ("caller.dispatch", None, 104.3, 0.010)):
        rec.add_span(name, parent, start, seconds)
    return rec


EXPECT = {metric: 1e6 * (SECONDS[span][1] + SECONDS[span][2]) / 5000
          for metric, span in READER.items()}
EXPECT["recv_us_per_row.call"] = 1e6 * 0.005 / 5000
EXPECT["rechunk_ms.call"] = 1e3 * 0.006 / 4   # over four dispatches


@pytest.fixture
def use_record(monkeypatch):
    from dsbench import program

    def use(rec):
        monkeypatch.setattr(program, "record", lambda: rec)
    return use


@pytest.mark.parametrize("name", NAMES)
def test_a_reader_of_a_planted_record(use_record, name):
    use_record(_planted())
    got = _reader(name).read({"window": (W0, W1)}, None)
    assert got == pytest.approx(EXPECT[name], rel=1e-9)


@pytest.mark.parametrize("name", NAMES)
def test_no_record_and_an_empty_record_read_nothing(use_record, name):
    from deepsignal_tpu_torch.core.logging import Record
    use_record(None)
    assert _reader(name).read({"window": (W0, W1)}, None) is None
    use_record(Record())
    assert _reader(name).read({"window": (W0, W1)}, None) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_record_without_the_span_reads_nothing(use_record, name):
    """What a program before these spans keeps: rows, dispatches and the
    older spans, none of the one the reader reads."""
    rec = _planted()
    dropped = READER.get(name) or {"recv_us_per_row.call": "pipeline.recv",
                                   "rechunk_ms.call": "caller.rechunk"}[name]
    rec.spans.pop(dropped, None)
    for _, (spans, _) in rec.received:
        spans.pop(dropped, None)
    use_record(rec)
    assert _reader(name).read({"window": (W0, W1)}, None) is None


def test_rechunk_is_per_dispatch_not_per_rechunk(use_record):
    rec = _planted()
    for start in (105.3, 106.3, 107.3, 108.3):   # four more device batches
        rec.add_span("caller.dispatch", None, start, 0.010)
    use_record(rec)
    got = _reader("rechunk_ms.call").read({"window": (W0, W1)}, None)
    assert got == pytest.approx(1e3 * 0.006 / 8, rel=1e-9)


# A tiny run's reader runs up to its queue's bound ahead of the consumer,
# and the pickling of a batch rides the item the reader builds next: a
# run that stops before the backlog drains may receive none of them.
@pytest.mark.parametrize("cell, names", [
    ("cpg.call-tsv", [n for n in NAMES if n != "pickle_us_per_row.call"]),
    ("cpg.call-features", ["rechunk_ms.call"])])
def test_each_reader_reads_a_tiny_run(tiny, cell, names):
    import run
    import torch
    from dsbench import spec
    root, base = tiny
    args = run.parse_args(["--workload", cell, "--seed", str(2**31 + 27),
                           "--seconds", "1"])
    spec_cell = spec.Cell(cell, spec.benchmark(root), str(base))
    t0 = time.perf_counter()
    res = spec_cell.driver.run(run.Context(spec_cell, args,
                                           torch.device("cpu")))
    assert res["failed"] == 0
    # the whole run: a tiny row is ~600 bytes, so a 4 MiB chunk holds
    # hundreds of tiny batches and the window may see no chunk wait
    res["window"] = (t0, time.perf_counter())
    listed = {m["name"] for m in spec_cell.per_layer}
    for name in names:
        assert name in listed
        value = spec_cell.reader(name).read(res, spec_cell)
        assert value is not None and math.isfinite(value) and value > 0, \
            name
