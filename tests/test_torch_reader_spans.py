"""The TSV call path's finer spans (``core/logging.py``) on the CPU: the
feature reader's chunk reads and waits, its native parse apart from the
decode, the pickling on its sending thread and the consumer's receipt,
each filed into the consumer's record with the items the reader sends;
and the record itself, shared by threads that record while another
takes."""

import sys
import threading
import time

import numpy as np

from deepsignal_tpu_torch.core.logging import RECORD, Record
from deepsignal_tpu_torch.io.feature_codec import FeatureBatch
from deepsignal_tpu_torch.runtime import pipeline
from deepsignal_tpu_torch.runtime.caller import coalesce_feature_batches
from tests import torch_tiny as tt

FIELDS = ("kmers", "means", "stds", "lens", "signals", "labels")


def _write_features(path, n_rows: int) -> str:
    path.write_text("\n".join(tt.tiny_feature_rows(n=n_rows)) + "\n")
    return str(path)


def _entries(taken, name: str) -> list:
    """(parent, start, seconds) of the spans ``name`` of one item."""
    return taken[0].get(name, [])


def _inside(child, parent) -> bool:
    (_, s, d), (_, ps, pd) = child, parent
    return ps <= s and s + d <= ps + pd


def _read_all(tsv: str):
    """The stream's batches, the items the consumer received with the
    time of each, the stream's creation and the end of the read."""
    t0 = time.perf_counter()
    stream = pipeline.stream_file_feature_batches(tsv, 1)
    got = []
    try:
        for fb in stream:
            got.append((fb, time.perf_counter()))
    finally:
        stream.close()
    t1 = time.perf_counter()
    items = [(at, taken) for at, taken in list(RECORD.received)
             if t0 <= at < t1]
    return got, items, t0, t1


def test_each_batch_brings_its_native_parse_decode_and_chunk_waits(
        tmp_path):
    got, items, _, _ = _read_all(_write_features(tmp_path / "f.tsv", 40))
    assert len(got) == 7 and len(items) == 8  # 7 batches and the done
    waits = []
    for _, taken in items[:7]:
        (parse,) = _entries(taken, "reader.parse")
        (native,) = _entries(taken, "reader.native")
        (decode,) = _entries(taken, "reader.decode")
        assert native[0] == decode[0] == "reader.parse"
        assert _inside(native, parse) and _inside(decode, parse)
        assert native[1] + native[2] <= decode[1]
        assert native[2] + decode[2] <= parse[2]
        groups = _entries(taken, "reader.group")
        for wait in _entries(taken, "reader.chunk_wait"):
            assert wait[0] == "reader.group"
            assert any(_inside(wait, g) for g in groups)
            waits.append(wait)
    # the file is one chunk: the first batch's grouping waited for it
    assert waits and sum(d for *_, d in waits) <= sum(
        d for _, taken in items for *_, d in
        _entries(taken, "reader.group"))


def test_by_the_done_item_every_pickle_and_read_has_arrived(tmp_path):
    got, items, _, _ = _read_all(_write_features(tmp_path / "f.tsv", 40))
    pickles = [e for _, taken in items for e in
               _entries(taken, "reader.pickle")]
    reads = [e for _, taken in items for e in _entries(taken, "reader.read")]
    assert len(pickles) == len(got)  # one a batch; the done's own stays
    assert len(reads) >= 1
    assert all(p is None for p, _, _ in pickles + reads)  # their threads
    # batch i's pickling starts after it was put: after its parse
    parses = sorted(s for _, taken in items for _, s, _ in
                    _entries(taken, "reader.parse"))
    assert all(p <= s for p, s in zip(parses, sorted(
        s for _, s, _ in pickles)))
    # each item carries the put of the batch before it
    puts = [len(_entries(taken, "reader.put")) for _, taken in items]
    assert puts == [0] + [1] * 7


def test_each_receipt_is_inside_its_wait(tmp_path):
    got, items, t0, t1 = _read_all(_write_features(tmp_path / "f.tsv", 40))
    recv = [e for e in RECORD.spans["pipeline.recv"] if t0 <= e[1] < t1]
    gets = [e for e in RECORD.spans["pipeline.get"] if t0 <= e[1] < t1]
    assert len(recv) == len(items)  # the batches and the done
    for r in recv:
        assert r[0] == "pipeline.get"
        assert any(_inside(r, g) for g in gets)
    # every item was filed after its receipt
    assert all(any(r[1] + r[2] <= at for r in recv) for at, _ in items)


def test_the_reader_stamps_on_the_consumers_clock(tmp_path):
    """Every span the reader process recorded, on any of its threads,
    started after the stream was made and before its item arrived: one
    clock for both processes."""
    got, items, t0, _ = _read_all(_write_features(tmp_path / "f.tsv", 40))
    names = set()
    for at, taken in items:
        for name, entries in taken[0].items():
            names.add(name)
            for _, s, d in entries:
                assert t0 <= s and s + d <= at, name
        for name, entries in taken[1].items():
            for t, _ in entries:
                assert t0 <= t <= at, name
    assert {"reader.read", "reader.chunk_wait", "reader.group",
            "reader.parse", "reader.native", "reader.decode",
            "reader.put", "reader.pickle"} <= names
    # each batch arrived after the item that carried it was filed
    for (fb, at), (filed, _) in zip(got, items):
        assert filed <= at


def test_the_pipe_gives_the_in_process_readers_batches(tmp_path):
    tsv = _write_features(tmp_path / "f.tsv", 40)
    got = [fb for fb, _ in _read_all(tsv)[0]]
    want = list(pipeline.stream_file_feature_batches(tsv, 1,
                                                     background=False))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert isinstance(g, FeatureBatch)
        assert g.sampleinfo == w.sampleinfo
        assert all(type(s) is str for s in g.sampleinfo)
        for name in FIELDS:
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_rechunking_is_a_span_before_each_device_batch():
    fb = FeatureBatch([f"r{i}" for i in range(10)],
                      *(np.arange(10)[:, None] + np.zeros((1, 3)),) * 5,
                      np.arange(10))
    t0 = time.perf_counter()
    out = []
    for batch in coalesce_feature_batches([fb[:3], fb[3:7], fb[7:]], 4):
        # the span of this batch has closed: it is not open across the
        # yield
        out.append((batch, len(RECORD.within("caller.rechunk", t0,
                                              time.perf_counter()))))
    assert [len(b) for b, _ in out] == [4, 4, 2]
    assert [n for _, n in out] == [1, 2, 3]
    assert [s for b, _ in out for s in b.sampleinfo] == fb.sampleinfo
    assert RECORD.within("caller.rechunk", t0, time.perf_counter(),
                         parent=None) == RECORD.within(
        "caller.rechunk", t0, time.perf_counter())


def test_threads_record_while_another_takes_and_nothing_is_lost():
    """Three threads record (two add spans and counts, one files another
    process's entries) while a fourth takes in a loop: every entry comes
    out of the takes once, in its thread's order."""
    rec = Record()
    n = 5000
    sent = ({"d": [(None, 0.0, 1.0)]}, {"d": [(0.0, 0)]})
    taken: list = []
    done = threading.Event()

    def record(name):
        for i in range(n):
            rec.add_span(name, None, float(i), 1.0)
            rec.add_count(name, float(i), i)

    def extend():
        for i in range(n):
            rec.extend(({"d": [(None, float(i), 1.0)]},
                        {"d": [(float(i), i)]}))

    def take():
        while not done.is_set():
            taken.append(rec.take())
        taken.append(rec.take())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        taker = threading.Thread(target=take)
        taker.start()
        writers = [threading.Thread(target=record, args=(name,))
                   for name in ("a", "b")]
        writers.append(threading.Thread(target=extend))
        for t in writers:
            t.start()
        for t in writers:
            t.join(timeout=60)
        done.set()
        taker.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not taker.is_alive() and not any(t.is_alive() for t in writers)
    assert rec.spans == {} and rec.counts == {}
    assert len(rec.received) == n and rec.received[0][1] == sent
    for name in ("a", "b", "d"):
        starts = [s for spans, _ in taken for _, s, _ in
                  spans.get(name, ())]
        values = [v for _, counts in taken for _, v in
                  counts.get(name, ())]
        assert starts == [float(i) for i in range(n)]
        assert values == list(range(n))
