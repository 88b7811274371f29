"""The port's background feature reader (``runtime/pipeline.py``) against the
JAX package's read-grouped TSV iterator, and its behaviour when the reader
dies or the consumer stops early.  Every wait is bounded."""

import multiprocessing as mp
import os
import signal
import threading
import time

import numpy as np
import pytest

from deepsignal_tpu.io.feature_codec import \
    iter_feature_batches_by_read as jax_iter_by_read
from deepsignal_tpu_torch.io import native
from deepsignal_tpu_torch.io.feature_codec import (
    format_feature_row, iter_feature_batches_by_read)
from deepsignal_tpu_torch.runtime import pipeline

K, S = 5, 8


def _write_tsv(path, n_reads, sites, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for r in range(n_reads):
            for j in range(sites(r)):
                f.write(format_feature_row(
                    "chr1", 10 * r + j, "+", 10 * r + j, f"read{r}", "t",
                    "".join(rng.choice(list("ACGT"), K)), rng.normal(0, 1, K),
                    np.abs(rng.normal(0, 1, K)), rng.integers(1, 9, K),
                    np.around(rng.normal(0, 1, S), 6), j % 2) + "\n")
    return str(path)


def _run_bounded(fn, timeout):
    """Run ``fn`` in a thread; return its result or exception, failing if
    it does not end within ``timeout`` seconds."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as exc:  # handed to the test
            out["error"] = exc

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still waiting after {timeout} s"
    return out


def _readers():
    return [p for p in mp.active_children() if p.name == pipeline.READER_NAME]


@pytest.mark.parametrize("background", [True, False])
def test_stream_matches_jax_iter_by_read(tmp_path, background):
    tsv = _write_tsv(tmp_path / "f.tsv", 23, lambda r: 1 + r % 4)
    want = list(jax_iter_by_read(tsv, 4))
    before = native.parse_feature_block.calls
    got = _run_bounded(lambda: list(pipeline.stream_file_feature_batches(
        tsv, 4, background=background)), 60)["value"]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.sampleinfo == w.sampleinfo
        for name in ("kmers", "means", "stds", "lens", "signals", "labels"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # the reader's native parses are counted in this process
    assert native.parse_feature_block.calls == before + len(want)
    assert _readers() == []


def test_iter_by_read_matches_jax_on_crlf_rows(tmp_path):
    tsv = _write_tsv(tmp_path / "f.tsv", 9, lambda r: 2)
    crlf = tmp_path / "crlf.tsv"
    crlf.write_bytes(open(tsv, "rb").read().replace(b"\n", b"\r\n"))
    for g, w in zip(iter_feature_batches_by_read(str(crlf), 2),
                    jax_iter_by_read(tsv, 2)):
        assert g.sampleinfo == w.sampleinfo
        np.testing.assert_array_equal(g.signals, w.signals)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_a_killed_reader_raises_within_seconds(tmp_path):
    # 400 one-row batches: more than the queue holds, so the reader is
    # still alive, blocked on a full queue, when it is killed
    tsv = _write_tsv(tmp_path / "f.tsv", 400, lambda r: 1)
    stream = pipeline.stream_file_feature_batches(tsv, 1)

    def consume():
        next(stream)
        (reader,) = _readers()
        os.kill(reader.pid, signal.SIGKILL)
        t0 = time.perf_counter()
        n = 1
        try:
            for _ in stream:
                n += 1
        except RuntimeError as exc:
            return str(exc), n, time.perf_counter() - t0
        return None, n, time.perf_counter() - t0

    out = _run_bounded(consume, 60)
    msg, n, seconds = out["value"]
    assert msg is not None and "exit code -9" in msg, out
    assert n < 400 and seconds < 10
    assert _readers() == []


def test_a_reader_error_is_raised_in_the_consumer(tmp_path):
    tsv = _write_tsv(tmp_path / "f.tsv", 6, lambda r: 2)
    with open(tsv, "a") as f:
        f.write("chr1\t1\t+\t1\tread9\tt\tACGTA\t1,2\n")
    out = _run_bounded(
        lambda: list(pipeline.stream_file_feature_batches(tsv, 2)), 60)
    assert isinstance(out.get("error"), ValueError), out
    assert "malformed feature row" in str(out["error"])
    assert _readers() == []


def test_an_abandoned_stream_stops_its_reader(tmp_path):
    tsv = _write_tsv(tmp_path / "f.tsv", 300, lambda r: 1)

    def take_two():
        stream = pipeline.stream_file_feature_batches(tsv, 1)
        first = [next(stream), next(stream)]
        stream.close()
        return first

    assert len(_run_bounded(take_two, 60)["value"]) == 2
    assert _readers() == []


def test_the_reader_starts_with_the_stream_and_stops_unread(tmp_path):
    # run_call_mods makes the stream before it loads the checkpoint, so the
    # reader must already run, and close() must stop it unread
    tsv = _write_tsv(tmp_path / "f.tsv", 300, lambda r: 1)

    def open_and_close():
        stream = pipeline.stream_file_feature_batches(tsv, 1)
        started = [p.is_alive() for p in _readers()]
        stream.close()
        return started

    assert _run_bounded(open_and_close, 60)["value"] == [True]
    assert _readers() == []


def test_a_reader_never_read_stops_at_the_queues_bound(tmp_path):
    """A consumer that takes nothing: the reader's sending thread blocks on
    its first item, the queue fills, and the reader stops parsing with
    ``QUEUE_MAX_BATCHES`` + 2 batches in flight (one sending, the queue's,
    one waiting to be queued); once the consumer reads, every batch and
    the end arrive, in order."""
    import subprocess
    import sys
    tsv = _write_tsv(tmp_path / "f.tsv", 300, lambda r: 1)
    code = ("import pickle, threading, time\n"
            "from deepsignal_tpu_torch.io import native\n"
            "from deepsignal_tpu_torch.runtime import pipeline\n"
            "go, got = threading.Event(), []\n"
            "class Held:\n"
            "    def send_bytes(self, data):\n"
            "        go.wait()\n"
            "        got.append(pickle.loads(data))\n"
            "t = threading.Thread(target=pipeline._file_reader_proc,\n"
            f"                     args=({tsv!r}, Held(), 1), daemon=True)\n"
            "t.start()\n"
            "seen = []\n"
            "while len(seen) < 480 and (len(seen) < 12\n"
            "                           or seen[-1] != seen[-12]):\n"
            "    time.sleep(0.25)\n"
            "    seen.append(native.parse_feature_block.calls)\n"
            "go.set()\n"
            "t.join(60)\n"
            "print(seen[-1], pipeline.QUEUE_MAX_BATCHES, t.is_alive(),\n"
            "      [item[0] for item in got].count('batch'), got[-1][0],\n"
            "      [item[1].sampleinfo[0].split()[4] for item in got[:-1]]\n"
            "      == ['read%d' % r for r in range(300)])\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    held, bound, alive, batches, last, in_order = out.stdout.split()
    assert int(held) == int(bound) + 2
    assert (alive, batches, last, in_order) == ("False", "300", "done",
                                                "True")


def test_the_reader_modules_import_no_torch():
    import subprocess
    import sys
    code = ("import sys\n"
            "import deepsignal_tpu_torch.runtime.pipeline\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'deepsignal_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
