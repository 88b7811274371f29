"""Observability (port of deepsignal_tpu/core/logging.py):

- ``ThroughputMeter``: streaming sites/s and reads/s with periodic report
  lines;
- ``trace``: a ``torch.profiler`` capture written as a Chrome trace;
- ``span`` and ``count``: the program's spans and counters, kept in the
  process's ``RECORD``;
- ``StageTimer``: wall-clock seconds per named stage.

A span records ``(name, parent, start, seconds)``: ``parent`` is the
innermost span open on the same thread, ``start`` is
``time.perf_counter()`` (CLOCK_MONOTONIC on Linux, one clock for every
process of the machine).  A count records ``(name, time, value)``.  Outside
a profiler that is all a span does: two clock reads and an append to the
in-memory record.  While a torch profiler records (``trace``, any
``torch.profiler.profile``), a span is also a ``record_function`` range,
so the profiler's trace shows it on its own clock beside the kernels
launched inside it; under ``torch.autograd.profiler.emit_nvtx()`` the same
ranges are NVTX ranges for Nsight.  Nothing turns tracing on or off.

Granularity: spans go around a feature batch, a chunk of input, a device
batch, a train step or a set-up stage, never around a row, a read, a
kernel or a convolution: at most 16 spans per 4,096-row device batch and
16 per train step.  Every name starts with its layer (``pipeline.``,
``reader.``, ``caller.``, ``model.``, ``trainer.``, ``lstm.`` for the LSTM
scan's counts, ``inception.`` for the CNN's by path, ``bn.`` for its
batch norms' by path, ``pool.`` for its max-pools' by path, ``conv.`` for
its blocks' 1x1 convs by path).

torch is imported inside ``trace`` only; a span looks torch up only when
the process already holds it, so host processes stay torch-free.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
from collections import deque
from typing import Optional

RECORD_LEN = 8192   # newest entries kept per name
_ANY = object()     # ``Record.within``'s default parent: any or none


class Record:
    """The spans and counts of one process, the newest ``maxlen`` of each
    name: ``spans[name]`` holds ``(parent, start, seconds)``,
    ``counts[name]`` holds ``(time, value)``; ``received`` holds
    ``(time, taken)`` for each ``extend`` with another process's
    entries.  ``add_span``, ``add_count``, ``take`` and ``extend`` hold
    one lock, so threads may record while another takes."""

    def __init__(self, maxlen: int = RECORD_LEN):
        self.maxlen = maxlen
        self.spans: dict = {}
        self.counts: dict = {}
        self.received: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def _entries(self, table: dict, name: str) -> deque:
        entries = table.get(name)
        if entries is None:
            entries = table.setdefault(name, deque(maxlen=self.maxlen))
        return entries

    def add_span(self, name: str, parent, start: float,
                 seconds: float) -> None:
        with self._lock:
            self._entries(self.spans, name).append((parent, start, seconds))

    def add_count(self, name: str, at: float, value) -> None:
        with self._lock:
            self._entries(self.counts, name).append((at, value))

    def _sent(self, table: int, name: str, t0: float, t1: float) -> list:
        return [e for at, taken in list(self.received) if t0 <= at < t1
                for e in taken[table].get(name, ())]

    def within(self, name: str, t0: float, t1: float, parent=_ANY,
               received: bool = False) -> list:
        """Seconds of the spans of ``name`` that started in [t0, t1), of
        those under ``parent`` when it is given (None: at the top).  With
        ``received``: of those another process sent, and this one received
        in [t0, t1)."""
        entries = self._sent(0, name, t0, t1) if received else [
            e for e in list(self.spans.get(name, ())) if t0 <= e[1] < t1]
        return [d for p, _, d in entries if parent is _ANY or p == parent]

    def counted(self, name: str, t0: float, t1: float,
                received: bool = False) -> list:
        """Values counted under ``name`` at times in [t0, t1), or (with
        ``received``) sent by another process and received then."""
        entries = self._sent(1, name, t0, t1) if received else [
            e for e in list(self.counts.get(name, ())) if t0 <= e[0] < t1]
        return [v for _, v in entries]

    def take(self) -> tuple:
        """Everything recorded so far, on every thread, as ``(spans,
        counts)``, dicts of lists, and an empty record: what a host process
        sends with its work, for the receiving process's ``extend``.  An
        entry recorded while it runs goes with this take or the next."""
        with self._lock:
            spans, counts, self.spans, self.counts = \
                self.spans, self.counts, {}, {}
        return ({k: list(v) for k, v in spans.items()},
                {k: list(v) for k, v in counts.items()})

    def extend(self, taken: tuple) -> None:
        """File another process's ``take`` into this record, received now;
        the stamps keep that process's clock."""
        spans, counts = taken
        with self._lock:
            for name, entries in spans.items():
                self._entries(self.spans, name).extend(entries)
            for name, entries in counts.items():
                self._entries(self.counts, name).extend(entries)
            self.received.append((time.perf_counter(), taken))


RECORD = Record()
_local = threading.local()


def _open_spans() -> list:
    """The names of the spans open on this thread, outermost first."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _profiler_on() -> bool:
    """Whether a torch profiler records: the flag that torch's profilers
    (``torch.profiler.profile``, ``emit_nvtx``, ``emit_itt``) set as they
    start and clear as they stop, looked up only in a process that already
    holds torch."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd.profiler._is_profiler_enabled


class span:
    """A span named ``name`` around a ``with`` block (module docstring).
    Never yield from a generator inside one: the span would stay open on
    the thread while the consumer runs."""

    __slots__ = ("name", "parent", "start", "_stack", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._stack = stack = _open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._range = None
        if _profiler_on():
            self._range = sys.modules["torch"].autograd.profiler \
                .record_function(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.start
        if self._range is not None:
            self._range.__exit__(*exc)
        self._stack.pop()
        RECORD.add_span(self.name, self.parent, self.start, seconds)
        return False


def count(name: str, value) -> None:
    """Record ``value`` under ``name`` at this moment."""
    RECORD.add_count(name, time.perf_counter(), value)


class ThroughputMeter:
    """Streaming throughput counter with periodic stdout reports."""

    def __init__(self, name: str = "call_mods",
                 report_every_s: Optional[float] = 30.0):
        self.name = name
        self.report_every_s = report_every_s
        self.start = time.time()
        self._last_report = self.start
        self.sites = 0
        self.reads = 0
        self.batches = 0

    def update(self, sites: int = 0, reads: int = 0,
               batches: int = 1) -> None:
        self.sites += sites
        self.reads += reads
        self.batches += batches
        now = time.time()
        if (self.report_every_s is not None
                and now - self._last_report >= self.report_every_s):
            self._last_report = now
            print(self.line(), flush=True)

    def line(self) -> str:
        dt = max(time.time() - self.start, 1e-9)
        return (f"[{self.name}] {self.sites} sites, {self.reads} reads, "
                f"{self.batches} batches in {dt:.1f}s | "
                f"{self.sites / dt:.0f} sites/s, {self.reads / dt:.1f} "
                f"reads/s")

    def as_dict(self) -> dict:
        dt = max(time.time() - self.start, 1e-9)
        return {"sites": self.sites, "reads": self.reads,
                "batches": self.batches, "seconds": dt,
                "sites_per_s": self.sites / dt,
                "reads_per_s": self.reads / dt}


@contextlib.contextmanager
def trace(log_dir: Optional[str], device=None):
    """Profile the block with ``torch.profiler`` when ``log_dir`` is set
    (a no-op otherwise) and write one Chrome trace,
    ``<log_dir>/trace.<pid>.<ms>.pt.trace.json``; yields its path, or None.

    The host's activity is always recorded, the device's when ``device``
    is CUDA (``None`` means ``cuda``, as for the entry points).  The file
    is torch's Chrome-trace JSON (chrome://tracing, Perfetto), not the
    TensorBoard profile directory that the JAX package's ``trace``
    writes."""
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cuda").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace.{os.getpid()}."
                                 f"{int(time.time() * 1e3)}.pt.trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


class StageTimer:
    """Accumulate wall-clock seconds per named stage; ``summary`` gives the
    JAX package's text."""

    def __init__(self):
        self.totals: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        parts = [f"{k}: {v:.2f}s ({100 * v / total:.0f}%)"
                 for k, v in sorted(self.totals.items(),
                                    key=lambda kv: -kv[1])]
        return "stage timing: " + ", ".join(parts)
