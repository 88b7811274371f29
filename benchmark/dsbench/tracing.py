"""Spans and the device trace, recorded from the benchmark's own files.

``Spans`` times calls into the program's layers on the host clock (a
wrapper per call site, installed on the objects a run drives) and, while
a ``DeviceTrace`` is on, marks each call with a ``record_function`` range
of the same name.  ``DeviceTrace`` runs ``torch.profiler`` over a short
window and reduces its events to what the per-layer readers need: the
device's busy time, each range's device time (the operations whose launch
lies inside it), the operations that took most time, and the idle gaps by
the innermost range the host was in.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict


class Spans:
    """Host-clock spans per name: (start, seconds) of every call, and the
    profiler ranges of the calls made while ``ranged`` is set."""

    def __init__(self):
        self.calls = defaultdict(list)
        self.ranged = False

    def wrap(self, obj, attr: str, name: str) -> None:
        """Time every call of ``obj.attr`` under ``name`` (an attribute of
        the instance shadows the class's method)."""
        import torch

        inner = getattr(obj, attr)
        calls = self.calls[name]

        def timed(*args, **kwargs):
            if self.ranged:
                with torch.profiler.record_function(name):
                    t = time.perf_counter()
                    out = inner(*args, **kwargs)
            else:
                t = time.perf_counter()
                out = inner(*args, **kwargs)
            calls.append((t, time.perf_counter() - t))
            return out
        setattr(obj, attr, timed)

    def wrap_iter(self, it, name: str):
        """A generator over ``it`` whose every ``next`` is a span."""
        import torch

        calls = self.calls[name]
        while True:
            t = time.perf_counter()
            if self.ranged:
                with torch.profiler.record_function(name):
                    item = next(it, None)
            else:
                item = next(it, None)
            calls.append((t, time.perf_counter() - t))
            if item is None:
                return
            yield item

    def within(self, name: str, t0: float, t1: float) -> list:
        """Seconds of the calls of ``name`` that started in [t0, t1)."""
        return [d for t, d in self.calls.get(name, ()) if t0 <= t < t1]


def stages(marks: list) -> dict:
    """Seconds of each set-up stage from a list of (name, end time)."""
    return {name: t - prev for (_, prev), (name, t) in zip(marks, marks[1:])}


def memory_peak(dev) -> int:
    """The card's peak of allocated bytes so far (0 off the card)."""
    import torch

    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def _activity(ev) -> str:
    """The kind of a host event: ``user_annotation`` (a range),
    ``cuda_runtime`` (a launch or copy call into CUDA), or another."""
    try:
        return ev.activity_type()
    except AttributeError:  # torch before 2.12: by flag and by name
        if ev.is_user_annotation():
            return "user_annotation"
        name = ev.name()
        if name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper()):
            return "cuda_runtime"
        return ""


class DeviceTrace:
    """``torch.profiler`` (host and CUDA) between ``start`` and ``stop``."""

    def __init__(self, range_names, cuda: bool = True):
        self.range_names = set(range_names)
        self.cuda = cuda
        self.prof = None
        self.t0 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + [ProfilerActivity.CUDA] * self.cuda)
        self.prof.start()
        self.t0 = time.perf_counter_ns()

    def stop(self) -> "TraceData":
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        self.prof.stop()
        return TraceData(self.prof.profiler.kineto_results.events(),
                         self.range_names, (t1 - self.t0) / 1e9)


class TraceData:
    """The reduction of one traced window's events."""

    def __init__(self, events, range_names, window_s: float):
        self.window_s = window_s
        # a device operation carries the correlation id of the CUDA call
        # that launched it, and the id of the host operation around that
        # call (a launch from a library of the program's own has no host
        # operation, but has its CUDA call)
        calls, ops = {}, {}      # id -> (host ns, thread)
        device = []              # (start ns, end ns, name, call, op)
        ranges = defaultdict(list)
        annotations = []         # (start, end, name, thread) of host ranges
        for ev in events:
            kind = _activity(ev)
            if str(ev.device_type()).endswith("CPU"):
                item = (ev.start_ns(), ev.start_thread_id())
                if kind == "user_annotation":
                    span = (ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                            ev.name(), ev.start_thread_id())
                    annotations.append(span)
                    if ev.name() in range_names:
                        ranges[ev.name()].append(span)
                elif kind in ("cuda_runtime", "cuda_driver"):
                    calls[ev.correlation_id()] = item
                else:
                    ops[ev.correlation_id()] = item
            elif not ev.is_user_annotation() and "annotation" not in kind:
                device.append((ev.start_ns(), ev.start_ns()
                               + ev.duration_ns(), ev.name(),
                               ev.correlation_id(),
                               ev.linked_correlation_id()))
        self.device = sorted(device)
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self.annotations = annotations
        # each device operation with the host time and thread of its launch
        launched, lost = [], 0
        for s, e, _, call, op in device:
            where = calls.get(call) or (ops.get(op) if op else None)
            if where is None:
                lost += e - s
            else:
                launched.append((where[0], where[1], e - s))
        self.launched = sorted(launched)
        self.unattributed_s = lost / 1e9
        self.busy_s = sum(e - s for s, e in self._merged()) / 1e9

    def _merged(self) -> list:
        merged = []
        for s, e, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def device_s_per_call(self, name: str) -> list:
        """Device seconds of each call of range ``name``: the operations
        launched on the range's thread while it was open."""
        times = [t for t, *_ in self.launched]
        out = []
        for s, e, _, thread in self.ranges.get(name, ()):
            lo = bisect.bisect_left(times, s)
            hi = bisect.bisect_right(times, e)
            out.append(sum(d for _, th, d in self.launched[lo:hi]
                           if th == thread) / 1e9)
        return out

    def device_s_between(self, name: str) -> list:
        """Device seconds from the start of each call of range ``name`` to
        the start of the next, on every thread; the last call, whose end
        the window cuts, is left out."""
        starts = [s for s, *_ in self.ranges.get(name, ())]
        times = [t for t, *_ in self.launched]
        out = []
        for a, b in zip(starts, starts[1:]):
            lo, hi = bisect.bisect_left(times, a), bisect.bisect_left(times, b)
            out.append(sum(d for *_, d in self.launched[lo:hi]) / 1e9)
        return out

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(int)
        for s, e, name, *_ in self.device:
            total[name] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device time between operations, summed by the innermost
        host range open at each gap's middle ("none" outside them)."""
        merged = self._merged()
        spans = sorted(self.annotations)
        starts = [s for s, *_ in spans]
        total = defaultdict(int)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = (a + b) // 2
            label = "none"
            # the latest-starting range that is still open is the innermost
            for i in range(bisect.bisect_right(starts, mid) - 1,
                           max(-1, bisect.bisect_right(starts, mid) - 4096),
                           -1):
                if spans[i][1] > mid:
                    label = spans[i][2]
                    break
            total[label] += b - a
        return [[k, v / 1e9] for k, v in
                sorted(total.items(), key=lambda kv: -kv[1])[:n]]
