"""The program's own spans and counts, as per-layer readings.

The port keeps every span and count of its process in
``deepsignal_tpu_torch.core.logging.RECORD``; the feature reader process's
arrive with each batch it sends, and are read by the window in which the
entry received them (a backlog of queued batches holds work done before
the window).  These helpers read the record over a run's measured window,
``res["window"]``, which is untraced, so the profiler's host cost is in
none of them; and they read the traced window's device time under a
program span.  Where the program keeps no such record, or the record holds
nothing of a name, they return None.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

BEFORE = float("-inf")


def record():
    """The program's record, or None for a program without one."""
    try:
        from deepsignal_tpu_torch.core import logging
    except ImportError:
        return None
    return getattr(logging, "RECORD", None)


def seconds(res: dict, name: str, t0=None, t1=None, **kw):
    """Seconds of each span ``name`` that started in the window (or in
    [t0, t1)); ``parent=`` keeps those under that span, ``received=True``
    takes another process's received then.  None without a record."""
    rec = record()
    if rec is None:
        return None
    w0, w1 = res["window"]
    return rec.within(name, w0 if t0 is None else t0,
                      w1 if t1 is None else t1, **kw)


def counted(res: dict, name: str, **kw):
    """Values counted under ``name`` in the window; None without a
    record."""
    rec = record()
    if rec is None:
        return None
    return rec.counted(name, *res["window"], **kw)


def mean_ms(res: dict, name: str, **kw):
    """Host ms of the mean span ``name`` in the window."""
    got = seconds(res, name, **kw)
    return 1e3 * sum(got) / len(got) if got else None


def ms_per(res: dict, names, per: str):
    """Host ms of the spans ``names`` together, per span ``per``, in the
    window."""
    calls = seconds(res, per)
    if not calls:
        return None
    return 1e3 * sum(sum(seconds(res, n)) for n in names) / len(calls)


def received_s(res: dict, names) -> list:
    """Seconds of the feature reader's spans ``names``, received in the
    window."""
    return [d for n in names for d in seconds(res, n, received=True)]


def per_row_us(res: dict, name: str):
    """Host us of the feature reader's spans ``name`` per row it counted
    as ``reader.rows``, received in the window."""
    rows = counted(res, "reader.rows", received=True)
    if not rows:
        return None
    return 1e6 * sum(received_s(res, (name,))) / sum(rows)


def setup_s(res: dict, name: str):
    """Seconds of the set-up span ``name``, before the window opened."""
    got = seconds(res, name, t0=BEFORE, t1=res["window"][0])
    return sum(got) if got else None


def device_s_under(trace, name: str, less: str) -> list:
    """Device seconds of each call of the program span ``name`` in the
    traced window: the operations launched on any thread while it was
    open (the autograd engine launches the backward from a thread of its
    own), less those launched inside a span ``less`` on their thread."""
    times = [t for t, *_ in trace.launched]
    left_out = defaultdict(list)
    for s, e, n, thread in trace.annotations:
        if n == less:
            left_out[thread].append((s, e))
    out = []
    for s, e, n, _ in sorted(trace.annotations):
        if n != name:
            continue
        lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
        out.append(sum(d for t, thread, d in trace.launched[lo:hi]
                       if not any(a <= t <= b
                                  for a, b in left_out[thread])) / 1e9)
    return out
