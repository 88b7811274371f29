"""Observability (port of deepsignal_tpu/core/logging.py):

- ``ThroughputMeter``: streaming sites/s and reads/s with periodic report
  lines;
- ``trace``: a ``torch.profiler`` capture written as a Chrome trace;
- ``nvtx_range``: an NVTX range on CUDA, nothing elsewhere;
- ``StageTimer``: wall-clock seconds per named stage.

torch is imported inside ``trace`` and ``nvtx_range`` only.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional


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


def nvtx_range(name: str, cuda: bool):
    """An NVTX range named ``name`` around a block when ``cuda`` (seen by
    Nsight tools), a null context otherwise."""
    if not cuda:
        return contextlib.nullcontext()
    import torch
    return torch.cuda.nvtx.range(name)


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
