"""Throughput counter (a copy of ThroughputMeter in
deepsignal_tpu/core/logging.py)."""

from __future__ import annotations

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
