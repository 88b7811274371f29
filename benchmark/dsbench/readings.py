"""Arithmetic the metric readers share: the window's rate, a part's
roofline bound from the counting functions, and the published peaks."""

from __future__ import annotations

import json
import os

import numpy as np

from .spec import HERE


def peaks() -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def rate(res: dict) -> float:
    """Sites completed inside the measured window over its length."""
    t0, t1 = res["window"]
    return res["sites"] / (t1 - t0)


def bound_s(cell, part: str, batch: int) -> float:
    """Least seconds the chip could take for one call of ``part`` at
    ``batch``: the larger of operations over the dtype's peak and bytes
    over the memory's bandwidth."""
    p = peaks()
    flops, nbytes = cell.count(part, batch)
    return max(flops / p["flops_per_s"][cell.dtype],
               nbytes / p["hbm_bytes_per_s"])


def roofline(res: dict, cell, part: str, range_name: str):
    """% of the bound that the device time under ``range_name`` reaches,
    per call; None without a traced call."""
    trace = res.get("trace")
    per_call = trace.device_s_per_call(range_name) if trace else []
    per_call = [d for d in per_call if d > 0]
    if not per_call:
        return None
    return 100.0 * bound_s(cell, part, res["batch_rows"]) / float(
        np.mean(per_call))


def mfu(res: dict, cell, passes: int) -> float:
    """% of the dtype's peak: ``passes`` x the forward's operations per
    site x the window's rate."""
    flops, _ = cell.count("model", 1)
    return 100.0 * passes * flops * rate(res) / peaks()["flops_per_s"][
        cell.dtype]


def idle_share(res: dict):
    trace = res.get("trace")
    if not trace or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
