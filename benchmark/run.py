#!/usr/bin/env python3
"""Run one cell of the benchmark of ``deepsignal_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  It sets up the cell (weights and inputs from the seed, the
program's objects, the warm-up), measures for ``--seconds``, checks every
output of the run against the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``, which adds a
traced window after the measured one), the device, and last the numbers
compared with their limits, which also close standard error.  Without
enough cards, or when the process holds JAX or the JAX package once the
window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# few host threads: the card's machine shares its 8 cores with the
# program's reader and the harness's writer, and idle OpenMP threads spin
HOST_THREADS = "2"
# top-level module names no run may hold, compared whole: the port's own
# name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "deepsignal_tpu")


class Context:
    """What a driver gets: the cell, the run's arguments, the device, the
    process's start, and (tests only) a fault to plant and a dict to keep
    the run's inputs in."""

    def __init__(self, cell, args, device, fault=None, keep=None,
                 t_start=T_START):
        self.cell = cell
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.t_start = t_start
        self.limits = cell.limits
        self.fault = fault
        self.keep = keep


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def measure(argv=None, device=None, fault=None, keep=None, base=HERE,
            root=CHECKOUT, t_start=T_START):
    """Run the cell; returns (result dict, its compared numbers).  With
    ``device`` given (tests) the look for a card is skipped and no metric
    is computed; ``fault`` is handed the program's object before the run,
    ``keep`` receives the run's inputs, ``t_start`` is the set-up's
    start."""
    args = parse_args(argv)
    for path in (root, base):
        if path not in sys.path:
            sys.path.insert(0, path)
    from dsbench import spec

    cell = spec.Cell(args.workload, spec.benchmark(root), base)
    import torch

    on_card = device is None
    if on_card:
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < cell.chips:
            raise SystemExit(f"{cell.name} needs {cell.chips} CUDA card(s); "
                             f"this machine has {cards}")
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    res = cell.driver.run(Context(cell, args, device, fault, keep,
                                  t_start))
    checks = res["checks"]
    correct = res["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct),
           "attempted": int(res["attempted"]), "failed": int(res["failed"]),
           "metrics": {}, "device": {"platform": device.type}}
    if on_card:
        metrics = cell.per_layer if args.trace else cell.end_to_end
        for m in metrics:
            value = cell.reader(m["name"]).read(res, cell)
            if value is not None:
                out["metrics"][m["name"]] = {"value": float(value),
                                             "unit": m["unit"]}
        out["device"] = {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(device),
                         "count": cell.chips,
                         "memory_peak_bytes": res["memory_peak_bytes"],
                         "card": power_limit()}
        trace = res.get("trace")
        if args.trace and trace is not None:
            out["device"]["busy_s"] = trace.busy_s
            out["device"]["window_s"] = trace.window_s
            out["device"]["unattributed_s"] = trace.unattributed_s
            out["breakdown"] = {"device_ops": trace.top_ops(),
                                "idle_gaps": trace.idle_gaps()}
    out["setup_stages"] = res["setup_stages"]
    out["checks"] = checks
    return out, checks


def stop_resource_tracker() -> None:
    """Stop, and wait for, the helper process that multiprocessing starts
    with a spawned process, so that the run leaves no process behind."""
    from multiprocessing import resource_tracker

    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def main(argv=None) -> int:
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, HOST_THREADS)
    out, checks = measure(argv)
    stop_resource_tracker()
    found = forbidden_modules()
    if found:
        print("the run holds " + ", ".join(found) + ": no result",
              file=sys.stderr)
        return 3
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out["setup_stages"].items()),
        file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
