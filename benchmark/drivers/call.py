"""call_mods cells: ``call_mods_on_batches`` of the port, fed a seeded pool
of feature batches held in memory (traffic ``input: pool``) or the
background reader of a feature TSV that the benchmark's writer process
streams through a named pipe (``input: tsv``), writing call rows to a file
under the run's temporary directory.

One call of ``call_mods_on_batches`` spans the whole run: warm-up, the
measured window, and with ``--trace 1`` a traced window after it.  The
input's wrapper opens and closes the windows as it hands out batches; a
meter the entry calls once a batch's rows are written stamps every
completion.  After the run every row written is checked against the
reference (``check_rows``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from dsbench import pipe_writer, traffic, weights
from dsbench.tracing import DeviceTrace, Spans, memory_peak, stages

RANGES = ("read_wait", "dispatch", "collect", "forward", "encoder",
          "inception", "head")


class Meter:
    """The ``meter`` of ``call_mods_on_batches``: (time, sites) of every
    batch whose rows were written."""

    def __init__(self, on_update):
        self.done = []
        self.on_update = on_update

    def update(self, sites: int = 0, reads: int = 0, batches: int = 1):
        self.done.append((time.perf_counter(), sites))
        self.on_update()


class Windows:
    """The run's clock: warm-up until ``steady()`` says so, then the
    measured window of ``seconds``, then (tracing) a traced window."""

    def __init__(self, seconds: float, trace_seconds: float, trace):
        self.seconds = seconds
        self.trace_seconds = trace_seconds
        self.trace = trace          # a DeviceTrace, or None
        self.t0 = self.t1 = self.t2 = None
        self.trace_data = None

    def start(self) -> None:
        if self.t0 is None:
            self.t0 = time.perf_counter()
            self.t1 = self.t0 + self.seconds

    def open(self) -> bool:
        """Whether the input may hand out one more batch; moves from the
        window to the traced window and ends the run."""
        now = time.perf_counter()
        if self.t1 is None or now < self.t1:
            return True
        if self.trace is None:
            return False
        if self.t2 is None:
            self.trace.start()
            self.t2 = time.perf_counter() + self.trace_seconds
            return True
        if now < self.t2:
            return True
        if self.trace_data is None:
            self.trace_data = self.trace.stop()
        return False


def _pool(data: dict, batch_rows: int, n_batches: int):
    from deepsignal_tpu_torch.io.feature_codec import FeatureBatch

    out = []
    for b in range(n_batches):
        s = slice(b * batch_rows, (b + 1) * batch_rows)
        out.append(FeatureBatch(data["sampleinfo"][s], data["kmer"][s],
                                data["means"][s], data["stds"][s],
                                data["lens"][s], data["signals"][s],
                                data["labels"][s]))
    return out


def _cycle(pool, windows: Windows, pulls: list):
    i = 0
    while windows.open():
        pulls.append(time.perf_counter())
        yield pool[i % len(pool)]
        i += 1


def _until_closed(stream, windows: Windows):
    for fb in stream:
        yield fb
        if not windows.open():
            return


def run(ctx) -> dict:
    """Set up, warm up, measure, trace; then check every row written."""
    from deepsignal_tpu_torch.core.config import ModelConfig
    from deepsignal_tpu_torch.ops.cuda.build import build_libraries
    from deepsignal_tpu_torch.runtime.caller import (ModCaller,
                                                     call_mods_on_batches)
    from deepsignal_tpu_torch.runtime.pipeline import \
        stream_file_feature_batches
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables

    cell, tp = ctx.cell, ctx.cell.traffic
    sizes, ref, dev = cell.sizes, cell.reference, ctx.device
    bs = tp["batch_rows"]
    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    work = tempfile.mkdtemp(prefix="dsbench-")
    writer = stream = None
    try:
        if tp["input"] == "tsv":  # the writer makes its block meanwhile
            fifo = os.path.join(work, "features.tsv")
            os.mkfifo(fifo)
            writer = mp.get_context("spawn").Process(
                target=pipe_writer.write_forever,
                args=(fifo, ctx.seed, sizes, tp), daemon=True)
            writer.start()
        build_libraries((["lstm_encoder"] if dev.type == "cuda" else [])
                        + ["callfmt", "fastparse"])
        marks.append(("build", time.perf_counter()))
        params = weights.make(ref, sizes, ctx.seed, dev, _tensors(
            traffic.rows(ctx.seed, tp["settle_rows"], sizes, tp), dev))
        mcfg = ModelConfig.from_dict({**sizes, "compute_dtype": cell.dtype})
        marks.append(("weights", time.perf_counter()))
        caller = ModCaller(mcfg, state_dict_to_variables(mcfg, params),
                           batch_size=bs, device=dev)
        marks.append(("program", time.perf_counter()))
        if ctx.fault is not None:
            ctx.fault(caller)
        spans = Spans()
        tracer = DeviceTrace(RANGES, dev.type == "cuda") if ctx.trace \
            else None
        windows = Windows(ctx.seconds, tp["trace_seconds"], tracer)
        if ctx.trace:
            spans.wrap(caller, "dispatch_feature_batch", "dispatch")
            spans.wrap(caller, "collect_block", "collect")
            spans.wrap(caller.model, "forward", "forward")
            for attr, name in (("event_model", "encoder"),
                               ("signal_model", "inception"),
                               ("joint_model", "head")):
                if hasattr(caller.model, attr):
                    spans.wrap(getattr(caller.model, attr), "forward", name)
        pulls = []
        if tp["input"] == "pool":
            data = traffic.rows(ctx.seed, tp["pool_batches"] * bs, sizes, tp)
            source = _cycle(_pool(data, bs, tp["pool_batches"]), windows,
                            pulls)
            marks.append(("inputs", time.perf_counter()))

            def steady():
                return len(meter.done) >= tp["warmup_batches"]
        else:
            stream = stream_file_feature_batches(fifo, tp["reads_per_batch"])
            source = _until_closed(stream, windows)
            waits = spans.calls["read_wait"]

            def steady():  # the reader's backlog is gone: pulls wait on it
                recent = [d for _, d in waits[-tp["warmup_waits"]:]]
                return (len(recent) == tp["warmup_waits"] and min(recent)
                        >= tp["warmup_wait_ms"] / 1e3) or \
                    time.perf_counter() - ctx.t_start > tp["warmup_max_s"]

        def on_update():
            if windows.t0 is None and steady():
                windows.start()
                spans.ranged = ctx.trace
        meter = Meter(on_update)
        out_path = os.path.join(work, "calls.tsv")
        written = call_mods_on_batches(
            caller, spans.wrap_iter(source, "read_wait"), out_path,
            meter=meter)
        peak = memory_peak(dev)
        if stream is not None:
            stream.close()
            stream = None
        del caller
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0, t1 = windows.t0, windows.t1
        if t0 is None:
            raise RuntimeError("the run ended before its warm-up did")
        done = [(t, s) for t, s in meter.done if t0 < t <= t1]
        marks.append(("warm-up", t0))
        res = {"setup_s": t0 - ctx.t_start, "window": (t0, t1),
               "setup_stages": stages(marks),
               "sites": sum(s for _, s in done), "completed": len(done),
               "memory_peak_bytes": peak, "spans": spans,
               "trace": windows.trace_data, "batch_rows": bs,
               "attempted": written}
        if tp["input"] == "pool":
            # pulls and completions are one to one (whole batches of bs)
            res["latencies_s"] = [t - pulls[i] for i, (t, _) in
                                  enumerate(meter.done) if t0 < t <= t1]
            expect = data
        else:
            expect = traffic.rows(ctx.seed, tp["block_rows"], sizes, tp)
        res["checks"], res["failed"] = check_rows(
            ref, sizes, params, expect, out_path, written, ctx.limits, dev)
        if ctx.keep is not None:
            ctx.keep.update(params=params, expect=expect, out_path=out_path)
        return res
    finally:
        if stream is not None:
            stream.close()
        if writer is not None:
            writer.join(timeout=10)
            if writer.is_alive():
                writer.terminate()
                writer.join(timeout=10)
        if ctx.keep is None:
            shutil.rmtree(work, ignore_errors=True)


def _tensors(data: dict, dev, rows=slice(None)) -> dict:
    return {"kmer": torch.from_numpy(data["kmer"][rows]).to(dev),
            "means": torch.from_numpy(data["means"][rows]).to(dev),
            "stds": torch.from_numpy(data["stds"][rows]).to(dev),
            "sanums": torch.from_numpy(
                data["lens"][rows].astype(np.float32)).to(dev),
            "signals": torch.from_numpy(data["signals"][rows]).to(dev)}


def reference_probs(ref, sizes: dict, params: dict, data: dict, dev,
                    block: int = 4096, operand=None) -> np.ndarray:
    """prob_1 of the reference for every row of ``data``, in blocks."""
    n = len(data["sampleinfo"])
    out = np.empty(n)
    kw = {} if operand is None else {"operand": operand}
    with torch.no_grad():
        for i in range(0, n, block):
            x = _tensors(data, dev, slice(i, i + block))
            out[i:i + block] = ref.call_probs(ref.forward(
                params, sizes, x["kmer"], x["means"], x["stds"],
                x["sanums"], x["signals"], **kw))
    return out


def read_calls(path: str):
    """(info+kmer bytes per row, prob_0, prob_1 as float32, labels) of a
    call TSV."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    fields = [ln.rsplit(b"\t", 4) for ln in lines]
    bad = sum(1 for f in fields if len(f) != 5)
    if bad:
        raise ValueError(f"{bad} call rows without 10 columns")
    keys = [f[0] + b"\t" + f[4] for f in fields]
    p0 = np.array([f[1] for f in fields]).astype(np.float32)
    p1 = np.array([f[2] for f in fields]).astype(np.float32)
    labels = np.array([f[3] for f in fields]).astype(np.int64)
    return keys, p0, p1, labels


def check_rows(ref, sizes, params, expect, out_path, written, limits,
               dev):
    """Every row written against the input it came from (row i of the
    output is row i mod n of the input: the pool's rows cycle, the pipe
    repeats its block) and the reference's prob_1 for it.  Returns the
    compared numbers, each with its limit, and the count of rows that
    fail one.

    ``prob_gap_ratio``: the mean gap of the rows' prob_1 to the float32
    reference, over the mean gap of the reference computed in bfloat16:
    how much farther the program is than bfloat16 itself, on this seed's
    weights and inputs (how sure a seed's calls are, and how far bfloat16
    moves them, both change from seed to seed; their ratio does not)."""
    keys, p0, p1, labels = read_calls(out_path)
    n_in = len(expect["sampleinfo"])
    idx = np.arange(len(keys)) % n_in
    bases = np.array(list("ACGT"))
    want = [(expect["sampleinfo"][i] + "\t"
             + "".join(bases[expect["kmer"][i]])).encode()
            for i in range(n_in)]
    text_bad = np.array([keys[r] != want[i] for r, i in enumerate(idx)],
                        dtype=bool)
    # the label is the argmax of the probabilities it is printed with
    label_bad = ((labels == 1) & (p1 < p0)) | ((labels == 0) & (p0 < p1)) \
        | ((labels != 0) & (labels != 1))
    probs = reference_probs(ref, sizes, params, expect, dev)
    scale = np.abs(reference_probs(ref, sizes, params, expect, dev,
                                   operand=ref.bf16_operand) - probs)[idx]
    gap = np.abs(p1.astype(np.float64) - probs[idx])
    gap[~np.isfinite(gap)] = np.inf
    ratio = float(gap.mean() / scale.mean()) if len(gap) else float("inf")
    lim = limits["numbers"]
    checks = {
        "rows_missing": {"value": abs(int(written) - len(keys))
                         + int(len(keys) == 0), "limit": 0},
        "rows_wrong": {"value": int((text_bad | label_bad).sum()),
                       "limit": 0},
        "prob_gap_ratio": {"value": ratio, "limit": lim["prob_gap_ratio"]},
    }
    failed = int((text_bad | label_bad).sum()) + int(
        not ratio <= lim["prob_gap_ratio"]) * len(gap)
    return checks, failed
