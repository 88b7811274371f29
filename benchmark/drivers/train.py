"""Training cells: ``Trainer.train_on_batch_async`` / ``resolve_metrics``
of the port over a seeded pool of labelled batches, staged by the
trainer's own ``stage_batch`` through ``prefetch_batches``, as ``train()``
feeds them; each step waits for the one before it (its metrics are read
one step late).

Set-up builds one ``Trainer``, restores into it the benchmark's weights, a
fresh Adam state and a dropout generator seeded from ``--seed``, and drives
it through its first three steps on three different batches: the step-1
gradients are read back from Adam's first moment, the change of every
parameter after step 3.  The same trainer then warms up and runs the
window.  After the window the reference follows the first three steps from
the same weights, batches and dropout seed (``check_steps``).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from dsbench import traffic, weights
from dsbench.tracing import DeviceTrace, Spans, memory_peak, stages

RANGES = ("step", "resolve", "stage", "encoder", "inception", "head")
CHECKED_STEPS = 3


def _batches(data: dict, bs: int, n: int) -> list:
    out = []
    for b in range(n):
        s = slice(b * bs, (b + 1) * bs)
        out.append({"kmer": data["kmer"][s], "means": data["means"][s],
                    "stds": data["stds"][s],
                    "sanums": data["lens"][s].astype(np.float32),
                    "signals": data["signals"][s],
                    "labels": data["labels"][s]})
    return out


def run(ctx) -> dict:
    from deepsignal_tpu_torch.core.config import ModelConfig, TrainConfig
    from deepsignal_tpu_torch.ops.cuda.build import build_libraries
    from deepsignal_tpu_torch.train.checkpoints import \
        state_dict_to_variables
    from deepsignal_tpu_torch.train.data import prefetch_batches
    from deepsignal_tpu_torch.train.trainer import Trainer

    cell, tp = ctx.cell, ctx.cell.traffic
    sizes, ref, dev = cell.sizes, cell.reference, ctx.device
    bs, lr = tp["batch_rows"], tp["learning_rate"]
    marks = [("start", ctx.t_start), ("imports", time.perf_counter())]
    if dev.type == "cuda":
        build_libraries(["lstm_encoder", "lstm_scan"])
    marks.append(("build", time.perf_counter()))
    data = traffic.rows(ctx.seed, tp["pool_batches"] * bs, sizes, tp)
    pool = _batches(data, bs, tp["pool_batches"])
    marks.append(("inputs", time.perf_counter()))
    settle = {k: v[:tp["settle_rows"]] for k, v in pool[0].items()}
    params = weights.make(ref, sizes, ctx.seed, dev, _tensors(settle, dev))
    marks.append(("weights", time.perf_counter()))
    dropout_seed = weights.torch_seed(ctx.seed, 13)
    gen = torch.Generator(device=dev)
    gen.manual_seed(dropout_seed)
    mcfg = ModelConfig.from_dict({**sizes, "compute_dtype": cell.dtype})
    tcfg = TrainConfig(batch_size=bs, learning_rate=lr,
                       keep_prob=tp["keep_prob"], save_state=False)
    trainer = Trainer(mcfg, tcfg, device=dev)
    trainer.restore(state_dict_to_variables(mcfg, params),
                    {"opt_state": {}, "rng": gen.get_state().numpy()})
    marks.append(("program", time.perf_counter()))
    if ctx.fault is not None:
        ctx.fault(trainer)
    spans = Spans()
    if ctx.trace:
        spans.wrap(trainer, "train_on_batch_async", "step")
        spans.wrap(trainer, "resolve_metrics", "resolve")
        spans.wrap(trainer, "stage_batch", "stage")
        for attr, name in (("event_model", "encoder"),
                           ("signal_model", "inception"),
                           ("joint_model", "head")):
            if hasattr(trainer.model, attr):
                spans.wrap(getattr(trainer.model, attr), "forward", name)
    feed = prefetch_batches(map(trainer.stage_batch,
                                itertools.cycle(pool)))
    try:
        # the checked steps: the window's own call and feed, resolved at once
        named = dict(trainer.model.named_parameters())
        losses = []
        for step in range(CHECKED_STEPS):
            loss, *_ = trainer.resolve_metrics(
                trainer.train_on_batch_async(next(feed), lr))
            losses.append(loss)
            if step == 0:
                grads = first_gradients(trainer.optimizer, named)
        with torch.no_grad():
            change = {k: float(torch.linalg.vector_norm(
                (p.detach() - params[k]).double())) for k, p in named.items()}
        state = {"losses": losses, "grad_norms": grads,
                 "change_norms": change}
        marks.append(("checked steps", time.perf_counter()))
        # warm-up, then the window: a step resolved one step late
        resolved = []              # (time, rows) of every step resolved
        pending = None
        t0 = t1 = t2 = None
        tracer = DeviceTrace(RANGES, dev.type == "cuda") if ctx.trace \
            else None
        trace_data = None
        step_i = 0
        while True:
            now = time.perf_counter()
            if t0 is None and step_i >= tp["warmup_steps"]:
                t0, t1 = now, now + ctx.seconds
                spans.ranged = ctx.trace
                marks.append(("warm-up", t0))
            elif t1 is not None and now >= t1:
                if tracer is None:
                    break
                if t2 is None:
                    tracer.start()
                    t2 = time.perf_counter() + tp["trace_seconds"]
                elif now >= t2:
                    break
            handle = trainer.train_on_batch_async(next(feed), lr)
            step_i += 1
            if pending is not None:
                trainer.resolve_metrics(pending)
                resolved.append((time.perf_counter(), bs))
            pending = handle
        trainer.resolve_metrics(pending)
        if tracer is not None:
            trace_data = tracer.stop()
        peak = memory_peak(dev)
    finally:
        feed.close()
    del trainer, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done = [(t, r) for t, r in resolved if t0 < t <= t1]
    res = {"setup_s": t0 - ctx.t_start, "window": (t0, t1),
           "setup_stages": stages(marks),
           "sites": sum(r for _, r in done), "completed": len(done),
           "memory_peak_bytes": peak, "spans": spans,
           "trace": trace_data, "batch_rows": bs, "attempted": len(done)}
    ref_state = ref.train_steps(
        params, sizes, [_tensors(b, dev, labels=True)
                        for b in pool[:CHECKED_STEPS]],
        tp["keep_prob"], lr, dropout_seed, CHECKED_STEPS)
    res["checks"], res["failed"] = check_steps(state, ref_state, ctx.limits)
    if ctx.keep is not None:
        ctx.keep.update(params=params, pool=pool, state=state,
                        ref_state=ref_state, dropout_seed=dropout_seed)
    return res


def first_gradients(optimizer, named: dict) -> dict:
    """Each leaf's step-1 gradient norm, from Adam's first moment after
    one step (m = (1 - beta1) g); 0 for a leaf Adam holds no state of."""
    b1 = optimizer.defaults["betas"][0]
    out = {}
    for k, p in named.items():
        m = optimizer.state.get(p, {}).get("exp_avg")
        out[k] = 0.0 if m is None else float(
            torch.linalg.vector_norm(m.double())) / (1 - b1)
    return out


def _tensors(batch: dict, dev, labels: bool = False) -> dict:
    keys = ("kmer", "means", "stds", "sanums", "signals") + \
        (("labels",) if labels else ())
    return {k: torch.from_numpy(batch[k]).to(dev) for k in keys}


def gaps(state: dict, ref_state: dict) -> dict:
    """The compared numbers of a training run against the reference:

    - ``loss_gap``: the largest |loss - reference loss| / |reference loss|
      over the checked steps; ``loss1_gap``: the same of step 1 alone;
    - ``grad_gap``: over the leaves, the largest gap between the step-1
      gradient norm and the reference's, over the larger of the
      reference's norm of that leaf and of the median leaf;
    - ``change_gap``: the same of the parameters' change after the
      checked steps, over the leaves whose reference gradient norm is at
      least a thousandth of the median leaf's (the others move by Adam's
      round-off alone)."""
    def worst(got, want, keys):
        med = float(np.median([want[k] for k in keys]))
        return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30)
                   for k in keys)

    rg = ref_state["grad_norms"]
    keys = sorted(rg)
    med = float(np.median([rg[k] for k in keys]))
    moving = [k for k in keys if rg[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(state["losses"], ref_state["losses"]))
    return {"loss_gap": loss_gap,
            "loss1_gap": abs(state["losses"][0] - ref_state["losses"][0])
            / abs(ref_state["losses"][0]),
            "grad_gap": worst(state["grad_norms"], rg, keys),
            "change_gap": worst(state["change_norms"],
                                ref_state["change_norms"], moving)}


def check_steps(state: dict, ref_state: dict, limits: dict):
    """The numbers the cell's limits file names, each with its limit."""
    lim = limits["numbers"]
    checks = {k: {"value": v, "limit": lim[k]}
              for k, v in gaps(state, ref_state).items() if k in lim}
    failed = sum(1 for c in checks.values()
                 if not c["value"] <= c["limit"])
    return checks, failed
