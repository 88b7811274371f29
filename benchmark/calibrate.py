#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, on the
card, in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]

For every seed of ``--seeds`` a sound run of the cell (a short window at
the cell's own load) and its compared numbers (the lower readings).  For
every seed of ``--control-seeds`` the control: the reference in the
nearest precision below the configuration's, put in the program's place
(fp8 operands for a bfloat16 call, TF32 for float32 training), judged by
the same comparison (the upper readings).  For every seed of
``--fault-seeds`` each fault of ``dsbench/faults.py`` that the cell can
have, planted in the program.  One JSON line per reading; the benchmark's
own runs never run this.
"""

import json
import sys
import time

import run


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_call(cell, keep, device):
    """The controls' ``prob_gap_ratio``: fp8 and int8 references over the
    run's inputs, judged as the program's rows are; and the run's own
    numbers in other forms."""
    import numpy as np

    call = cell.driver
    ref = cell.reference

    def probs(operand=None):
        return call.reference_probs(ref, cell.sizes, keep["params"],
                                    keep["expect"], device, operand=operand)
    want = probs()
    scale = np.abs(probs(ref.bf16_operand) - want).mean()
    _, _, p1, _ = call.read_calls(keep["out_path"])
    idx = np.arange(len(p1)) % len(want)
    gap = np.abs(p1.astype(np.float64) - want[idx])
    out = {"program": {"prob_gap_mean": float(gap.mean()),
                       "prob_gap_max": float(gap.max()),
                       "bf16_gap_mean": float(scale),
                       "prob_1_spread": float(np.std(want))}}
    for name, operand in (("fp8", ref.fp8_operand),
                          ("int8", ref.int8_operand)):
        gap = np.abs(probs(operand) - want)
        out[name] = {"prob_gap_ratio": float(gap.mean() / scale),
                     "prob_gap_mean": float(gap.mean()),
                     "prob_gap_max": float(gap.max())}
    return out


def control_train(cell, keep, device):
    import torch

    drv = cell.driver
    tp = cell.traffic
    batches = [drv._tensors(b, device, labels=True)
               for b in keep["pool"][:drv.CHECKED_STEPS]]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctrl = cell.reference.train_steps(
            keep["params"], cell.sizes, batches, tp["keep_prob"],
            tp["learning_rate"], keep["dropout_seed"], drv.CHECKED_STEPS)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return {"tf32": drv.gaps(ctrl, keep["ref_state"]),
            "tf32_detail": detail(ctrl, keep["ref_state"])}


def detail(state, ref_state, top=6):
    """Each step's loss on both sides and the leaves whose change gaps
    most, with their reference gradient and change norms."""
    rg, rc, c = (ref_state["grad_norms"], ref_state["change_norms"],
                 state["change_norms"])
    leaves = sorted(rc, key=lambda k: -abs(c[k] - rc[k]) / max(rc[k], 1e-30))
    return {"losses": state["losses"], "ref_losses": ref_state["losses"],
            "leaves": [[k, rg[k], c[k], rc[k]] for k in leaves[:top]],
            "median_grad": sorted(rg.values())[len(rg) // 2],
            "median_change": sorted(rc.values())[len(rc) // 2]}


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch

    from dsbench import faults, spec
    cell = spec.Cell(args.workload, spec.benchmark())
    entry = cell.traffic["entry"]
    device = torch.device("cuda", 0)

    def one(seed, fault=None, keep=None):
        out, _ = run.measure(["--workload", args.workload, "--seed",
                              str(seed), "--seconds", str(args.seconds)],
                             device="cuda", fault=fault, keep=keep,
                             t_start=time.perf_counter())
        return {k: c["value"] for k, c in out["checks"].items()}, out

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        keep = {} if seed in args.control_seeds else None
        t = time.perf_counter()
        values, out = one(seed, keep=keep)
        line = {"seed": seed, "kind": "program", "readings": values,
                "correct": out["correct"],
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        if keep is not None:
            if entry == "train":
                print(json.dumps({"seed": seed, "kind": "detail",
                                  "detail": detail(keep["state"],
                                                   keep["ref_state"])}),
                      flush=True)
            ctrl = (control_call if entry == "call" else control_train)(
                cell, keep, device)
            print(json.dumps({"seed": seed, "kind": "control",
                              "readings": ctrl}), flush=True)
        torch.cuda.empty_cache()
    for seed in args.fault_seeds:
        for name, plant in faults.FAULTS[entry].items():
            values, out = one(seed, fault=plant)
            print(json.dumps({"seed": seed, "kind": "fault:" + name,
                              "readings": values,
                              "correct": out["correct"]}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
