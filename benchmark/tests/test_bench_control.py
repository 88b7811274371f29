"""The control of each cell, on the card at the cell's own size: the
reference put in the program's place and computed in the nearest
precision below the configuration's fails the cell's comparison (the
readings the limits were set from are in PERF.md)."""

import pytest

CONTROLS = {"cpg.call-features": "fp8", "cpg.call-tsv": "fp8",
            "rnn.train": "tf32", "cpg.train": "tf32"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", sorted(CONTROLS))
def test_control_is_not_correct(cuda_device, cell_name):
    import calibrate
    import run
    from dsbench import spec

    cell = spec.Cell(cell_name, spec.benchmark())
    keep = {}
    out, _ = run.measure(["--workload", cell_name, "--seed", "4000000001",
                          "--seconds", "2"], device="cuda", keep=keep)
    assert out["correct"], out["checks"]
    control = (calibrate.control_call if cell.traffic["entry"] == "call"
               else calibrate.control_train)(cell, keep, cuda_device)
    readings = control[CONTROLS[cell_name]]
    limits = cell.limits["numbers"]
    compared = {k: readings[k] for k in limits if k in readings}
    assert any(v > limits[k] for k, v in compared.items()), (readings, limits)
