"""step_device_ms.train: device ms per optimizer step: every operation
launched, on any thread, from the start of one train_on_batch_async to the
start of the next, in the traced window."""

import numpy as np


def read(res, cell):
    trace = res.get("trace")
    steps = trace.device_s_between("step") if trace else []
    return 1e3 * float(np.mean(steps)) if steps else None
