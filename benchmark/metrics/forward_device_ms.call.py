"""forward_device_ms.call: device ms per device batch of every operation
launched inside the model forward, in the traced window."""

import numpy as np


def read(res, cell):
    trace = res.get("trace")
    calls = [d for d in trace.device_s_per_call("forward") if d > 0] \
        if trace else []
    return 1e3 * float(np.mean(calls)) if calls else None
