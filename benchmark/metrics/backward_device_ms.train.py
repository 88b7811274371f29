"""backward_device_ms.train: device ms per train step of the operations
launched, on any thread, while ``trainer.backward`` was open in the traced
window, less those launched inside ``trainer.stage`` (the prefetch
thread's copies of the next batch)."""

import numpy as np

from dsbench.program import device_s_under


def read(res, cell):
    trace = res.get("trace")
    calls = [d for d in device_s_under(trace, "trainer.backward",
                                       "trainer.stage") if d > 0] \
        if trace else []
    return 1e3 * float(np.mean(calls)) if calls else None
