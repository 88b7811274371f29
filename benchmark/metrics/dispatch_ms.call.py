"""dispatch_ms.call: host ms per call of ModCaller.dispatch_feature_batch
(wire arrays, pinning, enqueue) in the measured window."""

import numpy as np


def read(res, cell):
    t0, t1 = res["window"]
    calls = res["spans"].within("dispatch", t0, t1)
    return 1e3 * float(np.mean(calls)) if calls else None
