"""call_batch_p95_ms: the 95th percentile, over the device batches whose
rows were written inside the window, of the time from the entry pulling
the batch from its input to its rows being written."""

import numpy as np


def read(res, cell):
    lat = res.get("latencies_s")
    if not lat:
        return None
    return 1e3 * float(np.percentile(lat, 95))
