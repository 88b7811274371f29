"""reader_busy_share.call: % of the measured window that the feature
reader process spent in ``reader.group`` and ``reader.parse``, for the
batches the entry received in it; near 100% the reader's one core sets
the pace."""

from dsbench.program import counted, received_s


def read(res, cell):
    if not counted(res, "reader.rows", received=True):
        return None
    t0, t1 = res["window"]
    return 100.0 * sum(received_s(res, ("reader.group", "reader.parse"))) \
        / (t1 - t0)
