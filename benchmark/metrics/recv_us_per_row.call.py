"""recv_us_per_row.call: host us per row of the consumer taking the feature
reader's batches off the pipe and unpickling them, after the wait for
them (the program's own ``pipeline.recv`` spans in the measured window,
over the reader's ``reader.rows`` counts received in it)."""

from dsbench.program import counted, seconds


def read(res, cell):
    got = seconds(res, "pipeline.recv")
    rows = counted(res, "reader.rows", received=True)
    if not got or not rows:
        return None
    return 1e6 * sum(got) / sum(rows)
