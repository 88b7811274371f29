"""pickle_us_per_row.call: host us per row of the feature reader's sending
thread pickling its batches for the consumer (the program's
``reader.pickle`` spans over its ``reader.rows`` counts, received in the
measured window)."""

from dsbench.program import per_row_us, seconds


def read(res, cell):
    if not seconds(res, "reader.pickle", received=True):
        return None
    return per_row_us(res, "reader.pickle")
