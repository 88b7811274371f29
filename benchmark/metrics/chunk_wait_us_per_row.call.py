"""chunk_wait_us_per_row.call: host us per row that the feature reader's
grouping waited for the chunks its reading thread reads ahead (the
program's ``reader.chunk_wait`` spans, inside ``reader.group``, over its
``reader.rows`` counts, received in the measured window)."""

from dsbench.program import per_row_us, seconds


def read(res, cell):
    if not seconds(res, "reader.chunk_wait", received=True):
        return None
    return per_row_us(res, "reader.chunk_wait")
