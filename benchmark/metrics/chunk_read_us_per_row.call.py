"""chunk_read_us_per_row.call: host us per row of the feature reader's
reading thread filling its chunks from the input (the program's
``reader.read`` spans over its ``reader.rows`` counts, received in the
measured window); on a pipe it holds the wait for the writer too."""

from dsbench.program import per_row_us, seconds


def read(res, cell):
    if not seconds(res, "reader.read", received=True):
        return None
    return per_row_us(res, "reader.read")
