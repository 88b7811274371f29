"""native_parse_us_per_row.call: host us per row of the feature reader's
two native calls, the row count and the parse, with the allocation of
their outputs (the program's ``reader.native`` spans, inside
``reader.parse``, over its ``reader.rows`` counts, received in the
measured window)."""

from dsbench.program import per_row_us, seconds


def read(res, cell):
    if not seconds(res, "reader.native", received=True):
        return None
    return per_row_us(res, "reader.native")
