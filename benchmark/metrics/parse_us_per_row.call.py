"""parse_us_per_row.call: host us per row of the feature reader's native
parse (the program's ``reader.parse`` spans over its ``reader.rows``
counts, received in the measured window)."""

from dsbench.program import per_row_us


def read(res, cell):
    return per_row_us(res, "reader.parse")
