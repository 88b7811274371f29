"""group_us_per_row.call: host us per row of the feature reader's reading
and grouping of lines by read (the program's ``reader.group`` spans over
its ``reader.rows`` counts, received in the measured window)."""

from dsbench.program import per_row_us


def read(res, cell):
    return per_row_us(res, "reader.group")
