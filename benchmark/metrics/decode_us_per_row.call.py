"""decode_us_per_row.call: host us per row of the feature reader's Python
decode of each row's sampleinfo into a str (the program's
``reader.decode`` spans, inside ``reader.parse``, over its
``reader.rows`` counts, received in the measured window)."""

from dsbench.program import per_row_us, seconds


def read(res, cell):
    if not seconds(res, "reader.decode", received=True):
        return None
    return per_row_us(res, "reader.decode")
