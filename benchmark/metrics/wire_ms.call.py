"""wire_ms.call: host ms per device batch in ``caller.wire`` (the wire
arrays, pinning, the copies' enqueue) in the measured window."""

from dsbench.program import mean_ms


def read(res, cell):
    return mean_ms(res, "caller.wire")
