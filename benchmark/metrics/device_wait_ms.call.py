"""device_wait_ms.call: host ms per device batch in ``caller.wait``, the
wait on the device's completion event, in the measured window; near 0 the
host sets the pace."""

from dsbench.program import mean_ms


def read(res, cell):
    return mean_ms(res, "caller.wait")
