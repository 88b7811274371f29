"""launch_ms.call: host ms per device batch in ``caller.forward`` (the
model's launches, sigmoid, argmax, the fetch's enqueue) in the measured
window."""

from dsbench.program import mean_ms


def read(res, cell):
    return mean_ms(res, "caller.forward")
