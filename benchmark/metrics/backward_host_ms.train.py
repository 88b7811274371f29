"""backward_host_ms.train: host ms per train step in ``trainer.backward``
(``loss.backward()``, the LSTM's recompute and every gradient's launch) in
the measured window."""

from dsbench.program import mean_ms


def read(res, cell):
    return mean_ms(res, "trainer.backward")
