"""forward_host_ms.train: host ms per train step in the model's forward
(``model.forward`` under ``trainer.step``) in the measured window."""

from dsbench.program import mean_ms


def read(res, cell):
    return mean_ms(res, "model.forward", parent="trainer.step")
