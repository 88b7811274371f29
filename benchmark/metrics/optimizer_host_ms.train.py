"""optimizer_host_ms.train: host ms per train step in
``trainer.zero_grad`` and ``trainer.optimizer`` (Adam's step) in the
measured window."""

from dsbench.program import ms_per


def read(res, cell):
    return ms_per(res, ("trainer.zero_grad", "trainer.optimizer"),
                  "trainer.step")
