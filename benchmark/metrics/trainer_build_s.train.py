"""trainer_build_s.train: seconds of the ``Trainer``'s ``trainer.build``
span in set-up (``DeepSignalNet(...)`` with its host draw of initial
weights)."""

from dsbench.program import setup_s


def read(res, cell):
    return setup_s(res, "trainer.build")
