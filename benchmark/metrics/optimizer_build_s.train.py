"""optimizer_build_s.train: seconds of the ``Trainer``'s
``trainer.build_optimizer`` span in set-up (the construction of its Adam
optimizer, the first of the process)."""

from dsbench.program import setup_s


def read(res, cell):
    return setup_s(res, "trainer.build_optimizer")
