"""trainer_restore_s.train: seconds of the ``Trainer``'s
``trainer.restore`` span in set-up (weights, Adam state and dropout
generator loaded into the trainer)."""

from dsbench.program import setup_s


def read(res, cell):
    return setup_s(res, "trainer.restore")
