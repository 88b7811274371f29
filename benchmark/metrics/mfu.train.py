"""mfu.train: three times the forward's operations per site (counts/
model.py: forward and backward) times train_sites_per_s of the measured
window, over the train dtype's peak."""

from dsbench.readings import mfu


def read(res, cell):
    return mfu(res, cell, 3)
