"""mfu.call: the forward's operations per site (counts/model.py) times
call_sites_per_s of the measured window, over the call dtype's peak."""

from dsbench.readings import mfu


def read(res, cell):
    return mfu(res, cell, 1)
