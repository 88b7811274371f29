"""train_sites_per_s: rows of the steps resolved inside the measured
window, over the window."""

from dsbench.readings import rate


def read(res, cell):
    return rate(res)
