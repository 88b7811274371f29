"""call_sites_per_s: sites whose call rows were written inside the measured
window, over the window."""

from dsbench.readings import rate


def read(res, cell):
    return rate(res)
