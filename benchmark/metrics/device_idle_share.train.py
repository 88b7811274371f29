"""device_idle_share.train: % of the traced window in which no operation
ran on the device."""

from dsbench.readings import idle_share


def read(res, cell):
    return idle_share(res)
