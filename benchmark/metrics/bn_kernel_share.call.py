"""bn_kernel_share.call: share (%) of the batch norms of Inception's
inference forwards on the card in the measured window that ran the
hand-written batch-norm-and-relu kernel (``bn.kernel``), not the torch
formula (``bn.plain``); None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    kernel = sum(counted(res, "bn.kernel") or [])
    plain = sum(counted(res, "bn.plain") or [])
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
