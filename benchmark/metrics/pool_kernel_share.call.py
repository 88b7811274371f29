"""pool_kernel_share.call: share (%) of the max-pools of Inception's
inference forwards on the card in the measured window that ran the
hand-written max-pool kernel (``pool.kernel``), not the padded copy and
torch's pool (``pool.plain``); None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    kernel = sum(counted(res, "pool.kernel") or [])
    plain = sum(counted(res, "pool.plain") or [])
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
