"""scan_backward_kernel_share.train: share (%) of the LSTM scan's backward
passes on the card in the measured window that ran the backward kernel
(``lstm.backward_kernel``), not the plain recompute (``lstm.backward_plain``);
None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    kernel = sum(counted(res, "lstm.backward_kernel") or [])
    plain = sum(counted(res, "lstm.backward_plain") or [])
    return 100.0 * kernel / (kernel + plain) if kernel + plain else None
