"""merged_conv_share.call: share (%) of the Inception blocks of the card's
inference forwards in the measured window that ran their five 1x1 convs
that read the block's input as one conv (``conv.merged``), not five
(``conv.split``); None where the program counts neither."""

from dsbench.program import counted


def read(res, cell):
    merged = sum(counted(res, "conv.merged") or [])
    split = sum(counted(res, "conv.split") or [])
    return 100.0 * merged / (merged + split) if merged + split else None
