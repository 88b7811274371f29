"""inception_roofline.call: % of the Inception CNN's roofline bound
(counts/inception.py at the device batch, in the call dtype) that the
device time of the operations launched inside InceptionNet.forward
reaches."""

from dsbench.readings import roofline


def read(res, cell):
    return roofline(res, cell, "inception", "inception")
