"""encoder_roofline.call: % of the BiLSTM encoder's roofline bound (counts/
encoder.py at the device batch, in the call dtype) that the device time of
the operations launched inside BiLSTMEncoder.forward reaches."""

from dsbench.readings import roofline


def read(res, cell):
    return roofline(res, cell, "encoder", "encoder")
