"""encoder_roofline.train: % of the BiLSTM encoder's forward roofline bound
(counts/encoder.py at the train batch, in the train dtype) that the device
time of the operations launched inside BiLSTMEncoder.forward in a train
step reaches."""

from dsbench.readings import roofline


def read(res, cell):
    return roofline(res, cell, "encoder", "encoder")
