"""The encoders' device time in a train step's forward: the median over the window's steps
of the time between the program's encoders marks (harness/marks.py), the two EfficientNet
trunks in train mode (batch statistics, drop-connect), inside the step's replay."""

from harness import marks

KIND = 'train'


def read(w):
    return marks.median_ms(w, "encoders")
