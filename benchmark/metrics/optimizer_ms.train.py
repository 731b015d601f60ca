"""The optimizer's device time a train step: the median over the window's steps of the time
between the program's optimizer marks (harness/marks.py), around the update (clipping where
the configuration clips, then Adam's step) inside the step's replay."""

from harness import marks

KIND = 'train'


def read(w):
    return marks.median_ms(w, "optimizer")
