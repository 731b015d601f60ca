"""The backward's device time a train step: the median over the window's steps of the time
between the program's backward marks (harness/marks.py), around the loss's .backward()
inside the step's replay: every gradient, encoders and decoders together."""

from harness import marks

KIND = 'train'


def read(w):
    return marks.median_ms(w, "backward")
