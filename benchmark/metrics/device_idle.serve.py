"""The device's idle share of the traced window of a serving cell: 100 x (1 - busy / window),
busy the union of every kernel's, copy's and set's span (harness/trace.py)."""

KIND = 'serve'


def read(w):
    return 100.0 * (1.0 - w.busy_s / w.window_s)
