"""The train steps' share of the card's peak: the model FLOPs of every step of the traced
window (forward and backward of the plain reference at the cell's shapes, work/model.py)
over the window's seconds times the peak (harness/peaks.py)."""

from harness import peaks
from work import model

KIND = 'train'


def read(w):
    c = w.cell
    flops = model.step_flops(c.model, c.config["train"], c.traffic)
    return 100.0 * flops * w.steps / (w.window_s * peaks.flops_per_s(c.model))
