"""The window's share of the card's bf16 peak: the model FLOPs of the
window's steps (3x the forward of every token, ``counts/model.py``) over
the window's seconds at 989 TFLOP/s, in %."""
from bench.counts import peaks


def read(rec):
    if rec.kind != "train" or not rec.window_s or not rec.steps:
        return None
    return 100.0 * rec.counters["model_flops"] / (
        rec.window_s * peaks.PEAK_FLOPS_BF16)
