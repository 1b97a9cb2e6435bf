"""The window's share of the card's bf16 peak: the model FLOPs of every
token served in the window (its prompt's pass for a first token, one
decode for every other; ``counts/model.py``) over the window's seconds at
989 TFLOP/s, in %."""
from bench.counts import peaks


def read(rec):
    if rec.kind != "serve" or not rec.window_s:
        return None
    return 100.0 * rec.counters["model_flops"] / (
        rec.window_s * peaks.PEAK_FLOPS_BF16)
