"""The share of the traced serve steps in which no operation ran on the
card: 1 - (union of device intervals) / (segment's length), in %."""


def read(rec):
    tr = rec.trace
    if rec.kind != "serve" or tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
