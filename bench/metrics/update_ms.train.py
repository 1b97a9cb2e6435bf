"""Milliseconds of ``optim/adamw.py::update`` a step, from CUDA events
recorded around each call in the window, mean over the window's steps."""


def read(rec):
    ms = rec.extras.get("update_ms") if rec.kind == "train" else None
    if not ms:
        return None
    return sum(ms) / len(ms)
