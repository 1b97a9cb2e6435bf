"""Host milliseconds a decode step spends in ``Engine._admit`` (prefill,
park, resume), over the window's steps."""


def read(rec):
    if rec.kind != "serve" or not rec.steps:
        return None
    return rec.spans["admit"] / rec.steps * 1e3
