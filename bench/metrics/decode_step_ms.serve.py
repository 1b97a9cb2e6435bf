"""Host milliseconds of an ``Engine.step`` outside its ``_admit``: the
decode step through ``models/decode.py::decode_step`` and its one fetch,
over the window's steps."""


def read(rec):
    if rec.kind != "serve" or not rec.steps:
        return None
    return (rec.spans["step"] - rec.spans["admit"]) / rec.steps * 1e3
