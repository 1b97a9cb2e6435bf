"""MiB a decode step copies between host and card to park and resume
lanes: the bytes of the tensors each park fetched and each resume
installed, from their sizes, over the window's steps. Nothing to read
where no lane was parked or resumed."""


def read(rec):
    if rec.kind != "serve" or not rec.steps or not rec.counters["copy_bytes"]:
        return None
    return rec.counters["copy_bytes"] / rec.steps / float(1 << 20)
