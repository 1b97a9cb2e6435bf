"""B5's share of its roofline over the traced steps: the bound of every
launch (``counts/kernels.py``: the codes and scales of each lane's
compressed prefix, the queries, the partial written; the larger of bytes
at HBM rate and operations at peak) over B5's device time in the trace, in
%. A launch's lengths are the ``cold_len`` its step left behind."""
from bench.counts import kernels as K


def read(rec):
    tr = rec.trace
    if rec.kind != "serve" or tr is None:
        return None
    ops = tr.named(*K.B5_KERNELS)
    dev_s = sum(o.end - o.start for o in ops)
    if not ops or dev_s <= 0:
        return None
    lanes, bits = rec.extras["lanes"], rec.extras["bits"]
    bound = sum(K.b5_bound_s(rec.model, layer, lanes, bits)
                for step in tr.extras["cold_lens"] for layer in step)
    return 100.0 * bound / dev_s
