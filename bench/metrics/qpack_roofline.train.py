"""B3's and B4's share of their roofline over the traced train steps: the
bound of the update's launches (each moment of every leaf decoded and
encoded once a step; ``counts/kernels.py``) over their device time in the
trace, in %."""
from bench.counts import kernels as K


def read(rec):
    tr = rec.trace
    if rec.kind != "train" or tr is None:
        return None
    ops = [o for o in tr.ops if K.is_b3(o.name) or K.is_b4(o.name)]
    dev_s = sum(o.end - o.start for o in ops)
    if not ops or dev_s <= 0:
        return None
    bound = tr.steps * K.qpack_update_bound_s(rec.extras["leaf_numels"],
                                               rec.extras["state_block"])
    return 100.0 * bound / dev_s
