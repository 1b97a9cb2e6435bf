"""Pool invariants I1-I4 and chunk conservation, checked in numpy over
``interop.pool_to_numpy(pool)`` (vectorised, so a deployment-size pool
checks in seconds). I5 (read-your-writes) is checked by reading back.

  I1  every C-chunk is free XOR referenced by exactly one page
  I2  promoted(page) <=> P-chunk allocated <=> activity entry allocated
  I3  dirty promoted pages hold no compressed copy
  I4  clean promoted pages keep the shadow (shadow_valid=1, chunks > 0)
"""
from __future__ import annotations

import numpy as np

from repro_torch.common.types import PoolConfig
from repro_torch.core.engine.state import n_single_chunks

_PTR = (1 << 29) - 1
_OSPN = (1 << 30) - 1


def check_pool_invariants(arrays: dict, cfg: PoolConfig) -> None:
    """Raise AssertionError naming the first violated invariant."""
    meta = arrays["meta"].astype(np.int64)
    activity = arrays["activity"].astype(np.int64)
    cfree = arrays["cfree.items"][: int(arrays["cfree.top"])].astype(np.int64)
    gfree = arrays["gfree.items"][: int(arrays["gfree.top"])].astype(np.int64)
    pfree = arrays["pfree.items"][: int(arrays["pfree.top"])].astype(np.int64)

    n_single = n_single_chunks(cfg)
    total = n_single + 8 * ((cfg.n_cchunks - n_single) // 8)
    free_ids = np.concatenate([cfree, (gfree[:, None] + np.arange(8)).ravel()])
    if np.unique(free_ids).size != free_ids.size:
        raise AssertionError("duplicate entries in chunk freelists")
    if np.unique(pfree).size != pfree.size:
        raise AssertionError("duplicate entries in P freelist")

    w0 = meta[:, 0]
    valid = (w0 >> 31) & 1 == 1
    promoted = valid & ((w0 >> 30) & 1 == 1)
    dirty = (w0 >> 29) & 1 == 1
    shadow = (w0 >> 28) & 1 == 1
    nchunks = (w0 >> 20) & 0xF
    ptrs = meta[:, 1:8] & _PTR

    bad = np.nonzero(promoted & dirty & (nchunks != 0))[0]
    if bad.size:
        raise AssertionError(f"I3 violated: page {bad[0]} dirty with chunks")
    bad = np.nonzero(promoted & ~dirty & ~(shadow & (nchunks > 0)))[0]
    if bad.size:
        raise AssertionError(f"I4 violated: page {bad[0]} clean promoted "
                             "without shadow")

    # chunk references of valid pages: groups own 8 from ptr0, singles ptrs
    grp = valid & (nchunks == 8)
    sing = valid & (nchunks < 8)
    ref_ids = [(ptrs[grp, 0:1] + np.arange(8)).ravel()]
    for s in range(7):
        ref_ids.append(ptrs[sing & (nchunks > s), s])
    ref_ids = np.concatenate(ref_ids)
    counts = np.bincount(np.concatenate([free_ids, ref_ids]),
                         minlength=max(total, 1))
    if counts.size > total and counts[total:].any():
        raise AssertionError("I1 violated: a chunk id outside the region")
    if (counts[:total] != 1).any():
        c = int(np.nonzero(counts[:total] != 1)[0][0])
        raise AssertionError(f"I1 violated: chunk {c} is free or referenced "
                             f"{int(counts[c])} times")

    # I2: promoted pages own distinct, allocated P-chunks naming them
    ospns = np.nonzero(promoted)[0]
    pidx = ptrs[ospns, 6]
    if np.unique(pidx).size != pidx.size:
        raise AssertionError("I2: a P-chunk owned by two pages")
    if np.isin(pidx, pfree).any():
        raise AssertionError("I2: a promoted page's P-chunk is free")
    if (pidx >= activity.size).any():
        raise AssertionError("I2: P-chunk pointer out of range")
    a = activity[pidx]
    if not (((a >> 31) & 1 == 1).all() and ((a & _OSPN) == ospns).all()):
        raise AssertionError("I2: activity entry not allocated to its page")
    alloc = np.nonzero((activity >> 31) & 1 == 1)[0]
    if alloc.size != ospns.size:
        raise AssertionError("I2: allocated activity entries without a "
                             "promoted page")
    if pfree.size + ospns.size != cfg.n_pchunks:
        raise AssertionError("P-chunk conservation")
