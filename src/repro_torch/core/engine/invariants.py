"""Pool invariants I1-I4 and chunk conservation, checked in numpy over
``interop.pool_to_numpy(pool)`` (vectorised, so a deployment-size pool
checks in seconds). I5 (read-your-writes) is checked by reading back.

  I1  every C-chunk is free XOR referenced by exactly one page
  I2  promoted(page) <=> P-chunk allocated <=> activity entry allocated
  I3  dirty promoted pages hold no compressed copy
  I4  clean promoted pages keep the shadow (shadow_valid=1, chunks > 0)

``first_violation`` reports what the reference's own checker
(``tests/helpers.py::check_pool_invariants``) reports: the same checks in
the same order (freelists, then page by page I3, I4, each chunk reference,
I2, then the activity entries and the two conservation counts), and the
same message for the first that fails. One check follows the reference's:
no chunk id lies outside the compressed region.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.common.types import PoolConfig
from repro_torch.core.engine.state import n_single_chunks
from repro_torch.core.metadata import PCHUNK_SLOT

_PTR = (1 << 29) - 1
_OSPN = (1 << 30) - 1
_I2_RANK = 10        # after I3 (0), I4 (1) and up to 8 chunk references


def _first_seen(keys: np.ndarray) -> np.ndarray:
    """For each position, the position of the first equal key (keys in
    check order)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.r_[True, sk[1:] != sk[:-1]]
    first = order[np.maximum.accumulate(np.where(start, np.arange(sk.size),
                                                 0))]
    out = np.empty_like(order)
    out[order] = first
    return out


def first_violation(arrays: dict, cfg: PoolConfig) -> Optional[str]:
    """The first violated invariant's message, or None if all hold."""
    meta = arrays["meta"].astype(np.int64)
    activity = arrays["activity"].astype(np.int64)
    cfree = arrays["cfree.items"][: int(arrays["cfree.top"])].astype(np.int64)
    gfree = arrays["gfree.items"][: int(arrays["gfree.top"])].astype(np.int64)
    pfree = arrays["pfree.items"][: int(arrays["pfree.top"])].astype(np.int64)

    free_ids = np.concatenate([cfree, (gfree[:, None] + np.arange(8)).ravel()])
    if np.unique(free_ids).size != free_ids.size:
        return "duplicate entries in chunk freelists"
    if np.unique(pfree).size != pfree.size:
        return "duplicate entries in P freelist"

    w0 = meta[:, 0]
    pages = np.nonzero((w0 >> 31) & 1 == 1)[0]
    w0 = w0[pages]
    promoted = (w0 >> 30) & 1 == 1
    dirty = (w0 >> 29) & 1 == 1
    shadow = (w0 >> 28) & 1 == 1
    nchunks = (w0 >> 20) & 0xF
    ptrs = meta[pages, 1:8] & _PTR
    n = pages.size
    # the rank of each valid page's first failing check (big: none)
    big = np.iinfo(np.int64).max
    rank = np.full(n, big, np.int64)
    rank[promoted & ~dirty & ~(shadow & (nchunks > 0))] = 1
    rank[promoted & dirty & (nchunks != 0)] = 0

    # chunk references in check order: page by page, slot by slot
    grp = nchunks == 8
    slot = np.arange(8)
    ids = np.where(grp[:, None], ptrs[:, :1] + slot,
                   np.pad(ptrs, ((0, 0), (0, 1))))
    live = np.where(grp[:, None], True,
                    slot < np.minimum(nchunks, 7)[:, None])
    ref_page, ref_slot = np.nonzero(live)
    ref_id = ids[ref_page, ref_slot]
    owner = _first_seen(ref_id)
    is_free = np.isin(ref_id, free_ids)
    bad = is_free | (owner != np.arange(ref_id.size))
    np.minimum.at(rank, ref_page[bad], 2 + ref_slot[bad])

    # I2 for promoted pages, in page order
    prom = np.nonzero(promoted)[0]
    pidx = meta[pages[prom], 1 + PCHUNK_SLOT] & _PTR
    p_owner = _first_seen(pidx)
    in_range = pidx < activity.size      # an entry past the end: unset
    a = np.where(in_range, activity[np.where(in_range, pidx, 0)], 0) \
        if activity.size else np.zeros_like(pidx)
    i2 = np.full(prom.size, big, np.int64)
    i2 = np.where((a & _OSPN) != pages[prom], _I2_RANK + 3, i2)
    i2 = np.where((a >> 31) & 1 != 1, _I2_RANK + 2, i2)
    i2 = np.where(p_owner != np.arange(prom.size), _I2_RANK + 1, i2)
    i2 = np.where(np.isin(pidx, pfree), _I2_RANK, i2)
    rank[prom] = np.minimum(rank[prom], i2)

    failing = np.nonzero(rank != big)[0]
    if failing.size:
        k = int(failing[0])
        page, r = int(pages[k]), int(rank[k])
        if r == 0:
            return f"I3 violated: page {page} dirty with chunks"
        if r == 1:
            return f"I4 violated: page {page} clean promoted without shadow"
        if r < _I2_RANK:
            j = int(np.nonzero((ref_page == k) & (ref_slot == r - 2))[0][0])
            c = int(ref_id[j])
            if is_free[j]:
                return f"I1 violated: page {page} references free chunk {c}"
            prev = int(pages[ref_page[owner[j]]])
            return f"I1 violated: chunk {c} shared by {prev} and {page}"
        j = int(np.nonzero(prom == k)[0][0])
        p = int(pidx[j])
        if r == _I2_RANK:
            return f"I2: page {page} P-chunk {p} is free"
        if r == _I2_RANK + 1:
            prev = int(pages[prom[p_owner[j]]])
            return f"I2: P-chunk {p} owned by {prev} and {page}"
        if r == _I2_RANK + 2:
            return f"I2: activity[{p}] not allocated"
        return f"I2: activity[{p}] OSPN mismatch"

    # every allocated activity entry belongs to the promoted page it names
    owned = np.full(activity.size, -1, np.int64)
    owned[pidx] = pages[prom]
    alloc = np.nonzero((activity >> 31) & 1 == 1)[0]
    named = activity[alloc] & _OSPN
    bad = np.nonzero(owned[alloc] != named)[0]
    if bad.size:
        return (f"activity[{int(alloc[bad[0]])}] allocated but page "
                f"{int(named[bad[0]])} does not own it")

    n_single = n_single_chunks(cfg)
    total = n_single + 8 * ((cfg.n_cchunks - n_single) // 8)
    if free_ids.size + ref_id.size != total:
        return (f"I1 conservation: {free_ids.size} free + {ref_id.size} "
                f"ref != {total}")
    if pfree.size + prom.size != cfg.n_pchunks:
        return "P-chunk conservation"
    # beyond the reference's checks: the counts can balance with an id
    # outside the region standing in for a missing one
    if (free_ids >= total).any() or (ref_id >= total).any():
        return "I1 violated: a chunk id outside the region"
    return None


def check_pool_invariants(arrays: dict, cfg: PoolConfig) -> None:
    """Raise AssertionError with the first violated invariant's message."""
    msg = first_violation(arrays, cfg)
    if msg is not None:
        raise AssertionError(msg)
