"""Cross-expander migration mechanism (PyTorch port of
``repro.fabric.ops``; DESIGN.md §11/§13).

When pages move between expanders — freelist-pressure spill or
traffic-imbalance rebalancing (fabric/migration.py decides) — the
mechanism is the same: the page's chunks are read on the source (charged
as demotion-read traffic there), freed, and the page is re-stored on the
destination (allocation + demotion-write + compression-store bookkeeping
charged there) — the same §4 mechanism ops demotion uses, so invariants
I1–I5 hold on both expanders after every migration. Only *non-promoted*
chunk-backed pages are eligible: hot pages stay where their traffic is,
and zero pages occupy no chunks so moving them frees nothing.

``segment_stats`` computes the per-expander facts a ``MigrationPolicy``
plans from (freelist headroom, per-page eligibility, per-page referenced
bits) on the device, over a whole stack at once; the scheduler fetches
them with the segment's counters and times in one transfer.
``apply_migrations`` applies one epoch's explicit (page, src, dst) moves
on the stacked state, re-checking donor headroom and page eligibility
against the live state before each move, so a page that promoted or
invalidated while its plan was in flight is skipped, never corrupted.

Eager control flow, as in core/engine/ops.py: each move reads what its
decisions need (the donor's freelist tops, the page's entry) through
counted syncs, and the compressed payload travels through
``ops._gather_page_buf``/``_scatter_page_buf`` (the reference's plain
gathers; no kernel runs here). ``spill_pages`` is the reference's older
API (in-order candidate selection on a pool pair), kept for
compatibility.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common.types import PoolConfig
from repro_torch.core import mcache as mcc
from repro_torch.core import metadata as md
from repro_torch.core.engine import ops
from repro_torch.core.engine.policy import Policy
from repro_torch.core.engine.state import (C_DEMO_RD, C_DEMO_WR, C_META_RD,
                                           C_META_WR, Pool, bump, pool_slice)

# the safe allocation margin a donor must hold for one move: the largest
# single-chunk page (7) plus one aligned group
DONOR_SINGLES, DONOR_GROUPS = 7, 1


class SegmentStats(NamedTuple):
    """Per-expander migration facts (a leading expander axis when computed
    on a stack). The singles/groups split lets the planner's donor rule use
    the same margin the apply enforces (7 singles + 1 group)."""
    free_units: torch.Tensor    # int32[]  cfree + 8*gfree, in chunk units
    free_singles: torch.Tensor  # int32[]  cfree.top
    free_groups: torch.Tensor   # int32[]  gfree.top
    eligible: torch.Tensor      # bool[P]  valid & ~promoted & chunk-backed
    referenced: torch.Tensor    # bool[P]  metadata-cache-resident (§4.4)


def segment_stats(pool: Pool, cfg: PoolConfig) -> SegmentStats:
    """Migration-planning facts of a pool or a stack (leading axes carry
    through), as fresh tensors: a snapshot the in-place mechanisms cannot
    change afterwards. Referenced bits of *compressed* pages are
    metadata-cache residency, the recency signal the demotion engine
    probes (activity-region bits cover only promoted pages, which never
    migrate)."""
    w0s = pool.meta[..., 0]
    eligible = (md.get_valid(w0s) == 1) & (md.get_promoted(w0s) == 0) & \
        (md.get_num_chunks(w0s) > 0)
    free_units = pool.cfree.top + 8 * pool.gfree.top
    tags = pool.cache.tags
    ids = torch.arange(cfg.n_pages, dtype=torch.int32, device=tags.device)
    sets = mcc.set_index(ids, tags.shape[-2]).long()
    referenced = (tags[..., sets, :] == ids[:, None]).any(dim=-1)
    return SegmentStats(free_units=free_units,
                        free_singles=pool.cfree.top.clone(),
                        free_groups=pool.gfree.top.clone(),
                        eligible=eligible, referenced=referenced)


def page_eligible(entry: List[int]) -> Tuple[bool, int]:
    """(eligible, nchunks) of a host metadata entry: valid, non-promoted,
    chunk-backed — the per-move re-check every apply path shares."""
    w0 = entry[0]
    nchunks = md.get_num_chunks(w0)
    eligible = md.get_valid(w0) == 1 and md.get_promoted(w0) == 0 and \
        nchunks > 0
    return eligible, nchunks


def _moved_units(cfg: PoolConfig, nchunks: int) -> int:
    return nchunks * (cfg.chunk_bytes // 64)


def migrate_src(s: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                entry: List[int], nchunks: int) -> None:
    """Source half of one page move (the caller gathers the payload
    first): charge the demotion-read and metadata traffic, free the
    chunks, invalidate the entry."""
    policy.charge_migration(s.counters, C_DEMO_RD, _moved_units(cfg, nchunks))
    bump(s.counters, C_META_RD, ops.meta_width(cfg, ospn))
    ops.free_chunks(s, cfg, entry)
    ops._set_entry(s, ospn, [0] * md.ENTRY_WORDS)
    bump(s.counters, C_META_WR, ops.meta_width(cfg, ospn))


def migrate_dst(d: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                entry: List[int], nchunks: int, buf: torch.Tensor) -> None:
    """Destination half: allocate, store the travelled payload, write the
    travelled metadata entry with its pointers rewritten for the
    destination's allocation."""
    ptrs, is_group = ops.alloc_chunks(d, cfg, nchunks)
    ops._scatter_page_buf(d, cfg, buf, ptrs, nchunks, is_group)
    new_entry = entry
    for i in range(7):
        new_entry = md.set_ptr(new_entry, i, max(ptrs[i], 0))
    policy.charge_migration(d.counters, C_DEMO_WR, _moved_units(cfg, nchunks))
    bump(d.counters, C_META_WR, ops.meta_width(cfg, ospn))
    policy.on_compress_store(d.counters)
    ops._set_entry(d, ospn, new_entry)


def migrate_page(src: Pool, dst: Pool, cfg: PoolConfig, policy: Policy,
                 ospn: int) -> bool:
    """Move one page's compressed copy from ``src`` to ``dst``, in place.

    Anything but a valid, non-promoted, chunk-backed page is a no-op
    (returns False). The metadata entry travels unchanged (rates, sizes,
    num_chunks, wr_cntr); only the chunk pointers are rewritten."""
    entry = ops._entry(src, ospn)
    eligible, nchunks = page_eligible(entry)
    if not eligible:
        return False
    buf = ops._gather_page_buf(src, cfg, entry)
    migrate_src(src, cfg, policy, ospn, entry, nchunks)
    migrate_dst(dst, cfg, policy, ospn, entry, nchunks, buf)
    return True


def _donor_headroom(pool: Pool) -> bool:
    """The donor's live safe allocation margin (one counted sync)."""
    singles, groups = contracts.tolist(
        torch.stack([pool.cfree.top, pool.gfree.top]))
    return singles >= DONOR_SINGLES and groups >= DONOR_GROUPS


def spill_pages(src: Pool, dst: Pool, cfg: PoolConfig, policy: Policy,
                k: int) -> np.ndarray:
    """Migrate up to ``k`` eligible pages from ``src`` to ``dst``.

    Candidates are the first ``k`` eligible pages in OSPN order (taken from
    the state at the call); each move is skipped when the donor lacks the
    safe allocation margin, so spill never corrupts the donor's
    freelists. Returns int32[k] migrated OSPNs, -1 where skipped."""
    cand = segment_stats(src, cfg).eligible
    order = contracts.tolist(torch.argsort(
        (~cand).to(torch.int8), stable=True)[:k])
    cand_h = contracts.tolist(cand[torch.tensor(order, dtype=torch.long,
                                                device=cand.device)]) \
        if order else []
    moved = np.full((k,), -1, np.int32)
    for i, (ospn, ok) in enumerate(zip(order, cand_h)):
        if ok and _donor_headroom(dst) and \
                migrate_page(src, dst, cfg, policy, ospn):
            moved[i] = ospn
    return moved


def apply_migrations(pools: Pool, cfg: PoolConfig, policy: Policy,
                     pages, srcs, dsts) -> np.ndarray:
    """Apply one migration epoch on the STACKED state, in place.

    ``pages``/``srcs``/``dsts`` are host int32[k] (pages -1-padded):
    explicit moves a ``MigrationPolicy`` planned, possibly one segment
    ago. Each move re-checks the donor's headroom (7 singles + 1 group)
    against its LIVE freelists and the page's eligibility against the
    LIVE metadata, so a stale plan skips, never corrupts. Returns int32[k]
    of the OSPNs that moved (-1 where skipped); the host turns it into
    one override-table scatter (``Placement.apply_epoch``)."""
    pages = np.asarray(pages, np.int64)
    moved = np.full(pages.shape, -1, np.int32)
    for i, (p, s, d) in enumerate(zip(pages.tolist(),
                                      np.asarray(srcs).tolist(),
                                      np.asarray(dsts).tolist())):
        if p < 0 or s == d:
            continue
        dst = pool_slice(pools, d)
        if _donor_headroom(dst) and \
                migrate_page(pool_slice(pools, s), dst, cfg, policy, p):
            moved[i] = p
    return moved
