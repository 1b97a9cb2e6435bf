"""Mechanism ops: allocation/free, metadata read-modify-write, store I/O,
promotion (§4.1, §4.5, §4.6), demotion (§4.4 + §4.5), and traffic
accounting in 64B units (PyTorch port of ``repro.core.engine.ops``).

Eager control flow: where the reference branches with ``lax.cond`` on a
device scalar, the port reads what the branch needs through one counted
sync and decides on the host. A slow access fetches its page's 8-word
metadata entry once, edits it as Python ints and uploads it back; the
payload stores, the activity region and the metadata cache stay on the
device and are updated in place. Every function takes ``(pool, cfg,
policy, ...)`` and mutates ``pool``'s tensors.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.common import contracts, prng
from repro_torch.common.types import PoolConfig
from repro_torch.core import activity as act
from repro_torch.core import compressor as comp
from repro_torch.core import freelist as fl
from repro_torch.core import mcache as mcc
from repro_torch.core import metadata as md
from repro_torch.core.bitpack import RATE_RAW, RATE_ZERO
from repro_torch.core.engine.policy import Policy
from repro_torch.core.engine.state import (C_ACT_RD, C_ACT_WR, C_DATA_RD,
                                           C_DATA_WR, C_DEMO_CLEAN,
                                           C_DEMO_DIRTY, C_DEMO_RD, C_DEMO_WR,
                                           C_HOST_RD, C_HOST_WR, C_MC_HIT,
                                           C_MC_MISS, C_META_RD, C_META_WR,
                                           C_PROMO_RD, C_PROMO_WR,
                                           C_PROMOTIONS, C_RANDOM_FB,
                                           C_RECOMP_RETRY, C_ZERO_SERVED,
                                           Pool, bump)


# ---------------------------------------------------------------------------
# Host views of device state.
# ---------------------------------------------------------------------------

def _entry(pool: Pool, ospn: int) -> List[int]:
    """Page ``ospn``'s metadata entry as 8 Python ints (one sync)."""
    return contracts.tolist(pool.meta[ospn])


def _set_entry(pool: Pool, ospn: int, entry: List[int]) -> None:
    pool.meta[ospn] = contracts.upload(entry, torch.int64, pool.meta.device)


def _nblocks(cfg: PoolConfig) -> int:
    return cfg.blocks_per_page if cfg.coloc else 1


def content_rates(pool: Pool, cfg: PoolConfig, ospn: int) -> List[int]:
    """Per-block rates from the content model (payload-less mode)."""
    r = contracts.tolist(pool.rates_table[ospn])
    if not cfg.zero_elision:
        r = [max(x, 1) for x in r]
    return r if cfg.coloc else [max(r)]


def rates_to_chunks(rates: List[int], cfg: PoolConfig) -> Tuple[int, int]:
    """(quanta_total, num_chunks) for a page with these block rates."""
    table = comp.quanta_per_rate(cfg.vals_per_page // len(rates))
    quanta = sum(table[r] for r in rates)
    qpc = cfg.chunk_bytes // comp.QUANTUM
    return quanta, -(-quanta // qpc)


def meta_width(cfg: PoolConfig, ospn: int) -> int:
    """64B accesses per metadata fetch: 1 compacted; uncompacted entries
    straddle the 64B boundary for odd pages (§4.7)."""
    return 1 if cfg.compact else 1 + (ospn & 1)


# ---------------------------------------------------------------------------
# Metadata-cache step with lazy reference update (§4.4) — no host sync.
# ---------------------------------------------------------------------------

def mcache_step(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int
                ) -> torch.Tensor:
    hit, evicted = mcc.access(pool.cache, ospn)
    miss = (~hit).to(torch.int32)
    c = pool.counters
    bump(c, C_MC_HIT, hit.to(torch.int32))
    bump(c, C_MC_MISS, miss)
    bump(c, C_META_RD, miss * meta_width(cfg, ospn))
    policy.on_mcache_miss(c, n=miss)
    # lazy update: the evicted page, if promoted, gets its referenced bit now
    ev_entry = pool.meta[torch.clamp(evicted, min=0)]
    ev_promoted = (md.get_promoted(ev_entry[0]) == 1) & (evicted >= 0) & \
        (md.get_valid(ev_entry[0]) == 1)
    ev_pidx = md.get_ptr(ev_entry, md.PCHUNK_SLOT)
    n_act = pool.activity.shape[0]
    safe = torch.clamp(ev_pidx, 0, n_act - 1)
    already = md.act_referenced(pool.activity[safe]) == 1
    act.lazy_touch(pool.activity, torch.where(
        ev_promoted & (ev_pidx < n_act), ev_pidx, torch.full_like(ev_pidx, -1)))
    # the activity word is written only when the referenced bit flips
    policy.charge_activity(c, C_ACT_WR, (ev_promoted & ~already).to(torch.int32))
    return hit


# ---------------------------------------------------------------------------
# Payload helpers (no-ops when store_payload=False).
# ---------------------------------------------------------------------------

def _chunk_ptrs(entry: List[int]) -> List[int]:
    """Pointer slots 0..6 (slot 6 doubles as the P-chunk slot)."""
    return [md.get_ptr(entry, i) for i in range(7)]


def _page_chunk_ids(cfg: PoolConfig, entry: List[int], n_chunks: int
                    ) -> List[int]:
    nchunks = md.get_num_chunks(entry[0])
    ptrs = _chunk_ptrs(entry)
    ids = []
    for i in range(cfg.chunks_per_page):
        idx = ptrs[0] + i if nchunks == 8 else \
            (ptrs[min(i, 6)] if i < nchunks else 0)
        ids.append(min(max(idx, 0), n_chunks - 1))
    return ids


def _gather_page_buf(pool: Pool, cfg: PoolConfig, entry: List[int]
                     ) -> torch.Tensor:
    """Reassemble the compacted compressed-page buffer from its chunks."""
    if not cfg.store_payload:
        return torch.zeros((cfg.page_bytes,), dtype=torch.uint8,
                           device=pool.meta.device)
    ids = contracts.upload(_page_chunk_ids(cfg, entry, pool.c_store.shape[0]),
                           torch.int64, pool.c_store.device)
    return pool.c_store.index_select(0, ids).reshape(cfg.page_bytes)


def _scatter_page_buf(pool: Pool, cfg: PoolConfig, buf: torch.Tensor,
                      ptrs: List[int], nchunks: int, is_group: bool) -> None:
    if not cfg.store_payload:
        return
    pieces = buf.reshape(cfg.chunks_per_page, cfg.chunk_bytes)
    last = pool.c_store.shape[0] - 1
    dest = {}                               # later writes win, as in order
    for i in range(cfg.chunks_per_page):
        if is_group or i < nchunks:
            idx = ptrs[0] + i if is_group else ptrs[min(i, 6)]
            dest[min(max(idx, 0), last)] = i
    if dest:
        dev = pool.c_store.device
        rows = contracts.upload(list(dest.keys()), torch.int64, dev)
        src = contracts.upload(list(dest.values()), torch.int64, dev)
        pool.c_store.index_copy_(0, rows, pieces.index_select(0, src))


def _pslot(pool: Pool, pidx: int) -> int:
    return min(max(pidx, 0), max(pool.p_store.shape[0] - 1, 0))


def _block_range(cfg: PoolConfig, block_idx: int) -> slice:
    start = min(block_idx * cfg.block_bytes, cfg.page_bytes - cfg.block_bytes)
    return slice(start, start + cfg.block_bytes)


def _read_pchunk_block(pool: Pool, cfg: PoolConfig, pidx: int,
                       block_idx: int) -> torch.Tensor:
    if not cfg.store_payload:
        return torch.zeros((cfg.vals_per_block,), dtype=torch.bfloat16,
                           device=pool.meta.device)
    return pool.p_store[_pslot(pool, pidx), _block_range(cfg, block_idx)] \
        .clone().view(torch.bfloat16)


def _write_pchunk_block(pool: Pool, cfg: PoolConfig, pidx: int,
                        block_idx: int, vals: torch.Tensor) -> None:
    if not cfg.store_payload:
        return
    pool.p_store[_pslot(pool, pidx), _block_range(cfg, block_idx)] = \
        _page_to_bytes(vals)


def _page_to_bytes(vals: torch.Tensor) -> torch.Tensor:
    """bf16 values -> their little-endian bytes."""
    return vals.to(torch.bfloat16).contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# Chunk (de)allocation.
# ---------------------------------------------------------------------------

def alloc_chunks(pool: Pool, cfg: PoolConfig, num_chunks: int
                 ) -> Tuple[List[int], bool]:
    """Allocate ``num_chunks`` C-chunks (8 -> one aligned group). Returns
    (ptrs[7], is_group); slots not allocated hold -1."""
    if num_chunks >= 8:
        return [fl.pop(pool.gfree)] + [-1] * 6, True
    k = min(num_chunks, 7)
    return (fl.pop_n(pool.cfree, k) if k > 0 else []) + [-1] * (7 - k), False


def free_chunks(pool: Pool, cfg: PoolConfig, entry: List[int]) -> None:
    """Release all C-chunks referenced by ``entry`` (no-op if none)."""
    nchunks = md.get_num_chunks(entry[0])
    if nchunks == 0:
        return
    ptrs = _chunk_ptrs(entry)
    if nchunks == 8:
        fl.push(pool.gfree, ptrs[0])
    else:
        fl.push_n(pool.cfree, [p if i < nchunks else -1
                               for i, p in enumerate(ptrs)])


# ---------------------------------------------------------------------------
# Demotion (§4.4 + §4.5).
# ---------------------------------------------------------------------------

def _select(pool: Pool, policy: Policy, force: bool = False) -> act.ScanResult:
    """One victim selection: split the pool's key, run the clock, charge
    the scan, and write back key and hand."""
    regs = contracts.tolist(torch.cat([pool.rng, pool.hand.reshape(1).long()]))
    rng, sub = prng.split((regs[0], regs[1]))
    res = policy.select_victim(pool.activity, regs[2], pool.cache, sub,
                               force=force)
    policy.charge_activity(pool.counters, C_ACT_RD, res.groups_scanned)
    policy.charge_activity(pool.counters, C_ACT_WR, res.groups_scanned)
    if res.used_random:
        bump(pool.counters, C_RANDOM_FB)
    pool.rng[0] = rng[0]
    pool.rng[1] = rng[1]
    pool.hand.fill_(res.hand)
    return res


def _demote_clean(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                  entry: List[int]) -> None:
    """§4.5: re-validate the shadow by flipping type fields only."""
    raw_sz = 7 if cfg.coloc else RATE_RAW   # non-coloc sz holds the rate
    w = entry[0]
    for i in range(_nblocks(cfg)):
        if md.get_block_type(w, i) == md.BT_PROM:
            restored = md.BT_INCOMP if md.get_block_sz(w, i) == raw_sz \
                else md.BT_COMP
            w = md.set_block_type(w, i, restored)
    w = md.set_shadow_valid(md.set_promoted(w, 0), 0)
    _set_entry(pool, ospn, [w] + entry[1:])
    bump(pool.counters, C_META_WR, meta_width(cfg, ospn))
    bump(pool.counters, C_DEMO_CLEAN)
    policy.on_demotion(pool.counters, clean=True)


def _store_compressed(pool: Pool, cfg: PoolConfig, ospn: int,
                      buf: torch.Tensor, rates: List[int], nchunks: int
                      ) -> None:
    """Allocate chunks, write the page stream, and write a fresh
    (resident, compressed) entry for ``ospn``."""
    ptrs, is_group = alloc_chunks(pool, cfg, nchunks)
    _scatter_page_buf(pool, cfg, buf, ptrs, nchunks, is_group)
    w = md.header_from_rates(rates) if cfg.coloc else \
        _header_4kb(rates[0], nchunks)
    w = md.set_num_chunks(w, nchunks)
    _set_entry(pool, ospn, [w] + [max(p, 0) & md.PTR_MASK for p in ptrs])


def _demote_dirty(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                  buf: torch.Tensor, rates: List[int], nchunks: int) -> None:
    """Store a recompressed page and charge the §4.2 cost."""
    _store_compressed(pool, cfg, ospn, buf, rates, nchunks)
    c = pool.counters
    policy.charge_migration(c, C_DEMO_RD, cfg.page_bytes // 64)
    policy.charge_migration(c, C_DEMO_WR, nchunks * (cfg.chunk_bytes // 64))
    bump(c, C_META_WR, meta_width(cfg, ospn))
    bump(c, C_DEMO_DIRTY)
    policy.on_compress_store(c)
    policy.on_demotion(c, clean=False)


def _is_clean(entry: List[int]) -> bool:
    return md.get_dirty(entry[0]) == 0 and md.get_shadow_valid(entry[0]) == 1


def _encode_victims(pool: Pool, cfg: PoolConfig, entries: List[List[int]]):
    """Recompress the promoted pages of ``entries`` (a payload pool's) in
    one batch: (bufs [K, page_bytes], host rates [K][B], host num_chunks
    [K])."""
    k = len(entries)
    slots = contracts.upload(
        [_pslot(pool, md.get_ptr(e, md.PCHUNK_SLOT)) for e in entries],
        torch.int64, pool.p_store.device)
    bufs, rates, _, _, record = comp.demote_pages(
        pool.p_store.view(torch.bfloat16), slots, cfg)
    host = contracts.tolist(record)
    nb = rates.shape[1]
    return bufs, [host[i * nb:(i + 1) * nb] for i in range(k)], host[k * nb:]


def demote_one(pool: Pool, cfg: PoolConfig, policy: Policy,
               force: bool = False) -> Pool:
    """Run the victim-selection policy once and demote the selected victim."""
    res = _select(pool, policy, force)
    if res.victim_ospn < 0:
        return pool
    ospn = res.victim_ospn
    entry = _entry(pool, ospn)
    if _is_clean(entry):
        _demote_clean(pool, cfg, policy, ospn, entry)
    else:
        if cfg.store_payload:
            bufs, rates, nch = _encode_victims(pool, cfg, [entry])
            _demote_dirty(pool, cfg, policy, ospn, bufs[0], rates[0], nch[0])
        else:
            rates = content_rates(pool, cfg, ospn)
            _demote_dirty(pool, cfg, policy, ospn, _zero_page(pool, cfg),
                          rates, rates_to_chunks(rates, cfg)[1])
    # free the P-chunk + activity entry in both cases
    pidx = md.get_ptr(entry, md.PCHUNK_SLOT)
    fl.push(pool.pfree, pidx)
    act.mark_free(pool.activity, pidx)
    return pool


def _zero_page(pool: Pool, cfg: PoolConfig) -> torch.Tensor:
    return torch.zeros((cfg.page_bytes,), dtype=torch.uint8,
                       device=pool.meta.device)


def _use_batched_demote(cfg: PoolConfig, device) -> bool:
    if cfg.fused_demote == "auto":
        return comp.resolve_impl(cfg, device) == "kernel"
    return cfg.fused_demote == "on"


def demote_batch(pool: Pool, cfg: PoolConfig, policy: Policy,
                 max_demotes: int, target: int) -> Pool:
    """Demote up to ``max_demotes`` victims with ONE batched recompression
    (one demote launch over all ``max_demotes`` pages), bit-identical
    to the serial loop: phase 1 selects victims and releases their
    P-chunks in serial order, phase 2 recompresses, phase 3 applies the
    metadata/chunk effects in victim order."""
    ospns, entries = [], []
    for _ in range(max_demotes):
        # the free count only grows here, so once it meets the target the
        # remaining steps (no-ops in the reference) can be skipped
        if fl.free_count(pool.pfree) >= target:
            break
        res = _select(pool, policy)
        if res.victim_ospn < 0:
            continue
        entry = _entry(pool, res.victim_ospn)
        pidx = md.get_ptr(entry, md.PCHUNK_SLOT)
        fl.push(pool.pfree, pidx)
        act.mark_free(pool.activity, pidx)
        ospns.append(res.victim_ospn)
        entries.append(entry)
    if not entries:
        return pool
    dirty = [not _is_clean(e) for e in entries]
    if any(dirty) and cfg.store_payload:
        # the batch always covers max_demotes pages (victim-less rows repeat
        # the first victim), so the launch shape is fixed
        pad = entries + [entries[0]] * (max_demotes - len(entries))
        bufs, rates, nch = _encode_victims(pool, cfg, pad)
    for i, (ospn, entry) in enumerate(zip(ospns, entries)):
        if not dirty[i]:
            _demote_clean(pool, cfg, policy, ospn, entry)
        elif cfg.store_payload:
            _demote_dirty(pool, cfg, policy, ospn, bufs[i], rates[i], nch[i])
        else:
            r = content_rates(pool, cfg, ospn)
            _demote_dirty(pool, cfg, policy, ospn, _zero_page(pool, cfg), r,
                          rates_to_chunks(r, cfg)[1])
    return pool


def demote_if_needed(pool: Pool, cfg: PoolConfig, policy: Policy,
                     max_demotes: int = 2, watermark: int = 0) -> Pool:
    """Keep >= watermark free P-chunks (at most ``max_demotes`` per call).
    ``watermark`` overrides ``cfg.demote_watermark`` when > 0. With
    ``cfg.fused_demote`` resolved on, the victims are recompressed in one
    batch (``demote_batch``)."""
    target = watermark or cfg.demote_watermark
    if max_demotes > 1 and _use_batched_demote(cfg, pool.meta.device):
        return demote_batch(pool, cfg, policy, max_demotes, target)
    for _ in range(max_demotes):
        if fl.free_count(pool.pfree) >= target:
            break                   # demotion only grows the free count
        demote_one(pool, cfg, policy)
    return pool


def ensure_free_pchunk(pool: Pool, cfg: PoolConfig, policy: Policy,
                       tries: int = 4) -> Pool:
    """Guarantee a free P-chunk before a promotion pops the list; the last
    tries force the clock's random fallback onto cache-resident pages."""
    for i in range(tries):
        if fl.free_count(pool.pfree) > 0:
            break                   # demotion only grows the free count
        demote_one(pool, cfg, policy, force=(i >= tries // 2))
    return pool


# ---------------------------------------------------------------------------
# Promotion (§4.1, §4.5, §4.6).
# ---------------------------------------------------------------------------

def _header_4kb(rate: int, nchunks: int) -> int:
    """word0 for co-location-disabled mode: rate kept in block_sz[0]."""
    bt = md.BT_ZERO if rate == RATE_ZERO else \
        (md.BT_INCOMP if rate == RATE_RAW else md.BT_COMP)
    w = md.set_block_sz(md.set_block_type(0, 0, bt), 0, rate)
    return md.set_valid(w, 1)


def _rates_of(entry: List[int], cfg: PoolConfig) -> List[int]:
    if cfg.coloc:
        return md.rates_from_header(entry[0], cfg.blocks_per_page)
    return [md.get_block_sz(entry[0], 0)]


def _promote_into(pool: Pool, cfg: PoolConfig, entry: List[int], slot: int,
                  ranges: List[int]) -> None:
    """Decode ``entry``'s compressed page into P-chunk ``slot``, only in
    its ``block_bytes`` ranges listed in ``ranges``: one record upload and
    one promote step (``compressor.promote_pages``)."""
    mask = sum(1 << r for r in ranges)
    rec = _page_chunk_ids(cfg, entry, pool.c_store.shape[0]) + \
        _rates_of(entry, cfg) + [slot, mask]
    comp.promote_pages(pool.c_store, pool.p_store,
                       contracts.upload([rec], torch.int32,
                                        pool.p_store.device), cfg)


def promote(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
            block_idx: int) -> List[int]:
    """Promote page ``ospn`` (fine-grained: materialize only ``block_idx``
    when the shadow can be kept). Returns the page's new entry."""
    entry = _entry(pool, ospn)
    already = md.get_promoted(entry[0]) == 1
    if not already:
        # demotion touches only promoted pages, so ``entry`` stays fresh
        ensure_free_pchunk(pool, cfg, policy)
    w0 = entry[0]
    nchunks = md.get_num_chunks(w0)
    pidx = md.get_ptr(entry, md.PCHUNK_SLOT) if already else fl.pop(pool.pfree)

    can_shadow = nchunks <= 6 or nchunks == 8
    full = (not can_shadow) or (not cfg.coloc)
    rates = _rates_of(entry, cfg)
    nblocks = _nblocks(cfg)

    # traffic: chunk reads; fine-grained reads only the target block's quanta
    q_all = comp.page_compressed_bytes(rates, cfg.vals_per_page // nblocks) // 64
    if cfg.coloc:
        table = comp.quanta_per_rate(cfg.vals_per_block)
        q_blk = table[rates[min(block_idx, nblocks - 1)]] * (comp.QUANTUM // 64)
    else:
        q_blk = q_all
    policy.charge_migration(pool.counters, C_PROMO_RD, q_all if full else q_blk)

    if cfg.store_payload:
        n_ranges = cfg.page_bytes // cfg.block_bytes
        ranges = [_block_range(cfg, block_idx).start // cfg.block_bytes] \
            if cfg.coloc and not full else list(range(n_ranges))
        _promote_into(pool, cfg, entry, _pslot(pool, pidx), ranges)
    policy.charge_migration(pool.counters, C_PROMO_WR,
                            cfg.page_bytes // 64 if full else cfg.block_bytes // 64)
    bump(pool.counters, C_PROMOTIONS)

    w = w0
    if cfg.coloc:
        for i in range(nblocks):
            if (block_idx == i or full) and md.get_block_type(w, i) != md.BT_ZERO:
                w = md.set_block_type(w, i, md.BT_PROM)
    else:
        w = md.set_block_type(w, 0, md.BT_PROM)
    w = md.set_promoted(w, 1)
    keep_shadow = can_shadow and cfg.shadow
    w = md.set_shadow_valid(w, int(keep_shadow))
    w = md.set_dirty(w, int(not keep_shadow))
    w = md.set_num_chunks(w, nchunks if keep_shadow else 0)
    new_entry = md.set_ptr([w] + entry[1:], md.PCHUNK_SLOT, max(pidx, 0))

    # if the shadow cannot be kept (or shadowing is off), free the chunks now
    if not (keep_shadow or nchunks == 0):
        free_chunks(pool, cfg, entry)
    bump(pool.counters, C_META_WR, meta_width(cfg, ospn))
    _set_entry(pool, ospn, new_entry)
    if not already:
        act.mark_allocated(pool.activity, pidx, ospn)   # arrives referenced
    return new_entry


# ---------------------------------------------------------------------------
# Host-facing access bodies (block granularity). They assume the per-access
# prologue already ran.
# ---------------------------------------------------------------------------

def write_page_op(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                  vals: torch.Tensor) -> Pool:
    """First-touch page write: lands uncompressed in the promoted region."""
    entry = _entry(pool, ospn)
    was_promoted = md.get_promoted(entry[0]) == 1
    if not was_promoted:
        ensure_free_pchunk(pool, cfg, policy)
    free_chunks(pool, cfg, entry)           # any previous incarnation
    pidx = md.get_ptr(entry, md.PCHUNK_SLOT) if was_promoted \
        else fl.pop(pool.pfree)
    if cfg.store_payload:
        pool.p_store[_pslot(pool, pidx)] = _page_to_bytes(vals)
    w = 0
    for i in range(_nblocks(cfg)):
        w = md.set_block_sz(md.set_block_type(w, i, md.BT_PROM), i, 0)
    w = md.set_dirty(md.set_promoted(md.set_valid(w, 1), 1), 1)
    new_entry = md.set_ptr([w] + [0] * 7, md.PCHUNK_SLOT, max(pidx, 0))
    bump(pool.counters, C_DATA_WR, cfg.page_bytes // 64)
    bump(pool.counters, C_META_WR, meta_width(cfg, ospn))
    _set_entry(pool, ospn, new_entry)
    act.mark_allocated(pool.activity, pidx, ospn)
    return pool


def read_block_op(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                  block_idx: int) -> Tuple[Pool, torch.Tensor]:
    """Read one block (paper Fig. 3 flow). Returns (pool, bf16 values)."""
    entry = _entry(pool, ospn)
    w0 = entry[0]
    valid = md.get_valid(w0) == 1
    bt = md.get_block_type(w0, block_idx if cfg.coloc else 0)
    if valid and bt == md.BT_ZERO:
        bump(pool.counters, C_ZERO_SERVED)
    elif valid and md.get_promoted(w0) == 1 and bt == md.BT_PROM:
        bump(pool.counters, C_DATA_RD, cfg.block_bytes // 64)
        return pool, _read_pchunk_block(
            pool, cfg, md.get_ptr(entry, md.PCHUNK_SLOT), block_idx)
    elif valid:
        e = promote(pool, cfg, policy, ospn, block_idx)
        return pool, _read_pchunk_block(
            pool, cfg, md.get_ptr(e, md.PCHUNK_SLOT), block_idx)
    return pool, torch.zeros((cfg.vals_per_block,), dtype=torch.bfloat16,
                             device=pool.meta.device)


def _write_inplace(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                   entry: List[int], block_idx: int,
                   vals: torch.Tensor) -> None:
    """§4.1.2: incompressible resident pages are updated in place; wr_cntr
    counts updates and triggers a recompression attempt at the threshold."""
    ww = entry[0]
    base = md.get_ptr(entry, 0)
    if cfg.store_payload:
        bb = _page_to_bytes(vals)
        cpb = cfg.block_bytes // cfg.chunk_bytes
        last = pool.c_store.shape[0] - 1
        for j in range(cpb):
            idx = min(max(base + block_idx * cpb + j, 0), last)
            pool.c_store[idx] = bb[j * cfg.chunk_bytes:(j + 1) * cfg.chunk_bytes]
    bump(pool.counters, C_DATA_WR, cfg.block_bytes // 64)
    cntr = md.get_wr_cntr(ww)
    if cntr + 1 < cfg.wr_thresh:
        _set_entry(pool, ospn, [md.set_wr_cntr(ww, cntr + 1)] + entry[1:])
        bump(pool.counters, C_META_WR, meta_width(cfg, ospn))
        return
    # recompression attempt: read the page, re-encode
    if cfg.store_payload:
        pv = _gather_page_buf(pool, cfg, entry).view(torch.bfloat16)
        bufs, _, _, _, record = comp.demote_pages(pv[None], None, cfg)
        buf = bufs[0]
        host = contracts.tolist(record)
        rates, nch = host[:-1], host[-1]
    else:
        buf = _zero_page(pool, cfg)
        rates = content_rates(pool, cfg, ospn)
        nch = rates_to_chunks(rates, cfg)[1]
    c = pool.counters
    policy.charge_migration(c, C_DEMO_RD, cfg.page_bytes // 64)
    bump(c, C_RECOMP_RETRY)
    # every retry is a compression-engine store attempt
    policy.on_compress_store(c)
    if nch < 8:
        free_chunks(pool, cfg, entry)
        _store_compressed(pool, cfg, ospn, buf, rates, nch)
        policy.charge_migration(c, C_DEMO_WR, nch * (cfg.chunk_bytes // 64))
        bump(c, C_META_WR, meta_width(cfg, ospn))
    else:
        _set_entry(pool, ospn, [md.set_wr_cntr(ww, 0)] + entry[1:])


def _update_promote(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                    entry: List[int], block_idx: int,
                    vals: torch.Tensor) -> None:
    """Write into a promoted (or promotable) page: materialize every cold
    block, drop the shadow (the update moment, §4.5), write the block."""
    e = entry if md.get_promoted(entry[0]) == 1 else \
        promote(pool, cfg, policy, ospn, block_idx)
    ww = e[0]
    nblocks = _nblocks(cfg)
    pidx = md.get_ptr(e, md.PCHUNK_SLOT)
    cold = [md.get_block_type(ww, i) not in (md.BT_PROM, md.BT_ZERO)
            for i in range(nblocks)]
    if any(cold):
        rates = _rates_of(e, cfg)
        if cfg.store_payload:
            _promote_into(pool, cfg, e, _pslot(pool, pidx), [
                p for p in range(cfg.page_bytes // cfg.block_bytes)
                if not (p < nblocks and
                        md.get_block_type(ww, p) == md.BT_PROM)])
        nb = comp.page_compressed_bytes(rates, cfg.vals_per_page // len(rates)) // 64
        policy.charge_migration(pool.counters, C_PROMO_RD, nb)
        policy.charge_migration(pool.counters, C_PROMO_WR, cfg.page_bytes // 64)
    if md.get_num_chunks(ww) > 0:
        free_chunks(pool, cfg, e)
    ww2 = ww
    for i in range(nblocks):
        ww2 = md.set_block_type(ww2, i, md.BT_PROM)
    ww2 = md.set_dirty(md.set_shadow_valid(md.set_num_chunks(ww2, 0), 0), 1)
    _set_entry(pool, ospn, [ww2] + [0] * 6 + e[7:])
    _write_pchunk_block(pool, cfg, pidx, block_idx, vals)
    bump(pool.counters, C_DATA_WR, cfg.block_bytes // 64)
    bump(pool.counters, C_META_WR, meta_width(cfg, ospn))


def write_block_op(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                   block_idx: int, vals: torch.Tensor) -> Pool:
    """Write one block. Writes promote (whole-page materialization so the
    page's chunks can be released — §4.5: updates invalidate the shadow)."""
    entry = _entry(pool, ospn)
    w0 = entry[0]
    if md.get_valid(w0) != 1:
        page = torch.zeros((cfg.vals_per_page,), dtype=torch.bfloat16,
                           device=pool.meta.device)
        n = vals.shape[0]
        start = min(max(block_idx * cfg.vals_per_block, 0), cfg.vals_per_page - n)
        page[start:start + n] = vals.to(torch.bfloat16)
        return write_page_op(pool, cfg, policy, ospn, page)
    if md.get_promoted(w0) == 0 and md.get_num_chunks(w0) == 8:
        _write_inplace(pool, cfg, policy, ospn, entry, block_idx, vals)
    else:
        _update_promote(pool, cfg, policy, ospn, entry, block_idx, vals)
    return pool


# ---------------------------------------------------------------------------
# Serial host-facing front-ends: per-access prologue + body. They run on the
# pool's device (``make_pool(..., device=...)``).
# ---------------------------------------------------------------------------

def _prologue(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
              is_write: bool) -> None:
    demote_if_needed(pool, cfg, policy)
    mcache_step(pool, cfg, policy, ospn)
    bump(pool.counters, C_HOST_WR if is_write else C_HOST_RD)
    policy.on_host_access(pool.counters, is_write)


def _as_int(x) -> int:
    return contracts.item(x) if isinstance(x, torch.Tensor) else int(x)


def host_write_page(pool: Pool, cfg: PoolConfig, policy: Policy, ospn,
                    vals: torch.Tensor) -> Pool:
    """Write a whole page of ``vals_per_page`` values (updates ``pool`` in
    place and returns it)."""
    ospn = _as_int(ospn)
    _prologue(pool, cfg, policy, ospn, is_write=True)
    return write_page_op(pool, cfg, policy, ospn, vals.to(pool.meta.device))


def host_read_block(pool: Pool, cfg: PoolConfig, policy: Policy, ospn,
                    block_idx) -> Tuple[Pool, torch.Tensor]:
    """Read one block: (pool, bf16[vals_per_block])."""
    ospn, block_idx = _as_int(ospn), _as_int(block_idx)
    _prologue(pool, cfg, policy, ospn, is_write=False)
    return read_block_op(pool, cfg, policy, ospn, block_idx)


def host_write_block(pool: Pool, cfg: PoolConfig, policy: Policy, ospn,
                     block_idx, vals: torch.Tensor) -> Pool:
    """Write one block of ``vals_per_block`` values."""
    ospn, block_idx = _as_int(ospn), _as_int(block_idx)
    _prologue(pool, cfg, policy, ospn, is_write=True)
    return write_block_op(pool, cfg, policy, ospn, block_idx,
                          vals.to(pool.meta.device))
