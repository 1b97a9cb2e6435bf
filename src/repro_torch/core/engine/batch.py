"""Batched access front-end (PyTorch port of ``repro.core.engine.batch``).

Each window of W accesses runs:

  phase 0  the background demotion engine tops up the free-P-chunk list
           once per window;
  phase 1  vectorized classification against a window-start metadata
           snapshot: hot/zero/invalid reads and writes to promoted all-hot
           dirty pages are *fast* (no metadata transition);
  phase 2  the whole window goes through ``mcache.access_window`` and one
           ``index_add_`` applies every lazy referenced-bit update;
  phase 3  the remaining (slow) accesses replay in order through the
           serial per-access bodies, branching on the host.

Phases 1-2 and the fast accounting cost one host sync per window (the
fast mask and its classes, fetched together); each slow access costs the
syncs its body needs (core/engine/ops.py). The trace's own arrays stay on
the host, so reading an access's page, block or direction costs nothing.
The tail that does not fill a window replays serially.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common.types import PoolConfig
from repro_torch.core import mcache as mcc
from repro_torch.core import metadata as md
from repro_torch.core.engine import ops
from repro_torch.core.engine.policy import Policy
from repro_torch.core.engine.state import (C_ACT_WR, C_DATA_RD, C_DATA_WR,
                                           C_HOST_RD, C_HOST_WR, C_MC_HIT,
                                           C_MC_MISS, C_META_RD, C_META_WR,
                                           C_ZERO_SERVED, Pool, bump)

DEFAULT_WINDOW = 32


def _classify_window(pool: Pool, cfg: PoolConfig, ospns: torch.Tensor,
                     writes: torch.Tensor, blocks: torch.Tensor):
    """Fast-path mask over a window: (fast, is_zero, is_hot), bool[W]."""
    w0s = pool.meta[ospns.long(), 0]
    valid = md.get_valid(w0s) == 1
    promoted = md.get_promoted(w0s) == 1
    if cfg.coloc:
        bt = md.get_block_type(w0s, blocks.long())
        all_prom = torch.ones_like(valid)
        for i in range(cfg.blocks_per_page):
            all_prom = all_prom & (md.get_block_type(w0s, i) == md.BT_PROM)
    else:
        bt = md.get_block_type(w0s, 0)
        all_prom = bt == md.BT_PROM
    is_zero = valid & (bt == md.BT_ZERO)
    is_hot = valid & promoted & (bt == md.BT_PROM)
    hot_write = valid & promoted & all_prom & \
        (md.get_dirty(w0s) == 1) & (md.get_num_chunks(w0s) == 0)
    candidate = torch.where(writes, hot_write, is_zero | is_hot | ~valid)
    w = ospns.shape[0]
    idx = torch.arange(w, device=ospns.device)
    earlier = idx[None, :] < idx[:, None]
    same = ospns[:, None] == ospns[None, :]
    slow_pred = (same & earlier & ~candidate[None, :]).any(dim=1)
    return candidate & ~slow_pred, is_zero, is_hot


def _mcache_window(pool: Pool, cfg: PoolConfig, policy: Policy,
                   ospns: torch.Tensor) -> None:
    """Vectorized metadata-cache walk + lazy activity updates (no sync)."""
    hits, evicted = mcc.access_window(pool.cache, ospns)
    n_hit = hits.sum().to(torch.int32)
    n_miss = ospns.shape[0] - n_hit
    widths = torch.ones_like(ospns) if cfg.compact else 1 + (ospns & 1)
    c = pool.counters
    bump(c, C_MC_HIT, n_hit)
    bump(c, C_MC_MISS, n_miss)
    bump(c, C_META_RD, torch.where(hits, 0, widths).sum().to(torch.int32))
    policy.on_mcache_miss(c, n=n_miss)
    # lazy reference update (§4.4) for every eviction, as one scatter-add
    ev = evicted.reshape(-1).long()
    entries = pool.meta[torch.clamp(ev, min=0)]
    w0 = entries[:, 0]
    prom = (md.get_promoted(w0) == 1) & (md.get_valid(w0) == 1) & (ev >= 0)
    pidx = md.get_ptr(entries, md.PCHUNK_SLOT)
    safe = torch.clamp(torch.where(prom, pidx, 0), 0,
                       pool.activity.shape[0] - 1)
    already = md.act_referenced(pool.activity[safe]) == 1
    flips = prom & ~already
    delta = torch.where(flips, 1 << md.ACT_REFERENCED_BIT, 0).to(torch.int64)
    pool.activity.index_add_(0, safe, delta)
    policy.charge_activity(c, C_ACT_WR, flips.sum().to(torch.int32))


def _window_step(pool: Pool, cfg: PoolConfig, policy: Policy,
                 host: tuple, dev: tuple, stats: Optional[dict]) -> None:
    ospns_h, writes_h, blocks_h = host
    ospns, writes, blocks = dev
    window = ospns_h.shape[0]
    zero_block = torch.zeros((cfg.vals_per_block,), dtype=torch.bfloat16,
                             device=pool.meta.device)
    s0 = contracts.SYNCS.count

    # phase 0: top up once per window to a raised target (bounded by the
    # watermark); "access" cadence re-checks before every slow access instead
    per_access = cfg.demote_cadence == "access"
    if per_access:
        extra, budget = 0, window
    else:
        extra = min(window // 4, max(2, cfg.demote_watermark // 2))
        budget = max(4, window // 4)
    ops.demote_if_needed(pool, cfg, policy, max_demotes=budget,
                         watermark=cfg.demote_watermark + extra)

    # phase 1 + 2: classification snapshot, then the window's cache walk
    fast, is_zero, is_hot = _classify_window(pool, cfg, ospns, writes, blocks)
    _mcache_window(pool, cfg, policy, ospns)
    fast_h, zero_h, hot_h = contracts.tolist(
        torch.stack([fast, is_zero, is_hot]))

    # fast accounting, from the fetched masks
    fast_rd = [f and not w for f, w in zip(fast_h, writes_h)]
    fast_wr = [f and w for f, w in zip(fast_h, writes_h)]
    n_rd, n_wr = sum(fast_rd), sum(fast_wr)
    c = pool.counters
    bump(c, C_HOST_RD, n_rd)
    bump(c, C_HOST_WR, n_wr)
    policy.on_host_access(c, False, n=n_rd)
    policy.on_host_access(c, True, n=n_wr)
    bump(c, C_ZERO_SERVED, sum(r and z for r, z in zip(fast_rd, zero_h)))
    bump(c, C_DATA_RD, sum(r and h for r, h in zip(fast_rd, hot_h))
         * (cfg.block_bytes // 64))
    bump(c, C_DATA_WR, n_wr * (cfg.block_bytes // 64))
    bump(c, C_META_WR, n_wr if cfg.compact else
         sum(1 + (int(o) & 1) for o, f in zip(ospns_h, fast_wr) if f))
    s1 = contracts.SYNCS.count

    # phase 3: the slow accesses, in trace order
    slow = [k for k in range(window) if not fast_h[k]]
    for k in slow:
        if per_access:
            ops.demote_if_needed(pool, cfg, policy)
        o, b = int(ospns_h[k]), int(blocks_h[k])
        if writes_h[k]:
            bump(c, C_HOST_WR)
            policy.on_host_access(c, True)
            ops.write_block_op(pool, cfg, policy, o, b, zero_block)
        else:
            bump(c, C_HOST_RD)
            policy.on_host_access(c, False)
            ops.read_block_op(pool, cfg, policy, o, b)
    if stats is not None:
        stats["windows"] += 1
        stats["slow"] += len(slow)
        stats["window_syncs"] += s1 - s0
        stats["slow_syncs"] += contracts.SYNCS.count - s1


def _serial_access(pool: Pool, cfg: PoolConfig, policy: Policy, ospn: int,
                   is_write: bool, blk: int) -> None:
    """One access through the serial per-access path (full prologue)."""
    zero_block = torch.zeros((cfg.vals_per_block,), dtype=torch.bfloat16,
                             device=pool.meta.device)
    if is_write:
        ops.host_write_block(pool, cfg, policy, ospn, blk, zero_block)
    else:
        ops.host_read_block(pool, cfg, policy, ospn, blk)


def new_stats() -> dict:
    """Counters ``replay_trace`` fills when given a stats dict."""
    return {"windows": 0, "slow": 0, "window_syncs": 0, "slow_syncs": 0,
            "serial": 0, "serial_syncs": 0}


def _replay_windows_masked(pool: Pool, cfg: PoolConfig, policy: Policy,
                           ospns, writes, blocks, valid, pending=None,
                           stats: Optional[dict] = None) -> Pool:
    """Window walk over a *padded* trace, in place: the multi-expander
    fabric's entry point (fabric/replay.py runs it on each expander's
    slice of the stack).

    ``ospns``/``writes``/``blocks``/``valid`` are host arrays [n_win, W]:
    an expander's trace partition as a prefix of real accesses followed by
    padding. Per window:

      * all valid  -> ``_window_step``, as ``replay_trace``'s windows;
      * part valid -> the serial per-access body over the valid accesses,
                      in order, as ``replay_trace``'s tail;
      * none valid -> nothing.

    Padding sits at the end, so the walk is full windows, one partial
    window, then no-ops, and the pool ends bit-identical to an unpadded
    ``replay_trace`` of the real prefix. ``pending`` (host bool[n_pages],
    the fabric's pages whose migration is in flight) turns an access to
    such a page into a no-op; all False changes nothing. The masks live on
    the host, so choosing a window's branch costs no sync."""
    ospns = np.asarray(ospns, np.int64)
    writes = np.asarray(writes, bool)
    blocks = np.asarray(blocks, np.int64)
    valid = np.asarray(valid, bool)
    if pending is not None:
        valid = valid & ~np.asarray(pending, bool)[ospns]
    full = valid.all(axis=1)
    if full.any():
        dev = pool.meta.device
        o_d = torch.from_numpy(ospns).to(dev).to(torch.int32)
        w_d = torch.from_numpy(writes).to(dev)
        b_d = torch.from_numpy(blocks).to(dev).to(torch.int32)
    for i in range(ospns.shape[0]):
        if full[i]:
            _window_step(pool, cfg, policy,
                         (ospns[i], writes[i], blocks[i]),
                         (o_d[i], w_d[i], b_d[i]), stats)
            continue
        sel = np.nonzero(valid[i])[0]
        s0 = contracts.SYNCS.count
        for k in sel:
            _serial_access(pool, cfg, policy, int(ospns[i, k]),
                           bool(writes[i, k]), int(blocks[i, k]))
        if stats is not None:
            stats["serial"] += len(sel)
            stats["serial_syncs"] += contracts.SYNCS.count - s0
    return pool


def replay_trace(pool: Pool, cfg: PoolConfig, policy: Policy, ospns, writes,
                 blocks, *, window: int = DEFAULT_WINDOW,
                 stats: Optional[dict] = None) -> Pool:
    """Replay a (ospn, is_write, block) trace through the pool, in place.

    ``window > 1`` uses the batched front-end over whole windows and replays
    the tail serially; ``window <= 1`` replays everything serially. Write
    accesses carry a zero-block payload. ``stats`` (``new_stats()``), when
    given, receives window, slow-access and sync counts."""
    ospns = np.asarray(ospns, np.int64)
    writes = np.asarray(writes, bool)
    blocks = np.asarray(blocks, np.int64)
    dev = pool.meta.device
    n = ospns.shape[0]
    n_win = n // window if window > 1 else 0
    head = n_win * window
    if n_win:
        o_d = torch.from_numpy(ospns[:head]).to(dev).to(torch.int32)
        w_d = torch.from_numpy(writes[:head]).to(dev)
        b_d = torch.from_numpy(blocks[:head]).to(dev).to(torch.int32)
        for i in range(n_win):
            sl = slice(i * window, (i + 1) * window)
            _window_step(pool, cfg, policy,
                         (ospns[sl], writes[sl], blocks[sl]),
                         (o_d[sl], w_d[sl], b_d[sl]), stats)
    s0 = contracts.SYNCS.count
    for k in range(head, n):
        _serial_access(pool, cfg, policy, int(ospns[k]), bool(writes[k]),
                       int(blocks[k]))
    if stats is not None:
        stats["serial"] += n - head
        stats["serial_syncs"] += contracts.SYNCS.count - s0
    return pool
