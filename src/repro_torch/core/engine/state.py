"""Pool state: the four device-memory regions + counters (PyTorch port of
``repro.core.engine.state``).

``Pool`` is a NamedTuple of tensors with the reference's leaves in the
reference's order. uint32 leaves (``meta``, ``activity``, ``rng``) are held
as int64; interop.py converts. The mechanisms update the tensors in place
(a pool passed to an entry point is consumed), which saves a copy of
``c_store``/``p_store`` per access.

Invariants (core/engine/invariants.py):
  I1  every C-chunk is free XOR referenced by exactly one page
  I2  promoted(page) <=> P-chunk allocated <=> activity entry allocated
  I3  dirty <=> num_chunks == 0 for promoted pages (no compressed copy)
  I4  clean promoted pages have shadow_valid=1 and intact chunks (§4.5)
  I5  read-your-writes at block granularity
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.common import contracts, prng
from repro_torch.common.types import PoolConfig
from repro_torch.common.utils import resolve_device
from repro_torch.core import freelist as fl
from repro_torch.core import mcache as mcc
from repro_torch.core import metadata as md

# Traffic counters (64B-access units unless noted).
C_META_RD, C_META_WR, C_DATA_RD, C_DATA_WR, C_PROMO_RD, C_PROMO_WR, \
    C_DEMO_RD, C_DEMO_WR, C_ACT_RD, C_ACT_WR, C_ZERO_SERVED, C_RANDOM_FB, \
    C_DEMO_CLEAN, C_DEMO_DIRTY, C_PROMOTIONS, C_HOST_RD, C_HOST_WR, \
    C_MC_HIT, C_MC_MISS, C_RECOMP_RETRY, NUM_COUNTERS = range(21)

CTR_DTYPE = torch.int32

COUNTER_NAMES = [
    "metadata_rd", "metadata_wr", "data_rd", "data_wr", "promo_rd", "promo_wr",
    "demo_rd", "demo_wr", "activity_rd", "activity_wr", "zero_served",
    "random_fallback", "demotions_clean", "demotions_dirty", "promotions",
    "host_reads", "host_writes", "mcache_hits", "mcache_misses",
    "recompress_retry",
]

# The ten internal 64B-access categories (excludes host accesses and events).
TRAFFIC_IDX = (C_META_RD, C_META_WR, C_DATA_RD, C_DATA_WR, C_PROMO_RD,
               C_PROMO_WR, C_DEMO_RD, C_DEMO_WR, C_ACT_RD, C_ACT_WR)
TRAFFIC_NAMES = tuple(COUNTER_NAMES[i] for i in TRAFFIC_IDX)


class Pool(NamedTuple):
    meta: torch.Tensor        # int64[n_pages, 8] (uint32 words)
    activity: torch.Tensor    # int64[n_pchunks]  (uint32 words)
    hand: torch.Tensor        # int32[]
    cfree: fl.FreeList        # single C-chunks
    gfree: fl.FreeList        # aligned 8-chunk groups (values = base chunk idx)
    pfree: fl.FreeList        # P-chunks
    cache: mcc.MCache
    counters: torch.Tensor    # int32[NUM_COUNTERS]
    rng: torch.Tensor         # int64[2] (a uint32 threefry key)
    c_store: torch.Tensor     # uint8[n_cchunks, chunk_bytes] (or [0, _])
    p_store: torch.Tensor     # uint8[n_pchunks, page_bytes]  (or [0, _])
    rates_table: torch.Tensor  # int32[n_pages, 4] content model (simx)


def n_single_chunks(cfg: PoolConfig) -> int:
    """Compressed region split: 7/8 singles, 1/8 aligned groups."""
    return (cfg.n_cchunks * 7 // 8) // 8 * 8


def make_pool(cfg: PoolConfig, seed: int = 0, rates_table=None,
              device=None) -> Pool:
    """A fresh pool on ``device`` (CUDA unless the caller names one)."""
    dev = resolve_device(device)
    n_single = n_single_chunks(cfg)
    n_groups = (cfg.n_cchunks - n_single) // 8
    gbases = n_single + 8 * torch.arange(n_groups, dtype=torch.int32,
                                         device=dev)
    pay_c = cfg.n_cchunks if cfg.store_payload else 0
    pay_p = cfg.n_pchunks if cfg.store_payload else 0
    if rates_table is None:
        rates_table = torch.zeros((cfg.n_pages, cfg.blocks_per_page),
                                  dtype=torch.int32)
    return Pool(
        meta=torch.zeros((cfg.n_pages, md.ENTRY_WORDS), dtype=torch.int64,
                         device=dev),
        activity=torch.zeros((cfg.n_pchunks,), dtype=torch.int64, device=dev),
        hand=torch.tensor(0, dtype=torch.int32, device=dev),
        cfree=fl.make_freelist(n_single, dev),
        gfree=fl.FreeList(items=gbases, top=torch.tensor(
            n_groups, dtype=torch.int32, device=dev)),
        pfree=fl.make_freelist(cfg.n_pchunks, dev),
        cache=mcc.make_mcache(cfg.mcache_sets, cfg.mcache_ways, dev),
        counters=torch.zeros((NUM_COUNTERS,), dtype=CTR_DTYPE, device=dev),
        rng=torch.tensor(prng.key(seed), dtype=torch.int64, device=dev),
        c_store=torch.zeros((pay_c, cfg.chunk_bytes), dtype=torch.uint8,
                            device=dev),
        p_store=torch.zeros((pay_p, cfg.page_bytes), dtype=torch.uint8,
                            device=dev),
        rates_table=torch.as_tensor(rates_table, dtype=torch.int32).to(dev),
    )


def bump(counters: torch.Tensor, idx: int, n=1) -> None:
    """counters[idx] += n (n an int or a 0-d tensor), in place."""
    counters[idx] += n


# ---------------------------------------------------------------------------
# Stacked pools (multi-expander fabric, repro_torch.fabric): N pools as one
# Pool whose every leaf carries a leading expander axis. ``pool_slice``
# returns views along that axis (each contiguous), so the single-pool
# mechanisms, which update a pool's tensors in place, advance expander e's
# slice of the stack directly.
# ---------------------------------------------------------------------------

def tree_map(fn, pool, *rest):
    """``fn`` over the leaves of a pool (nested NamedTuples), with the
    matching leaves of ``rest`` as further arguments."""
    if isinstance(pool, tuple) and hasattr(pool, "_fields"):
        return type(pool)(*(tree_map(fn, *xs) for xs in zip(pool, *rest)))
    return fn(pool, *rest)


def make_pool_stack(cfg: PoolConfig, n_expanders: int, seed: int = 0,
                    rates_table=None, device=None, ids=None) -> Pool:
    """N identically configured pools stacked leaf-wise on ``device``
    (CUDA unless the caller names one). Expander e's key is
    ``fold_in(key(seed), e)``, the reference's derivation, so a fabric run
    is reproducible from one seed and expanders share no randomness.
    ``ids`` (a range of expander ids) stacks only those expanders: a rank's
    block of the sharded fabric."""
    ids = range(n_expanders) if ids is None else ids
    base = make_pool(cfg, seed=seed, rates_table=rates_table, device=device)
    stack = tree_map(lambda a: a.unsqueeze(0).expand(
        (len(ids),) + tuple(a.shape)).clone(), base)
    keys = [prng.fold_in(prng.key(seed), e) for e in ids]
    return stack._replace(rng=torch.tensor(keys, dtype=torch.int64,
                                           device=base.meta.device))


def pool_slice(stack: Pool, e: int) -> Pool:
    """Expander ``e``'s pool: views into the stack, so in-place updates
    through it reach the stack."""
    return tree_map(lambda a: a[e], stack)


def pool_unslice(stack: Pool, e: int, pool: Pool) -> Pool:
    """Copy one pool into expander ``e``'s slice of the stack, in place;
    returns the stack."""
    tree_map(lambda s, a: s[e].copy_(a), stack, pool)
    return stack


def stacked_counters(stack: Pool) -> torch.Tensor:
    """Summed counters across expanders: int32[NUM_COUNTERS]."""
    return stack.counters.sum(dim=0, dtype=CTR_DTYPE)


def stacked_counters_dict(stack: Pool) -> dict:
    """Aggregate counters of a stacked state, ``counters_dict``'s keys
    (one counted sync)."""
    return dict(zip(COUNTER_NAMES, contracts.tolist(stacked_counters(stack))))


def per_expander_counters(stack: Pool) -> list:
    """One ``counters_dict`` per expander, in expander order (one counted
    sync)."""
    return [dict(zip(COUNTER_NAMES, row))
            for row in contracts.tolist(stack.counters)]


def compression_ratio(pool: Pool, cfg: PoolConfig) -> float:
    """Logical bytes of valid pages / physical bytes used (chunks + promoted
    duplicates)."""
    logical = contracts.item((md.get_valid(pool.meta[:, 0]) == 1).sum()) \
        * cfg.page_bytes
    n_single = n_single_chunks(cfg)
    n_groups = (cfg.n_cchunks - n_single) // 8
    used_chunks = (n_single - fl.free_count(pool.cfree)) + \
        8 * (n_groups - fl.free_count(pool.gfree))
    used_p = cfg.n_pchunks - fl.free_count(pool.pfree)
    physical = used_chunks * cfg.chunk_bytes + used_p * cfg.page_bytes
    # the reference divides two int32 scalars, which rounds to float32
    return float(np.float32(logical) / np.float32(max(physical, 1)))


def counters_dict(pool: Pool) -> dict:
    return dict(zip(COUNTER_NAMES, contracts.tolist(pool.counters)))


def traffic_vector(counters):
    """Internal-traffic view of a counter vector: ``[..., NUM_COUNTERS]`` ->
    ``[..., len(TRAFFIC_IDX)]`` in ``TRAFFIC_IDX`` order, for numpy arrays
    and tensors alike, with any leading axes."""
    return counters[..., list(TRAFFIC_IDX)]


def counters_snapshot(pool: Pool) -> torch.Tensor:
    """A point-in-time copy of the counter vector. The port updates pools
    in place, so unlike the reference's live array this must copy."""
    return pool.counters.clone()


def counters_delta(before, after):
    """Counter delta between two snapshots (leading axes broadcast)."""
    return after - before


def counters_delta_dict(delta) -> dict:
    """Name-keyed view of a counter delta: ``[..., NUM_COUNTERS]`` (leading
    axes summed) -> ``{counter_name: int}``. Keys come from
    ``COUNTER_NAMES``, never positions. A tensor is read with one counted
    sync."""
    vals = delta.reshape(-1, NUM_COUNTERS).sum(axis=0)
    if isinstance(vals, torch.Tensor):
        vals = contracts.tolist(vals)
    return {k: int(v) for k, v in zip(COUNTER_NAMES, vals)}


def total_traffic(pool: Pool) -> torch.Tensor:
    """Total internal 64B accesses (host accesses and event counters
    excluded), in the counters' dtype, on the pool's device."""
    return traffic_vector(pool.counters).sum(dim=-1, dtype=CTR_DTYPE)
