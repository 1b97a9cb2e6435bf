"""Trace-driven evaluation engine (PyTorch port of ``repro.simx.engine``):
runs a workload trace through the payload-less pool under each compared
scheme and turns its counters into traffic and delivered-time metrics.

Each scheme is a ``Policy`` (core/engine/policy.py) that charges its own
traffic where it occurs; nothing is adjusted afterwards. Traces replay
through the batched front-end (``batch.replay_trace``), the pool's state
on the torch device. Compresso (line-level, no promotion machinery) keeps
its own model over the metadata cache.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common.types import PoolConfig, replace
from repro_torch.common.utils import resolve_device
from repro_torch.core.engine import batch as B
from repro_torch.core.engine import state as S
from repro_torch.core.engine.policy import POLICIES, Policy
from repro_torch.simx import device as DEV
from repro_torch.simx import time as TM
from repro_torch.simx.trace import WorkloadSpec, make_rates_table, make_trace

SCHEMES: Dict[str, Policy] = POLICIES

# the ten internal-traffic categories, from the counter layout
TRAFFIC_KEYS = S.TRAFFIC_NAMES

DEFAULT_WINDOW = B.DEFAULT_WINDOW


def pool_cfg_for(policy: Policy, *, n_pages: int, n_pchunks: int,
                 n_cchunks: int) -> PoolConfig:
    return PoolConfig(
        # the metadata cache must be much smaller than the page population
        # (paper: 24MB against GBs of pages), or every page probe-hits and
        # the clock falls back to random victims
        n_pages=n_pages, n_cchunks=n_cchunks, n_pchunks=n_pchunks,
        mcache_sets=4, mcache_ways=8, demote_watermark=8,
        shadow=policy.shadow, coloc=policy.coloc, compact=policy.compact,
        zero_elision=policy.zero_elision, store_payload=False)


def first_touch_populate(pool, cfg: PoolConfig, policy: Policy, *,
                         n_used: int, seed: int = 0,
                         window: int = DEFAULT_WINDOW, stats=None):
    """Write every used page once (first touch promotes; demotes), then
    zero the counters. Padded to ``cfg.n_pages`` accesses by cycling, as
    the reference does."""
    order = np.random.default_rng(seed).permutation(n_used).astype(np.int32)
    order = order[np.arange(cfg.n_pages) % n_used]
    pool = B.replay_trace(pool, cfg, policy, order,
                          np.ones((cfg.n_pages,), bool),
                          np.zeros((cfg.n_pages,), np.int32), window=window,
                          stats=stats)
    pool.counters.zero_()
    return pool


def run_cell(scheme_name: str, spec: WorkloadSpec, *,
             n_accesses: int = 20000, promoted_pages: int = 128,
             seed: int = 0, first_touch: bool = True,
             device: Optional[DEV.DeviceConfig] = None,
             window: int = DEFAULT_WINDOW, torch_device=None,
             stats=None) -> Tuple[Dict[str, float], Optional[S.Pool],
                                  Optional[PoolConfig]]:
    """``run_workload``'s body: the metrics dict, and the pool and its
    config at the cell's end (None for line-level schemes), so callers can
    check I1-I4. ``stats`` (``batch.new_stats()``) receives the replays'
    window, slow-access and sync counts."""
    policy = SCHEMES[scheme_name]
    n_pages = 4 * promoted_pages
    n_used = min(max(int(promoted_pages * spec.footprint_pages), 32), n_pages)
    rates = make_rates_table(spec, n_pages, seed=seed)
    ospn, is_write, block = make_trace(spec, n_accesses=n_accesses,
                                       n_pages=n_used, seed=seed)
    dev = device or DEV.DeviceConfig()
    if policy.block4k_engine:
        dev = replace(dev, block_scale=4.0)
    tdev = resolve_device(torch_device)

    if policy.line_level:
        return _run_compresso(spec, rates[:n_used], ospn, is_write, dev,
                              tdev), None, None
    cfg = pool_cfg_for(policy, n_pages=n_pages, n_pchunks=promoted_pages,
                       n_cchunks=2 * n_pages * 8)
    pool = S.make_pool(cfg, seed=seed, rates_table=rates, device=tdev)
    if first_touch:
        pool = first_touch_populate(pool, cfg, policy, n_used=n_used,
                                    seed=seed, window=window, stats=stats)
    pool = B.replay_trace(pool, cfg, policy, ospn, is_write, block,
                          window=window, stats=stats)
    c = S.counters_dict(pool)
    out = _finalize(c, dev, ratio=S.compression_ratio(pool, cfg))
    return out, pool, cfg


def run_workload(scheme_name: str, spec: WorkloadSpec, *,
                 n_accesses: int = 20000, promoted_pages: int = 128,
                 seed: int = 0, first_touch: bool = True,
                 device: Optional[DEV.DeviceConfig] = None,
                 window: int = DEFAULT_WINDOW, obs=None,
                 torch_device=None) -> Dict[str, float]:
    """Run one (scheme x workload) cell; returns traffic + time metrics.

    Pool dimensions are fixed (4x the promoted region) across workloads; a
    workload's footprint is the set of pages its trace touches.
    ``window=1`` replays one access at a time. ``device`` is the timing
    model's ``DeviceConfig``; ``torch_device`` is where the pool lives
    (the card unless the caller names another). ``obs`` (a
    ``repro_torch.obs.Recorder``) records the finished cell's metrics, which
    are host values already: no extra sync."""
    out = run_cell(scheme_name, spec, n_accesses=n_accesses,
                   promoted_pages=promoted_pages, seed=seed,
                   first_touch=first_touch, device=device, window=window,
                   torch_device=torch_device)[0]
    if obs is not None:
        obs.record_cell(scheme_name, spec.name, out)
    return out


def _finalize(c: Dict[str, int], dev: DEV.DeviceConfig, ratio: float
              ) -> Dict[str, float]:
    """Assemble the metrics dict from the counters; time from the model
    over the counter vector, float64 on the host."""
    t = {k: float(c[k]) for k in TRAFFIC_KEYS}
    internal = sum(t.values())
    traffic = dict(t, internal_accesses=internal,
                   host_reads=c["host_reads"], host_writes=c["host_writes"],
                   zero_served=c["zero_served"],
                   promotions=c["promotions"],
                   demotions_clean=c["demotions_clean"],
                   demotions_dirty=c["demotions_dirty"],
                   recompress_retry=c.get("recompress_retry", 0),
                   random_fallback=c["random_fallback"],
                   mcache_hits=c["mcache_hits"],
                   mcache_misses=c["mcache_misses"])
    host = c["host_reads"] + c["host_writes"]
    time_s = float(TM.exec_time_vec(TM.counters_from_dict(traffic), dev))
    base_s = TM.uncompressed_time(host, dev)
    return dict(traffic, time_s=time_s, uncompressed_s=base_s,
                normalized_perf=base_s / time_s, compression_ratio=ratio)


def _run_compresso(spec: WorkloadSpec, rates: np.ndarray, ospn: np.ndarray,
                   is_write: np.ndarray, dev: DEV.DeviceConfig,
                   tdev: torch.device) -> Dict[str, float]:
    """Line-level compression (no promotion machinery): metadata access on
    a metadata-cache miss; ~1.05 data accesses per read (lines pack across
    64B), ~2.2 per write (read-modify-write + occasional repack). The
    cache walk is the serial ``mcache.access``, one access at a time as
    the reference's scan; the hit count stays on the device and is read
    once."""
    from repro_torch.core import mcache as MC
    mc = MC.make_mcache(32, 16, tdev)
    h = torch.zeros((), dtype=torch.int32, device=tdev)
    for p in ospn.tolist():
        hit, _ = MC.access(mc, p)
        h += hit
    hits = contracts.item(h)
    n = len(ospn)
    misses = n - hits
    reads = int((~is_write).sum())
    writes = int(is_write.sum())
    t = {k: 0.0 for k in TRAFFIC_KEYS}
    t["metadata_rd"] = float(misses)
    t["metadata_wr"] = float(writes * 0.1)    # size-class changes
    t["data_rd"] = reads * 1.05
    t["data_wr"] = writes * 2.2
    internal = sum(t.values())
    # line-level ratio: a 64B window only captures the strong patterns
    # (zero lines + narrow-range data, rate <= 1 blocks) at ~2:1
    comp_frac = float((rates <= 1).mean())
    ratio = 1.0 / (comp_frac * 0.55 + (1 - comp_frac) * 1.0)
    traffic = dict(t, internal_accesses=internal, host_reads=reads,
                   host_writes=writes, zero_served=0, promotions=0,
                   demotions_clean=0, demotions_dirty=0, recompress_retry=0,
                   random_fallback=0, mcache_hits=hits, mcache_misses=misses)
    time_s = float(TM.exec_time_vec(TM.counters_from_dict(traffic), dev))
    base_s = TM.uncompressed_time(n, dev)
    return dict(traffic, time_s=time_s, uncompressed_s=base_s,
                normalized_perf=base_s / time_s, compression_ratio=ratio)
