"""Policy layer: per-scheme residency + accounting decisions (PyTorch port
of ``repro.core.engine.policy``).

A ``Policy`` holds what differs between the compared designs (paper
§5/§6): the victim selection and hooks that charge a scheme's extra traffic
at the site where it occurs. Hooks add to the counters tensor in place;
``n`` may be an int or a 0-d tensor.

Schemes: ibex (and its ablation rungs ibex_base/_s/_sc/_scm), tmcc, dylect,
mxt, dmc, compresso. ``SecondChanceLanes`` is the same clock over serving
lanes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

import numpy as np

from repro_torch.core import activity as act
from repro_torch.core.engine.state import (C_ACT_WR, C_DEMO_WR, C_META_RD,
                                           C_META_WR, bump)


@dataclass(frozen=True)
class Policy:
    """Base policy: pure IBEX behavior."""
    name: str = "ibex"
    # mechanism toggles the policy requires of its PoolConfig (ablation S/C/M)
    coloc: bool = True
    shadow: bool = True
    compact: bool = True
    zero_elision: bool = True
    # device-model knob: 4KB-block schemes pay 4x compression-engine latency
    block4k_engine: bool = False
    # line-level schemes bypass the pool entirely (no promotion machinery)
    line_level: bool = False

    def on_host_access(self, counters, is_write, n=1) -> None:
        """Per host access (e.g. recency-list maintenance)."""

    def on_mcache_miss(self, counters, n=1) -> None:
        """Extra traffic per metadata-cache miss (e.g. a second probe)."""

    def on_compress_store(self, counters) -> None:
        """Per compressed-page store (dirty demotion or recompression)."""

    def on_demotion(self, counters, clean) -> None:
        """Per demotion, after the mechanism's own traffic is charged."""

    def charge_activity(self, counters, idx: int, n=1) -> None:
        """Activity-region traffic (clock scans, lazy reference updates)."""
        bump(counters, idx, n)

    def charge_migration(self, counters, idx: int, n=1) -> None:
        """Promotion/demotion data movement (promo_rd/wr, demo_rd/wr)."""
        bump(counters, idx, n)

    def select_victim(self, activity, hand: int, cache, rng,
                      force: bool = False) -> act.ScanResult:
        """The §4.4 second-chance clock over the activity region."""
        return act.clock_scan(activity, hand, cache, rng, force=force)


@dataclass(frozen=True)
class IbexPolicy(Policy):
    """Full IBEX. Ablation rungs are mechanism toggles on the same policy."""


@dataclass(frozen=True)
class TmccPolicy(Policy):
    """TMCC: 4KB blocks, zsmalloc-style chunks, LRU-list recency: one list
    update per host access, two bookkeeping writes per compressed store, one
    reclaim access per demotion."""
    name: str = "tmcc"
    coloc: bool = False
    shadow: bool = False
    block4k_engine: bool = True

    def on_host_access(self, counters, is_write, n=1):
        bump(counters, C_ACT_WR, n)

    def on_compress_store(self, counters):
        bump(counters, C_META_WR, 2)

    def on_demotion(self, counters, clean):
        bump(counters, C_DEMO_WR, 1)


@dataclass(frozen=True)
class DylectPolicy(TmccPolicy):
    """DyLeCT: TMCC plus dual metadata tables (one extra read per miss)."""
    name: str = "dylect"

    def on_mcache_miss(self, counters, n=1):
        bump(counters, C_META_RD, n)


@dataclass(frozen=True)
class MxtPolicy(Policy):
    """MXT-style promotion cache with on-chip tags: no activity traffic,
    page-granular promotion, no zero elision."""
    name: str = "mxt"
    coloc: bool = False
    zero_elision: bool = False
    block4k_engine: bool = True

    def charge_activity(self, counters, idx, n=1):
        pass


@dataclass(frozen=True)
class DmcPolicy(Policy):
    """DMC: 32KB migration granularity (promotion/demotion traffic x8)."""
    name: str = "dmc"
    coloc: bool = False
    shadow: bool = False
    block4k_engine: bool = True
    migrate_mult: int = 8

    def charge_migration(self, counters, idx, n=1):
        bump(counters, idx, n * self.migrate_mult)


@dataclass(frozen=True)
class CompressoPolicy(Policy):
    """Compresso: line-level compression, no promotion machinery."""
    name: str = "compresso"
    line_level: bool = True


DEFAULT_POLICY = IbexPolicy()

POLICIES: Dict[str, Policy] = {
    "ibex": IbexPolicy(),
    "ibex_base": dataclasses.replace(IbexPolicy(), name="ibex_base",
                                     coloc=False, shadow=False, compact=False,
                                     block4k_engine=True),
    "ibex_s": dataclasses.replace(IbexPolicy(), name="ibex_s", coloc=False,
                                  shadow=True, compact=False,
                                  block4k_engine=True),
    "ibex_sc": dataclasses.replace(IbexPolicy(), name="ibex_sc", coloc=True,
                                   shadow=True, compact=False),
    "ibex_scm": dataclasses.replace(IbexPolicy(), name="ibex_scm", coloc=True,
                                    shadow=True, compact=True),
    "tmcc": TmccPolicy(),
    "dylect": DylectPolicy(),
    "mxt": MxtPolicy(),
    "dmc": DmcPolicy(),
    "compresso": CompressoPolicy(),
}


class SecondChanceLanes:
    """The §4.4 second-chance victim selection at *lane* (request)
    granularity, used by the serving engine: reference bit = "generated a
    token since last sweep". Numpy only, line for line the reference's
    ``SecondChanceLanes``."""

    def __init__(self, n_lanes: int):
        self.n = n_lanes
        self.hand = 0

    def select_mask(self, occupied, referenced, groups=None, group_load=None):
        """One-pass sweep. occupied/referenced: bool[n] arrays. Returns
        (victim lane or None, new referenced bits): ref bits of occupied
        lanes between the hand and the victim are cleared; if every
        occupied lane is referenced, all are cleared and the first occupied
        lane after the hand is taken. ``groups``/``group_load`` prefer the
        least-loaded expander among the candidates."""
        occ = np.asarray(occupied, bool)
        ref = np.array(referenced, bool, copy=True)
        order = (self.hand + np.arange(self.n)) % self.n
        cand = occ[order] & ~ref[order]
        if cand.any():
            if groups is None:
                k = int(np.argmax(cand))
            else:
                pos = np.nonzero(cand)[0]
                loads = np.asarray(group_load)[
                    np.asarray(groups)[order[pos]]]
                k = int(pos[int(np.argmin(loads))])
            swept = order[:k]
            ref[swept[occ[swept]]] = False
        elif occ.any():
            k = int(np.argmax(occ[order]))
            ref[occ] = False
        else:
            return None, ref
        victim = int(order[k])
        self.hand = (victim + 1) % self.n
        return victim, ref
