"""Migration policy layer: WHAT moves between expanders, and WHY (a copy
of ``repro.fabric.migration``, numpy only; DESIGN.md §13).

The segment scheduler (fabric/replay.py) separates migration *mechanism*
from migration *policy*, mirroring the pool's ``core/engine/policy.Policy``
split: the scheduler owns the pipeline (per-segment stats computed on the
device, one fetch per stage, batched apply + one override scatter per
epoch), and a ``MigrationPolicy`` owns the decision. A policy is a pure host-side
function of a :class:`SegmentView` — the per-segment facts the segment
replay already computed on device (freelist headroom, eligibility and
referenced bits per page, counter deltas, on-device delivered times) — and
returns a :class:`MigrationPlan` (or ``None``): explicit page → expander
moves the scheduler applies in one batched epoch.

Policies:

  * ``SpillPressure``    — the freelist-pressure spill: an expander whose
    compressed-region headroom falls below the low watermark sheds its
    first ``k`` eligible pages (OSPN order — spill relieves capacity, it
    does not rank hotness) to the most-free donor that clears ``2 * low``.
  * ``TrafficRebalance`` — pressure spill PLUS a traffic-imbalance
    trigger: when one expander's share of the segment's host-access delta
    exceeds ``trigger`` times the fair share AND its on-device delivered time
    leads the coldest expander's by ``time_ratio``, hot *compressed* pages
    migrate toward the idle expander. The referenced bits pick WHICH pages
    move: only eligible pages whose metadata is cache-resident — the §4.4
    lazy-reference live set; the activity-region referenced bits cover
    promoted pages, which never migrate — are worth moving, because their
    future promotions and reads follow them to the donor.
  * ``NoMigration``      — the off switch (``--migration off``).

Eligibility is always re-checked against the live state at apply time
(``fabric.ops.migrate_page``), so a plan computed one segment ago can
never move a page that promoted or invalidated while in flight.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.engine.state import C_HOST_RD, C_HOST_WR


@dataclass
class SegmentView:
    """Host-side view of one replayed segment: everything a policy may
    consume, all fetched in the scheduler's single per-segment sync.
    Arrays are numpy; ``N`` expanders, ``P`` OSPA pages, ``C`` counters."""
    free_units: np.ndarray    # int64[N]  compressed headroom (chunk units)
    free_singles: np.ndarray  # int64[N]  free single C-chunks
    free_groups: np.ndarray   # int64[N]  free aligned 8-chunk groups
    eligible: np.ndarray      # bool[N, P] valid & ~promoted & chunk-backed
    referenced: np.ndarray    # bool[N, P] metadata-cache-resident (§4.4)
    counters: np.ndarray      # int64[N, C] cumulative, post-segment
    delta: np.ndarray         # int64[N, C] this segment's replay delta
    times: np.ndarray         # float64[N] on-device (f32) delivered s
    recent: np.ndarray        # bool[P] pages moved by the last epoch
    # pages whose last planned epoch moved NOTHING (the scheduler's
    # livelock guard): candidate selection must skip them so the next
    # plan tries DIFFERENT pages — a successful epoch then clears the
    # set. Merely filtering them out post-hoc would leave the policy
    # re-planning the same barred pages forever, with migration dead.
    blocked: np.ndarray       # bool[P]

    @property
    def n_expanders(self) -> int:
        return self.free_units.shape[0]

    def donor_ok(self) -> np.ndarray:
        """bool[N]: expanders holding the apply-time safe allocation
        margin (7 singles + 1 aligned group — exactly the guard
        ``fabric.ops.apply_migrations`` enforces per move). Planning a
        donor without it yields an epoch whose every move is skipped."""
        return (self.free_singles >= 7) & (self.free_groups >= 1)


@dataclass
class MigrationPlan:
    """Explicit page moves for one epoch. Applied by the scheduler in one
    batch; the override-table update is one scatter of the pages
    that actually moved. ``urgent`` marks a plan whose source is ALREADY
    below the hard watermark: the scheduler applies it at this boundary
    (synchronous emergency relief — deferring it one segment risks
    freelist exhaustion mid-replay) instead of overlapping it."""
    pages: np.ndarray         # int32[k]
    srcs: np.ndarray          # int32[k]
    dsts: np.ndarray          # int32[k]
    urgent: bool = False

    def __len__(self) -> int:
        return len(self.pages)

    def pairs(self) -> List[Tuple[int, int]]:
        """Sorted unique (src, dst) expander routes this plan uses — the
        telemetry-facing shape of a plan (``obs.Recorder.record_plan``
        tags each plan event with it, so a trace can show WHERE pages
        were routed without storing every per-page move)."""
        return sorted({(int(s), int(d))
                       for s, d in zip(self.srcs, self.dsts)})


def _plan(moves: List[Tuple[np.ndarray, int, int]],
          urgent: bool = False) -> Optional[MigrationPlan]:
    moves = [(p, s, d) for p, s, d in moves if len(p)]
    if not moves:
        return None
    pages = np.concatenate([p for p, _, _ in moves]).astype(np.int32)
    srcs = np.concatenate([np.full(len(p), s, np.int32)
                           for p, s, _ in moves])
    dsts = np.concatenate([np.full(len(p), d, np.int32)
                           for p, _, d in moves])
    return MigrationPlan(pages, srcs, dsts, urgent=urgent)


class MigrationPolicy:
    """Protocol: ``plan`` maps a segment view to moves (or ``None``)."""

    name = "base"

    def plan(self, view: SegmentView) -> Optional[MigrationPlan]:
        raise NotImplementedError


@dataclass
class NoMigration(MigrationPolicy):
    name: str = "off"

    def plan(self, view: SegmentView) -> Optional[MigrationPlan]:
        return None


@dataclass
class SpillPressure(MigrationPolicy):
    """Freelist-pressure spill (planned host-side).

    ``low`` is the hard compressed-region watermark in chunk units; ``k``
    pages move per starved expander per epoch; a donor must clear
    ``2 * low``. ``proactive`` widens the trigger to ``proactive * low``
    so the pipelined scheduler can fire a spill one segment EARLY and
    overlap it; an expander already below the hard ``low`` makes the plan
    ``urgent`` (the scheduler applies it synchronously — relief that
    lands a segment late is relief after the freelists ran dry). Donor
    accounting stays conservative within one plan (a planned page may
    occupy a whole 8-chunk group on the donor)."""
    k: int = 16
    low: int = 64
    proactive: float = 1.5
    name: str = "spill"

    def _pressure_moves(self, view: SegmentView, free: np.ndarray
                        ) -> Tuple[List[Tuple[np.ndarray, int, int]], bool]:
        moves: List[Tuple[np.ndarray, int, int]] = []
        urgent = False
        donor_ok = view.donor_ok()
        for e in np.nonzero(free < self.proactive * self.low)[0]:
            donor = int(np.argmax(free))
            if donor == int(e) or free[donor] < 2 * self.low or \
                    not donor_ok[donor]:
                continue
            cand = view.eligible[e] & ~view.recent & ~view.blocked
            pages = np.nonzero(cand)[0][: self.k].astype(np.int32)
            if not len(pages):
                continue
            urgent = urgent or free[e] < self.low
            moves.append((pages, int(e), donor))
            free[donor] -= 8 * len(pages)
        return moves, urgent

    def plan(self, view: SegmentView) -> Optional[MigrationPlan]:
        moves, urgent = self._pressure_moves(view, view.free_units.copy())
        return _plan(moves, urgent)


@dataclass
class TrafficRebalance(SpillPressure):
    """Pressure spill + traffic-imbalance rebalancing.

    The trigger consumes the per-segment counter DELTAS (host-access share
    this segment) and the per-expander on-device delivered times — both
    computed with the segment replay, no extra sync. When the hottest
    expander's segment host share exceeds ``trigger / N`` and its
    delivered time leads the coldest headroom-bearing expander by
    ``time_ratio``, up to ``k`` referenced (metadata-cache-resident)
    eligible pages move hot → cold."""
    trigger: float = 1.5      # x fair share of the segment's host delta
    time_ratio: float = 1.05  # hot delivered time must lead cold by this
    min_delta: int = 8        # ignore near-empty segments
    name: str = "rebalance"

    def plan(self, view: SegmentView) -> Optional[MigrationPlan]:
        free = view.free_units.copy()
        moves, urgent = self._pressure_moves(view, free)
        host_d = (view.delta[:, C_HOST_RD] +
                  view.delta[:, C_HOST_WR]).astype(np.int64)
        total = int(host_d.sum())
        n = view.n_expanders
        if n > 1 and total >= self.min_delta:
            hot = int(np.argmax(host_d))
            # coldest expander by delivered time among those with donor
            # headroom (never rebalance INTO a pressure-starved expander,
            # nor one the apply-time allocation guard would refuse)
            ok = (free >= 2 * self.low) & view.donor_ok()
            ok[hot] = False
            if ok.any() and host_d[hot] * n > self.trigger * total:
                times = np.where(ok, view.times, np.inf)
                cold = int(np.argmin(times))
                if view.times[hot] > self.time_ratio * view.times[cold]:
                    planned = np.concatenate(
                        [p for p, _, _ in moves]) if moves else \
                        np.empty(0, np.int32)
                    cand = (view.eligible[hot] & ~view.recent &
                            ~view.blocked)
                    cand[planned] = False
                    # referenced bits rank the candidates: recently
                    # referenced compressed pages (metadata-cache
                    # resident) carry the most future traffic, so they
                    # move first; the rest of the budget falls back to
                    # unreferenced eligible pages in page order
                    refd = cand & view.referenced[hot]
                    order = np.concatenate([np.nonzero(refd)[0],
                                            np.nonzero(cand & ~refd)[0]])
                    pages = order[: self.k].astype(np.int32)
                    if len(pages):
                        moves.append((pages, hot, cold))
        return _plan(moves, urgent)


def make_migration_policy(mode: str, *, k: int = 16, low: int = 64,
                          proactive: float = 1.5, trigger: float = 1.5,
                          time_ratio: float = 1.05) -> MigrationPolicy:
    """CLI/bench factory: spill | rebalance | off."""
    if mode == "spill":
        return SpillPressure(k=k, low=low, proactive=proactive)
    if mode == "rebalance":
        return TrafficRebalance(k=k, low=low, proactive=proactive,
                                trigger=trigger, time_ratio=time_ratio)
    if mode == "off":
        return NoMigration()
    raise ValueError(f"unknown migration mode {mode!r}")
