"""Fabric segment scheduler: segmented replay of N expanders with
overlapped migration (PyTorch port of ``repro.fabric.replay``; DESIGN.md
§11/§13).

A merged (ospn, is_write, block) trace is partitioned by the placement's
current routing (base rule + migration overrides), padded per expander to
a common window-aligned length, and replayed through
``engine.batch._replay_windows_masked`` on each expander's slice of the
stacked pool state, one expander after another (the reference vmaps them).
The window bodies are the single-pool ones, so per-expander counters are
bit-identical to replaying that expander's partition through
``batch.replay_trace`` on a single pool (the fabric's parity contract).

The replay advances in *segments* (``spill_interval`` accesses per
expander, window-aligned). Each segment is one pipeline stage:

  stage A  the segment's replay, then on the device: the per-expander
           delivered times (float32, ``simx.time.exec_time_vec`` over the
           stacked counters and lanes) and, when a migration policy will
           read them, freelist headroom, page eligibility and referenced
           bits (``fabric.ops.segment_stats``), fetched with a counter
           snapshot in ONE transfer;
  stage B  the previous segment's migration plan (a pluggable
           ``fabric.migration.MigrationPolicy``) applied as one batch
           (``fabric.ops.apply_migrations``) and its override-table
           updates committed as one scatter (``Placement.apply_epoch``).

``pipeline_depth=2`` (the default): the plan computed off segment N's
stats applies after segment N+1's replay. The port's host drives the card
eagerly, so nothing runs concurrently; the schedule, the pending mask and
the pricing are the reference's, and so is every bit of end state.
Accesses landing on a page whose plan is in flight are masked to no-ops
by the pending mask and replayed after the epoch commits, routed to the
page's final home. ``pipeline_depth=1`` plans and applies at the same
boundary and is bit-identical to the synchronous driver
(``sync_migration=True``).

Fetch budget (the reference's ``@sync_contract``s): ONE fetch per
replayed segment (``_fetch_view``) plus ONE per committed epoch
(``_commit_epoch``). The port's pool mechanisms add their own counted
syncs inside the replay and the apply (core/engine/ops.py); those are
reported beside the budget (``replay_stats``, ``apply_syncs``), not in
it.

Delivered time: per-segment replay deltas and per-epoch migration deltas
are recorded from the same fetches; ``Fabric.pipeline_times`` prices them
through ``simx.time.pipeline_delivered_time``. ``obs`` (a
``repro_torch.obs.Recorder``) takes its samples from the same two fetches:
a recorder attached makes every segment compute the migration stats (the
freelist headroom it records) even with migration off, inside the one
fetch, as the reference does.

The sharded driver (``shard_devices=D``; DESIGN.md §17, ``fabric/shard.py``)
runs on D ranks (``common.sharding``: one process a device, joined by
``init_expander_ranks`` or ``spawn_ranks``), each holding the replicated
host state (placement, trace partition, plan, counter snapshots, the
recorder on rank 0) and its own block of ``N / D`` expanders. It schedules
migration synchronously (the ``_replay_sync`` semantics): each segment
boundary replays locally, plans on the device from stats gathered in one
collective, applies the plan collectively and commits with ONE fetch
(``_commit_boundary``); with migration off nothing is gathered until one
deferred fetch per ``replay()`` (``_drain_deferred``). Every rank issues
the same collectives in the same order: the metrics that read expanders
(``counters``, ``counters_by_expander``, ``delivered_time``,
``park_capacity``, ``state_identical``, ``gather_leaves``) are collective
calls, made on every rank.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common import sharding as SH
from repro_torch.common.contracts import sync_contract
from repro_torch.common.types import PoolConfig
from repro_torch.common.utils import next_pow2, resolve_device
from repro_torch.core.engine import batch as B
from repro_torch.core.engine import ops as E
from repro_torch.core.engine import state as S
from repro_torch.core.engine.policy import Policy
from repro_torch.fabric import migration as MG
from repro_torch.fabric import ops as fops
from repro_torch.fabric import shard as FS
from repro_torch.fabric.placement import Placement
from repro_torch.simx import time as TM

# one expander's slice of a segment: body(e, ospns, writes, args, valid,
# pending mask or None)
Body = Callable[..., None]


def partition_trace(placement: Placement, ospns, writes, blocks,
                    window: int) -> Tuple[np.ndarray, ...]:
    """Route a trace and pack it per expander: [N, n_win, W] arrays plus a
    validity mask. Each expander's partition keeps the merged trace's
    relative order and sits as a prefix before the padding, so the masked
    replay walks full windows, then one partial window, then no-ops — the
    exact shapes ``batch.replay_trace`` produces on a single pool."""
    n = placement.n_expanders
    ospns = np.asarray(ospns, np.int32)
    writes = np.asarray(writes, bool)
    blocks = np.asarray(blocks, np.int32)
    eids = placement.route(ospns)
    counts = np.bincount(eids, minlength=n)
    n_win = next_pow2(-(-max(int(counts.max()), 1) // window))
    L = n_win * window
    o = np.zeros((n, L), np.int32)
    w = np.zeros((n, L), bool)
    b = np.zeros((n, L), np.int32)
    v = np.zeros((n, L), bool)
    for e in range(n):
        sel = eids == e
        k = int(counts[e])
        o[e, :k] = ospns[sel]
        w[e, :k] = writes[sel]
        b[e, :k] = blocks[sel]
        v[e, :k] = True
    shp = (n, n_win, window)
    return (o.reshape(shp), w.reshape(shp), b.reshape(shp), v.reshape(shp),
            eids)


class Fabric:
    """N expanders as one stacked pool state + placement + segment
    scheduler with pluggable migration.

    ``migration`` selects the ``fabric.migration.MigrationPolicy``:
    ``"spill"`` (freelist pressure, the default when ``spill=True``),
    ``"rebalance"`` (pressure + traffic-imbalance trigger fed by segment
    counter deltas and delivered times), ``"off"``, or a policy instance.
    ``spill_low`` is the compressed-region watermark in *chunks* (singles
    + 8x groups); ``spill_k`` pages move per (src, dst) pair per epoch;
    ``spill_interval`` is the segment length between decisions.
    ``pipeline_depth``/``sync_migration`` pick the driver (module
    docstring). ``devices`` is the fleet's timing model: None (default
    ``DeviceConfig`` everywhere), one ``DeviceConfig``, or a sequence
    cycled to N. ``on_epoch(fabric, plan, moved_pages)`` runs after every
    committed epoch. ``obs`` is an optional ``repro_torch.obs.Recorder``
    fed from the per-segment and per-epoch fetches (on the sharded driver,
    rank 0's; the other ranks record nothing). ``device`` is where the
    stack lives: CUDA unless the caller names one.

    ``shard_devices=D`` runs the sharded driver on the D ranks that
    ``common.sharding.init_expander_ranks`` joined (none raises): this
    rank's block of the stack lives on the rank's device, and N must divide
    by D. Its migration policy needs an on-device planner (``spill`` or
    ``rebalance``)."""

    def __init__(self, cfg: PoolConfig, policy: Policy, placement: Placement,
                 *, seed: int = 0, rates_table=None,
                 window: Optional[int] = None, spill: bool = True,
                 spill_interval: int = 2048, spill_k: int = 16,
                 spill_low: Optional[int] = None, devices=None,
                 migration: Union[str, MG.MigrationPolicy, None] = None,
                 pipeline_depth: int = 2, sync_migration: bool = False,
                 shard_devices: Optional[int] = None,
                 on_epoch: Optional[Callable] = None, obs=None,
                 device=None):
        if placement.n_pages != cfg.n_pages:
            raise ValueError("placement/page-space mismatch")
        if pipeline_depth not in (1, 2):
            raise ValueError("pipeline_depth must be 1 or 2")
        self.shard_devices = shard_devices
        self.group = None
        ids = range(placement.n_expanders)
        if shard_devices is not None:
            if placement.n_expanders % shard_devices:
                raise ValueError(f"{placement.n_expanders} expanders not "
                                 f"divisible by shard_devices="
                                 f"{shard_devices}")
            self.group = SH.current_group()
            if self.group.world != shard_devices:
                raise ValueError(f"shard_devices={shard_devices} on a group "
                                 f"of {self.group.world} ranks")
            if device is not None and \
                    torch.device(device).type != self.group.device.type:
                raise ValueError(f"device {device} is not the rank's "
                                 f"{self.group.device}")
            device = self.group.device
            ids = self.group.owned(placement.n_expanders)
            if obs is not None and self.group.rank:
                obs = None                # only rank 0 records
        self._owned = ids
        self.device = resolve_device(device)
        self.cfg = cfg
        self.policy = policy
        self.placement = placement
        self.n_expanders = placement.n_expanders
        self.window = B.DEFAULT_WINDOW if window is None else window
        self.spill_interval = spill_interval
        self.spill_k = spill_k
        self.spill_low = (max(16, cfg.n_cchunks // 16)
                          if spill_low is None else spill_low)
        if migration is None:
            migration = "spill" if spill else "off"
        if isinstance(migration, str):
            migration = MG.make_migration_policy(migration, k=spill_k,
                                                 low=self.spill_low)
        self.migration_policy = migration
        self.migration_enabled = (self.n_expanders > 1 and
                                  not isinstance(migration, MG.NoMigration))
        if shard_devices is not None and self.migration_enabled:
            FS.plan_params(migration)   # fail fast: no on-device planner
        self.pipeline_depth = pipeline_depth
        self.sync_migration = sync_migration
        self.on_epoch = on_epoch
        self.devices = TM.resolve_fleet(devices, self.n_expanders)
        self.lanes = TM.stack_devices(
            self.devices[ids.start:ids.stop], device=self.device)
        self.pools = S.make_pool_stack(cfg, self.n_expanders, seed=seed,
                                       rates_table=rates_table,
                                       device=self.device, ids=ids)
        n = self.n_expanders
        self.spill_events = 0
        self.spill_pages_out = np.zeros((n,), np.int64)
        self.spill_pages_in = np.zeros((n,), np.int64)
        # per-segment replay counter deltas (int64 [N, NUM_COUNTERS]) and
        # per-epoch migration deltas tagged (segment overlapped, delta,
        # genuinely overlapped?); the float32 times of every segment
        self.segment_deltas: List[np.ndarray] = []
        self.migration_deltas: List[Tuple[int, np.ndarray, bool]] = []
        self.segment_times: List[np.ndarray] = []
        self.segments_replayed = 0
        self.segment_syncs = 0
        self.epochs_applied = 0
        self.epoch_syncs = 0
        # the mechanisms' own syncs, beside the fetch budget
        self.replay_stats = B.new_stats()
        self.apply_syncs = 0
        # the sharded driver's fetches: one a boundary (migration on), one
        # deferred drain a replay() (migration off)
        self.boundaries = 0
        self.boundary_syncs = 0
        self.drain_syncs = 0
        self._deferred: List[Dict[str, torch.Tensor]] = []
        self._last_counters = np.zeros((n, S.NUM_COUNTERS), np.int64)
        self._last_free: Optional[np.ndarray] = None
        self._pending_plan: Optional[MG.MigrationPlan] = None
        # livelock guard: pages whose last planned epoch moved NOTHING are
        # barred from re-planning until some epoch makes progress
        self._blocked = np.zeros((cfg.n_pages,), bool)
        self._modeled_times: Optional[torch.Tensor] = None
        self.obs = obs
        if obs is not None:
            obs.attach_fabric(self)

    def pool(self, e: int) -> S.Pool:
        """Expander ``e``'s pool: views into the stack (on the sharded
        driver, only this rank's expanders have one here)."""
        if e not in self._owned:
            raise IndexError(f"expander {e} lives on another rank")
        return S.pool_slice(self.pools, e - self._owned.start)

    # -- pipeline stages -----------------------------------------------------

    def _dispatch_segment(self, body: Body, o, w, a, v, sl,
                          pending_pages: Optional[np.ndarray]):
        """Stage A: run ``body`` over one segment on every expander, then
        compute the delivered times, the migration stats (when a policy or
        a recorder reads them) and a counter snapshot on the device, for
        ``_fetch_view``."""
        pend = None
        if pending_pages is not None and len(pending_pages):
            pend = np.zeros((self.cfg.n_pages,), bool)
            pend[pending_pages] = True
        for e in range(self.n_expanders):
            body(e, o[e, sl], w[e, sl], a[e, sl], v[e, sl], pend)
        times = TM.exec_time_vec(self.pools.counters, self.lanes)
        stats = fops.segment_stats(self.pools, self.cfg) \
            if self.migration_enabled or self.obs is not None else None
        self._modeled_times = times
        self.segments_replayed += 1
        return times, stats, S.counters_snapshot(self.pools)

    def _replay_body(self, e: int, o, w, blocks, v, pend) -> None:
        """``replay``'s body for one expander's segment: the masked window
        replay of its (ospn, is_write, block) accesses."""
        B._replay_windows_masked(self.pool(e), self.cfg, self.policy, o, w,
                                 blocks, v, pend, self.replay_stats)

    def _write_body(self, pages: torch.Tensor, e: int, o, w, rows, v,
                    pend) -> None:
        """``write_pages``' body for one expander's segment: each valid
        item, in order, writes ``pages[row]`` as page ``ospn`` through
        ``host_write_page``."""
        v = np.asarray(v, bool).reshape(-1)
        if pend is not None:
            v = v & ~pend[np.asarray(o).reshape(-1)]
        pool = self.pool(e)
        for ospn, row in zip(np.asarray(o).reshape(-1)[v].tolist(),
                             np.asarray(rows).reshape(-1)[v].tolist()):
            E.host_write_page(pool, self.cfg, self.policy, ospn, pages[row])

    @sync_contract(syncs_per="segment", fetches=1)
    def _fetch_view(self, times, stats, counters,
                    recent: np.ndarray) -> Optional[MG.SegmentView]:
        """The ONE fetch per segment: delivered times, migration stats and
        the counter snapshot together; the replay delta falls out against
        the previous snapshot. With migration off and no recorder no stats
        were computed and no view is built."""
        tree = {"t": times, "c": counters}
        if stats is not None:
            tree.update(stats._asdict())
        got = contracts.fetch_packed(tree)
        self.segment_syncs += 1
        t32 = got["t"].numpy()
        self.segment_times.append(t32)
        ctrs = got["c"].numpy().astype(np.int64)
        delta = ctrs - self._last_counters
        self._last_counters = ctrs
        self.segment_deltas.append(delta)
        if stats is not None:
            self._last_free = got["free_units"].numpy().astype(np.int64)
        if self.obs is not None:
            # telemetry drain: host values of this segment's one fetch
            self.obs.record_segment(self.segments_replayed - 1, delta,
                                    t32.astype(np.float64), self._last_free)
        if stats is None:
            return None
        return MG.SegmentView(
            free_units=self._last_free,
            free_singles=got["free_singles"].numpy().astype(np.int64),
            free_groups=got["free_groups"].numpy().astype(np.int64),
            eligible=got["eligible"].numpy(),
            referenced=got["referenced"].numpy(),
            counters=ctrs, delta=delta, times=t32.astype(np.float64),
            recent=recent, blocked=self._blocked.copy())

    def _plan(self, view: Optional[MG.SegmentView]
              ) -> Optional[MG.MigrationPlan]:
        """Ask the migration policy for an epoch, dropping pages the
        livelock guard barred (their last planned epoch moved nothing)."""
        if view is None:
            return None
        plan = self._plan_filtered(view)
        if plan is not None and self.obs is not None:
            self.obs.record_plan(self.segments_replayed - 1, plan,
                                 self.migration_policy.name)
        return plan

    def _plan_filtered(self, view: MG.SegmentView
                       ) -> Optional[MG.MigrationPlan]:
        plan = self.migration_policy.plan(view)
        if plan is None or not self._blocked.any():
            return plan
        keep = ~self._blocked[plan.pages]
        if keep.all():
            return plan
        if not keep.any():
            return None
        return MG.MigrationPlan(plan.pages[keep], plan.srcs[keep],
                                plan.dsts[keep], urgent=plan.urgent)

    def _dispatch_apply(self, plan: MG.MigrationPlan):
        """Stage B: apply one epoch's moves on the stack."""
        pages = np.asarray(plan.pages, np.int32)
        srcs = np.asarray(plan.srcs, np.int32)
        dsts = np.asarray(plan.dsts, np.int32)
        s0 = contracts.SYNCS.count
        moved = fops.apply_migrations(self.pools, self.cfg, self.policy,
                                      pages, srcs, dsts)
        self.apply_syncs += contracts.SYNCS.count - s0
        return plan, srcs, dsts, moved

    @sync_contract(syncs_per="epoch", fetches=1)
    def _commit_epoch(self, plan: MG.MigrationPlan, srcs, dsts, moved,
                      overlapping_seg: int,
                      view: Optional[MG.SegmentView] = None,
                      overlapped: bool = False,
                      kind: str = "sync") -> np.ndarray:
        """The ONE fetch per epoch: the post-apply counters (the epoch's
        migration delta) with, when the pipelined driver is about to plan
        at this boundary, the post-apply migration facts that refresh its
        ``view`` (else only the freelist tops); then the override-table
        updates as one scatter."""
        if view is not None:
            extra = fops.segment_stats(self.pools, self.cfg)._asdict()
        else:
            extra = {"free_singles": self.pools.cfree.top,
                     "free_groups": self.pools.gfree.top}
        got = contracts.fetch_packed({"c": self.pools.counters, **extra})
        free_units = (got["free_singles"].numpy().astype(np.int64) +
                      8 * got["free_groups"].numpy().astype(np.int64))
        self.epoch_syncs += 1
        ctrs = got["c"].numpy().astype(np.int64)
        delta = ctrs - self._last_counters
        self.migration_deltas.append((overlapping_seg, delta, overlapped))
        self._last_counters = ctrs
        self._last_free = free_units
        moved = np.asarray(moved)
        sel = moved >= 0
        pages_moved = moved[sel].astype(np.int64)
        self.placement.apply_epoch(pages_moved, dsts[sel])
        self.epochs_applied += 1
        if len(pages_moved):
            np.add.at(self.spill_pages_out, srcs[sel], 1)
            np.add.at(self.spill_pages_in, dsts[sel], 1)
            pairs = {(int(s), int(d)) for s, d in zip(srcs[sel], dsts[sel])}
            self.spill_events += len(pairs)
            self._modeled_times = None    # migration traffic not yet priced
            self._blocked[:] = False      # progress: conditions changed
        else:
            # nothing moved: bar the plan's pages from re-planning until
            # some epoch succeeds, or an unappliable plan recurs forever
            self._blocked[plan.pages] = True
        if self.obs is not None:
            # telemetry drain: the same single per-epoch fetch
            self.obs.record_epoch(overlapping_seg, delta, kind=kind,
                                  overlapped=overlapped, planned=len(plan),
                                  moved=len(pages_moved), urgent=plan.urgent,
                                  free_units=free_units)
        if view is not None:
            view.free_units = self._last_free
            view.free_singles = got["free_singles"].numpy().astype(np.int64)
            view.free_groups = got["free_groups"].numpy().astype(np.int64)
            view.eligible = got["eligible"].numpy()
            view.referenced = got["referenced"].numpy()
            view.recent[pages_moved] = True
            view.blocked = self._blocked.copy()
        if self.on_epoch is not None:
            self.on_epoch(self, plan, pages_moved)
        return pages_moved

    # -- drivers -------------------------------------------------------------

    def replay(self, ospns, writes, blocks) -> "Fabric":
        """Replay a merged trace through all expanders.

        The trace is partitioned ONCE and replayed in window-aligned
        segments of ``spill_interval`` accesses per expander, so each
        expander's window boundaries are exactly those of
        ``batch.replay_trace`` over its partition. When a migration epoch
        commits, the unconsumed tails (plus any accesses deferred by the
        pending mask) re-merge in original trace order and re-partition,
        so accesses follow migrated pages to their new expander."""
        return self._run((np.asarray(ospns, np.int32),
                          np.asarray(writes, bool),
                          np.asarray(blocks, np.int32)), self._replay_body)

    def write_pages(self, ospns, pages: torch.Tensor) -> "Fabric":
        """Write whole pages (``pages[i]`` is OSPN ``ospns[i]``'s bf16
        values, ``[n, vals_per_page]`` on the fabric's device) through
        ``host_write_page`` on each page's expander: the port's way to load
        a payload-carrying fabric (the reference's fabric runs payload-less
        and has none). The writes go through the same segments, schedule,
        migration and fetch budget as ``replay``; a segment holds
        ``spill_interval`` writes per expander."""
        ospns = np.asarray(ospns, np.int32)
        return self._run((ospns, np.ones(ospns.shape, bool),
                          np.arange(len(ospns), dtype=np.int32)),
                         functools.partial(self._write_body, pages))

    def _run(self, cols, body: Body) -> "Fabric":
        """Drive the merged items ``cols`` = (ospn, is_write, arg) through
        the segments: ``body(e, ospns, writes, args, valid, pending)`` runs
        one expander's slice of a segment, ``arg`` being whatever the body
        reads per item (``replay``: the block; ``write_pages``: the row of
        the payload)."""
        rem = cols
        if self.shard_devices is not None:
            driver = self._replay_sharded
        elif self.sync_migration:
            driver = self._replay_sync
        else:
            driver = self._replay_pipelined
        while rem is not None and len(rem[0]):
            rem = driver(rem, body)
        if self._deferred:
            # sharded, migration off: nothing forced a fetch mid-run; the
            # per-segment bookkeeping drains in ONE deferred fetch now
            self._drain_deferred()
        if self._pending_plan is not None:
            # drain: the plan computed off the final segment's stats has
            # nothing left to overlap; apply and commit it now
            applied = self._dispatch_apply(self._pending_plan)
            self._pending_plan = None
            self._commit_epoch(*applied, self.segments_replayed,
                               kind="drain")
        return self

    def _segments(self, n_win: int) -> int:
        if not self.migration_enabled:
            return n_win
        seg = next_pow2(max(self.spill_interval // self.window, 1))
        return min(seg, n_win)

    def _rebuild(self, cur, pos_by_exp, hi: int, deferred: np.ndarray):
        """Re-merge the unconsumed per-expander tails (plus deferred
        accesses) in original merged-trace order for re-partitioning."""
        done = hi * self.window
        tails = [p[done:] for p in pos_by_exp]
        pos = np.sort(np.concatenate([deferred.astype(np.int64)] +
                                     [t.astype(np.int64) for t in tails]))
        if not len(pos):
            return None
        return tuple(a[pos] for a in cur)

    def _replay_pipelined(self, cur, body: Body):
        """One partition round of the double-buffered scheduler. Returns
        the re-merged remainder when an epoch commit re-routes pages (or
        deferred accesses must replay), ``None`` when the round consumed
        everything."""
        o, w, b, v, eids = partition_trace(self.placement, *cur, self.window)
        n = self.n_expanders
        n_win = o.shape[1]
        seg = self._segments(n_win)
        pos_by_exp = [np.nonzero(eids == e)[0] for e in range(n)]
        none = np.empty((0,), np.int64)
        for lo in range(0, n_win, seg):
            hi = min(lo + seg, n_win)
            in_flight, self._pending_plan = self._pending_plan, None
            times, stats, ctrs = self._dispatch_segment(
                body, o, w, b, v, slice(lo, hi),
                in_flight.pages if in_flight is not None else None)
            view = self._fetch_view(times, stats, ctrs,
                                    np.zeros((self.cfg.n_pages,), bool))
            moved_pages, deferred = none, none
            if in_flight is not None:
                # the previous segment's plan applies behind this one
                moved_pages = self._commit_epoch(
                    *self._dispatch_apply(in_flight),
                    self.segments_replayed - 1, view, overlapped=True,
                    kind="overlapped")
                # accesses this segment deferred by the pending mask,
                # replayed after the commit, routed to the final home
                defer = []
                for e in range(n):
                    seg_pos = pos_by_exp[e][lo * self.window:
                                            hi * self.window]
                    dsel = np.isin(cur[0][seg_pos], in_flight.pages)
                    defer.append(seg_pos[dsel])
                deferred = np.concatenate(defer) if defer else none
            if self.migration_enabled:
                plan = self._plan(view)
                if plan is not None and (self.pipeline_depth == 1 or
                                         plan.urgent):
                    # depth 1, or an URGENT plan (source already below the
                    # hard watermark): apply at this boundary
                    m1 = self._commit_epoch(
                        *self._dispatch_apply(plan),
                        self.segments_replayed - 1,
                        kind="urgent" if plan.urgent else "sync")
                    moved_pages = np.concatenate([moved_pages, m1])
                elif plan is not None:
                    self._pending_plan = plan
            if len(moved_pages) or len(deferred):
                rem = self._rebuild(cur, pos_by_exp, hi, deferred)
                if rem is not None:
                    return rem
        return None

    def _replay_sync(self, cur, body: Body):
        """The synchronous reference driver: plan and apply at every
        segment boundary, no pending mask, no deferral (the parity anchor
        the depth-1 pipeline is pinned against)."""
        o, w, b, v, eids = partition_trace(self.placement, *cur, self.window)
        n = self.n_expanders
        n_win = o.shape[1]
        seg = self._segments(n_win)
        pos_by_exp = [np.nonzero(eids == e)[0] for e in range(n)]
        for lo in range(0, n_win, seg):
            hi = min(lo + seg, n_win)
            times, stats, ctrs = self._dispatch_segment(
                body, o, w, b, v, slice(lo, hi), None)
            view = self._fetch_view(times, stats, ctrs,
                                    np.zeros((self.cfg.n_pages,), bool))
            if not self.migration_enabled:
                continue
            plan = self._plan(view)
            if plan is None:
                continue
            moved = self._commit_epoch(*self._dispatch_apply(plan),
                                       self.segments_replayed - 1)
            if len(moved):
                rem = self._rebuild(cur, pos_by_exp, hi,
                                    np.empty((0,), np.int64))
                if rem is not None:
                    return rem
        return None

    def _replay_sharded(self, cur, body: Body):
        """The sharded driver (DESIGN.md §17): at each segment boundary
        ``shard.boundary_step`` replays this rank's expanders, plans on the
        device from the gathered stats and applies the plan collectively,
        and ``_commit_boundary`` commits it with ONE fetch: the
        ``_replay_sync`` semantics (bit-identical for the integer ``spill``
        planner) at one fetch a boundary instead of one a segment plus one
        an epoch. With migration off nothing is gathered or fetched mid-run:
        each segment's device values wait for one deferred fetch at the end
        of ``replay()``."""
        o, w, b, v, eids = partition_trace(self.placement, *cur, self.window)
        n = self.n_expanders
        n_win = o.shape[1]
        seg = self._segments(n_win)
        pos_by_exp = [np.nonzero(eids == e)[0] for e in range(n)]
        for lo in range(0, n_win, seg):
            hi = min(lo + seg, n_win)
            sl = slice(lo, hi)

            def replay_local():
                for e in self._owned:
                    body(e, o[e, sl], w[e, sl], b[e, sl], v[e, sl], None)

            self.segments_replayed += 1
            if not self.migration_enabled:
                out = FS.replay_step(replay_local, self.pools, self.lanes)
                self._modeled_times = out["t"]
                self._deferred.append(out)
                continue
            step = FS.boundary_step(replay_local, self.pools, self.lanes,
                                    self.cfg, self.policy,
                                    FS.plan_params(self.migration_policy),
                                    self.group, self._blocked)
            self._modeled_times = step["times"]
            self.apply_syncs += step["apply_syncs"]
            self.boundaries += 1
            moved_pages = self._commit_boundary(
                step["gathered"], step["plan"], step["moved"], step["post"])
            if len(moved_pages):
                rem = self._rebuild(cur, pos_by_exp, hi,
                                    np.empty((0,), np.int64))
                if rem is not None:
                    return rem
        return None

    @sync_contract(syncs_per="boundary", fetches=1)
    def _commit_boundary(self, gathered: Dict[str, torch.Tensor],
                         plan: Optional[MG.MigrationPlan],
                         moved: Optional[np.ndarray],
                         post: Optional[Dict[str, torch.Tensor]]
                         ) -> np.ndarray:
        """The sharded driver's ONE fetch a boundary: the gathered
        post-replay times, counters (the segment's replay delta) and
        headroom, with the post-apply counters and freelist tops (the
        epoch's migration delta) when the plan was not empty; then the
        host bookkeeping ``_fetch_view`` and ``_commit_epoch`` split across
        two fetches on the vmap drivers. ``plan`` and ``moved`` are already
        on the host (the apply read them)."""
        tree = {"t": gathered["t"], "c": gathered["c"],
                "f": gathered["free_units"]}
        if post is not None:
            tree.update(c_post=post["c"], fc=post["fc"], fg=post["fg"])
        got = contracts.fetch_packed(tree)
        self.boundary_syncs += 1
        t32 = got["t"].numpy()
        self.segment_times.append(t32)
        ctrs_mid = got["c"].numpy().astype(np.int64)
        delta_replay = ctrs_mid - self._last_counters
        self.segment_deltas.append(delta_replay)
        self._last_free = got["f"].numpy().astype(np.int64)
        seg = self.segments_replayed - 1
        if self.obs is not None:
            # telemetry drain: host values of this boundary's one fetch
            self.obs.record_segment(seg, delta_replay,
                                    t32.astype(np.float64), self._last_free)
        if plan is None:
            # empty plan: no epoch; the snapshot advances to post-replay
            self._last_counters = ctrs_mid
            return np.empty((0,), np.int64)
        if self.obs is not None:
            self.obs.record_plan(seg, plan, self.migration_policy.name)
        ctrs_post = got["c_post"].numpy().astype(np.int64)
        delta_mig = ctrs_post - ctrs_mid
        self.migration_deltas.append((seg, delta_mig, False))
        self._last_counters = ctrs_post
        free_units = (got["fc"].numpy().astype(np.int64) +
                      8 * got["fg"].numpy().astype(np.int64))
        self._last_free = free_units
        sel = moved >= 0
        pages_moved = moved[sel].astype(np.int64)
        self.placement.apply_epoch(pages_moved, plan.dsts[sel])
        self.epochs_applied += 1
        if len(pages_moved):
            np.add.at(self.spill_pages_out, plan.srcs[sel], 1)
            np.add.at(self.spill_pages_in, plan.dsts[sel], 1)
            pairs = {(int(s), int(d)) for s, d in zip(plan.srcs[sel],
                                                      plan.dsts[sel])}
            self.spill_events += len(pairs)
            self._modeled_times = None    # migration traffic not yet priced
            self._blocked[:] = False      # progress: conditions changed
        else:
            self._blocked[plan.pages] = True
        if self.obs is not None:
            self.obs.record_epoch(seg, delta_mig, kind="sync",
                                  overlapped=False, planned=len(plan),
                                  moved=len(pages_moved), urgent=plan.urgent,
                                  free_units=free_units)
        if self.on_epoch is not None:
            self.on_epoch(self, plan, pages_moved)
        return pages_moved

    @sync_contract(syncs_per="drain", fetches=1)
    def _drain_deferred(self) -> None:
        """The sharded migration-off driver's ONE fetch a ``replay()``: every
        segment's times, counter snapshot and headroom, gathered over the
        ranks in one collective after the whole trace replayed, then the
        per-segment bookkeeping the vmap drivers do a fetch at a time."""
        tree = {f"{k}{i}": x for i, out in enumerate(self._deferred)
                for k, x in out.items()}
        got = contracts.fetch_packed(self.group.gather_tree(tree))
        self.drain_syncs += 1
        seg0 = self.segments_replayed - len(self._deferred)
        for i in range(len(self._deferred)):
            t32 = got[f"t{i}"].numpy()
            self.segment_times.append(t32)
            ctrs = got[f"c{i}"].numpy().astype(np.int64)
            delta = ctrs - self._last_counters
            self._last_counters = ctrs
            self.segment_deltas.append(delta)
            self._last_free = got[f"f{i}"].numpy().astype(np.int64)
            if self.obs is not None:
                self.obs.record_segment(seg0 + i, delta,
                                        t32.astype(np.float64),
                                        self._last_free)
        self._deferred = []

    # -- metrics -------------------------------------------------------------

    def _all(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tree``'s per-expander tensors for all N expanders: this rank's
        block gathered with the others' on the sharded driver (a
        collective), the stack itself otherwise."""
        return tree if self.group is None else self.group.gather_tree(tree)

    def _all_pools(self) -> S.Pool:
        return self.pools if self.group is None else \
            FS.gather_pool(self.pools, self.group)

    def gather_leaves(self) -> Optional[Dict[str, np.ndarray]]:
        """Every expander's leaves as numpy (``interop.pool_stack_to_numpy``'s
        names and dtypes): on the sharded driver gathered from every rank (a
        collective) and returned on rank 0, None on the others."""
        from repro_torch import interop
        pools = self._all_pools()
        if self.group is not None and self.group.rank:
            return None
        return interop.pool_stack_to_numpy(pools)

    def counters(self) -> Dict[str, int]:
        """Summed traffic counters across expanders."""
        c = self._all({"c": self.pools.counters})["c"]
        return dict(zip(S.COUNTER_NAMES, contracts.tolist(
            c.sum(dim=0, dtype=S.CTR_DTYPE))))

    @sync_contract(syncs_per="call", fetches=1)
    def delivered_time(self, exact: bool = True) -> np.ndarray:
        """Per-expander delivered seconds for the traffic replayed so far,
        each priced by that expander's own ``DeviceConfig``, migration
        traffic included where it occurred. ``exact=True`` recomputes in
        float64 on the host (the reference's parity-grade numbers);
        ``exact=False`` returns the float32 values the last segment
        computed on the device, or re-prices the current counters through
        the same float32 path when a later migration invalidated them.
        Either costs one fetch."""
        times = self._modeled_times
        if times is None:
            times = TM.exec_time_vec(self.pools.counters, self.lanes)
        got = contracts.fetch_packed(self._all({"t": times,
                                                "c": self.pools.counters}))
        if not exact:
            return got["t"].numpy().astype(np.float64)
        return TM.exec_time_vec(got["c"].numpy().astype(np.float64),
                                TM.stack_devices(self.devices, xp=np))

    def bottleneck_time(self, exact: bool = True) -> float:
        """Delivered time of the fabric serving one merged trace: expanders
        run in parallel, so the bottleneck expander governs."""
        return float(np.max(self.delivered_time(exact=exact)))

    def pipeline_times(self) -> Optional[Dict[str, object]]:
        """Pipeline-model delivered seconds from the recorded per-segment
        replay deltas and per-epoch migration deltas: ``overlapped_s``
        prices each segment as max(replay, migration), ``sync_s`` as their
        sum, per expander, over the SAME deltas (so overlapped <= sync);
        epochs that did not overlap a segment (urgent, depth-1, sync and
        drain epochs) get zero-replay rows of their own. ``delivered_s``
        is the pricing that matches how this fabric ran."""
        rows = self._pipeline_rows()
        if rows is None:
            return None
        replay, mig = rows
        lanes = TM.stack_devices(self.devices, xp=np)
        over = TM.pipeline_delivered_time(replay, mig, lanes, overlapped=True)
        sync = TM.pipeline_delivered_time(replay, mig, lanes,
                                          overlapped=False)
        overlapped_run = (not self.sync_migration and
                          self.pipeline_depth > 1 and
                          self.shard_devices is None)
        return {"overlapped_s": over, "sync_s": sync,
                "mode": "overlapped" if overlapped_run else "sync",
                "delivered_s": over if overlapped_run else sync}

    def _pipeline_rows(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(replay [R,N,C], mig [R,N,C]): the pipeline row matrices."""
        if not self.segment_deltas:
            return None
        n, c = self.n_expanders, S.NUM_COUNTERS
        n_seg = len(self.segment_deltas)
        sync_epochs = [d for _, d, over in self.migration_deltas
                       if not over]
        rows = n_seg + len(sync_epochs)
        replay = np.zeros((rows, n, c), np.float64)
        replay[:n_seg] = np.stack(self.segment_deltas)
        mig = np.zeros_like(replay)
        for i, d, over in self.migration_deltas:
            if over:
                mig[min(i, n_seg - 1)] += d
        for j, d in enumerate(sync_epochs):
            mig[n_seg + j] += d
        return replay, mig

    def device_times(self) -> Optional[Dict[str, object]]:
        """Per-rank delivered seconds on the sharded driver: a rank's
        expanders replay one after another on its device, so it finishes
        pipeline row ``r`` when its slowest owned expander does:
        ``device_s[d] = sum_r max_{e in d} max(replay, mig)``, from the same
        row matrices as ``pipeline_times`` (every epoch here is a
        zero-replay sync row). None on the vmap drivers or before any
        segment."""
        if self.shard_devices is None:
            return None
        rows = self._pipeline_rows()
        if rows is None:
            return None
        replay, mig = rows
        lanes = TM.stack_devices(self.devices, xp=np)
        cell = np.maximum(np.atleast_2d(TM.exec_time_vec(replay, lanes,
                                                         xp=np)),
                          np.atleast_2d(TM.exec_time_vec(mig, lanes, xp=np)))
        owners = SH.device_of_expander(self.n_expanders, self.shard_devices)
        device_s = np.asarray([cell[:, owners == d].max(axis=1).sum()
                               for d in range(self.shard_devices)],
                              np.float64)
        return {"device_s": device_s, "owners": owners}

    def park_capacity(self) -> np.ndarray:
        """Per-expander compressed-region headroom in chunk units, from the
        last segment's stats when a segment has run (no fetch), else one
        fetch of the freelist tops."""
        if self._last_free is None:
            got = contracts.fetch_packed(self._all({
                "c": self.pools.cfree.top, "g": self.pools.gfree.top}))
            return (got["c"].numpy().astype(np.int64) +
                    8 * got["g"].numpy().astype(np.int64))
        return self._last_free

    def state_identical(self, other: "Fabric") -> bool:
        """Bit-identity of two fabrics' end states: every leaf of the
        stacked pool (counters included) and the placement override
        tables. A sharded fabric gathers its leaves (a collective), so
        every rank calls it, each with an ``other`` of its own. One
        counted read: the leaves' equality flags, stacked on the card."""
        shapes, same = [], []

        def compare(a, b):
            shapes.append(a.shape == b.shape)
            if a.shape == b.shape:
                same.append((a == b.to(a.device)).all().to(self.device))
        S.tree_map(compare, self._all_pools(), other._all_pools())
        leaves = all(shapes) and contracts.item(torch.stack(same).all())
        return bool(leaves and (self.placement.overrides ==
                                other.placement.overrides).all())

    def counters_by_expander(self) -> List[Dict[str, int]]:
        return [dict(zip(S.COUNTER_NAMES, row)) for row in contracts.tolist(
            self._all({"c": self.pools.counters})["c"])]

    def spill_stats(self) -> Dict[str, object]:
        return {
            "events": self.spill_events,
            "pages_out": self.spill_pages_out.tolist(),
            "pages_in": self.spill_pages_in.tolist(),
            "syncs": self.epoch_syncs,
        }

    def sync_stats(self) -> Dict[str, int]:
        """The fetch budget: on the vmap drivers one fetch per replayed
        segment plus one per committed epoch; on the sharded driver one per
        boundary (migration on) or one deferred drain per ``replay()``
        (migration off). The mechanisms' own syncs (``replay_stats``,
        ``apply_syncs``) are beside it, not in it."""
        return {
            "segments": self.segments_replayed,
            "segment_syncs": self.segment_syncs,
            "epochs": self.epochs_applied,
            "epoch_syncs": self.epoch_syncs,
            "boundaries": self.boundaries,
            "boundary_syncs": self.boundary_syncs,
            "drain_syncs": self.drain_syncs,
            "host_syncs": self.segment_syncs + self.epoch_syncs +
            self.boundary_syncs + self.drain_syncs,
        }
