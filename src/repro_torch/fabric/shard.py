"""Sharded fabric execution: the stacked pool state split over ranks
(PyTorch port of ``repro.fabric.shard``; DESIGN.md §17).

The vmap drivers in ``fabric/replay.py`` model N expanders on ONE device:
their modeled delivered time scales, their wall time does not. The sharded
driver gives each rank (``common.sharding``: one process a device) its own
block of ``L = N / D`` expanders, replayed with the SAME masked window
bodies, so every expander's leaves are bit-identical to the vmap driver's
(all pool state is integer).

Pieces, in the reference's order:

  * ``plan_params`` / ``plan_rows`` — the planner's parameters and the
    plan's rows (one a potential source expander, plus the rebalance row);
  * ``plan_on_device`` — the ``MigrationPolicy`` plan step (the reference's
    ``plan_in_jit``) in torch ops over the gathered stats, no host sync:
    the same pages, srcs, dsts and ``urgent`` as ``SpillPressure`` /
    ``TrafficRebalance``, in the same row-major move order;
  * ``collective_apply`` — one migration epoch, move by move in the plan's
    order: the source's metadata entry and the destination's headroom bit
    cross in ONE masked all_reduce a move, and the compressed payload is
    broadcast from the source's owner (known on every rank from the
    replicated plan, so the reference's log2(D) ppermute ring is not
    needed; skipped when ``cfg.store_payload`` is off). ``migrate_src``
    runs on the source's owner, ``migrate_dst`` on the destination's. The
    control flow is eager, as in ``fabric.ops.apply_migrations``: each rank
    reads the plan and each move's all-reduced entry through counted syncs
    (the fabric's ``apply_syncs``, beside its fetch budget);
  * ``replay_step`` / ``boundary_step`` — a segment with migration off
    (nothing gathered or fetched), and a segment boundary: the local
    replay, the stats gathered in one collective, the plan, the collective
    apply and the post-apply counters gathered in one more collective, for
    the driver's ONE fetch (``Fabric._commit_boundary``).

The reference's ``unroll_slow=True`` exists for an XLA:CPU miscompile and
has no eager counterpart. ``replay_specs`` is a rank entry point
(``common.sharding.spawn_ranks``): it builds sharded fabrics from
picklable specs, runs them, and returns their end states on rank 0.

Planner parity: all pool state and spill logic is integer, so ``spill``
plans bit-identically to the host planner. The ``rebalance`` time trigger
compares float32 times where the host compares float64 promotions of the
same values: equal except at exact ties of ``time_ratio * times[cold]``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common.sharding import ExpanderGroup, device_of_expander
from repro_torch.common.types import PoolConfig
from repro_torch.core import metadata as md
from repro_torch.core.engine import ops
from repro_torch.core.engine import state as S
from repro_torch.core.engine.policy import Policy
from repro_torch.fabric import migration as MG
from repro_torch.fabric import ops as fops
from repro_torch.simx import time as TM

__all__ = ["plan_params", "plan_rows", "plan_on_device", "collective_apply",
           "gather_pool", "replay_step", "boundary_step", "replay_specs",
           "device_of_expander"]


def plan_params(policy: "MG.MigrationPolicy") -> Tuple:
    """The planner's parameters (``kind`` selects the on-device planner);
    a policy with no on-device planner raises."""
    if isinstance(policy, MG.TrafficRebalance):
        return ("rebalance", policy.k, policy.low, policy.proactive,
                policy.trigger, policy.time_ratio, policy.min_delta)
    if isinstance(policy, MG.SpillPressure):
        return ("spill", policy.k, policy.low, policy.proactive)
    raise ValueError(f"no on-device planner for {policy.name!r}")


def plan_rows(params: Tuple, n_expanders: int) -> int:
    """Plan rows: one a potential pressure source, plus the rebalance row.
    Row-major flattening keeps the host planner's move order (ascending
    starved expander, rebalance last)."""
    return n_expanders + (1 if params[0] == "rebalance" else 0)


def _first_k(cand: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """int32[k]: the first ``k`` indices where ``cand`` holds, in order,
    ``fill`` past the last (a stable sort: no host sync)."""
    order = torch.argsort((~cand).to(torch.int8), stable=True)[:k]
    out = torch.full((k,), fill, dtype=torch.int32, device=cand.device)
    out[:order.numel()] = order.to(torch.int32)
    return out


def plan_on_device(params: Tuple, free_units, free_singles, free_groups,
                   eligible, referenced, delta, times, blocked):
    """The MigrationPolicy plan step on the device: mirrors
    ``SpillPressure._pressure_moves`` (and ``TrafficRebalance``'s traffic
    trigger) over the gathered stats. Returns ``(pages, srcs, dsts,
    urgent)``, pages int32[R, k] -1-padded a row: a row a potential source
    expander in ascending order (the host loop's order), then the
    rebalance row, so the flattened real moves come in exactly the host
    plan's order. ``recent`` is left out: the synchronous scheduling the
    sharded driver uses never carries recently moved pages, and
    ``blocked`` plays the livelock guard."""
    kind, k = params[0], int(params[1])
    low, proactive = int(params[2]), float(params[3])
    n, n_pages = eligible.shape
    dev = eligible.device
    i32 = torch.int32
    free = free_units.to(i32).clone()
    donor_ok = (free_singles >= fops.DONOR_SINGLES) & \
        (free_groups >= fops.DONOR_GROUPS)
    # the trigger set is fixed from the ORIGINAL headroom (the host loop
    # takes np.nonzero before any donor decrement)
    trig = free < proactive * low
    cand_all = eligible & ~blocked[None, :]
    rows = plan_rows(params, n)
    pages = torch.full((rows, k), -1, dtype=i32, device=dev)
    srcs = torch.zeros((rows, k), dtype=i32, device=dev)
    dsts = torch.zeros((rows, k), dtype=i32, device=dev)
    lane = torch.arange(k, dtype=i32, device=dev)
    urgent = torch.zeros((), dtype=torch.bool, device=dev)
    for e in range(n):
        donor = torch.argmax(free).to(i32)
        cand = cand_all[e]
        cnt = torch.clamp(cand.sum(), max=k).to(i32)
        ok = trig[e] & (donor != e) & (free[donor] >= 2 * low) & \
            donor_ok[donor] & (cnt > 0)
        urgent = urgent | (ok & (free[e] < low))
        pages[e] = torch.where(ok & (lane < cnt), _first_k(cand, k, n_pages),
                               -1)
        srcs[e] = e
        dsts[e] = donor
        # conservative donor accounting within one plan (8 units a page)
        free[donor] = free[donor] - torch.where(ok, 8 * cnt, 0)

    if kind == "rebalance" and n > 1:
        trigger, time_ratio = float(params[4]), float(params[5])
        min_delta = int(params[6])
        delta = delta.to(i32)
        host_d = delta[:, S.C_HOST_RD] + delta[:, S.C_HOST_WR]
        total = host_d.sum()
        hot = torch.argmax(host_d).to(i32)
        ok_d = (free >= 2 * low) & donor_ok
        ok_d[hot] = False
        fire = (total >= min_delta) & ok_d.any() & \
            (host_d[hot] * n > trigger * total)
        times = times.to(torch.float32)
        cold = torch.argmin(torch.where(ok_d, times, torch.inf)).to(i32)
        fire = fire & (times[hot] > time_ratio * times[cold])
        # pages the pressure moves already claimed are off the table
        claimed = torch.zeros((n_pages + 1,), dtype=torch.bool, device=dev)
        claimed[torch.where(pages >= 0, pages, n_pages).reshape(-1)
                .long()] = True
        cand = cand_all[hot] & ~claimed[:n_pages]
        refd = cand & referenced[hot]
        # referenced first, then the other candidates, each in page order:
        # a stable sort of the 3-level rank gives the host's concatenated
        # np.nonzero order
        rank = torch.where(refd, 0, torch.where(cand, 1, 2)).to(torch.int8)
        order = torch.argsort(rank, stable=True)[:k].to(i32)
        order = torch.cat([order, torch.full((k - order.numel(),), n_pages,
                                             dtype=i32, device=dev)])
        cnt = torch.clamp(cand.sum(), max=k).to(i32)
        fire = fire & (cnt > 0)
        pages[n] = torch.where(fire & (lane < cnt), order, -1)
        srcs[n] = hot
        dsts[n] = cold
    return pages, srcs, dsts, urgent


def collective_apply(pools_l: S.Pool, cfg: PoolConfig, policy: Policy,
                     pages, srcs, dsts, group: ExpanderGroup,
                     n_local: int) -> np.ndarray:
    """One migration epoch on this rank's block of the stack (``pools_l``,
    ``[L, ...]``), in place. ``pages``/``srcs``/``dsts`` are the
    replicated plan's moves on the host (global expander ids), in order.
    Each move re-checks the destination's headroom (7 singles + 1 group)
    and the page's eligibility against the live state, exactly as
    ``apply_migrations``, so the result equals the one-device apply.
    Every rank takes the same branches: each depends only on the plan and
    on all-reduced values. Returns int32[K] moved OSPNs (-1 where
    skipped), the same on every rank."""
    mw = md.ENTRY_WORDS
    dev = pools_l.meta.device
    moved = np.full((len(pages),), -1, np.int32)
    for i, (p, s, d) in enumerate(zip(np.asarray(pages).tolist(),
                                      np.asarray(srcs).tolist(),
                                      np.asarray(dsts).tolist())):
        if p < 0 or s == d:
            continue
        sdev, sloc = divmod(s, n_local)
        ddev, dloc = divmod(d, n_local)
        # one all_reduce: the entry from the source's owner, the headroom
        # bit from the destination's
        vec = torch.zeros((mw + 1,), dtype=torch.int64, device=dev)
        if sdev == group.rank:
            vec[:mw] = pools_l.meta[sloc, p]
        if ddev == group.rank:
            vec[mw] = ((pools_l.cfree.top[dloc] >= fops.DONOR_SINGLES) &
                       (pools_l.gfree.top[dloc] >= fops.DONOR_GROUPS)
                       ).to(torch.int64)
        host = contracts.tolist(group.psum(vec))
        entry, headroom = host[:mw], host[mw] > 0
        eligible, nchunks = fops.page_eligible(entry)
        if not (headroom and eligible):
            continue
        if sdev == group.rank:
            src = S.pool_slice(pools_l, sloc)
            buf = ops._gather_page_buf(src, cfg, entry)
        else:
            buf = torch.zeros((cfg.page_bytes,), dtype=torch.uint8,
                              device=dev)
        if cfg.store_payload:
            group.bcast(buf, sdev)
        if sdev == group.rank:
            fops.migrate_src(src, cfg, policy, p, entry, nchunks)
        if ddev == group.rank:
            fops.migrate_dst(S.pool_slice(pools_l, dloc), cfg, policy, p,
                             entry, nchunks, buf)
        moved[i] = p
    return moved


def gather_pool(pools_l: S.Pool, group: ExpanderGroup) -> S.Pool:
    """Every rank's block of the stack, concatenated: the whole ``[N, ...]``
    stack on this rank's device (one collective)."""
    leaves = []
    S.tree_map(leaves.append, pools_l)
    got = group.gather_tree({str(i): a for i, a in enumerate(leaves)})
    it = iter(range(len(leaves)))
    return S.tree_map(lambda a: got[str(next(it))], pools_l)


def replay_step(replay_local: Callable[[], None], pools_l: S.Pool,
                lanes_l) -> Dict[str, torch.Tensor]:
    """A segment with migration off: the local replay, then this rank's
    float32 times, a counter snapshot and the freelist headroom, left on
    the device (``Fabric._drain_deferred`` gathers and fetches them after
    the whole trace)."""
    replay_local()
    return {"t": TM.exec_time_vec(pools_l.counters, lanes_l),
            "c": S.counters_snapshot(pools_l),
            "f": pools_l.cfree.top + 8 * pools_l.gfree.top}


def boundary_step(replay_local: Callable[[], None], pools_l: S.Pool, lanes_l,
                  cfg: PoolConfig, policy: Policy, mparams: Tuple,
                  group: ExpanderGroup, blocked: np.ndarray) -> dict:
    """A segment boundary with migration live: the local replay; times,
    counters, the segment's counter delta and the migration stats gathered
    in ONE collective; the plan on the device from them (the same on every
    rank); the plan read and applied collectively; the post-apply counters
    and freelist tops gathered in one more collective. Returns the
    device-resident values ``Fabric._commit_boundary`` fetches, the host
    plan (None when empty) and moves, and the syncs the plan read and the
    apply took."""
    ctrs_prev = S.counters_snapshot(pools_l)
    replay_local()
    times = TM.exec_time_vec(pools_l.counters, lanes_l)
    stats = fops.segment_stats(pools_l, cfg)
    ctrs_mid = S.counters_snapshot(pools_l)
    g = group.gather_tree({"t": times, "c": ctrs_mid, "d": ctrs_mid -
                           ctrs_prev, **stats._asdict()})
    dev = pools_l.meta.device
    pages, srcs, dsts, urgent = plan_on_device(
        mparams, g["free_units"], g["free_singles"], g["free_groups"],
        g["eligible"], g["referenced"], g["d"], g["t"],
        contracts.upload(blocked, torch.bool, dev))
    s0 = contracts.SYNCS.count
    got = contracts.fetch_packed({"p": pages.reshape(-1),
                                  "s": srcs.reshape(-1),
                                  "d": dsts.reshape(-1),
                                  "u": urgent.reshape(1)})
    p = got["p"].numpy()
    sel = p >= 0
    plan = moved = post = None
    if sel.any():
        plan = MG.MigrationPlan(p[sel].astype(np.int32),
                                got["s"].numpy()[sel].astype(np.int32),
                                got["d"].numpy()[sel].astype(np.int32),
                                urgent=bool(got["u"][0]))
        moved = collective_apply(pools_l, cfg, policy, plan.pages, plan.srcs,
                                 plan.dsts, group, pools_l.meta.shape[0])
        post = group.gather_tree({"c": pools_l.counters,
                                  "fc": pools_l.cfree.top,
                                  "fg": pools_l.gfree.top})
    return {"times": times, "gathered": g, "plan": plan, "moved": moved,
            "post": post, "apply_syncs": contracts.SYNCS.count - s0}


def replay_specs(group: ExpanderGroup, specs) -> Optional[list]:
    """A rank entry point (``common.sharding.spawn_ranks``): for each spec
    in turn, build the sharded fabric it describes on this rank, load and
    replay it; return on rank 0 what a parity check reads of each (None on
    the others).

    ``spec`` keys: ``cfg`` (PoolConfig fields), ``policy`` (a scheme name),
    ``placement`` ((name in ``fabric.placement``, args)), ``fabric`` (the
    Fabric's keyword arguments), ``rates`` (or None), ``trace`` ((ospns,
    writes, blocks)), optionally ``write`` ((ospns, float32 page values):
    ``write_pages`` first) and ``obs`` (attach a Recorder on rank 0)."""
    out = [_replay_spec(group, spec) for spec in specs]
    return None if group.rank else out


def _replay_spec(group: ExpanderGroup, spec: dict) -> Optional[dict]:
    from repro_torch.core.engine.policy import POLICIES
    from repro_torch.fabric import placement as PL
    from repro_torch.fabric.replay import Fabric
    from repro_torch.kernels import qpack
    from repro_torch.obs import Recorder
    from repro_torch.obs import export as OBX
    cfg = PoolConfig(**spec["cfg"])
    name, args = spec["placement"]
    rec = Recorder() if spec.get("obs") and group.rank == 0 else None
    fab = Fabric(cfg, POLICIES[spec["policy"]], getattr(PL, name)(*args),
                 rates_table=spec.get("rates"), obs=rec,
                 shard_devices=group.world, **spec["fabric"])
    d0, p0 = qpack.fused_demote_launches, qpack.fused_promote_launches
    t0 = time.perf_counter()
    if "write" in spec:
        ospns, vals = spec["write"]
        fab.write_pages(ospns, torch.from_numpy(vals).to(fab.device)
                        .to(torch.bfloat16))
    fab.replay(*spec["trace"])
    run_s = time.perf_counter() - t0
    launches = contracts.tolist(group.psum(torch.tensor(
        [qpack.fused_demote_launches - d0, qpack.fused_promote_launches - p0],
        dtype=torch.int64, device=fab.device)))
    leaves = fab.gather_leaves()
    by_exp = fab.counters_by_expander()
    total = fab.counters()
    exact = fab.delivered_time()
    f32 = fab.delivered_time(exact=False)
    free = fab.park_capacity()
    if group.rank:
        return None
    out = {"leaves": leaves, "overrides": fab.placement.overrides.copy(),
           "epoch": fab.placement.epoch, "counters_by_expander": by_exp,
           "counters": total, "spill_stats": fab.spill_stats(),
           "sync_stats": fab.sync_stats(), "apply_syncs": fab.apply_syncs,
           "segment_deltas": fab.segment_deltas,
           "migration_deltas": fab.migration_deltas,
           "segment_times": fab.segment_times, "delivered": exact,
           "delivered_f32": f32, "park_capacity": free,
           "pipeline_times": fab.pipeline_times(),
           "device_times": fab.device_times(),
           "launches": {"demote": launches[0], "promote": launches[1]},
           "run_s": run_s}
    if rec is not None:
        trace = OBX.build_trace(rec)
        out["obs"] = {"device_totals": OBX.fabric_device_totals(rec),
                      "track_totals": OBX.fabric_track_totals(rec),
                      "trace_problems": OBX.validate_trace(trace),
                      "device_spans": [
                          (e["tid"], e["ts"], e["dur"])
                          for e in trace["traceEvents"]
                          if e["ph"] == "X" and e.get("tid", 0) >= 1000],
                      "segments": len(rec.segments),
                      "epochs": len(rec.epochs)}
    return out
