"""Multi-expander fabric launcher (PyTorch port of ``repro.launch.fabric``):
replay a paper workload through a fabric of N simulated expanders with a
chosen placement mode (DESIGN.md §11/§13).

  PYTHONPATH=src python -m repro_torch.launch.fabric --workload mcf \\
      --expanders 4 --skew 0.8 --check-parity --device cpu

The reference's flags and printed lines: ``--skew`` forces a weighted
placement that sends that fraction of pages to expander 0;
``--migration {spill,rebalance,off}`` picks the MigrationPolicy;
``--sync-migration`` forces the synchronous driver; ``--pipeline-depth 1``
plans and applies at the same boundary. ``--verify-depth1`` replays the
trace through BOTH and asserts bit-identical end states.
``--check-parity`` replays every expander's partition through the
single-pool engine and asserts the summed counters (with ``--payload``,
every leaf of every expander) match the fabric exactly, when no migration
fired.

The port's own flags: ``--device`` (CUDA unless named) and ``--payload``
(``store_payload=True, lossless=True``: every page of the OSPA space is
first written with content of the workload's rate mix through
``Fabric.write_pages``, so demotions and promotions run the compression
kernels on the card). ``--devices N`` runs the sharded driver
(``Fabric(shard_devices=N)``) on N ranks that the launcher spawns itself
(``common.sharding.spawn_ranks``, a ``file://`` rendezvous): NCCL on the
cards ``cuda:0..N-1`` by default (fewer visible cards raises, naming the
count), gloo with ``--device cpu``. Rank 0 prints the reference's mesh and
ownership lines and the report; ``main`` then returns rank 0's summary
(per-expander and summed counters, delivered times, spill and sync stats)
instead of the fabric, which lives on the ranks.

``--trace OUT.trace.json`` attaches a ``repro_torch.obs.Recorder`` fed by
the per-segment and per-epoch fetches (the sync budgets are asserted with
it attached), checks that the trace's per-expander track totals reconcile
with ``Fabric.pipeline_times()`` at rtol 1e-9, writes the Perfetto
timeline there and the metrics snapshot beside it (``OUT.metrics.json``),
and prints the per-segment summary table. ``main`` returns the fabric (its
recorder is ``fabric.obs``).

``BENCH_RECIPE``/``BENCH_FABRICS`` are the fabrics of the reference's
``benchmarks/fabric_bench.py::run(quick=False)`` (scaling, mixed fleets,
skew sweep, migration pipeline), ``build`` makes one on the port and
``record`` reads what the reference file ``fabric/reference_fabric.json``
holds for it (written by ``tests/test_torch_fabric_reference.py`` with
the JAX package; ``chip_smoke.py`` phase 12 holds the card to it).
"""
from __future__ import annotations

import argparse
import hashlib
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common import sharding as SH
from repro_torch.common.types import replace
from repro_torch.common.utils import resolve_device
from repro_torch.core.engine import batch as B
from repro_torch.core.engine import ops as E
from repro_torch.core.engine import state as S
from repro_torch.core.engine.policy import POLICIES
from repro_torch.fabric import Fabric, make_placement
from repro_torch.obs import Recorder
from repro_torch.obs import export as OBX
from repro_torch.simx import time as TM
from repro_torch.simx.engine import TRAFFIC_KEYS, pool_cfg_for
from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                    make_rates_table, make_trace)


REFERENCE = Path(__file__).resolve().parents[1] / "fabric" / \
    "reference_fabric.json"

# benchmarks/fabric_bench.py::run(quick=False): one mcf trace over a
# 256-page OSPA space, 32 promoted P-chunks per expander
BENCH_RECIPE = dict(workload="mcf", scheme="ibex", n_pages=256, n_pchunks=32,
                    n_cchunks=2 * 256 * 4, n_accesses=8192, window=16, seed=0)


def _bench_fabrics() -> list:
    out = [dict(name=f"scale.{n}x", n=n, weights=None, profiles=["default"],
                n_cchunks=BENCH_RECIPE["n_cchunks"], kwargs=dict(spill=False))
           for n in (1, 2, 4, 8)]
    for name, profiles in (("mixed2", ["default", "gen4"]),
                           ("mixed4", ["default", "default", "gen4",
                                       "gen4"])):
        n = len(profiles)
        rest = (1.0 - 0.8) / max(n - 1, 1)
        out.append(dict(name=f"fleet.{name}", n=n,
                        weights=[0.8] + [rest] * (n - 1), profiles=profiles,
                        n_cchunks=256, kwargs=dict(
                            spill=True, spill_interval=512, spill_k=16,
                            spill_low=112)))
    for share in (0.25, 0.5, 0.8):
        rest = (1.0 - share) / 3.0
        out.append(dict(name=f"skew.{share:.2f}", n=4,
                        weights=[share, rest, rest, rest],
                        profiles=["default"],
                        n_cchunks=BENCH_RECIPE["n_cchunks"],
                        kwargs=dict(spill=True, spill_interval=1024)))
    rest = (1.0 - 0.8) / 3.0
    for name, kw in (("depth2", dict(pipeline_depth=2)),
                     ("sync", dict(sync_migration=True)),
                     ("depth1", dict(pipeline_depth=1))):
        out.append(dict(name=f"migration.{name}", n=4,
                        weights=[0.8] + [rest] * 3, profiles=["default"],
                        n_cchunks=BENCH_RECIPE["n_cchunks"],
                        kwargs=dict(migration="rebalance", spill_interval=1024,
                                    **kw)))
    return out


BENCH_FABRICS = _bench_fabrics()


def bench_inputs(recipe: dict = BENCH_RECIPE):
    """(rates table, (ospns, writes, blocks)) of the recipe's trace."""
    spec = WORKLOADS[recipe["workload"]]
    rates = make_rates_table(spec, recipe["n_pages"], seed=recipe["seed"])
    trace = make_trace(spec, n_accesses=recipe["n_accesses"],
                       n_pages=recipe["n_pages"], seed=recipe["seed"])
    return rates, trace


def build(fabric: dict, rates, recipe: dict = BENCH_RECIPE,
          device=None) -> Fabric:
    """One of ``BENCH_FABRICS`` on the port (not yet replayed)."""
    policy = POLICIES[recipe["scheme"]]
    cfg = pool_cfg_for(policy, n_pages=recipe["n_pages"],
                       n_pchunks=recipe["n_pchunks"],
                       n_cchunks=fabric["n_cchunks"])
    n = fabric["n"]
    placement = (make_placement("interleave", n, recipe["n_pages"])
                 if fabric["weights"] is None else
                 make_placement("weighted", n, recipe["n_pages"],
                                weights=fabric["weights"]))
    return Fabric(cfg, policy, placement, seed=recipe["seed"],
                  rates_table=rates, window=recipe["window"],
                  devices=[TM.DEVICE_PROFILES[p] for p in fabric["profiles"]],
                  device=device, **fabric["kwargs"])


def digest(a: np.ndarray) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype.str}{a.shape}".encode() +
                          a.tobytes()).hexdigest()


def record(fab: Fabric) -> dict:
    """What the reference file holds for a replayed fabric: per-expander
    counters, the override table's digest, spill and sync stats, the
    segment and migration deltas, float64 delivered times, every
    segment's float32 times as bit patterns, the pipeline pricing and
    every leaf's digest."""
    pt = fab.pipeline_times()
    return {
        "counters": fab.counters_by_expander(),
        "overrides_sha256": digest(fab.placement.overrides),
        "overrides_set": int((fab.placement.overrides >= 0).sum()),
        "spill_stats": fab.spill_stats(),
        "sync_stats": fab.sync_stats(),
        "segment_deltas": [d.tolist() for d in fab.segment_deltas],
        "migration_deltas": [[int(i), d.tolist(), bool(o)]
                             for i, d, o in fab.migration_deltas],
        "delivered_exact": [float(t) for t in fab.delivered_time()],
        "segment_times_f32": [
            np.asarray(t, np.float32).view(np.uint32).tolist()
            for t in fab.segment_times],
        "pipeline": None if pt is None else {
            "mode": pt["mode"],
            "overlapped_s": [float(t) for t in pt["overlapped_s"]],
            "sync_s": [float(t) for t in pt["sync_s"]]},
        "leaves_sha256": {k: digest(a) for k, a in
                          interop.pool_stack_to_numpy(fab.pools).items()},
    }


def _content(rates: np.ndarray, cfg, seed: int, dev) -> torch.Tensor:
    """bf16 page values [n_pages, vals_per_page] of the rate mix."""
    vals = make_block_content(rates, cfg.vals_per_block, seed)
    return torch.from_numpy(vals.reshape(rates.shape[0], cfg.vals_per_page)) \
        .to(dev).to(torch.bfloat16)


def _single_pool_parity(agg: dict, leaves, cfg, policy, placement, rates,
                        content, trace, args, dev) -> None:
    """Each expander's partition through the single-pool engine, from the
    same starting state: summed counters ``agg`` (and, with payload, every
    leaf of every expander, ``leaves``) must equal the fabric's."""
    ospn, wr, blk = trace
    eids = placement.route(ospn)
    n = placement.n_expanders
    stack0 = S.make_pool_stack(cfg, n, seed=args.seed,
                               rates_table=rates, device=dev)
    total = {k: 0 for k in S.COUNTER_NAMES}
    homes = placement.route(np.arange(cfg.n_pages)) if content is not None \
        else None
    for e in range(n):
        pool = S.pool_slice(stack0, e)
        if content is not None:
            for p in np.nonzero(homes == e)[0].tolist():
                E.host_write_page(pool, cfg, policy, p, content[p])
        sel = eids == e
        B.replay_trace(pool, cfg, policy, ospn[sel], wr[sel], blk[sel],
                       window=args.window)
        for k, v in S.counters_dict(pool).items():
            total[k] += v
    assert agg == total, "fabric drifted from single-pool"
    if content is not None:
        a, b = leaves, interop.pool_stack_to_numpy(stack0)
        bad = [k for k in a if not np.array_equal(a[k], b[k])]
        assert not bad, f"fabric leaves drifted from single-pool: {bad}"
        print("parity: every leaf of every expander (payload stores "
              "included) == per-shard single-pool replays (exact)")
    print("parity: summed fabric counters == per-shard single-pool "
          "replays (exact)")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mcf", choices=sorted(WORKLOADS))
    ap.add_argument("--scheme", default="ibex", choices=sorted(POLICIES))
    ap.add_argument("--expanders", type=int, default=4)
    ap.add_argument("--placement", default="interleave",
                    choices=("interleave", "capacity", "locality"))
    ap.add_argument("--skew", type=float, default=0.0,
                    help="page share forced onto expander 0 (>0 overrides "
                         "--placement with a weighted interleave)")
    ap.add_argument("--accesses", type=int, default=4096)
    ap.add_argument("--pages", type=int, default=512)
    ap.add_argument("--prom", type=int, default=32,
                    help="promoted P-chunks per expander")
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--migration", default="spill",
                    choices=("spill", "rebalance", "off"))
    ap.add_argument("--no-spill", action="store_true",
                    help="alias for --migration off")
    ap.add_argument("--sync-migration", action="store_true",
                    help="force the synchronous driver (plan and apply at "
                         "every boundary)")
    ap.add_argument("--pipeline-depth", type=int, default=2, choices=(1, 2))
    ap.add_argument("--verify-depth1", action="store_true",
                    help="replay through the depth-1 pipeline AND the "
                         "synchronous driver and assert bit-identical "
                         "end states")
    ap.add_argument("--check-parity", action="store_true")
    ap.add_argument("--device-profile", default="default",
                    help="comma-separated simx.time.DEVICE_PROFILES names "
                         f"({', '.join(sorted(TM.DEVICE_PROFILES))}) or "
                         "'calibrated', cycled across expanders")
    ap.add_argument("--device", default=None,
                    help="torch device (CUDA unless named; 'cpu' runs the "
                         "plain versions)")
    ap.add_argument("--payload", action="store_true",
                    help="store_payload=True, lossless=True: write every "
                         "page with content of the rate mix first")
    ap.add_argument("--devices", type=int, default=None, metavar="N",
                    help="the sharded driver on N spawned ranks (NCCL on "
                         "cuda:0..N-1; gloo with --device cpu)")
    ap.add_argument("--trace", default=None, metavar="OUT.trace.json",
                    help="attach a repro_torch.obs.Recorder (fed by the "
                         "per-segment and per-epoch fetches: zero extra "
                         "syncs, asserted), write the Perfetto trace_event "
                         "export there plus a .metrics.json sibling, and "
                         "print the per-segment summary table")
    return ap


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if args.devices is None:
        return _run(ap, args)
    if args.expanders % args.devices:
        ap.error(f"--devices {args.devices} does not divide --expanders "
                 f"{args.expanders}")
    on_cpu = args.device is not None and \
        torch.device(args.device).type == "cpu"
    if not on_cpu:
        n_cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_cards < args.devices:
            raise RuntimeError(f"--devices {args.devices} needs "
                               f"{args.devices} CUDA devices; {n_cards} "
                               f"visible (--device cpu runs gloo ranks)")
    return SH.spawn_ranks(_rank_main, args.devices,
                          backend="gloo" if on_cpu else "nccl",
                          args=(argv,), device="cpu" if on_cpu else None)[0]


def _rank_main(group: SH.ExpanderGroup, argv) -> dict:
    """One rank of ``--devices N``: the launcher's run on its block."""
    ap = _parser()
    return _run(ap, ap.parse_args(argv), group)


def _run(ap, args, group: SH.ExpanderGroup = None):
    """The launcher's run: on one device (returns the fabric), or as one
    rank of ``--devices N`` (returns rank 0's summary, None elsewhere;
    only rank 0 prints)."""
    rank = 0 if group is None else group.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    dev = resolve_device(args.device) if group is None else group.device

    profiles = [p.strip() for p in args.device_profile.split(",")
                if p.strip()]
    unknown = [p for p in profiles
               if p != "calibrated" and p not in TM.DEVICE_PROFILES]
    if unknown:
        ap.error(f"unknown device profile(s) {unknown}; choose from "
                 f"{sorted(TM.DEVICE_PROFILES) + ['calibrated']}")
    if len(profiles) > args.expanders:
        ap.error(f"{len(profiles)} device profiles for "
                 f"{args.expanders} expanders")
    devices = [TM.calibrated_device() if p == "calibrated"
               else TM.DEVICE_PROFILES[p] for p in profiles]

    policy = POLICIES[args.scheme]
    cfg = pool_cfg_for(policy, n_pages=args.pages, n_pchunks=args.prom,
                       n_cchunks=2 * args.pages * 4)
    if args.payload:
        cfg = replace(cfg, store_payload=True, lossless=True)
    spec = WORKLOADS[args.workload]
    rates = make_rates_table(spec, args.pages, seed=args.seed)
    ospn, wr, blk = make_trace(spec, n_accesses=args.accesses,
                               n_pages=args.pages, seed=args.seed)
    content = _content(rates, cfg, args.seed, dev) if args.payload else None
    n = args.expanders

    def new_placement():
        if args.skew > 0:
            rest = (1.0 - args.skew) / max(n - 1, 1)
            return make_placement("weighted", n, args.pages,
                                  weights=[args.skew] + [rest] * (n - 1))
        return make_placement(args.placement, n, args.pages)

    placement = new_placement()
    migration = "off" if args.no_spill else args.migration
    sharded = dict(shard_devices=group.world) if group else {}

    def make_fabric(pl, **kw):
        fab = Fabric(cfg, policy, pl, seed=args.seed, rates_table=rates,
                     window=args.window, migration=migration,
                     devices=devices, device=dev, **kw)
        if content is not None:
            fab.write_pages(np.arange(args.pages), content)
        return fab

    if group is not None:
        owners = SH.device_of_expander(n, group.world)
        say(f"mesh: {group.world} device(s) ({dist.get_backend()} ranks), "
            f"axis '{SH.EXPANDER_AXIS}', {n} expanders "
            f"({n // group.world} per device)")
        for d in range(group.world):
            owned = np.nonzero(owners == d)[0]
            say(f"  device {d} ({dev.type}): expanders {owned.tolist()}")
    rec = Recorder() if args.trace and rank == 0 else None
    fab = make_fabric(placement, sync_migration=args.sync_migration,
                      pipeline_depth=args.pipeline_depth, obs=rec, **sharded)
    contracts.SYNCS.reset()
    t0 = time.perf_counter()
    fab.replay(ospn, wr, blk)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    # collective on the sharded driver: every rank reads them
    agg = fab.counters()
    per = fab.counters_by_expander()
    delivered = fab.delivered_time()
    leaves = fab.gather_leaves() if args.check_parity and content is not \
        None else None
    say(f"fabric: {n} expanders, placement="
        f"{'weighted' if args.skew > 0 else args.placement}, "
        f"profiles={','.join(profiles)}, "
        f"{'payload, ' if args.payload else ''}"
        f"{args.accesses} accesses in {dt:.1f}s "
        f"({args.accesses / max(dt, 1e-9):,.0f} acc/s) on {dev}")
    for e, c in enumerate(per):
        host = c["host_reads"] + c["host_writes"]
        internal = sum(c[k] for k in TRAFFIC_KEYS)
        say(f"  expander {e} ({profiles[e % len(profiles)]}): "
            f"host={host} internal={internal} "
            f"promotions={c['promotions']} "
            f"demotions={c['demotions_clean'] + c['demotions_dirty']} "
            f"delivered={delivered[e] * 1e6:.1f}us")
    say(f"  aggregate: host={agg['host_reads'] + agg['host_writes']} "
        f"internal={sum(agg[k] for k in TRAFFIC_KEYS)}")
    bottleneck = float(delivered.max())
    say(f"  delivered time (bottleneck expander "
        f"{int(delivered.argmax())}): {bottleneck * 1e6:.1f}us "
        f"({args.accesses / bottleneck:,.0f} modeled acc/s)")
    say(f"  migration ({fab.migration_policy.name}): {fab.spill_stats()}")
    ss = fab.sync_stats()
    if group is not None:
        assert ss["segment_syncs"] == 0 and ss["epoch_syncs"] == 0, ss
        assert ss["boundary_syncs"] == ss["boundaries"], ss
        assert ss["drain_syncs"] <= 1, ss
        say(f"  syncs: {ss} (sharded: one fetch per boundary, one drain "
            f"with migration off, asserted)")
    else:
        assert ss["segment_syncs"] == ss["segments"], ss
        assert ss["epoch_syncs"] == ss["epochs"], ss
        say(f"  syncs: {ss} (one per segment + one per epoch, asserted)")
    rs = fab.replay_stats
    say(f"  mechanism syncs: replay {contracts.SYNCS.count} counted "
        f"({rs['windows']} windows, "
        f"{(rs['window_syncs'] + rs['slow_syncs']) / max(rs['windows'], 1):.3f}"
        f" a window), migration apply {fab.apply_syncs}")
    pt = fab.pipeline_times()
    if pt is not None and fab.epochs_applied:
        over = float(np.max(pt["overlapped_s"]))
        sync = float(np.max(pt["sync_s"]))
        say(f"  pipeline pricing ({pt['mode']}): "
            f"overlapped={over * 1e6:.1f}us sync={sync * 1e6:.1f}us "
            f"(migration overlap hides {(sync - over) * 1e6:.2f}us)")

    if rec is not None:
        # the budgets held with recording on (asserted above); the exported
        # tracks must reconcile with the pipeline pricing
        totals = OBX.fabric_track_totals(rec)
        if pt is not None:
            assert np.allclose(totals["overlapped_s"], pt["overlapped_s"],
                               rtol=1e-9), "trace drifted from pipeline_times"
        dev_totals = OBX.fabric_device_totals(rec)
        if dev_totals is not None:
            dts = fab.device_times()
            assert np.allclose(dev_totals["device_s"], dts["device_s"],
                               rtol=1e-9), \
                "device tracks drifted from Fabric.device_times"
            say(f"  device tracks: "
                f"{[f'{t * 1e6:.1f}us' for t in dts['device_s']]} "
                f"(reconcile with device_times at rtol=1e-9, asserted)")
        mpath = OBX.metrics_path(args.trace)
        OBX.write_trace(rec, args.trace)
        OBX.write_metrics(rec, mpath, seed=args.seed)
        say(f"  trace: {args.trace} (+ {mpath}); {len(rec.segments)} "
            f"segments, {len(rec.plans)} plans, {len(rec.epochs)} epochs "
            f"recorded; per-expander track totals reconcile with "
            f"pipeline_times (asserted)")
        say(OBX.fabric_summary_table(rec))

    if args.verify_depth1 and rank == 0:
        f1 = make_fabric(new_placement(), pipeline_depth=1)
        fs = make_fabric(new_placement(), sync_migration=True)
        f1.replay(ospn, wr, blk)
        fs.replay(ospn, wr, blk)
        assert f1.state_identical(fs), \
            "depth-1 pipeline drifted from the synchronous driver"
        say(f"  verify-depth1: depth-1 pipeline == synchronous driver "
            f"(bit-identical; {fs.epochs_applied} epochs)")

    if args.check_parity and rank == 0:
        if (placement.overrides >= 0).any():
            say("parity check skipped: migration fired (re-run with "
                "--migration off for the exact contract)")
        else:
            _single_pool_parity(agg, leaves, cfg, policy, placement, rates,
                                content, (ospn, wr, blk), args, dev)
    if group is None:
        return fab
    if rank:
        return None
    return {"counters": per, "aggregate": agg, "delivered": delivered,
            "spill_stats": fab.spill_stats(), "sync_stats": ss,
            "device_times": fab.device_times()}


if __name__ == "__main__":
    main()
