"""The port's sharded fabric driver (``Fabric(shard_devices=D)``,
``fabric/shard.py``, ``common/sharding.py``) on gloo ranks on the CPU,
against the JAX package, case for case with tests/test_fabric_sharded.py.

Every sharded run here is D spawned processes (``sharding.spawn_ranks``,
one thread each, a ``file://`` rendezvous under ``tmp_path``, a time limit
that turns a stuck collective into a failure). One spawn a D runs both
fabrics (``shard.replay_specs``), and rank 0 returns the end state. The
oracle is the JAX package's vmap ``Fabric`` (the reference pins its own
sharded driver bit for bit to it; the JAX sharded one compiles too slowly
for tier-1):

  * spill on the saturating fixture (tests/test_fabric.py's 96 pages and
    96 C-chunks, every page on expander 0) widened to 4 expanders so D 4
    moves pages across ranks, against the JAX ``Fabric(sync_migration=
    True)``: moves, every leaf, the override table; I1-I5 on every
    expander; one fetch a boundary and fewer fetches than the port's
    pipelined driver; recorded on rank 0, with per-device tracks equal to
    ``device_times()`` at rtol 1e-9 (and the recording changed no leaf);
  * migration off, D in {1, 2, 4}, on the same pool and segments (the
    reference's 120-access mcf trace, pages spread 55/15/15/15): the JAX
    oracle runs a spill policy that never fires (watermark 0), which
    replays exactly as migration off and shares the spill fabric's one
    JAX compile. Every leaf of every expander and the counters ``==``;
    the port's one segment equals the sum of the oracle's one-window
    segments, its float32 times the oracle's last; one deferred drain
    fetch;
  * ``plan_on_device`` against the JAX ``plan_in_jit`` and the port's
    host planner on the reference's scripted views;
  * rejections, the block layout, and ``launch/fabric.py --devices 2
    --device cpu`` against the one-device synchronous run.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine.policy import POLICIES as JPOLICIES  # noqa: E402
from repro.fabric import placement as JPL  # noqa: E402
from repro.fabric import replay as JR  # noqa: E402
from repro.fabric import shard as JFS  # noqa: E402
from repro.simx.engine import pool_cfg_for as jpool_cfg_for  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common import sharding as SH  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core.engine import state as S  # noqa: E402
from repro_torch.core.engine.invariants import first_violation  # noqa: E402
from repro_torch.core.engine.policy import POLICIES  # noqa: E402
from repro_torch.fabric import migration as MG  # noqa: E402
from repro_torch.fabric import placement as PL  # noqa: E402
from repro_torch.fabric import replay as R  # noqa: E402
from repro_torch.fabric import shard as FS  # noqa: E402
from repro_torch.obs import Recorder  # noqa: E402
from repro_torch.obs import export as OBX  # noqa: E402
from repro_torch.simx.trace import (WORKLOADS, make_rates_table,  # noqa: E402
                                    make_trace)

JPOL, POL = JPOLICIES["ibex"], POLICIES["ibex"]
WINDOW = 8
N = 4
RANK_TIMEOUT = 240.0
# the saturating fixture's pool (spill: every page on expander 0, one write
# a page; migration off: pages spread)
JSAT = jpool_cfg_for(JPOL, n_pages=96, n_pchunks=16, n_cchunks=96)
REPLAY_W = [0.55, 0.15, 0.15, 0.15]
SAT_W = [1.0, 0.0, 0.0, 0.0]
SAT_RUN = dict(window=WINDOW, spill=True, spill_interval=WINDOW, spill_k=8,
               spill_low=40)
SAT_TRACE = (np.arange(40, dtype=np.int32), np.ones((40,), bool),
             np.zeros((40,), np.int32))


@pytest.fixture(scope="module", autouse=True)
def jax_segment_times():
    """Record the float32 times of every JAX segment fetch."""
    fetch = JR.Fabric._fetch_view

    def recording(self, times, stats, counters, recent):
        self.__dict__.setdefault("seg_times", []).append(
            np.asarray(jax.device_get(times)))
        return fetch(self, times, stats, counters, recent)

    JR.Fabric._fetch_view = recording
    yield
    JR.Fabric._fetch_view = fetch


def _replay_inputs():
    spec = WORKLOADS["mcf"]
    rates = make_rates_table(spec, JSAT.n_pages, seed=1)
    return rates, make_trace(spec, n_accesses=120, n_pages=JSAT.n_pages,
                             seed=1)


def _sat_rates():
    return np.full((JSAT.n_pages, JSAT.blocks_per_page), 2, np.int32)


def _specs():
    rates, trace = _replay_inputs()
    return [
        dict(cfg=dataclasses.asdict(JSAT), policy="ibex",
             placement=("WeightedInterleave", (N, JSAT.n_pages, REPLAY_W)),
             fabric=dict(seed=0, window=WINDOW, spill=False), rates=rates,
             trace=trace),
        dict(cfg=dataclasses.asdict(JSAT), policy="ibex",
             placement=("WeightedInterleave", (N, JSAT.n_pages, SAT_W)),
             fabric=dict(seed=0, **SAT_RUN), rates=_sat_rates(),
             trace=SAT_TRACE, obs=True)]


def _jax_runs():
    rates, trace = _replay_inputs()
    off = JR.Fabric(JSAT, JPOL, JPL.WeightedInterleave(N, JSAT.n_pages,
                                                       REPLAY_W),
                    seed=0, rates_table=jnp.asarray(rates),
                    sync_migration=True, **dict(SAT_RUN, spill_low=0))
    spill = JR.Fabric(JSAT, JPOL, JPL.WeightedInterleave(N, JSAT.n_pages,
                                                         SAT_W),
                      seed=0, rates_table=jnp.asarray(_sat_rates()),
                      sync_migration=True, **SAT_RUN)
    return off.replay(*trace), spill.replay(*SAT_TRACE)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({D: (migration-off record, spill record)}, the JAX migration-off
    oracle, the JAX spill oracle): the ranks (one spawn a D, in a thread)
    run while the JAX fabrics compile and replay here."""
    import concurrent.futures as cf

    def spawn_all():
        return {d: SH.spawn_ranks(
            FS.replay_specs, d, backend="gloo", args=(_specs(),),
            device="cpu", workdir=str(tmp_path_factory.mktemp(f"d{d}")),
            timeout=RANK_TIMEOUT)[0] for d in (1, 2, 4)}

    with cf.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_all)
        jax_off, jax_spill = _jax_runs()
        return ranks.result(), jax_off, jax_spill


@pytest.fixture(scope="module")
def sharded(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_replay(runs):
    assert runs[1].spill_stats()["events"] == 0
    return runs[1]


@pytest.fixture(scope="module")
def jax_spill(runs):
    return runs[2]


def _assert_leaves_equal(got: dict, jf):
    want = {k: np.asarray(v) for k, v in interop.leaves(jf.pools)}
    assert list(got) == list(want)
    bad = [k for k in want if got[k].dtype != want[k].dtype or
           not np.array_equal(got[k], want[k])]
    assert not bad, f"leaves differ: {bad}"


def _assert_times_equal(got, jf):
    want = [t.view(np.uint32) for t in jf.__dict__.get("seg_times", [])]
    got = [np.asarray(t, np.float32).view(np.uint32) for t in got]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# migration off: every leaf == the JAX vmap Fabric
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_shard_replay_bit_identical_to_vmap(sharded, jax_replay, n_devices):
    """Migration off: every leaf of every expander and the counters equal
    the JAX vmap driver's; the port's one segment (the whole trace) is the
    sum of the oracle's one-window segments and its float32 times the
    oracle's last; the run's bookkeeping drained in one deferred fetch."""
    rec = sharded[n_devices][0]
    jf = jax_replay
    _assert_leaves_equal(rec["leaves"], jf)
    assert rec["counters_by_expander"] == jf.counters_by_expander()
    assert rec["counters"] == jf.counters()
    ss = rec["sync_stats"]
    assert ss["drain_syncs"] == 1 and ss["boundary_syncs"] == 0
    assert ss["segment_syncs"] == 0 and ss["epoch_syncs"] == 0
    assert ss["segments"] == len(rec["segment_deltas"]) == 1
    assert jf.sync_stats()["segments"] > 1
    np.testing.assert_array_equal(rec["segment_deltas"][0],
                                  np.sum(jf.segment_deltas, axis=0))
    np.testing.assert_array_equal(
        np.asarray(rec["segment_times"][-1], np.float32).view(np.uint32),
        jf.__dict__["seg_times"][-1].view(np.uint32))
    np.testing.assert_array_equal(rec["delivered"], jf.delivered_time())
    np.testing.assert_array_equal(rec["delivered_f32"],
                                  jf.delivered_time(exact=False))
    assert rec["device_times"]["owners"].tolist() == \
        SH.device_of_expander(N, n_devices).tolist()


# ---------------------------------------------------------------------------
# spill: the collective apply == the JAX synchronous driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_collective_spill_parity_and_invariants(sharded, jax_spill,
                                                n_devices):
    """Migration live on the saturating fixture: the on-device plans and
    the collective apply land bit-identically to the JAX synchronous
    driver (moves, every leaf, the override table), with I1-I5 on every
    expander; one fetch a boundary, none a segment or an epoch."""
    rec = sharded[n_devices][1]
    jf = jax_spill
    js = jf.spill_stats()
    assert js["events"] > 0, "fixture no longer saturates"
    assert rec["spill_stats"]["events"] == js["events"]
    assert rec["spill_stats"]["pages_out"] == js["pages_out"]
    assert rec["spill_stats"]["pages_in"] == js["pages_in"]
    _assert_leaves_equal(rec["leaves"], jf)
    np.testing.assert_array_equal(rec["overrides"], jf.placement.overrides)
    assert rec["epoch"] == jf.placement.epoch
    assert rec["counters_by_expander"] == jf.counters_by_expander()
    assert [(i, o) for i, _, o in rec["migration_deltas"]] == \
        [(i, o) for i, _, o in jf.migration_deltas]
    for (_, a, _), (_, b, _) in zip(rec["migration_deltas"],
                                    jf.migration_deltas):
        np.testing.assert_array_equal(a, b)
    _assert_times_equal(rec["segment_times"], jf)
    for a, b in zip(rec["segment_deltas"], jf.segment_deltas):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rec["pipeline_times"]["sync_s"],
                                  jf.pipeline_times()["sync_s"])
    assert rec["pipeline_times"]["mode"] == "sync"
    cfg = PoolConfig(**dataclasses.asdict(JSAT))
    for e in range(N):
        one = {k: v[e] for k, v in rec["leaves"].items()}
        assert first_violation(one, cfg) is None, e
    ss = rec["sync_stats"]
    assert ss["boundary_syncs"] == ss["boundaries"] == ss["segments"]
    assert ss["segment_syncs"] == 0 and ss["epoch_syncs"] == 0
    assert ss["epochs"] == jf.sync_stats()["epochs"]
    assert ss["host_syncs"] < jf.sync_stats()["host_syncs"]
    assert rec["apply_syncs"] > 0


def test_sharded_beats_pipelined_sync_count(sharded):
    """The reference's acceptance comparison: on the same trace the sharded
    driver's fetches (one a boundary) are fewer than the port's pipelined
    driver's (one a segment plus one an epoch)."""
    pipe = R.Fabric(PoolConfig(**dataclasses.asdict(JSAT)), POL,
                    PL.WeightedInterleave(N, JSAT.n_pages, SAT_W), seed=0,
                    rates_table=_sat_rates(), device="cpu", **SAT_RUN)
    pipe.replay(*SAT_TRACE)
    assert pipe.epochs_applied > 0
    for d in (1, 2, 4):
        ss = sharded[d][1]["sync_stats"]
        assert ss["host_syncs"] == ss["boundaries"]
        assert ss["host_syncs"] < pipe.sync_stats()["host_syncs"]
        assert sharded[d][0]["sync_stats"]["host_syncs"] == 1


# ---------------------------------------------------------------------------
# per-device telemetry (rank 0 records)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_device_tracks_reconcile_device_times(sharded, jax_spill, n_devices):
    """Rank 0's recorder: per-device track totals equal ``device_times()``
    at rtol 1e-9, each device's track extent equals its total, a device's
    time bounds its expanders' delivered seconds, the trace validates, and
    the recorded run's leaves equal the JAX run's (recording changed no
    state)."""
    rec = sharded[n_devices][1]
    obs, dt = rec["obs"], rec["device_times"]
    assert obs["segments"] == rec["sync_stats"]["segments"]
    assert obs["epochs"] == rec["sync_stats"]["epochs"]
    tot = obs["device_totals"]
    assert np.allclose(tot["device_s"], dt["device_s"], rtol=1e-9, atol=0)
    assert (tot["owners"] == dt["owners"]).all()
    assert np.allclose(obs["track_totals"]["sync_s"],
                       rec["pipeline_times"]["sync_s"], rtol=1e-9)
    per = np.asarray(rec["pipeline_times"]["delivered_s"])
    for d in range(n_devices):
        assert dt["device_s"][d] >= per[dt["owners"] == d].max() - 1e-15
    assert not obs["trace_problems"]
    spans = obs["device_spans"]
    assert {tid for tid, _, _ in spans} == {1000 + d
                                            for d in range(n_devices)}
    for d in range(n_devices):
        ext = max(ts + dur for tid, ts, dur in spans if tid == 1000 + d)
        assert np.isclose(ext / 1e6, dt["device_s"][d], rtol=1e-9)
    _assert_leaves_equal(rec["leaves"], jax_spill)


def test_vmap_runs_emit_no_device_tracks():
    rec = Recorder()
    fab = R.Fabric(PoolConfig(**dataclasses.asdict(JSAT)), POL,
                   PL.WeightedInterleave(N, JSAT.n_pages, SAT_W), seed=0,
                   rates_table=_sat_rates(), device="cpu", obs=rec,
                   **SAT_RUN)
    fab.replay(*SAT_TRACE)
    assert fab.device_times() is None
    assert OBX.fabric_device_totals(rec) is None
    assert rec.fabric_info["shard_devices"] is None
    t = OBX.build_trace(rec)
    assert not any(e.get("tid", 0) >= 1000 for e in t["traceEvents"])


# ---------------------------------------------------------------------------
# the on-device planner against the JAX plan_in_jit and the host planner
# ---------------------------------------------------------------------------

def _view(free_units, free_singles, free_groups, eligible, referenced,
          delta, times, blocked=None, n_pages=32):
    n = len(free_units)
    return MG.SegmentView(
        free_units=np.asarray(free_units, np.int64),
        free_singles=np.asarray(free_singles, np.int64),
        free_groups=np.asarray(free_groups, np.int64),
        eligible=np.asarray(eligible, bool),
        referenced=np.asarray(referenced, bool),
        counters=np.zeros((n, S.NUM_COUNTERS), np.int64),
        delta=np.asarray(delta, np.int64),
        times=np.asarray(times, np.float64),
        recent=np.zeros((n_pages,), bool),
        blocked=np.zeros((n_pages,), bool) if blocked is None
        else np.asarray(blocked, bool))


def _plan_of(pages, srcs, dsts, urgent):
    pages = np.asarray(pages).reshape(-1)
    srcs = np.asarray(srcs).reshape(-1)
    dsts = np.asarray(dsts).reshape(-1)
    sel = pages >= 0
    if not sel.any():
        return None, bool(urgent)
    return MG.MigrationPlan(pages[sel].astype(np.int32),
                            srcs[sel].astype(np.int32),
                            dsts[sel].astype(np.int32)), bool(urgent)


def _device_plan(policy, view):
    t = torch.from_numpy
    out = FS.plan_on_device(
        FS.plan_params(policy), t(view.free_units).to(torch.int32),
        t(view.free_singles).to(torch.int32),
        t(view.free_groups).to(torch.int32), t(view.eligible),
        t(view.referenced), t(view.delta).to(torch.int32),
        t(view.times).to(torch.float32), t(view.blocked))
    assert out[0].shape == (FS.plan_rows(FS.plan_params(policy),
                                         view.n_expanders), policy.k)
    return _plan_of(*(x.numpy() for x in out))


def _jit_plan(policy, view):
    jpol = {"spill": JFS.MG.SpillPressure,
            "rebalance": JFS.MG.TrafficRebalance}[policy.name](
        **dataclasses.asdict(policy))
    out = JFS.plan_in_jit(
        JFS.plan_params(jpol), jnp.asarray(view.free_units),
        jnp.asarray(view.free_singles), jnp.asarray(view.free_groups),
        jnp.asarray(view.eligible), jnp.asarray(view.referenced),
        jnp.asarray(view.delta), jnp.asarray(view.times, jnp.float32),
        jnp.asarray(view.blocked))
    return _plan_of(*out)


def _assert_plans_equal(host_plan, got):
    plan, urgent = got
    if host_plan is None:
        assert plan is None and not urgent
        return
    assert plan is not None
    assert plan.pages.tolist() == host_plan.pages.tolist()
    assert plan.srcs.tolist() == host_plan.srcs.tolist()
    assert plan.dsts.tolist() == host_plan.dsts.tolist()
    assert urgent == host_plan.urgent


def _spill_view():
    n_pages = 32
    eligible = np.zeros((4, n_pages), bool)
    eligible[0, [2, 5, 9, 11]] = True       # 4 candidates, k=3 clips
    eligible[1, [1, 30]] = True
    eligible[3, [7]] = True                 # starved but the donor runs dry
    return MG.SpillPressure(k=3, low=16, proactive=1.5), _view(
        free_units=[10, 20, 200, 23], free_singles=[8, 8, 64, 8],
        free_groups=[2, 2, 16, 2], eligible=eligible,
        referenced=np.zeros_like(eligible),
        delta=np.zeros((4, S.NUM_COUNTERS)), times=[1.0] * 4,
        n_pages=n_pages)


def _blocked_view():
    n_pages = 16
    eligible = np.zeros((2, n_pages), bool)
    eligible[0, [3, 4]] = True
    blocked = np.zeros((n_pages,), bool)
    blocked[[3, 4]] = True                  # the livelock guard bars both
    return MG.SpillPressure(k=4, low=16, proactive=1.5), _view(
        free_units=[10, 200], free_singles=[4, 32], free_groups=[1, 8],
        eligible=eligible, referenced=np.zeros_like(eligible),
        delta=np.zeros((2, S.NUM_COUNTERS)), times=[1.0, 1.0],
        blocked=blocked, n_pages=n_pages)


def _rebalance_view():
    n_pages, n = 24, 3
    eligible = np.zeros((n, n_pages), bool)
    eligible[0, [1, 3, 5, 7, 9, 11]] = True
    referenced = np.zeros_like(eligible)
    referenced[0, [5, 9]] = True            # referenced pages move first
    delta = np.zeros((n, S.NUM_COUNTERS), np.int64)
    delta[0, S.C_HOST_RD] = 90              # hot: 90 of 100 accesses
    delta[1, S.C_HOST_RD] = 6
    delta[2, S.C_HOST_RD] = 4
    return MG.TrafficRebalance(k=4, low=8, proactive=1.5, trigger=1.5,
                               time_ratio=1.05), _view(
        free_units=[100, 60, 200], free_singles=[16, 16, 64],
        free_groups=[4, 4, 16], eligible=eligible, referenced=referenced,
        delta=delta, times=[4.0, 1.5, 1.0], n_pages=n_pages)


def _balanced_view():
    n_pages, n = 16, 2
    delta = np.zeros((n, S.NUM_COUNTERS), np.int64)
    delta[:, S.C_HOST_RD] = 50              # perfectly balanced
    return MG.TrafficRebalance(k=4, low=8), _view(
        free_units=[100, 100], free_singles=[16, 16], free_groups=[4, 4],
        eligible=np.ones((n, n_pages), bool),
        referenced=np.zeros((n, n_pages), bool), delta=delta,
        times=[1.0, 1.0], n_pages=n_pages)


@pytest.mark.parametrize("case", ["spill", "blocked", "rebalance",
                                  "balanced"])
def test_plan_on_device_matches_jit_and_host(case):
    """Multi-source spill with donor decrements (one source urgent, the
    conservative accounting making the donor ineligible for the third);
    the livelock guard barring every candidate (no plan); the traffic
    trigger with referenced-first order and claimed pages excluded; quiet
    when balanced. Pages, srcs, dsts, urgency and order equal the JAX
    ``plan_in_jit``'s and the host planner's."""
    policy, view = {"spill": _spill_view, "blocked": _blocked_view,
                    "rebalance": _rebalance_view,
                    "balanced": _balanced_view}[case]()
    host = policy.plan(view)
    if case == "spill":
        assert host is not None and host.urgent and len(host) > 3
    if case == "rebalance":
        assert host.pages.tolist() == [5, 9, 1, 3]
    if case in ("blocked", "balanced"):
        assert host is None
    _assert_plans_equal(host, _device_plan(policy, view))
    _assert_plans_equal(host, _jit_plan(policy, view))


# ---------------------------------------------------------------------------
# rejections and plumbing
# ---------------------------------------------------------------------------

def test_shard_devices_must_divide_expanders():
    cfg = PoolConfig(**dataclasses.asdict(JSAT))
    with pytest.raises(ValueError, match="not divisible"):
        R.Fabric(cfg, POL, PL.WeightedInterleave(3, cfg.n_pages,
                                                 [0.5, 0.25, 0.25]),
                 seed=0, shard_devices=2, device="cpu")


def test_plan_params_rejects_host_only_policies():
    with pytest.raises(ValueError, match="no on-device planner"):
        FS.plan_params(MG.NoMigration())
    assert FS.plan_params(MG.SpillPressure(k=8, low=40)) == \
        ("spill", 8, 40, MG.SpillPressure().proactive)
    assert FS.plan_rows(("rebalance",), 4) == 5


def test_device_of_expander_block_layout():
    assert SH.device_of_expander(8, 2).tolist() == [0, 0, 0, 0, 1, 1, 1, 1]
    assert SH.device_of_expander(4, 4).tolist() == [0, 1, 2, 3]
    assert SH.device_of_expander(4, 1).tolist() == [0, 0, 0, 0]
    group = SH.ExpanderGroup(1, 2, "cpu")
    assert list(group.owned(8)) == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        group.owned(3)


def test_launcher_devices_equals_the_synchronous_run(capfd, tmp_path):
    """``launch/fabric.py --devices 2 --device cpu`` (two gloo ranks it
    spawns itself) prints the mesh and ownership lines and gives the
    one-device synchronous run's counters, spill and delivered times."""
    from repro_torch.launch import fabric as LF
    argv = ["--workload", "mcf", "--expanders", "4", "--skew", "0.8",
            "--migration", "rebalance", "--device", "cpu",
            "--accesses", "2048", "--pages", "256"]
    got = LF.main(argv + ["--devices", "2"])
    out = capfd.readouterr().out
    assert "mesh: 2 device(s) (gloo ranks), axis 'expander', 4 expanders" \
        in out
    assert "device 1 (cpu): expanders [2, 3]" in out
    ref = LF.main(argv + ["--sync-migration"])
    assert ref.epochs_applied > 0
    assert got["counters"] == ref.counters_by_expander()
    assert got["spill_stats"]["pages_out"] == \
        ref.spill_stats()["pages_out"]
    np.testing.assert_array_equal(got["delivered"], ref.delivered_time())
    assert got["sync_stats"]["boundary_syncs"] == \
        got["sync_stats"]["boundaries"]
