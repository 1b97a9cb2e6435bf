"""The port's multi-expander fabric (``repro_torch.fabric``) against the
JAX package's, payload-less, at the reference tests' sizes
(tests/test_fabric.py's 64-page pool, 16 promoted P-chunks, window 8).

Every fabric here runs two expanders in segments of 8 windows with a
migration policy attached (one JAX compile of the segment replay serves
the whole file; a spill that never fires changes nothing but the stats
the segment computes). Held exactly (``==``): every leaf of every
expander, the override table, counters, spill and sync stats, segment
and migration deltas, float64 delivered times; the float32 segment times
bit for bit. Also here: the stack helpers, the masked window replay with
a pending mask, the placements, the rebalance pipeline at depth 2, 1 and
synchronous, and the numpy-only placement and migration modules.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import state as JS  # noqa: E402
from repro.core.engine.policy import POLICIES as JPOLICIES  # noqa: E402
from repro.fabric import migration as JMG  # noqa: E402
from repro.fabric import placement as JPL  # noqa: E402
from repro.fabric import replay as JR  # noqa: E402
from repro.simx import time as JTM  # noqa: E402
from repro.simx.engine import pool_cfg_for as jpool_cfg_for  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core.engine import batch as B  # noqa: E402
from repro_torch.core.engine import state as S  # noqa: E402
from repro_torch.core.engine.invariants import first_violation  # noqa: E402
from repro_torch.core.engine.policy import POLICIES  # noqa: E402
from repro_torch.fabric import migration as MG  # noqa: E402
from repro_torch.fabric import ops as fops  # noqa: E402
from repro_torch.fabric import placement as PL  # noqa: E402
from repro_torch.fabric import replay as R  # noqa: E402
from repro_torch.simx import time as TM  # noqa: E402
from repro_torch.simx.trace import (WORKLOADS, make_rates_table,  # noqa: E402
                                    make_trace)

JPOL, POL = JPOLICIES["ibex"], POLICIES["ibex"]
WINDOW = 8
SEGMENT = 8 * WINDOW          # spill_interval: segments of 8 windows
JCFG = jpool_cfg_for(JPOL, n_pages=64, n_pchunks=16, n_cchunks=2 * 64 * 8)
CFG = PoolConfig(**dataclasses.asdict(JCFG))
N = 2


@pytest.fixture(scope="module", autouse=True)
def jax_segment_times():
    """Record the float32 times of every JAX segment fetch on the fabric
    (the reference keeps only the last)."""
    fetch = JR.Fabric._fetch_view

    def recording(self, times, stats, counters, recent):
        self.__dict__.setdefault("seg_times", []).append(
            np.asarray(jax.device_get(times)))
        return fetch(self, times, stats, counters, recent)

    JR.Fabric._fetch_view = recording
    yield
    JR.Fabric._fetch_view = fetch


def _trace(n_accesses, seed, wl="mcf"):
    spec = WORKLOADS[wl]
    rates = make_rates_table(spec, CFG.n_pages, seed=seed)
    return rates, make_trace(spec, n_accesses=n_accesses,
                             n_pages=CFG.n_pages, seed=seed)


def _pair(placement, rates, devices=None, **kw):
    """The same fabric on both packages (placements built by name)."""
    kind, args = placement
    jf = JR.Fabric(JCFG, JPOL, getattr(JPL, kind)(*args), seed=0,
                   rates_table=jnp.asarray(rates), window=WINDOW,
                   devices=None if devices is None else
                   [JTM.DEVICE_PROFILES[d] for d in devices], **kw)
    tf = R.Fabric(CFG, POL, getattr(PL, kind)(*args), seed=0,
                  rates_table=rates, window=WINDOW,
                  devices=None if devices is None else
                  [TM.DEVICE_PROFILES[d] for d in devices], device="cpu",
                  **kw)
    return jf, tf


def _jleaves(pools):
    return {k: np.asarray(v) for k, v in interop.leaves(pools)}


def assert_same_fabric(jf, tf):
    """Every observable of the two fabrics equal (module docstring)."""
    ja, ta = _jleaves(jf.pools), interop.pool_stack_to_numpy(tf.pools)
    assert list(ja) == list(ta)
    bad = [k for k in ja if ja[k].dtype != ta[k].dtype or
           not np.array_equal(ja[k], ta[k])]
    assert not bad, f"leaves differ: {bad}"
    np.testing.assert_array_equal(tf.placement.overrides,
                                  jf.placement.overrides)
    assert tf.placement.epoch == jf.placement.epoch
    assert tf.counters() == jf.counters()
    assert tf.counters_by_expander() == jf.counters_by_expander()
    assert tf.spill_stats() == jf.spill_stats()
    assert tf.sync_stats() == jf.sync_stats()
    ss = tf.sync_stats()
    assert ss["segment_syncs"] == ss["segments"]
    assert ss["epoch_syncs"] == ss["epochs"]
    assert len(tf.segment_deltas) == len(jf.segment_deltas)
    for a, b in zip(tf.segment_deltas, jf.segment_deltas):
        np.testing.assert_array_equal(a, b)
    assert [(i, o) for i, _, o in tf.migration_deltas] == \
        [(i, o) for i, _, o in jf.migration_deltas]
    for (_, a, _), (_, b, _) in zip(tf.migration_deltas, jf.migration_deltas):
        np.testing.assert_array_equal(a, b)
    # float32 segment times, bit for bit
    want = [t.view(np.uint32) for t in jf.__dict__.get("seg_times", [])]
    got = [np.asarray(t, np.float32).view(np.uint32)
           for t in tf.segment_times]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tf.delivered_time(), jf.delivered_time())
    np.testing.assert_array_equal(
        tf.delivered_time(exact=False).view(np.uint64),
        jf.delivered_time(exact=False).view(np.uint64))
    assert tf.park_capacity().tolist() == jf.park_capacity().tolist()
    pt, pj = tf.pipeline_times(), jf.pipeline_times()
    assert pt["mode"] == pj["mode"]
    for k in ("overlapped_s", "sync_s", "delivered_s"):
        np.testing.assert_array_equal(pt[k], pj[k])


def _no_violation(tf):
    for e in range(tf.n_expanders):
        assert first_violation(interop.pool_to_numpy(tf.pool(e)), tf.cfg) \
            is None, e


# -- the stack -----------------------------------------------------------------

def test_pool_stack_matches_reference_and_slices_alias_it():
    """``make_pool_stack`` equals the reference's leaf for leaf (per-expander
    keys ``fold_in(key(seed), e)``); a slice is a view, so in-place updates
    through it reach the stack; ``pool_unslice`` copies a pool in; the
    stacked counter readers match the reference's; and interop carries a
    stack across both ways."""
    rates, _ = _trace(16, seed=3)
    js = JS.make_pool_stack(JCFG, 3, seed=5, rates_table=jnp.asarray(rates))
    ts = S.make_pool_stack(CFG, 3, seed=5, rates_table=rates, device="cpu")
    ja, ta = _jleaves(js), interop.pool_stack_to_numpy(ts)
    assert not [k for k in ja if not np.array_equal(ja[k], ta[k])]

    p1 = S.pool_slice(ts, 1)
    S.bump(p1.counters, S.C_HOST_RD, 7)
    p1.meta[3, 0] = 123
    p1.cfree.top.fill_(9)
    p1.rng[0] = 11
    assert int(ts.counters[1, S.C_HOST_RD]) == 7
    assert int(ts.meta[1, 3, 0]) == 123 and int(ts.cfree.top[1]) == 9
    assert int(ts.rng[1, 0]) == 11
    assert int(ts.counters[0, S.C_HOST_RD]) == 0
    S.pool_unslice(ts, 2, p1)
    assert int(ts.meta[2, 3, 0]) == 123 and int(ts.cfree.top[2]) == 9

    ctrs = np.random.default_rng(0).integers(
        0, 1000, (3, S.NUM_COUNTERS)).astype(np.int32)
    js = js._replace(counters=jnp.asarray(ctrs))
    ts.counters.copy_(torch.from_numpy(ctrs))
    assert S.stacked_counters_dict(ts) == JS.stacked_counters_dict(js)
    assert S.per_expander_counters(ts) == JS.per_expander_counters(js)
    np.testing.assert_array_equal(S.stacked_counters(ts).numpy(),
                                  np.asarray(JS.stacked_counters(js)))

    back = interop.pool_stack_from_numpy(_jleaves(js), CFG, device="cpu")
    got = interop.pool_stack_to_numpy(back)
    assert not [k for k, a in _jleaves(js).items()
                if not np.array_equal(a, got[k])]
    with pytest.raises(ValueError, match="stack"):
        interop.pool_stack_from_numpy(
            interop.pool_to_numpy(S.pool_slice(back, 0)), CFG, device="cpu")


def test_replay_windows_masked_matches_reference_with_pending():
    """One segment of padded windows on two expanders with a non-empty
    pending mask: the port's ``_replay_windows_masked`` on each slice
    against the reference's vmapped segment replay (``_replay_stacked``),
    leaf for leaf, with its float32 times (bitwise) and migration stats.
    Without the mask, each expander's pool equals an unpadded
    ``replay_trace`` of its prefix."""
    rates, (o, w, b) = _trace(80, seed=2)    # 63 and 17 accesses
    pl = PL.StaticInterleave(N, CFG.n_pages)
    po, pw, pb, pv, eids = R.partition_trace(pl, o, w, b, WINDOW)
    assert po.shape == (N, 8, WINDOW) and not pv.all()
    pend = np.zeros((CFG.n_pages,), bool)
    pend[np.unique(o)[:6]] = True          # hot pages: masked accesses
    assert (pend[po] & pv).any()

    js = JS.make_pool_stack(JCFG, N, seed=0, rates_table=jnp.asarray(rates))
    lanes = JTM.stack_devices([JTM.DeviceConfig()] * N)
    js, jt, jst = JR._replay_stacked(
        js, JCFG, JPOL, jnp.asarray(po), jnp.asarray(pw), jnp.asarray(pb),
        jnp.asarray(pv), lanes, jnp.asarray(pend), True)
    ts = S.make_pool_stack(CFG, N, seed=0, rates_table=rates, device="cpu")
    for e in range(N):
        B._replay_windows_masked(S.pool_slice(ts, e), CFG, POL, po[e], pw[e],
                                 pb[e], pv[e], pend)
    ja, ta = _jleaves(js), interop.pool_stack_to_numpy(ts)
    assert not [k for k in ja if not np.array_equal(ja[k], ta[k])]
    tt = TM.exec_time_vec(ts.counters, TM.stack_devices(
        [TM.DeviceConfig()] * N, device="cpu"))
    np.testing.assert_array_equal(tt.numpy().view(np.uint32),
                                  np.asarray(jt).view(np.uint32))
    st = fops.segment_stats(ts, CFG)
    for f in fops.SegmentStats._fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)))

    # no mask: bit-identical to the unpadded single-pool replay
    ts = S.make_pool_stack(CFG, N, seed=0, rates_table=rates, device="cpu")
    ref = S.make_pool_stack(CFG, N, seed=0, rates_table=rates, device="cpu")
    for e in range(N):
        B._replay_windows_masked(S.pool_slice(ts, e), CFG, POL, po[e], pw[e],
                                 pb[e], pv[e])
        sel = eids == e
        B.replay_trace(S.pool_slice(ref, e), CFG, POL, o[sel], w[sel],
                       b[sel], window=WINDOW)
    assert S.tree_map(torch.equal, ts, ref) == S.tree_map(lambda a: True, ts)


# -- parity without migration ----------------------------------------------------

def test_single_expander_fabric_matches_single_pool():
    """One expander equals one pool: the port's N=1 fabric ends leaf for
    leaf as ``replay_trace`` of the trace on a single pool; and with all
    pages placed on expander 0 of a two-expander fabric, the port equals
    the JAX fabric and expander 0 equals that single pool."""
    rates, (o, w, b) = _trace(90, seed=0)
    one = R.Fabric(CFG, POL, PL.StaticInterleave(1, CFG.n_pages), seed=0,
                   rates_table=rates, window=WINDOW, spill=False,
                   device="cpu").replay(o, w, b)
    pool = S.pool_slice(S.make_pool_stack(CFG, 1, seed=0, rates_table=rates,
                                          device="cpu"), 0)
    B.replay_trace(pool, CFG, POL, o, w, b, window=WINDOW)
    a, p = interop.pool_to_numpy(one.pool(0)), interop.pool_to_numpy(pool)
    assert not [k for k in a if not np.array_equal(a[k], p[k])]
    assert one.counters() == S.counters_dict(pool)
    assert one.sync_stats()["segment_syncs"] == 1

    jf, tf = _pair(("WeightedInterleave", (N, CFG.n_pages, [1.0, 0.0])),
                   rates, migration="spill", spill_interval=SEGMENT)
    jf.replay(o, w, b)
    tf.replay(o, w, b)
    assert_same_fabric(jf, tf)
    e0 = interop.pool_to_numpy(tf.pool(0))
    skip = ("rng",)       # expander 0's key is fold_in(key(0), 0)
    assert not [k for k in p if k not in skip and
                not np.array_equal(p[k], e0[k])]


@pytest.mark.parametrize("placement", ["StaticInterleave", "LocalityAffinity",
                                       "CapacityAware"])
def test_counter_sum_parity_per_shard_matches_reference(placement):
    """Each placement: the port's fabric equals the JAX fabric in every
    observable, each expander's counters equal its partition replayed
    through the single-pool ``replay_trace`` from the same starting state,
    the sums equal the fabric's, and I1-I4 hold on every expander. The
    interleave case runs a mixed fleet (gen5 + gen4), so each expander's
    delivered time is priced by its own device."""
    rates, (o, w, b) = _trace(120, seed=1)
    devices = ["default", "gen4"] if placement == "StaticInterleave" else None
    jf, tf = _pair((placement, (N, CFG.n_pages)), rates, devices=devices,
                   migration="spill", spill_interval=SEGMENT)
    jf.replay(o, w, b)
    tf.replay(o, w, b)
    assert tf.spill_stats()["events"] == 0
    assert_same_fabric(jf, tf)
    eids = tf.placement.route(o)
    stack0 = S.make_pool_stack(CFG, N, seed=0, rates_table=rates,
                               device="cpu")
    total = {k: 0 for k in S.COUNTER_NAMES}
    for e in range(N):
        sel = eids == e
        ref = B.replay_trace(S.pool_slice(stack0, e), CFG, POL, o[sel],
                             w[sel], b[sel], window=WINDOW)
        ce = S.counters_dict(ref)
        assert tf.counters_by_expander()[e] == ce
        total = {k: total[k] + v for k, v in ce.items()}
    assert tf.counters() == total
    _no_violation(tf)
    if devices:
        per = tf.delivered_time()
        assert per[1] > 0 and per.shape == (N,)


# -- migration on the 64-page pool ------------------------------------------------

def _rebalance(rates, trace, **kw):
    jf, tf = _pair(("WeightedInterleave", (N, CFG.n_pages, [0.8, 0.2])),
                   rates, migration="rebalance", spill_interval=SEGMENT, **kw)
    jf.replay(*trace)
    tf.replay(*trace)
    return jf, tf


@pytest.fixture(scope="module")
def rebalance_runs():
    rates, trace = _trace(512, seed=7)
    return {name: _rebalance(rates, trace, **kw) for name, kw in (
        ("depth2", {}), ("depth1", dict(pipeline_depth=1)),
        ("sync", dict(sync_migration=True)))}


@pytest.mark.parametrize("name", ["depth2", "depth1", "sync"])
def test_rebalance_matches_reference(rebalance_runs, name):
    """The traffic-imbalance trigger on a 0.8-skewed trace, whose decision
    compares the float32 segment times (``TrafficRebalance.plan``): the
    port equals the JAX fabric in every observable, at depth 2
    (overlapped epochs, deferred accesses), depth 1 and synchronously; the
    segment times bit for bit; I1-I4 hold on both expanders."""
    jf, tf = rebalance_runs[name]
    assert tf.epochs_applied > 0 and tf.spill_pages_out[0] > 0
    assert_same_fabric(jf, tf)
    _no_violation(tf)
    pt = tf.pipeline_times()
    assert (pt["overlapped_s"] <= pt["sync_s"]).all()
    if name == "depth2":
        assert pt["mode"] == "overlapped"
        assert any(over for _, _, over in tf.migration_deltas)


def test_depth1_equals_sync_and_overlap_is_cheaper(rebalance_runs):
    """Depth 1 plans and applies at the same boundary: bit-identical to the
    synchronous driver (``state_identical``), as in the reference."""
    _, d1 = rebalance_runs["depth1"]
    _, sync = rebalance_runs["sync"]
    assert d1.state_identical(sync)
    assert d1.spill_stats() == sync.spill_stats()
    assert not rebalance_runs["depth2"][1].state_identical(sync)


# -- the numpy-only modules -------------------------------------------------------

@pytest.mark.parametrize("kind", ["interleave", "capacity", "locality",
                                  "weighted"])
def test_placement_module_matches_reference(kind):
    """Routing, overrides and epochs of every placement against the
    reference on seeded page streams."""
    rng = np.random.default_rng(11)
    kw = dict(weights=[0.5, 0.2, 0.2, 0.1]) if kind == "weighted" else {}
    jp = JPL.make_placement(kind, 4, 300, **kw)
    tp = PL.make_placement(kind, 4, 300, **kw)
    for _ in range(3):
        ospns = rng.integers(0, 300, 200)
        np.testing.assert_array_equal(tp.route(ospns), jp.route(ospns))
        np.testing.assert_array_equal(tp.assign(ospns), jp.assign(ospns))
        pages = rng.choice(300, 10, replace=False)
        dests = rng.integers(0, 4, 10).astype(np.int32)
        jp.apply_epoch(pages, dests)
        tp.apply_epoch(pages, dests)
        tp.override(pages[:2], 3)
        jp.override(pages[:2], 3)
    np.testing.assert_array_equal(tp.overrides, jp.overrides)
    assert tp.epoch == jp.epoch
    with pytest.raises(ValueError):
        PL.make_placement("nope", 2, 8)


def _view(mod, rng, n=4, p=64):
    free = rng.integers(0, 400, n)
    delta = rng.integers(0, 50, (n, S.NUM_COUNTERS))
    return mod.SegmentView(
        free_units=free, free_singles=free - rng.integers(0, 8, n),
        free_groups=rng.integers(0, 4, n), eligible=rng.random((n, p)) < 0.6,
        referenced=rng.random((n, p)) < 0.4, counters=delta * 3,
        delta=delta, times=rng.random(n) * 1e-4,
        recent=rng.random(p) < 0.1, blocked=rng.random(p) < 0.1)


@pytest.mark.parametrize("mode", ["spill", "rebalance", "off"])
def test_migration_module_matches_reference(mode):
    """Every policy's plans against the reference's on seeded views
    (pressure, imbalance, barred and recent pages, donor margins)."""
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    tpol = MG.make_migration_policy(mode, k=6, low=60)
    jpol = JMG.make_migration_policy(mode, k=6, low=60)
    planned = 0
    for _ in range(40):
        tv, jv = _view(MG, rng_t), _view(JMG, rng_j)
        a, b = tpol.plan(tv), jpol.plan(jv)
        assert (a is None) == (b is None)
        if a is not None:
            planned += 1
            for f in ("pages", "srcs", "dsts"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.urgent == b.urgent and a.pairs() == b.pairs()
        np.testing.assert_array_equal(tv.donor_ok(), jv.donor_ok())
    assert planned > 0 or mode == "off"
    with pytest.raises(ValueError):
        MG.make_migration_policy("nope")
