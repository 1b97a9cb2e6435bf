"""Cross-expander migration of the port's fabric against the JAX package's,
on the reference tests' saturating pool (tests/test_fabric.py: 96 pages,
16 promoted P-chunks, 96 C-chunks, every page placed on expander 0, a
segment of one window of 8), and the payload-carrying fabric, which only
the port has.

Against the JAX ``Fabric`` (``==`` on every leaf of every expander, the
override table, spill and sync stats, segment and migration deltas and
delivered times; the float32 segment times bit for bit): skewed spill at
depth 2 with urgent epochs, depth 1 and the synchronous driver, deferred
in-flight accesses at depth 2, an unappliable plan that must not livelock,
and pricing that keeps urgent epochs on the critical path. One JAX compile
of the segment replay serves the file.

Port only, with payload (``store_payload=True, lossless=True``): with
migration off, every expander's leaves, the stores included, equal its
partition written and replayed through the single-pool engine; with spill
live, every migrated page's compressed bytes and metadata travel intact
and I1-I4 hold on both expanders after every epoch.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine.policy import POLICIES as JPOLICIES  # noqa: E402
from repro.fabric import migration as JMG  # noqa: E402
from repro.fabric import placement as JPL  # noqa: E402
from repro.fabric import replay as JR  # noqa: E402
from repro.simx.engine import pool_cfg_for as jpool_cfg_for  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.types import PoolConfig, replace  # noqa: E402
from repro_torch.core.engine import batch as B  # noqa: E402
from repro_torch.core.engine import ops as E  # noqa: E402
from repro_torch.core.engine import state as S  # noqa: E402
from repro_torch.core.engine.invariants import first_violation  # noqa: E402
from repro_torch.core.engine.policy import POLICIES  # noqa: E402
from repro_torch.core import metadata as md  # noqa: E402
from repro_torch.fabric import migration as MG  # noqa: E402
from repro_torch.fabric import ops as fops  # noqa: E402
from repro_torch.fabric import placement as PL  # noqa: E402
from repro_torch.fabric import replay as R  # noqa: E402
from repro_torch.simx.trace import (WORKLOADS, make_block_content,  # noqa: E402
                                    make_rates_table, make_trace)

from test_torch_fabric import assert_same_fabric  # noqa: E402

JPOL, POL = JPOLICIES["ibex"], POLICIES["ibex"]
WINDOW = 8
N_PAGES = 96
JCFG = jpool_cfg_for(JPOL, n_pages=N_PAGES, n_pchunks=16, n_cchunks=96)
CFG = PoolConfig(**dataclasses.asdict(JCFG))


@pytest.fixture(scope="module", autouse=True)
def jax_segment_times():
    fetch = JR.Fabric._fetch_view

    def recording(self, times, stats, counters, recent):
        self.__dict__.setdefault("seg_times", []).append(
            np.asarray(jax.device_get(times)))
        return fetch(self, times, stats, counters, recent)

    JR.Fabric._fetch_view = recording
    yield
    JR.Fabric._fetch_view = fetch


def _rates(rate: int) -> np.ndarray:
    return np.full((N_PAGES, CFG.blocks_per_page), rate, np.int32)


def _pair(migration, rate=2, **kw):
    """The same saturating two-expander fabric on both packages: every
    page on expander 0, segments of one window."""
    kw = dict(dict(spill_interval=WINDOW), **kw)
    jf = JR.Fabric(JCFG, JPOL, JPL.WeightedInterleave(2, N_PAGES, [1.0, 0.0]),
                   seed=0, rates_table=jnp.asarray(_rates(rate)),
                   window=WINDOW, migration=migration, **kw)
    tf = R.Fabric(CFG, POL, PL.WeightedInterleave(2, N_PAGES, [1.0, 0.0]),
                  seed=0, rates_table=_rates(rate), window=WINDOW,
                  migration=migration, device="cpu", **kw)
    return jf, tf


SAT = dict(spill_k=8, spill_low=40)
# one first-touch write per used page: 40 pages of 5 chunks each against
# 80 single chunks, so the spill path must carry the overflow
SAT_TRACE = (np.arange(40, dtype=np.int32), np.ones((40,), bool),
             np.zeros((40,), np.int32))


def _no_violation(tf):
    for e in range(tf.n_expanders):
        assert first_violation(interop.pool_to_numpy(tf.pool(e)), tf.cfg) \
            is None, e


@pytest.mark.parametrize("driver", ["depth2", "depth1", "sync"])
def test_skewed_spill_matches_reference(driver):
    """Freelist exhaustion on expander 0 under all-on-one placement: the
    spill path fires, the port equals the JAX fabric in every observable
    (leaf for leaf across both expanders, the override table, spill
    stats, segment and migration deltas), I1-I4 hold on both expanders,
    migration is charged where it happens (demotion reads on the source,
    demotion writes on the donor, which sees no host access), and a
    migrated page's later accesses follow it to the donor."""
    kw = {"depth2": {}, "depth1": dict(pipeline_depth=1),
          "sync": dict(sync_migration=True)}[driver]
    jf, tf = _pair("spill", **SAT, **kw)
    jf.replay(*SAT_TRACE)
    tf.replay(*SAT_TRACE)
    st = tf.spill_stats()
    assert st["events"] > 0 and st["pages_out"][0] > 0
    assert (tf.placement.overrides >= 0).sum() == st["pages_out"][0]
    assert_same_fabric(jf, tf)
    _no_violation(tf)
    c0, c1 = tf.counters_by_expander()
    assert c0["host_writes"] == 40 and c1["host_writes"] == 0
    assert c0["demo_rd"] > 0 and c1["demo_wr"] > 0
    dev = tf.devices[1]
    internal1 = sum(c1[k] for k in S.TRAFFIC_NAMES)
    assert tf.delivered_time()[1] == internal1 * 64 / (dev.channels *
                                                       dev.ch_bw)
    if driver == "depth2":
        moved = np.nonzero(tf.placement.overrides >= 0)[0]
        tail = (np.full((WINDOW,), moved[0], np.int32),
                np.zeros((WINDOW,), bool), np.zeros((WINDOW,), np.int32))
        jf.replay(*tail)
        tf.replay(*tail)
        assert tf.counters_by_expander()[1]["host_reads"] == WINDOW
        assert_same_fabric(jf, tf)
        _no_violation(tf)


def test_depth1_pipeline_bit_identical_to_sync():
    """Depth 1 (plan and apply at the same boundary) ends bit-identical to
    the synchronous driver on a config where migration fires."""
    _, d1 = _pair("spill", pipeline_depth=1, **SAT)
    _, sync = _pair("spill", sync_migration=True, **SAT)
    d1.replay(*SAT_TRACE)
    sync.replay(*SAT_TRACE)
    assert sync.spill_stats()["events"] > 0
    assert d1.state_identical(sync)
    assert d1.counters() == sync.counters()
    assert d1.spill_stats() == sync.spill_stats()


def test_urgent_epochs_priced_on_the_critical_path():
    """``proactive=1.0``: every pressure plan is urgent and applies at its
    boundary, so the overlapped and synchronous pricings coincide, on
    both packages alike."""
    jf, tf = _pair("spill", **SAT)
    jf.migration_policy = JMG.SpillPressure(k=8, low=40, proactive=1.0)
    tf.migration_policy = MG.SpillPressure(k=8, low=40, proactive=1.0)
    jf.replay(*SAT_TRACE)
    tf.replay(*SAT_TRACE)
    assert tf.epochs_applied > 0
    assert_same_fabric(jf, tf)
    pt = tf.pipeline_times()
    assert pt["mode"] == "overlapped"
    assert (pt["overlapped_s"] == pt["sync_s"]).all()


class _Scripted:
    """A policy that plans a fixed page set when armed, once or always,
    built for both packages from one script."""

    def __init__(self, mod, pages=None, once=True):
        self.mod, self.pages, self.once, self.armed = mod, pages, once, False
        self.name = "scripted"

    def plan(self, view):
        if not self.armed or self.pages is None:
            return None
        if self.once:
            self.armed = False
        k = len(self.pages)
        return self.mod.MigrationPlan(np.asarray(self.pages, np.int32),
                                      np.zeros((k,), np.int32),
                                      np.ones((k,), np.int32))


def _scripted_pair(once, pages=None, rate=1):
    jp, tp = _Scripted(JMG, pages, once), _Scripted(MG, pages, once)
    jf = JR.Fabric(JCFG, JPOL, JPL.WeightedInterleave(2, N_PAGES, [1.0, 0.0]),
                   seed=0, rates_table=jnp.asarray(_rates(rate)),
                   window=WINDOW, migration=jp, spill_interval=WINDOW)
    tf = R.Fabric(CFG, POL, PL.WeightedInterleave(2, N_PAGES, [1.0, 0.0]),
                  seed=0, rates_table=_rates(rate), window=WINDOW,
                  migration=tp, spill_interval=WINDOW, device="cpu")
    return (jf, jp), (tf, tp)


def test_overlapped_migration_defers_inflight_accesses():
    """Depth 2: accesses to pages whose plan is in flight are masked by
    the pending mask and replayed after the epoch commits, on the pages'
    final home; the port equals the JAX fabric through it all."""
    (jf, jp), (tf, tp) = _scripted_pair(once=True)
    warm = (np.arange(24, dtype=np.int32), np.ones((24,), bool),
            np.zeros((24,), np.int32))
    jf.replay(*warm)
    tf.replay(*warm)
    eligible = np.nonzero(fops.segment_stats(tf.pool(0), CFG)
                          .eligible.numpy())[0]
    assert len(eligible) >= 4, "warm phase left no eligible pages"
    pages = eligible[:4]
    for p in (jp, tp):
        p.pages, p.armed = pages, True
    filler1 = np.arange(24, 32, dtype=np.int32)
    reads = np.concatenate([pages, pages]).astype(np.int32)
    filler2 = np.arange(32, 40, dtype=np.int32)
    ospn = np.concatenate([filler1, reads, filler2])
    wr = np.concatenate([np.ones(8, bool), np.zeros(8, bool),
                         np.ones(8, bool)])
    blk = np.zeros((24,), np.int32)
    jf.replay(ospn, wr, blk)
    tf.replay(ospn, wr, blk)
    assert (tf.placement.route(pages) == 1).all(), "pages did not migrate"
    c0, c1 = tf.counters_by_expander()
    assert c1["host_reads"] == len(reads) and c0["host_reads"] == 0
    assert c0["host_writes"] == 40 and c1["host_writes"] == 0
    assert any(over for _, _, over in tf.migration_deltas)
    assert_same_fabric(jf, tf)
    _no_violation(tf)
    assert tf.sync_stats()["epoch_syncs"] == tf.sync_stats()["epochs"] == 1


def test_unappliable_plan_does_not_livelock():
    """A plan the apply refuses every time (the page is promoted, so
    ineligible) while the trace keeps reading it: the livelock guard bars
    the page, the replay ends, the reads are served on the source; the
    port equals the JAX fabric."""
    (jf, jp), (tf, tp) = _scripted_pair(once=False, pages=[0], rate=2)
    warm = (np.arange(4, dtype=np.int32), np.ones((4,), bool),
            np.zeros((4,), np.int32))
    jf.replay(*warm)
    tf.replay(*warm)
    jp.armed = tp.armed = True
    reads = np.concatenate([np.arange(8, 16, dtype=np.int32),
                            np.zeros((16,), np.int32)])
    tr = (reads, np.zeros((24,), bool), np.zeros((24,), np.int32))
    jf.replay(*tr)
    tf.replay(*tr)
    c0, c1 = tf.counters_by_expander()
    assert c0["host_reads"] == 24 and c1["host_reads"] == 0
    assert tf.spill_stats()["pages_out"] == [0, 0]
    assert tf._blocked[0] and (tf.placement.overrides == -1).all()
    assert_same_fabric(jf, tf)


# -- the payload fabric (port only) ----------------------------------------------

PCFG = replace(PoolConfig(n_pages=128, n_pchunks=16, n_cchunks=512,
                          mcache_sets=4, mcache_ways=8),
               store_payload=True, lossless=True)


def _payload_inputs(n_pages, n_accesses, seed=0):
    spec = WORKLOADS["mcf"]
    rates = make_rates_table(spec, n_pages, PCFG.blocks_per_page, seed)
    pages = torch.from_numpy(
        make_block_content(rates, PCFG.vals_per_block, seed)
        .reshape(n_pages, PCFG.vals_per_page)).to(torch.bfloat16)
    return rates, pages, make_trace(spec, n_accesses=n_accesses,
                                    n_pages=n_pages, seed=seed)


def test_payload_fabric_equals_single_pool_partitions():
    """Migration off, payload on: every expander's leaves, ``c_store`` and
    ``p_store`` included, equal its pages written through
    ``host_write_page`` and its partition replayed through
    ``replay_trace`` on a single pool from the same starting state."""
    rates, pages, (o, w, b) = _payload_inputs(PCFG.n_pages, 512)
    placement = PL.StaticInterleave(3, PCFG.n_pages)
    fab = R.Fabric(PCFG, POL, placement, rates_table=rates, window=WINDOW,
                   spill=False, device="cpu")
    fab.write_pages(np.arange(PCFG.n_pages), pages).replay(o, w, b)
    ref = S.make_pool_stack(PCFG, 3, rates_table=rates, device="cpu")
    homes, eids = placement.route(np.arange(PCFG.n_pages)), placement.route(o)
    for e in range(3):
        pool = S.pool_slice(ref, e)
        for p in np.nonzero(homes == e)[0].tolist():
            E.host_write_page(pool, PCFG, POL, p, pages[p])
        sel = eids == e
        B.replay_trace(pool, PCFG, POL, o[sel], w[sel], b[sel],
                       window=WINDOW)
    a, r = interop.pool_stack_to_numpy(fab.pools), \
        interop.pool_stack_to_numpy(ref)
    assert not [k for k in a if not np.array_equal(a[k], r[k])]
    assert int(ref.c_store.count_nonzero()) > 0
    assert fab.sync_stats()["segment_syncs"] == 2      # writes, replay


def test_payload_spill_moves_pages_intact():
    """Spill live with payload: every page a committed epoch moved arrives
    with its compressed bytes and its metadata entry (pointers aside)
    unchanged, and I1-I4 hold on both expanders after every epoch."""
    rates, pages, (o, w, b) = _payload_inputs(PCFG.n_pages, 256, seed=1)
    before = {}
    apply = fops.apply_migrations

    def snapshot(pools, cfg, policy, pg, srcs, dsts):
        for p, s in zip(pg.tolist(), srcs.tolist()):
            src = S.pool_slice(pools, s)
            entry = E._entry(src, p)
            before[p] = (entry, E._gather_page_buf(src, cfg, entry).clone())
        return apply(pools, cfg, policy, pg, srcs, dsts)

    checked = []

    def on_epoch(fab, plan, moved):
        for e in range(fab.n_expanders):
            assert first_violation(interop.pool_to_numpy(fab.pool(e)),
                                   fab.cfg) is None
        dsts = dict(zip(plan.pages.tolist(), plan.dsts.tolist()))
        for p in moved.tolist():
            entry, buf = before[p]
            dst = fab.pool(dsts[p])
            got = E._entry(dst, p)
            assert got[0] == entry[0]
            n = md.get_num_chunks(entry[0])
            assert torch.equal(E._gather_page_buf(dst, fab.cfg, got)
                               .reshape(-1, 512)[:n],
                               buf.reshape(-1, 512)[:n])
            checked.append(p)

    fops.apply_migrations = snapshot
    try:
        fab = R.Fabric(PCFG, POL, PL.WeightedInterleave(2, PCFG.n_pages,
                                                        [0.9, 0.1]),
                       rates_table=rates, window=WINDOW, spill_interval=16,
                       spill_k=16, spill_low=128, on_epoch=on_epoch,
                       device="cpu")
        fab.write_pages(np.arange(PCFG.n_pages), pages).replay(o, w, b)
    finally:
        fops.apply_migrations = apply
    assert fab.epochs_applied >= 2 and len(checked) > 0
    ss = fab.sync_stats()
    assert ss["segment_syncs"] == ss["segments"]
    assert ss["epoch_syncs"] == ss["epochs"]


def test_spill_pages_matches_reference():
    """The reference's older spill API: up to ``k`` eligible pages in OSPN order
    from one pool to another, each behind the donor's margin check; the
    port's on expander 0 and 1 of a spilled fabric's state equals the
    reference's on the same state carried across (moved pages and every
    leaf of both pools)."""
    from repro.core.engine import state as JS
    from repro.fabric import ops as jfops
    _, tf = _pair("spill", **SAT)
    tf.replay(*SAT_TRACE)
    like = jax.tree_util.tree_structure(JS.make_pool(JCFG))

    def to_jax(pool):
        return jax.tree_util.tree_unflatten(like, [
            jnp.asarray(a) for a in interop.pool_to_numpy(pool).values()])

    js, jd, jmoved = jfops.spill_pages(to_jax(tf.pool(0)), to_jax(tf.pool(1)),
                                       JCFG, JPOL, 4)
    moved = fops.spill_pages(tf.pool(0), tf.pool(1), CFG, POL, 4)
    np.testing.assert_array_equal(moved, np.asarray(jmoved))
    assert (moved >= 0).sum() > 0
    for jp, e in ((js, 0), (jd, 1)):
        got = interop.pool_to_numpy(tf.pool(e))
        assert not [k for k, v in interop.leaves(jp)
                    if not np.array_equal(np.asarray(v), got[k])]
