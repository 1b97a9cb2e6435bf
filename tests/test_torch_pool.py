"""The port's payload pool against the reference, end to end: make_pool,
a host_write_page population, then replay_trace of a seeded trace. Every
pool leaf (metadata and activity words, freelists, cache, counters, PRNG
key, both payload stores) must be bit-identical after the run."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common.types import PoolConfig as JConfig  # noqa: E402
from repro.core import engine as JE  # noqa: E402
from repro.core.engine import batch as JB  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.engine import batch as TB  # noqa: E402
from repro_torch.core.engine.invariants import check_pool_invariants  # noqa: E402
from repro_torch.simx import trace as TT  # noqa: E402

from helpers import check_pool_invariants as jax_invariants  # noqa: E402

SEED = 5
N_WRITTEN = 36          # 36 pages over 24 P-chunks: population demotes
N_ACCESSES = 256


def _base(**kw) -> JConfig:
    return JConfig(n_pages=48, n_cchunks=384, n_pchunks=24, mcache_sets=4,
                   mcache_ways=4, demote_watermark=4, store_payload=True, **kw)


def _for_policy(cfg: JConfig, name: str) -> JConfig:
    pol = JE.POLICIES[name]
    return dataclasses.replace(cfg, coloc=pol.coloc, shadow=pol.shadow,
                               compact=pol.compact,
                               zero_elision=pol.zero_elision)


CONFIGS = {
    "ibex_fused_on": ("ibex", _base(lossless=True, fused_demote="on")),
    "ibex_fused_off": ("ibex", _base(lossless=True, fused_demote="off")),
    "tmcc": ("tmcc", _for_policy(_base(), "tmcc")),
    # payload-less (the simx mode: sizes from the content model), batched
    # demotion, the serial engine's demotion cadence
    "ibex_access_cadence_no_payload": ("ibex", dataclasses.replace(
        _base(demote_cadence="access", fused_demote="on"),
        store_payload=False)),
}


def _port_cfg(cfg: JConfig) -> PoolConfig:
    return PoolConfig(**dataclasses.asdict(cfg))


def _inputs(cfg: JConfig):
    nb = cfg.blocks_per_page
    rates = TT.make_rates_table(TT.WORKLOADS["mcf"], N_WRITTEN, nb, SEED)
    pages = TT.make_block_content(rates, cfg.vals_per_block, SEED) \
        .reshape(N_WRITTEN, cfg.vals_per_page)
    trace = TT.make_trace(TT.WORKLOADS["mcf"], n_accesses=N_ACCESSES,
                          n_pages=cfg.n_pages, seed=SEED)
    return pages, trace


def _content_model(cfg: JConfig):
    """The rates table a payload-less pool sizes its pages by."""
    if cfg.store_payload:
        return None
    return TT.make_rates_table(TT.WORKLOADS["mcf"], cfg.n_pages,
                               cfg.blocks_per_page, SEED)


def _jax_write(pool, cfg, pol, pages):
    for i, x in enumerate(pages):
        pool = JE.host_write_page(pool, cfg, pol, jnp.asarray(i),
                                  jnp.asarray(x).astype(jnp.bfloat16))
    return pool


def _port_write(pool, cfg, pol, pages):
    for i, x in enumerate(pages):
        TE.host_write_page(pool, cfg, pol, i,
                           torch.from_numpy(x).to(torch.bfloat16))
    return pool


def _jax_arrays(pool) -> dict:
    return {k: np.asarray(v) for k, v in interop.leaves(pool)}


def _assert_same(ref: dict, got: dict, what: str):
    assert list(ref) == list(got), (list(ref), list(got))
    for k in ref:
        assert ref[k].dtype == got[k].dtype, (what, k, ref[k].dtype, got[k].dtype)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{what}: {k}")


@functools.lru_cache(maxsize=None)
def reference(key: str) -> dict:
    """One JAX run per config, shared by every test that asks for it:
    arrays after population, after half the trace and after all of it."""
    name, cfg = CONFIGS[key]
    pol = JE.POLICIES[name]
    pages, (o, w, b) = _inputs(cfg)
    pool = _jax_write(JE.make_pool(cfg, seed=SEED,
                                   rates_table=_content_model(cfg)),
                      cfg, pol, pages)
    written = _jax_arrays(pool)
    half = N_ACCESSES // 2
    mid = JB.replay_trace(pool, cfg, pol, o[:half], w[:half], b[:half])
    end = JB.replay_trace(mid, cfg, pol, o[half:], w[half:], b[half:])
    jax_invariants(end, cfg)
    return {"written": written, "mid": _jax_arrays(mid),
            "end": _jax_arrays(end), "pool": end}


def _port_run(key):
    name, cfg = CONFIGS[key]
    tcfg, pol = _port_cfg(cfg), TE.POLICIES[name]
    pages, (o, w, b) = _inputs(cfg)
    pool = _port_write(TE.make_pool(tcfg, seed=SEED,
                                    rates_table=_content_model(cfg),
                                    device="cpu"), tcfg, pol, pages)
    written = interop.pool_to_numpy(pool)
    half = N_ACCESSES // 2
    TB.replay_trace(pool, tcfg, pol, o[:half], w[:half], b[:half])
    TB.replay_trace(pool, tcfg, pol, o[half:], w[half:], b[half:])
    return tcfg, written, pool


def check_slice(key: str) -> dict:
    """The port's run of config ``key`` against the reference's, leaf for
    leaf after population and after replay; returns the final counters."""
    ref = reference(key)
    tcfg, written, pool = _port_run(key)
    _assert_same(ref["written"], written, f"{key} population")
    end = interop.pool_to_numpy(pool)
    _assert_same(ref["end"], end, f"{key} replay")
    check_pool_invariants(end, tcfg)
    c = TE.counters_dict(pool)
    assert c["demotions_dirty"] > 0 and c["promotions"] > 0, c
    return c


def check_interop_mid_run(key: str) -> None:
    """Start the port from the reference pool taken mid-run and replay the
    second half of the trace: the port ends where the reference ends."""
    name, cfg = CONFIGS[key]
    tcfg, pol = _port_cfg(cfg), TE.POLICIES[name]
    mid = reference(key)["mid"]
    pool = interop.pool_from_numpy(mid, tcfg, device="cpu")
    _assert_same(mid, interop.pool_to_numpy(pool), f"{key} round trip")
    _, (o, w, b) = _inputs(cfg)
    half = N_ACCESSES // 2
    TB.replay_trace(pool, tcfg, pol, o[half:], w[half:], b[half:])
    _assert_same(reference(key)["end"], interop.pool_to_numpy(pool),
                 f"{key} resumed")


# The ibex configs run here; tmcc and the payload-less config run in
# test_torch_pool_schemes.py, so the two files' JAX compiles land on
# different test workers.
IBEX = ["ibex_fused_on", "ibex_fused_off"]


@pytest.mark.parametrize("key", IBEX)
def test_slice_bit_identical(key):
    check_slice(key)


def test_random_fallback_exercised():
    # the clock's Gumbel-argmax fallback ran (and matched, above)
    fb = [int(reference(k)["end"]["counters"][JE.state.C_RANDOM_FB])
          for k in IBEX]
    assert max(fb) > 0, fb


def test_all_rates_reach_the_pool():
    # the lossless population stores zero, 4-bit, 8-bit and raw blocks
    meta = reference("ibex_fused_on")["written"]["meta"]
    bt = [(meta[:, 0] >> (5 * i)) & 3 for i in range(4)]
    sz = [(meta[:, 0] >> (5 * i + 2)) & 7 for i in range(4)]
    valid = (meta[:, 0] >> 31) & 1 == 1
    seen = set()
    for t, s in zip(bt, sz):
        seen |= set(zip(t[valid].tolist(), s[valid].tolist()))
    # (type, sz): zero (0,0), 4-bit (1,2), 8-bit (1,4), raw (3,7)
    assert {(0, 0), (1, 2), (1, 4), (3, 7)} <= seen, seen


def test_interop_round_trip_mid_run():
    check_interop_mid_run("ibex_fused_on")


def test_read_back_is_exact_and_matches_reference():
    """host_read_block after a lossless population returns each block's
    written content in both packages (I5), promoting compressed pages."""
    name, cfg = CONFIGS["ibex_fused_on"]
    tcfg, pol = _port_cfg(cfg), TE.POLICIES[name]
    jpol = JE.POLICIES[name]
    pages, _ = _inputs(cfg)
    jpool = _jax_write(JE.make_pool(cfg, seed=SEED), cfg, jpol, pages)
    tpool = _port_write(TE.make_pool(tcfg, seed=SEED, device="cpu"), tcfg,
                        pol, pages)
    rng = np.random.default_rng(SEED)
    for _ in range(12):
        o, blk = int(rng.integers(N_WRITTEN)), int(rng.integers(4))
        jpool, jv = JE.host_read_block(jpool, cfg, jpol, jnp.asarray(o),
                                       jnp.asarray(blk))
        _, tv = TE.host_read_block(tpool, tcfg, pol, o, blk)
        want = pages[o].reshape(4, -1)[blk]
        np.testing.assert_array_equal(tv.to(torch.float32).numpy(), want)
        np.testing.assert_array_equal(np.asarray(jv, np.float32), want)
    _assert_same(_jax_arrays(jpool), interop.pool_to_numpy(tpool), "reads")
    assert TE.counters_dict(tpool)["promotions"] > 0


def test_stale_zero_block_after_write_matches_reference():
    """ROADMAP queue C1, a fault of the reference that the port keeps: a
    block write to a page whose cold blocks are all ZERO materializes none
    of them, yet types every block hot, so those blocks read whatever the
    P-chunk held before. Find such a block with the port, then read it
    through both packages: same stale values, not the zeros written."""
    name, cfg = CONFIGS["ibex_fused_on"]
    tcfg, pol, jpol = _port_cfg(cfg), TE.POLICIES[name], JE.POLICIES[name]
    pages, (o, w, b) = _inputs(cfg)
    written = set(zip(o[w].tolist(), b[w].tolist()))
    pool = interop.pool_from_numpy(reference("ibex_fused_on")["end"], tcfg,
                                   device="cpu")
    stale = None
    for p, blk in sorted(written):
        probe = interop.pool_from_numpy(interop.pool_to_numpy(pool), tcfg,
                                        device="cpu")
        _, v = TE.host_read_block(probe, tcfg, pol, p, blk)
        if v.abs().sum() > 0:
            stale = (p, blk, v)
            break
    assert stale is not None, "no stale block: the C1 case left the trace"
    p, blk, v = stale
    _, jv = JE.host_read_block(reference("ibex_fused_on")["pool"], cfg, jpol,
                               jnp.asarray(p), jnp.asarray(blk))
    np.testing.assert_array_equal(v.to(torch.float32).numpy(),
                                  np.asarray(jv, np.float32))


def test_trace_copy_matches_reference():
    from repro.simx import trace as JT
    for wl in ("mcf", "lbm", "xsbench"):
        a = JT.make_trace(JT.WORKLOADS[wl], n_accesses=500, n_pages=64, seed=3)
        b = TT.make_trace(TT.WORKLOADS[wl], n_accesses=500, n_pages=64, seed=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(
            JT.make_rates_table(JT.WORKLOADS[wl], 64, 4, 3),
            TT.make_rates_table(TT.WORKLOADS[wl], 64, 4, 3))
    assert JT.WORKLOADS == {k: JT.WorkloadSpec(*dataclasses.astuple(v))
                            for k, v in TT.WORKLOADS.items()}
