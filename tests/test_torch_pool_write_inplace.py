"""The §4.1.2 in-place write path (``ops._write_inplace``) against the
reference: a population whose pages 9, 11, 13 and 15 are all raw, so the
clock demotes them into 8-chunk groups (not promoted), then a trace of 96
block writes to those pages mixed into an mcf trace that leaves them
alone. Each page reaches ``wr_thresh`` (16) writes and tries to
recompress: ``recompress_retry > 0`` in both packages, every pool leaf
identical, I1-I4 hold. The final counters then go through
``simx.engine._finalize`` in both packages, so the time model's
``recompress_retry`` term is held on a non-zero value."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import engine as JE  # noqa: E402
from repro.core.engine import batch as JB  # noqa: E402
from repro.simx import engine as JSE  # noqa: E402
from repro.simx import time as JTM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as TE  # noqa: E402
from repro_torch.core.engine import batch as TB  # noqa: E402
from repro_torch.core.engine.invariants import check_pool_invariants  # noqa: E402
from repro_torch.simx import engine as SE  # noqa: E402
from repro_torch.simx import time as TM  # noqa: E402
from repro_torch.simx import trace as TT  # noqa: E402
from test_torch_pool import (N_WRITTEN, SEED, _assert_same, _base,  # noqa: E402
                             _jax_arrays, _jax_write, _port_cfg, _port_write)

from helpers import check_pool_invariants as jax_invariants  # noqa: E402

RAW = [9, 11, 13, 15]      # pages the population demotes (8..19)
N_RAW_WRITES = 96
CFG = _base(lossless=True)


def _inputs():
    rates = TT.make_rates_table(TT.WORKLOADS["mcf"], N_WRITTEN, 4, SEED)
    rates[RAW] = 3
    pages = TT.make_block_content(rates, CFG.vals_per_block, SEED) \
        .reshape(N_WRITTEN, CFG.vals_per_page)
    o, w, b = TT.make_trace(TT.WORKLOADS["mcf"], n_accesses=128,
                            n_pages=N_WRITTEN, seed=SEED)
    keep = ~np.isin(o, RAW)
    rng = np.random.default_rng(SEED)
    o = np.concatenate([o[keep], rng.choice(RAW, N_RAW_WRITES)])
    w = np.concatenate([w[keep], np.ones(N_RAW_WRITES, bool)])
    b = np.concatenate([b[keep], rng.integers(0, 4, N_RAW_WRITES)])
    assert np.bincount(o[o >= 0], minlength=N_WRITTEN)[RAW].min() >= \
        CFG.wr_thresh
    perm = rng.permutation(o.size)
    return pages, (o[perm].astype(np.int32), w[perm], b[perm].astype(np.int32))


def _raw_pages_grouped(arrays):
    w0 = arrays["meta"][RAW, 0].astype(np.int64)
    return bool((((w0 >> 30) & 1) == 0).all() and
                (((w0 >> 20) & 0xF) == 8).all())


def test_write_inplace_matches_reference():
    pages, (o, w, b) = _inputs()
    jpol, pol, tcfg = JE.POLICIES["ibex"], TE.POLICIES["ibex"], _port_cfg(CFG)
    jpool = _jax_write(JE.make_pool(CFG, seed=SEED), CFG, jpol, pages)
    pool = _port_write(TE.make_pool(tcfg, seed=SEED, device="cpu"), tcfg,
                       pol, pages)
    written = _jax_arrays(jpool)
    _assert_same(written, interop.pool_to_numpy(pool), "population")
    assert _raw_pages_grouped(written)

    jpool = JB.replay_trace(jpool, CFG, jpol, o, w, b)
    TB.replay_trace(pool, tcfg, pol, o, w, b)
    end = interop.pool_to_numpy(pool)
    _assert_same(_jax_arrays(jpool), end, "replay")
    jax_invariants(jpool, CFG)
    check_pool_invariants(end, tcfg)
    c, jc = TE.counters_dict(pool), JE.counters_dict(jpool)
    assert c == jc and c["recompress_retry"] > 0, c

    # the time model's recompress_retry term, on the run's counters
    ratio = TE.compression_ratio(pool, tcfg)
    assert ratio == float(JE.compression_ratio(jpool, CFG))
    for name in ("default", "slow_engine"):
        got = SE._finalize(c, TM.DEVICE_PROFILES[name], ratio)
        want = JSE._finalize(jc, JTM.DEVICE_PROFILES[name], ratio)
        assert got == want and got["recompress_retry"] > 0
    # on the slow engine the compression engine bounds the time, so the
    # retries are priced: without them the cell would be faster
    slow = TM.DEVICE_PROFILES["slow_engine"]
    assert SE._finalize(dict(c, recompress_retry=0), slow, ratio)["time_s"] \
        < SE._finalize(c, slow, ratio)["time_s"]
