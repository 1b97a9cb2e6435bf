"""Fabric-aware serving (``ServeConfig.n_expanders > 1``) against the
reference: lanes striped across expanders, parked payloads charged to
their lane's expander, victim selection balancing the parked load
(``SecondChanceLanes`` with groups). REDUCED llama3-8b in float32, the
reference serving test's configuration with two expanders
(tests/test_fabric.py::test_serve_engine_parks_per_expander), params
carried across from the reference's ``init_params(PRNGKey(0))``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.core.engine.policy import SecondChanceLanes as JSecondChanceLanes
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro_torch import interop
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.core.engine.policy import SecondChanceLanes
from repro_torch.serve import DONE, Engine

JCFG = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
CFG = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
JSCFG = JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                     kv_rate_bits=8, n_expanders=2)
SCFG = ServeConfig.from_reference(JSCFG)
MAX_LEN = 128


def _serve(eng):
    rng = np.random.default_rng(0)
    rids = [eng.submit([int(t) for t in rng.integers(1, CFG.vocab_size,
                                                     12 + 2 * i)], 6)
            for i in range(5)]
    eng.run_until_done(max_steps=500)
    assert all(eng.requests[r].state == DONE for r in rids)
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def engines():
    jparams = JT.init_params(jax.random.PRNGKey(0), JCFG)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    jeng = JEngine(JCFG, JSCFG, jparams, max_len=MAX_LEN)
    eng = Engine(CFG, SCFG, params, max_len=MAX_LEN, device="cpu")
    return (jeng, _serve(jeng)), (eng, _serve(eng))


def test_two_expander_engine_matches_reference(engines):
    """Generations token for token, the whole counters dict, the lanes'
    expanders and every per-expander stat equal the reference's; parked
    bytes reconcile with the totals and both expanders took parks."""
    (jeng, want), (eng, got) = engines
    assert got == want
    assert eng.counters == jeng.counters
    assert list(eng.lane_expander) == list(jeng.lane_expander) == [0, 1]
    assert set(eng.expander_stats) == set(jeng.expander_stats)
    for k, v in jeng.expander_stats.items():
        np.testing.assert_array_equal(eng.expander_stats[k], np.asarray(v))
    st = eng.expander_stats
    assert int(st["preempt_bytes"].sum()) == eng.counters["preempt_bytes"]
    assert int(st["resume_bytes"].sum()) == eng.counters["resume_bytes"]
    assert eng.counters["demotions"] >= 2
    assert (st["preempt_bytes"] > 0).all()
    assert int(st["parked"].sum()) == 0


def test_second_chance_lanes_group_balancing_matches_reference():
    """The sweep with groups takes the candidate on the least-loaded
    expander (clearing the swept reference bits), without groups the plain
    clock: victims, hands and bits equal the reference's over seeded
    sweeps, and the reference test's two fixed cases."""
    sel, jsel = SecondChanceLanes(4), JSecondChanceLanes(4)
    occupied = np.array([True, True, True, True])
    ref = np.array([False, False, False, False])
    groups, load = np.array([0, 1, 0, 1]), np.array([5, 0])
    assert sel.select_mask(occupied, ref, groups=groups,
                           group_load=load)[0] == 1
    assert SecondChanceLanes(4).select_mask(occupied, ref)[0] == 0

    rng = np.random.default_rng(3)
    sel, jsel = SecondChanceLanes(6), JSecondChanceLanes(6)
    for i in range(200):
        occ = rng.random(6) < 0.7
        refd = rng.random(6) < 0.5
        kw = {} if i % 3 == 0 else dict(groups=np.arange(6) % 3,
                                        group_load=rng.integers(0, 4, 3))
        v, r = sel.select_mask(occ, refd, **kw)
        jv, jr = jsel.select_mask(occ, refd, **kw)
        assert v == jv and sel.hand == jsel.hand
        np.testing.assert_array_equal(r, np.asarray(jr))
