"""The port's serving engines on REDUCED minicpm3 (MLA: the compressed
latent cache) against the reference's, in float32 (so that the argmax has
margin), with the reference serving tests' configuration
(``max_running=2, hot_window=16, attn_chunk=32``), 4- and 8-bit latent
codes, ``max_len=128``, and params carried across from the reference's
``init_params(PRNGKey(0))``: five requests through two lanes (preemption,
resume, shadowed re-preemption), generations token for token and the whole
counters dict (``preempt_bytes`` included) equal to the reference
engine's of the same kind; and the parked payload of a demoted lane (the
latent lane flush's codes) equal to the reference's ``_demote_lane_impl``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro.serve.engine import Engine as JEngine
from repro.serve.serial import SerialEngine as JSerialEngine
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.serve import DONE, Engine, SerialEngine
from repro_torch.serve import engine as tengine

JCFG = dataclasses.replace(jget_reduced("minicpm3_4b"), dtype="float32")
CFG = dataclasses.replace(get_reduced("minicpm3_4b"), dtype="float32")
MAX_LEN = 128
LENGTHS = (16, 12, 32, 20, 16)


def _jscfg(bits: int) -> JServeConfig:
    return JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                        kv_rate_bits=bits)


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jax.random.PRNGKey(0), JCFG)[0]


@pytest.fixture(scope="module")
def params(jparams):
    return interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")


def _prompt(seed, n=20):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, CFG.vocab_size, size=n)]


def _serve(eng):
    rids = [eng.submit(_prompt(i, n), max_new_tokens=6)
            for i, n in enumerate(LENGTHS)]
    eng.run_until_done(max_steps=400)
    assert all(eng.requests[r].state == DONE for r in rids)
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def reference(jparams):
    out = {}
    for bits in (4, 8):
        for name, cls in (("batched", JEngine), ("serial", JSerialEngine)):
            eng = cls(JCFG, _jscfg(bits), jparams, max_len=MAX_LEN)
            out[bits, name] = (_serve(eng), dict(eng.counters))
    return out


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", ["batched", "serial"])
def test_mla_engine_matches_reference(reference, params, name, bits):
    """Generations token for token and the whole counters dict against the
    reference's engine of the same kind; both kinds generate the reference
    batched engine's tokens; the host syncs are the counted ones."""
    cls = {"batched": Engine, "serial": SerialEngine}[name]
    want, want_counters = reference[bits, name]
    eng = cls(CFG, ServeConfig.from_reference(_jscfg(bits)), params,
              max_len=MAX_LEN, device="cpu")
    assert set(eng.cache) == {"lat_codes", "lat_scales", "lat_hot",
                              "cold_len"}
    contracts.SYNCS.reset()
    got = _serve(eng)
    assert got == want == reference[bits, "batched"][0]
    assert eng.counters == want_counters
    c = eng.counters
    assert c["demotions"] >= 1 and c["preempt_bytes"] > 0
    assert contracts.SYNCS.count == c["step_syncs"] + c["admit_syncs"]


@pytest.mark.parametrize("bits", [4, 8])
def test_demoted_lane_payload_matches_reference(params, bits):
    """A lane demotion's device half on a served lane (the latent lane
    flush) writes the reference ``_demote_lane_impl``'s codes, scales and
    cold_len bit for bit, and the engine parks only those (no ring)."""
    scfg = ServeConfig.from_reference(_jscfg(bits))
    eng = Engine(CFG, scfg, params, max_len=MAX_LEN, device="cpu")
    eng.submit(_prompt(7, 24), max_new_tokens=12)
    for _ in range(5):
        eng.step()
    pos = eng.requests[0].pos
    lane = {k: v.clone() for k, v in tengine._lane_slice(eng.cache, 0)
            .items()}
    ref = jengine._demote_lane_impl(
        {k: jnp.asarray(v) for k, v in interop.cache_to_numpy(lane).items()},
        pos, scfg=_jscfg(bits))
    got = tengine._demote_lane_impl(lane, pos, scfg=scfg)
    for k in ("lat_codes", "lat_scales", "cold_len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    eng._preempt(0)
    assert set(eng.requests[0].parked) == {"lat_codes", "lat_scales",
                                           "cold_len"}
    R = CFG.mla.kv_lora_rank + CFG.mla.qk_rope_head_dim
    assert eng.counters["preempt_bytes"] == \
        CFG.num_layers * pos * (R * bits // 8 + 4)
