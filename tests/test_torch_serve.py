"""The port's serving engines against the reference's on REDUCED llama3-8b
in float32 (so that the argmax has margin), with the reference serving
tests' configuration (``max_running=2, hot_window=16, attn_chunk=32,
kv_rate_bits=8``, ``max_len=128``) and params carried across from the
reference's ``init_params(PRNGKey(0))``.

The reference engine runs at its default ``quantize_impl`` ("auto": on the
CPU that is the jnp ``quantize_blocks``, the function the port's B3
computes). It is never built with ``quantize_impl="kernel"``: a jitted lane
demotion crashes there (reference fault C4,
``tests/test_torch_qpack_fixed.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.serial import SerialEngine as JSerialEngine
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.models import decode as TD
from repro_torch.serve import DONE, Engine, SerialEngine

JCFG = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
CFG = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
JSCFG = JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                     kv_rate_bits=8)
SCFG = ServeConfig.from_reference(JSCFG)
MAX_LEN = 128
LENGTHS = (16, 12, 32, 20, 16)


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
    for name, cls in (("batched", JEngine), ("serial", JSerialEngine)):
        eng = cls(JCFG, JSCFG, jparams, max_len=MAX_LEN)
        out[name] = (_serve(eng), dict(eng.counters))
    return out


@pytest.mark.parametrize("name,engine_cls", [("batched", Engine),
                                             ("serial", SerialEngine)])
def test_engine_matches_reference(reference, params, name, engine_cls):
    """Generations token for token and the whole counters dict, across
    mixed prompt lengths (buckets 16 and 32) and preemptions (5 requests
    through 2 lanes), against the reference's engine of the same kind; and
    both kinds generate the reference batched engine's tokens."""
    want, want_counters = reference[name]
    eng = engine_cls(CFG, SCFG, params, max_len=MAX_LEN, device="cpu")
    contracts.SYNCS.reset()
    got = _serve(eng)
    assert got == want == reference["batched"][0]
    assert eng.counters == want_counters
    c = eng.counters
    assert c["demotions"] >= 1
    assert contracts.SYNCS.count == c["step_syncs"] + c["admit_syncs"]
    if engine_cls is Engine:
        contracts.verify_sync_counters(Engine.step, c["steps"],
                                       c["step_syncs"])


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "deepseek_7b",
                                  "chameleon_34b", "musicgen_medium"])
def test_dense_mha_engine_matches_reference(arch):
    """The dense MHA configs (Hq = Hkv, group 1) and the frontend backbones
    (chameleon-34b GQA, musicgen-medium MHA; both engines feed the
    frontend stub zero embeddings) on the same dense path: the batched
    engine's generations and counters equal to the reference engine's,
    with preemption."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype="float32")
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    if cfg.frontend == "none":
        assert cfg.num_heads == cfg.num_kv_heads
    else:
        assert cfg.family in ("vlm", "audio")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    p = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    ref = JEngine(jcfg, JSCFG, jp, max_len=MAX_LEN)
    want = _serve(ref)
    eng = Engine(cfg, SCFG, p, max_len=MAX_LEN, device="cpu")
    assert _serve(eng) == want
    assert eng.counters == dict(ref.counters)
    assert eng.counters["demotions"] >= 1


def test_shadow_repreempt_moves_zero_bytes(params):
    """§4.5 at request granularity: re-preempting an untouched resumed
    request moves zero bytes; after two new tokens a preempt moves only
    their compressed payload."""
    scfg1 = dataclasses.replace(SCFG, max_running=1)
    eng = Engine(CFG, scfg1, params, max_len=MAX_LEN, device="cpu")
    rid = eng.submit(_prompt(3), max_new_tokens=12)
    for _ in range(3):
        eng.step()
    req = eng.requests[rid]
    pos0 = req.pos
    eng._preempt(0)
    first = eng.counters["preempt_bytes"]
    assert first > 0
    eng.queue.remove(rid)
    eng.lane_req[0] = rid
    eng._resume(req, 0)
    eng._preempt(0)                       # untouched since resume
    assert eng.counters["preempt_bytes"] == first
    assert eng.counters["shadow_repreempts"] == 1
    eng.queue.remove(rid)
    eng.lane_req[0] = rid
    eng._resume(req, 0)
    eng.step()
    eng.step()
    assert req.shadow_pos == req.pos - 2
    eng._preempt(0)
    per_tok = first // pos0
    assert first == per_tok * pos0
    assert eng.counters["preempt_bytes"] - first == 2 * per_tok


def test_padded_prefill_matches_exact(params):
    """A prompt right-padded into a length bucket gives the same logits (to
    f32 rounding: a 12-row and a 32-row product may be blocked differently
    on the CPU) and cold_len as the exact prefill, and decodes to the same
    tokens."""
    S, Lb = 12, 32
    prompt = torch.tensor([_prompt(9, n=S)], dtype=torch.int32)
    lg_e, c_e = TD.prefill(params, {"tokens": prompt}, CFG, SCFG, MAX_LEN)
    padded = torch.zeros((1, Lb), dtype=torch.int32)
    padded[0, :S] = prompt[0]
    lg_p, c_p = TD.prefill(params, {"tokens": padded}, CFG, SCFG, MAX_LEN,
                           lens=torch.tensor([S]))
    torch.testing.assert_close(lg_e, lg_p, atol=1e-5, rtol=1e-5)
    assert torch.equal(c_e["cold_len"], c_p["cold_len"])

    def decode(cache, tok0):
        toks, t, p = [], torch.tensor([tok0], dtype=torch.int32), \
            torch.tensor([S], dtype=torch.int32)
        for _ in range(6):
            lg, cache = TD.decode_step(params, cache, t, p, CFG, SCFG)
            t = lg.argmax(dim=-1).to(torch.int32)
            p = p + 1
            toks.append(int(t[0]))
        return toks

    t0 = int(lg_e[0].argmax())
    assert decode(c_e, t0) == decode(c_p, t0)
