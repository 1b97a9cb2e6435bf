"""The port's hybrid family (zamba2-2.7b) served against the reference on
REDUCED zamba2-2.7b (4 Mamba2 layers in 2 groups, 2 shared attention
blocks, d 128), params made by the reference's ``init_params(PRNGKey(0))``
in float32 and carried across with ``interop.params_from_numpy``: each of
the port's engines token for token and counter for counter against the
reference's engine of the same kind, and the launcher's counters against
the reference launcher's.

The engines' recipe: ``ServeConfig(max_running=2, hot_window=16,
attn_chunk=32)``, ``max_len`` 256, prompts of 32, 64 and 20 tokens, 8 new
each. A lane's cache holds both kinds of state: its compressed KV (2
sites) and its raw Mamba2 state (4 layers of h 8 x 32 x 16 f32 and conv 3
x 256 bf16: 69,632 B), which every park and resume moves whole beside the
KV suffix. The two reference engines disagree on what a re-park costs
(its ``Engine`` keeps a shadow and charges only the KV suffix not yet
covered, its ``SerialEngine`` drops its park on resume): the port keeps
both behaviours, so the batched engine parks 687,680 B at 4 bits and the
serial one 767,040 B. C10 (ROADMAP): both packages refuse a 45-token
prompt at chunk 32.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as JLS
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.serial import SerialEngine as JSerialEngine
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as LS
from repro_torch.serve import DONE, Engine, SerialEngine

ARCH = "zamba2_2p7b"
MAX_LEN = 256
LENGTHS = (32, 64, 20)
STATE_BYTES = 4 * (8 * 32 * 16 * 4 + 3 * 256 * 2)
PREEMPT_BYTES = {("batched", 4): 687_680, ("serial", 4): 767_040}


def _jscfg(bits: int) -> JServeConfig:
    return JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                        kv_rate_bits=bits)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype="float32")
    cfg = dataclasses.replace(get_reduced(ARCH), dtype="float32")
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _prompt(seed: int, n: int, vocab: int):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, vocab, size=n)]


def _serve(eng, vocab: int):
    rids = [eng.submit(_prompt(i, n, vocab), max_new_tokens=8)
            for i, n in enumerate(LENGTHS)]
    eng.run_until_done(max_steps=400)
    assert all(eng.requests[r].state == DONE for r in rids)
    return [eng.result(r) for r in rids]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name,engine_cls,ref_cls",
                         [("batched", Engine, JEngine),
                          ("serial", SerialEngine, JSerialEngine)])
def test_engine_matches_reference(name, engine_cls, ref_cls, bits):
    """Generations token for token and the whole counters dict against the
    reference's engine of the same kind: 3 requests through 2 lanes, 9
    parks of the raw state and the KV suffix, exact-length prefill groups,
    one sync a step."""
    jcfg, cfg, jparams, params = _models()
    ref = ref_cls(jcfg, _jscfg(bits), jparams, max_len=MAX_LEN)
    want = _serve(ref, cfg.vocab_size)
    eng = engine_cls(cfg, ServeConfig.from_reference(_jscfg(bits)), params,
                     max_len=MAX_LEN, device="cpu")
    assert eng.cache["ssm.h"].shape[:2] == (4, 2) and \
        eng.cache["k_codes"].shape[:2] == (2, 2)
    contracts.SYNCS.reset()
    assert _serve(eng, cfg.vocab_size) == want
    c = eng.counters
    assert c == dict(ref.counters)
    assert (c["promotions"], c["demotions"], c["steps"], c["tokens"],
            c["prefill_batches"]) == (12, 9, 11, 21, 3)
    if (name, bits) in PREEMPT_BYTES:
        assert c["preempt_bytes"] == PREEMPT_BYTES[name, bits]
    # every park and resume moves the whole state; the rest is KV suffix
    assert c["preempt_bytes"] > 9 * STATE_BYTES and \
        c["resume_bytes"] > 9 * STATE_BYTES
    assert c["step_syncs"] == c["steps"]
    assert contracts.SYNCS.count == c["step_syncs"] + c["admit_syncs"]


def test_engines_refuse_what_the_reference_refuses():
    """C10: a 45-token prompt at chunk 32 is refused by both packages'
    engines at its prefill."""
    jcfg, cfg, jparams, params = _models()
    ref = JEngine(jcfg, _jscfg(4), jparams, max_len=MAX_LEN)
    ref.submit(_prompt(0, 45, cfg.vocab_size), max_new_tokens=2)
    with pytest.raises(AssertionError):
        ref.run_until_done()
    for cls in (Engine, SerialEngine):
        eng = cls(cfg, ServeConfig.from_reference(_jscfg(4)), params,
                  max_len=MAX_LEN, device="cpu")
        eng.submit(_prompt(0, 45, cfg.vocab_size), max_new_tokens=2)
        with pytest.raises(ValueError, match="ROADMAP C10"):
            eng.run_until_done()


def test_launcher_counters_match_reference_launcher(monkeypatch):
    """``launch/serve.py --arch zamba2_2p7b --reduced`` prints the JAX
    launcher's ``pool:`` and ``host:`` lines (the schedule and the parked
    bytes do not depend on the params, which come from other
    generators)."""
    argv = ["--arch", ARCH, "--reduced", "--requests", "5", "--new-tokens",
            "6", "--lanes", "2", "--kv-bits", "4"]
    outs = []
    for main, extra in ((JLS.main, []), (LS.main, ["--device", "cpu"])):
        # the reference launcher reads sys.argv
        monkeypatch.setattr(sys, "argv", ["serve"] + argv + extra)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main()
        outs.append([ln for ln in buf.getvalue().splitlines()
                     if ln.startswith(("pool:", "host:"))])
    assert outs[0] == outs[1]
    assert outs[1][0] == ("pool: promotions=15 demotions=10 "
                          "preempt_bytes=761280 shadow_repreempts=0")
