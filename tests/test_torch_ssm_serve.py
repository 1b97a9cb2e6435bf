"""The port's SSM family (falcon-mamba-7b) served against the reference on
REDUCED falcon-mamba-7b (2 Mamba1 layers, d 128, d_state 8, chunk 32),
params made by the reference's ``init_params(PRNGKey(0))`` and carried
across with ``interop.params_from_numpy``: ``forward``, ``prefill`` and
three ``decode_step``s, and the serving engines token for token with the
same counters as the reference's engine of the same kind.

Tolerances as ``tests/test_torch_model.py``: logits within 1e-4 in float32
and 2e-2 in bf16; the state h within 1e-4, the bf16 conv tail within one
bf16 step (an f32 input at a rounding boundary may round either way).

The engines' recipe: ``ServeConfig(max_running=2, hot_window=16,
attn_chunk=32)``, ``max_len`` 256, prompts of 32, 64, 32, 96 and 20 tokens,
8 new each, in float32. There is no KV cache: a preemption parks the raw
recurrent state (h 2 x 256 x 8 x 4 B and conv 2 x 3 x 256 x 2 B = 19,456 B
a park), the same at 4 and 8 bits; prompts are prefilled in exact-length
groups. C10 (ROADMAP): both packages refuse a 45-token prompt at chunk 32.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as JLS
from repro.models import decode as JD
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.serial import SerialEngine as JSerialEngine
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as LS
from repro_torch.models import decode as TD
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT
from repro_torch.serve import DONE, Engine, SerialEngine

ARCH = "falcon_mamba_7b"
MAX_LEN = 256
LENGTHS = (32, 64, 32, 96, 20)
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}
PARK_BYTES = 2 * 256 * 8 * 4 + 2 * 3 * 256 * 2


def _jscfg(bits: int) -> JServeConfig:
    return JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                        kv_rate_bits=bits)


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _tokens(n: int, T: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(1, vocab, (n, T)).astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(dtype):
    jcfg, cfg, jparams, params = _models(dtype)
    tokens = _tokens(2, 96, cfg.vocab_size)
    got, aux = TT.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    want, jaux = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    _close(got, want, TOLS[dtype])
    assert float(aux) == float(jaux) == 0.0


def test_prefill_and_decode_match():
    """A 96-token prefill (three chunks), then three decode steps, each
    package on its own state: logits, h and the conv tail after each."""
    jcfg, cfg, jparams, params = _models("float32")
    tol = TOLS["float32"]
    scfg = ServeConfig.from_reference(_jscfg(4))
    tokens = _tokens(2, 96, cfg.vocab_size)
    lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                           scfg, MAX_LEN)
    jlg, jcache = jax.jit(functools.partial(
        JD.prefill, cfg=jcfg, scfg=_jscfg(4), max_len=MAX_LEN))(
            jparams, {"tokens": jnp.asarray(tokens)})
    assert set(cache) == {"ssm.h", "ssm.conv"}
    assert TD.cache_bytes(cache) == JD.cache_bytes(jcache)

    def compare_state():
        got = interop.cache_to_numpy(cache)["ssm"]
        want = jax.tree_util.tree_map(np.asarray, jcache)["ssm"]
        np.testing.assert_allclose(got["h"], want["h"], rtol=tol, atol=tol)
        np.testing.assert_allclose(got["conv"], want["conv"].astype(
            np.float32), rtol=2.0 ** -7, atol=0.0)

    _close(lg, jlg, tol)
    compare_state()
    step = jax.jit(functools.partial(JD.decode_step, cfg=jcfg,
                                     scfg=_jscfg(4)))
    tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
    pos = np.full((2,), 96, np.int32)
    for _ in range(3):
        lg, _ = TD.decode_step(params, cache, torch.tensor(tok),
                               torch.tensor(pos), cfg, scfg)
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        _close(lg, jlg, tol)
        compare_state()
        tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
        pos = pos + 1


def test_cache_round_trips_through_interop():
    """``cache_from_numpy`` of the reference's ssm subtree gives the port's
    dotted leaves in their dtypes, and ``cache_to_numpy`` gives it back."""
    jcfg, cfg, _, _ = _models("float32")
    jcache = jax.tree_util.tree_map(
        np.asarray, JD.init_cache(jcfg, _jscfg(4), 3, MAX_LEN))
    jcache["ssm"]["h"] = np.random.default_rng(1).standard_normal(
        jcache["ssm"]["h"].shape).astype(np.float32)
    cache = interop.cache_from_numpy(jcache, device="cpu")
    own = TD.init_cache(cfg, ServeConfig.from_reference(_jscfg(4)), 3,
                        MAX_LEN, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype) for k, v in own.items()}
    back = interop.cache_to_numpy(cache)
    assert np.array_equal(back["ssm"]["h"], jcache["ssm"]["h"])
    assert np.array_equal(back["ssm"]["conv"], jcache["ssm"]["conv"])


def test_float32_leaves_stay_float32_in_bf16():
    """The Mamba1 leaves the reference uses in float32 without a cast
    (A_log, dt_bias, D, conv_w, conv_b) stay float32 under bf16, through
    interop and through the port's own init; the projections are bf16."""
    _, cfg, _, params = _models("bfloat16")
    own = TT.init_params(cfg, seed=0, device="cpu")
    for tree in (params, own):
        for lp in tree["layers"]:
            for k, v in lp["mixer"].items():
                want = torch.float32 if k in TSSM.F32_PARAMS else \
                    torch.bfloat16
                assert v.dtype == want, k
    assert TSSM.F32_PARAMS == {"A_log", "dt_bias", "D", "conv_w", "conv_b"}


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
    reference's engine of the same kind: 5 requests through 2 lanes, 15
    parks of the raw state, exact-length prefill groups, one sync a
    step."""
    jcfg, cfg, jparams, params = _models("float32")
    ref = ref_cls(jcfg, _jscfg(bits), jparams, max_len=MAX_LEN)
    want = _serve(ref, cfg.vocab_size)
    eng = engine_cls(cfg, ServeConfig.from_reference(_jscfg(bits)), params,
                     max_len=MAX_LEN, device="cpu")
    contracts.SYNCS.reset()
    assert _serve(eng, cfg.vocab_size) == want
    c = eng.counters
    assert c == dict(ref.counters)
    assert (c["promotions"], c["demotions"], c["prefill_batches"]) == \
        (20, 15, 5)
    assert c["preempt_bytes"] == c["resume_bytes"] == 15 * PARK_BYTES \
        == 291_840
    assert c["step_syncs"] == c["steps"]
    assert contracts.SYNCS.count == c["step_syncs"] + c["admit_syncs"]


def test_engines_refuse_what_the_reference_refuses():
    """C10: a 45-token prompt at chunk 32 is refused by both packages'
    engines at its prefill."""
    jcfg, cfg, jparams, params = _models("float32")
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
    """``launch/serve.py --arch falcon_mamba_7b --reduced`` prints the JAX
    launcher's ``pool:`` and ``host:`` lines (the schedule and the parked
    state do not depend on the params, which come from other
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
                          "preempt_bytes=194560 shadow_repreempts=0")
