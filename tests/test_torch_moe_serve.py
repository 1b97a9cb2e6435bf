"""The port's MoE serving path against the reference's on REDUCED
qwen3-moe (2 layers, d 128, 4 heads over 2 KV heads, 8 experts top-2) in
float32, params carried across from the reference's
``init_params(PRNGKey(0))``, with the reference serving tests'
configuration (``max_running=2, hot_window=16, attn_chunk=32``): two lanes
of two choices each give a decode capacity of ceil(2*2*1.25/8) = 1 row an
expert, so decode drops pairs, and which it drops depends on both lanes'
tokens, an idle lane's included.

  * ``prefill`` (right-padded, with ``lens``) and three ``decode_step``s:
    logits within 1e-4, each step fed the reference's cache; the cache
    end to end up to rounding flips (tests/test_torch_model.py's rule);
  * the KV cache bit for bit given the same K/V rows (both packages'
    ``gqa_project_kv`` replaced by one table): codes, scales, rings and
    ``cold_len`` after prefill and after decode steps, 4 and 8 bits;
  * ``Engine`` against the JAX ``Engine`` and ``SerialEngine`` against the
    JAX ``SerialEngine`` (never one kind against the other: capacity makes
    a token depend on its batch), token for token with equal ``counters``,
    4 and 8 bits, one prompt of 1,024 tokens so that its prefill takes the
    grouped form (asserted), decode drops asserted;
  * REDUCED arctic (top-2 plus the dense residual MLP) through ``Engine``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_reduced as jget_reduced
from repro.core.compressor import dequantize_blocks as jdeq
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve.engine import Engine as JEngine
from repro.serve.serial import SerialEngine as JSerialEngine
from repro_torch import interop
from repro_torch.common import contracts
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.serve import DONE, Engine, SerialEngine

ARCH = "qwen3_moe_235b_a22b"
JCFG = dataclasses.replace(jget_reduced(ARCH), dtype="float32")
CFG = dataclasses.replace(get_reduced(ARCH), dtype="float32")
MAX_LEN = 1088            # a multiple of attn_chunk above the 1,024 bucket
LENGTHS = (16, 12, 1024, 20, 16)
S, LENS = 40, (40, 23)    # the model tests' prefill: one row padded
TOL = 1e-4


def _jscfg(bits: int) -> JServeConfig:
    return JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                        kv_rate_bits=bits)


def _carry(jcfg, cfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    return jp, interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def carried():
    return _carry(JCFG, CFG)


def _tokens():
    tokens = np.random.default_rng(0).integers(
        1, CFG.vocab_size, (2, S)).astype(np.int32)
    tokens[1, LENS[1]:] = 0
    return tokens


def _bits(cache) -> dict:
    """Every leaf as raw bits (f32 leaves as int32, so -0 != +0)."""
    out = {}
    for k, v in cache.items():
        a = np.ascontiguousarray(np.asarray(v, np.float32 if k.endswith(
            "_hot") else None))
        out[k] = a.view(np.int32) if a.dtype == np.float32 else a
    return out


def _compare_caches(port: dict, ref, bits: int) -> None:
    """Dequantized K/V and the rings within TOL, except values one
    rounding step away (a code by one scale, a ring value by one bf16
    ulp), under 1 in 100 (tests/test_torch_model.py's rule)."""
    a = interop.cache_to_numpy(port)
    b = jax.tree_util.tree_map(np.asarray, ref)
    np.testing.assert_array_equal(a["cold_len"], b["cold_len"])
    d = CFG.resolved_head_dim
    for kind in ("k", "v"):
        sc = [np.asarray(c[f"{kind}_scales"]) for c in (a, b)]
        np.testing.assert_allclose(sc[0], sc[1], atol=TOL, rtol=TOL)
        vals = [np.asarray(jdeq(jnp.asarray(c[f"{kind}_codes"]), jnp.asarray(
            s_)[..., None], bits, d, jnp.float32)) for c, s_ in zip((a, b),
                                                                   sc)]
        for got, want, step in (
                (*vals, np.abs(sc[1])[..., None]),
                (np.asarray(a[f"{kind}_hot"], np.float32),
                 np.asarray(b[f"{kind}_hot"], np.float32),
                 np.abs(np.asarray(b[f"{kind}_hot"], np.float32))
                 * 2.0 ** -7)):
            diff, bound = np.abs(got - want), TOL + TOL * np.abs(want)
            assert np.all(diff <= bound + step * 1.001)
            assert np.mean(diff > bound) <= 1e-2


def test_prefill_and_decode_match(carried):
    """Logits within 1e-4 after prefill and three decode steps (each fed
    the reference's cache); the port's own cache, chained through the
    steps, within the model tests' bound up to rounding flips."""
    jparams, params = carried
    jscfg = _jscfg(8)
    scfg = ServeConfig.from_reference(jscfg)
    tokens, lens = _tokens(), np.asarray(LENS, np.int32)
    lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, CFG,
                           scfg, 64, lens=torch.from_numpy(lens))
    jlg, jcache = jax.jit(functools.partial(
        JD.prefill, cfg=JCFG, scfg=jscfg, max_len=64))(
            jparams, {"tokens": jnp.asarray(tokens)}, lens=jnp.asarray(lens))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL,
                               rtol=TOL)
    _compare_caches(cache, jcache, 8)
    step = jax.jit(functools.partial(JD.decode_step, cfg=JCFG, scfg=jscfg))
    tok, pos = np.asarray(jnp.argmax(jlg, axis=-1), np.int32), lens.copy()
    for _ in range(3):
        fed = interop.cache_from_numpy(
            jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
        lg, _ = TD.decode_step(params, fed, torch.tensor(tok),
                               torch.tensor(pos), CFG, scfg)
        TD.decode_step(params, cache, torch.tensor(tok), torch.tensor(pos),
                       CFG, scfg)
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL,
                                   rtol=TOL)
        tok, pos = np.asarray(jnp.argmax(jlg, axis=-1), np.int32), pos + 1
    _compare_caches(cache, jcache, 8)


@pytest.mark.parametrize("bits", [4, 8])
def test_kv_cache_bit_identical(carried, bits, monkeypatch):
    """Both packages' K/V projections replaced by one table of rows (lane,
    position -> K, V; values of both signs, zeros and bf16 ties among
    them): prefill and three decode steps (the ring evicting into codes)
    write the reference's codes, scales, rings and cold_len bit for
    bit."""
    jparams, params = carried
    hkv, d = CFG.num_kv_heads, CFG.resolved_head_dim
    rng = np.random.default_rng(bits)
    table = rng.standard_normal((2, 2, 64, hkv, d)).astype(np.float32) * 3
    table[:, :, 5] = 0.0
    table[:, :, 7, :, ::2] = np.float32(1 + 2 ** -8)        # bf16 ties
    jtab, ttab = jnp.asarray(table), torch.from_numpy(table)

    def jkv(p, x, positions, cfg):
        pos = jnp.broadcast_to(positions, (x.shape[0], positions.shape[-1]))
        b = jnp.arange(x.shape[0])[:, None]
        return jtab[0][b, pos].astype(x.dtype), jtab[1][b, pos].astype(
            x.dtype)

    def tkv(p, x, positions, cfg):
        pos = positions.expand(x.shape[0], positions.shape[-1]).long()
        b = torch.arange(x.shape[0])[:, None]
        return ttab[0][b, pos].to(x.dtype), ttab[1][b, pos].to(x.dtype)

    monkeypatch.setattr(JL, "gqa_project_kv", jkv)
    monkeypatch.setattr(TL, "gqa_project_kv", tkv)
    jscfg = _jscfg(bits)
    scfg = ServeConfig.from_reference(jscfg)
    tokens, lens = _tokens(), np.asarray(LENS, np.int32)
    lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, CFG,
                           scfg, 64, lens=torch.from_numpy(lens))
    jlg, jcache = JD.prefill(jparams, {"tokens": jnp.asarray(tokens)}, JCFG,
                             jscfg, 64, lens=jnp.asarray(lens))
    tok, pos = np.asarray(jnp.argmax(jlg, axis=-1), np.int32), lens.copy()
    for step in range(4):
        got = _bits(interop.cache_to_numpy(cache))
        want = _bits(jax.tree_util.tree_map(np.asarray, jcache))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k} after step {step}")
        if step == 3:
            break
        TD.decode_step(params, cache, torch.tensor(tok), torch.tensor(pos),
                       CFG, scfg)
        jlg, jcache = JD.decode_step(jparams, jcache, jnp.asarray(tok),
                                     jnp.asarray(pos), JCFG, jscfg)
        tok, pos = np.asarray(jnp.argmax(jlg, axis=-1), np.int32), pos + 1
    assert int(np.asarray(jcache["cold_len"]).max()) > 0


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, CFG.vocab_size, size=n)]


def _serve(eng, lengths=LENGTHS):
    rids = [eng.submit(_prompt(i, n), max_new_tokens=6)
            for i, n in enumerate(lengths)]
    eng.run_until_done(max_steps=400)
    assert all(eng.requests[r].state == DONE for r in rids)
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def reference(carried):
    jparams = carried[0]
    out = {}
    for bits in (4, 8):
        for name, cls in (("batched", JEngine), ("serial", JSerialEngine)):
            eng = cls(JCFG, _jscfg(bits), jparams, max_len=MAX_LEN)
            out[bits, name] = (_serve(eng), dict(eng.counters))
    return out


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("name", ["batched", "serial"])
def test_moe_engine_matches_reference(reference, carried, name, bits,
                                      monkeypatch):
    """Generations token for token and the whole counters dict against
    the reference's engine of the same kind; the 1,024-token prompt's
    prefill took the grouped form; decode dropped pairs."""
    cls = {"batched": Engine, "serial": SerialEngine}[name]
    want, want_counters = reference[bits, name]
    grouped, drops = [], []
    route, apply_grouped = TM.route, TM.moe_apply_grouped

    def counted_grouped(p, x, cfg):
        grouped.append(x.shape[0] * x.shape[1])
        return apply_grouped(p, x, cfg)

    def counted_route(router, x, k):
        out = route(router, x, k)
        if x.dim() == 2 and x.shape[0] == 2:            # a decode step
            e = CFG.moe.num_experts
            counts = torch.bincount(out[2].reshape(-1), minlength=e)
            drops.append(int((counts - TM.capacity(k, 2, e))
                             .clamp(min=0).sum()))
        return out

    monkeypatch.setattr(TM, "moe_apply_grouped", counted_grouped)
    monkeypatch.setattr(TM, "route", counted_route)
    eng = cls(CFG, ServeConfig.from_reference(_jscfg(bits)), carried[1],
              max_len=MAX_LEN, device="cpu")
    contracts.SYNCS.reset()
    got = _serve(eng)
    assert got == want
    assert eng.counters == want_counters
    c = eng.counters
    assert c["demotions"] >= 1 and c["preempt_bytes"] > 0
    assert contracts.SYNCS.count == c["step_syncs"] + c["admit_syncs"]
    assert grouped and all(n == 1024 for n in grouped)
    assert sum(drops) > 0, "no decode step dropped a pair"


def test_arctic_engine_matches_reference():
    """REDUCED arctic (top-2 plus the dense residual MLP): the batched
    engine's generations and counters equal to the reference engine's,
    with preemption."""
    jcfg = dataclasses.replace(jget_reduced("arctic_480b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("arctic_480b"), dtype="float32")
    assert cfg.moe.dense_residual
    jp, p = _carry(jcfg, cfg)
    lengths = (16, 12, 32, 20, 16)
    ref = JEngine(jcfg, _jscfg(8), jp, max_len=128)
    want = _serve(ref, lengths)
    eng = Engine(cfg, ServeConfig.from_reference(_jscfg(8)), p, max_len=128,
                 device="cpu")
    assert _serve(eng, lengths) == want
    assert eng.counters == dict(ref.counters)
    assert eng.counters["demotions"] >= 1
