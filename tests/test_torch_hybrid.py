"""The hybrid family (zamba2-2.7b) of the port against the reference on
REDUCED zamba2-2.7b (4 Mamba2 layers in 2 groups of 2, 2 shared attention
blocks, d 128, d_in 256, 8 SSM heads of 32, d_state 16, chunk 32; 4/4
attention heads of 32) in float32, inputs made from a seed with numpy:

  * the Mamba2 layer (``repro_torch.models.ssm``) against
    ``repro.models.ssm``, the mixer's params from the reference's
    ``mamba2_init(PRNGKey(0))``: the in_proj split, the SSD core at T 20,
    32 and 96 from a nonzero state, the full-history scan, the
    full-sequence form, five chained decode steps, the zero state and the
    init's distributions;
  * the model (``transformer``, ``decode``) against the reference's, its
    params from ``init_params(PRNGKey(0))`` through ``interop``:
    ``forward``, ``prefill`` plus three ``decode_step``s and every cache
    leaf after each, and the float32 leaves under bf16.

Tolerances. The Mamba2 layer: 1e-5 relative and 1e-6 absolute, as
``tests/test_torch_ssm.py`` states for Mamba1 (the scans associate the
products in another order, the einsums block the N-contraction
differently), and for the full-sequence form 1e-5 of the output's
largest magnitude absolute (out_proj's sum of 256 terms); the bf16 conv
tail of a decode state within one bf16 step (an f32 input at a rounding
boundary may round either way). The model: ``tests/test_torch_model.py``'s,
logits within 1e-4 in float32 and 2e-2 in bf16; in the cache under 0.1%
of the KV codes one code step off (a value at a rounding boundary), the
scales and the state h within 1e-4, the bf16 rings and conv tail within
1e-4 or one bf16 step.
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
from repro.models import decode as JD
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.models import decode as TD
from repro_torch.models import ssm as TSSM
from repro_torch.models import transformer as TT

ARCH = "zamba2_2p7b"
JCFG = dataclasses.replace(jget_reduced(ARCH), dtype="float32")
CFG = dataclasses.replace(get_reduced(ARCH), dtype="float32")
SSM = CFG.ssm
D_IN = SSM.expand * CFG.d_model
H, P, N, K = D_IN // SSM.headdim, SSM.headdim, SSM.d_state, SSM.d_conv
GN = SSM.ngroups * N
RTOL, ATOL = 1e-5, 1e-6
MAX_LEN = 256
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}


@pytest.fixture(scope="module")
def mixer():
    jp, _ = JSSM.mamba2_init(jax.random.PRNGKey(0), JCFG)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _bf16(a: np.ndarray):
    """(the reference's bf16 array, the port's bf16 tensor) of a."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


def test_config_matches_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert (H, P, N) == (8, 32, 16)
    assert TT.hybrid_groups(CFG) == (2, 2, 2)


def test_mixer_init_distributions(mixer):
    """The port's own init has the reference's leaves, shapes, dtypes and
    constants (the random leaves come from another generator, at the
    reference's scales)."""
    jp, tp = mixer
    gen = torch.Generator().manual_seed(0)
    own = TSSM.mamba2_init(gen, CFG, torch.float32, "cpu")
    assert own.keys() == tp.keys()
    for k in own:
        assert own[k].shape == tp[k].shape and own[k].dtype == tp[k].dtype
    for k in ("conv_b", "dt_bias", "A_log", "D", "norm_w"):
        assert torch.equal(own[k], tp[k]), k
    for k, scale in (("in_proj", CFG.d_model ** -0.5), ("conv_w", 0.5),
                     ("out_proj", D_IN ** -0.5)):
        for a in (own[k], tp[k]):
            assert abs(float(a.std()) / scale - 1.0) < 0.1, k


def test_split_matches(mixer):
    jp, tp = mixer
    u = _normal(1, (2, 20, CFG.d_model))
    want = JSSM._mamba2_split(jp, jnp.asarray(u), JCFG)
    got = TSSM._mamba2_split(tp, torch.from_numpy(u), CFG)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == \
        [(2, 20, D_IN), (2, 20, D_IN), (2, 20, GN), (2, 20, GN), (2, 20, H)]
    for g, w in zip(got, want):
        _close(g, w)


def _core_inputs(T: int, seed: int):
    xc = _normal(seed, (2, T, D_IN))
    Bc, Cc = _normal(seed + 1, (2, T, GN)), _normal(seed + 2, (2, T, GN))
    dt = _normal(seed + 3, (2, T, H))
    z = _normal(seed + 4, (2, T, D_IN))
    h0 = _normal(seed + 5, (2, H, P, N), 0.5)
    return xc, Bc, Cc, dt, z, h0


@pytest.mark.parametrize("T", [20, 32, 96])
def test_core_matches(mixer, T):
    """The SSD core under a chunk (20), one chunk (32) and three chunks
    (96), from a nonzero h0: the output and the final state."""
    jp, tp = mixer
    ins = _core_inputs(T, 2)
    want_y, want_h = jax.jit(
        lambda p, *a: JSSM._mamba2_core(p, *a, JCFG))(
            jp, *(jnp.asarray(a) for a in ins))
    got_y, got_h = TSSM._mamba2_core(
        tp, *(torch.from_numpy(a) for a in ins), CFG)
    assert got_y.shape == (2, T, CFG.d_model) and got_h.shape == (2, H, P, N)
    _close(got_y, want_y)
    _close(got_h, want_h)


@pytest.mark.parametrize("T", [20, 32, 96])
def test_chunked_scan_matches(T):
    """The full-history scan (the reference's ``_chunked_ssm_scan``) with
    Mamba2's per-head decay [B, T, H, 1, 1] against inp [B, T, H, P, N]:
    every state and the last."""
    decay = np.exp(-np.abs(_normal(3, (2, T, H, 1, 1), 0.1)))
    inp = _normal(4, (2, T, H, P, N))
    h0 = _normal(5, (2, H, P, N))
    want_all, want_h = jax.jit(
        lambda d, i, h: JSSM._chunked_ssm_scan(d, i, h, SSM.chunk))(
            jnp.asarray(decay), jnp.asarray(inp), jnp.asarray(h0))
    got_all, got_h = TSSM._chunked_ssm_scan(
        torch.from_numpy(decay), torch.from_numpy(inp), torch.from_numpy(h0),
        SSM.chunk)
    assert got_all.shape == (2, T, H, P, N)
    _close(got_all, want_all)
    _close(got_h, want_h)


def test_scans_refuse_what_the_reference_refuses():
    """C10: T = 45 at chunk 32 is neither under a chunk nor a multiple of
    it; the reference asserts, the port raises naming the rule (both
    scans)."""
    decay = np.ones((1, 45, H, 1, 1), np.float32)
    inp = np.ones((1, 45, H, P, N), np.float32)
    h0 = np.zeros((1, H, P, N), np.float32)
    with pytest.raises(AssertionError):
        JSSM._chunked_ssm_scan(jnp.asarray(decay), jnp.asarray(inp),
                               jnp.asarray(h0), SSM.chunk)
    with pytest.raises(ValueError, match="ROADMAP C10"):
        TSSM._chunked_ssm_scan(torch.from_numpy(decay),
                               torch.from_numpy(inp), torch.from_numpy(h0),
                               SSM.chunk)


@pytest.mark.parametrize("T", [20, 96])
def test_apply_train_matches(mixer, T):
    jp, tp = mixer
    u = _normal(8, (2, T, CFG.d_model))
    want = jax.jit(lambda p, u: JSSM.mamba2_apply_train(p, u, JCFG))(
        jp, jnp.asarray(u))
    got = TSSM.mamba2_apply_train(tp, torch.from_numpy(u), CFG)
    # out_proj sums 256 terms of the gated norm's unit scale: its error
    # scales with the output's magnitude, not with each element's own
    _close(got, want, atol=RTOL * float(np.abs(np.asarray(want)).max()))


def test_decode_chain_matches(mixer):
    """Five chained decode steps from a random state, each package carrying
    its own state: the outputs, h and the bf16 conv tail."""
    jp, tp = mixer
    h = _normal(9, (2, H, P, N), 0.5)
    jconv, tconv = _bf16(_normal(10, (2, K - 1, D_IN)))
    jst = JSSM.Mamba2State(h=jnp.asarray(h), conv=jconv)
    tst = TSSM.Mamba2State(torch.from_numpy(h), tconv)
    step = jax.jit(lambda p, u, s: JSSM.mamba2_decode(p, u, s, JCFG))
    for t in range(5):
        u = _normal(11 + t, (2, 1, CFG.d_model))
        want, jst = step(jp, jnp.asarray(u), jst)
        got, tst = TSSM.mamba2_decode(tp, torch.from_numpy(u), tst, CFG)
        _close(got, want)
        _close(tst.h, jst.h)
        # one bf16 step (at most 2^-7 of the value) where the f32 input
        # sat at a rounding boundary
        _close(tst.conv, np.asarray(jst.conv, np.float32), rtol=2.0 ** -7,
               atol=0.0)
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == torch.bfloat16


def test_init_state_matches():
    jst = JSSM.mamba2_init_state(JCFG, 3)
    tst = TSSM.mamba2_init_state(CFG, 3, "cpu")
    for a, b in zip(tst, jst):
        assert tuple(a.shape) == b.shape and not a.any()
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _jscfg(bits: int = 4) -> JServeConfig:
    return JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                        kv_rate_bits=bits)


@functools.lru_cache(maxsize=None)
def _models(dtype: str):
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


def _tokens(n: int, T: int, vocab: int) -> np.ndarray:
    return np.random.default_rng(0).integers(1, vocab, (n, T)).astype(
        np.int32)


def test_params_from_numpy_takes_the_hybrid_tree():
    """The reference's [G, period, ...] Mamba2 layers become the port's
    flat list in order (layer g * period + j), its shared blocks a list of
    their own."""
    jcfg, cfg, jparams, params = _models("float32")
    G, period, nshared = TT.hybrid_groups(cfg)
    assert len(params["layers"]) == G * period and \
        len(params["shared"]) == nshared
    for g in range(G):
        for j in range(period):
            got = params["layers"][g * period + j]["mixer"]["in_proj"]
            want = np.asarray(jparams["layers"]["mixer"]["in_proj"][g, j])
            assert np.array_equal(got.numpy(), want)
    for s in range(nshared):
        assert np.array_equal(params["shared"][s]["attn"]["wq"].numpy(),
                              np.asarray(jparams["shared"]["attn"]["wq"][s]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches(dtype):
    jcfg, cfg, jparams, params = _models(dtype)
    tokens = _tokens(2, 96, cfg.vocab_size)
    got, aux = TT.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    want, jaux = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOLS[dtype], rtol=TOLS[dtype])
    assert float(aux) == float(jaux) == 0.0


def _signed_codes(packed: np.ndarray, bits: int) -> np.ndarray:
    """Packed uint8 KV codes as their signed codes: two 4-bit codes a byte
    (low nibble first) or one 8-bit code."""
    if bits == 8:
        return packed.view(np.int8).astype(np.int16)
    nib = np.stack([packed & 15, packed >> 4], -1).astype(np.int16)
    return np.where(nib >= 8, nib - 16, nib)


def _compare_cache(cache, jcache, tol: float, bits: int = 4) -> None:
    """Every leaf of the port's cache (through ``cache_to_numpy``, the
    reference's layout) against the reference's."""
    got = interop.cache_to_numpy(cache)
    want = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32)
                                  if a.dtype == jnp.bfloat16 else
                                  np.asarray(a), jcache)
    assert set(got) == set(want) and set(got["ssm"]) == {"h", "conv"}
    for k in ("k_codes", "v_codes"):
        assert got[k].shape == want[k].shape
        # a value at a rounding boundary may take the next code: at most
        # one code in a thousand differs, and none by more than one step
        step = np.abs(_signed_codes(got[k], bits) -
                      _signed_codes(want[k], bits))
        assert (step != 0).mean() < 1e-3 and step.max() <= 1, k
    for k in ("k_scales", "v_scales"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol)
    for k in ("k_hot", "v_hot"):            # bf16: one step at a boundary
        np.testing.assert_allclose(got[k], want[k], rtol=2.0 ** -7, atol=tol)
    assert np.array_equal(got["cold_len"], want["cold_len"])
    np.testing.assert_allclose(got["ssm"]["h"], want["ssm"]["h"], rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(got["ssm"]["conv"], want["ssm"]["conv"],
                               rtol=2.0 ** -7, atol=tol)


def test_prefill_and_decode_match():
    """A 96-token prefill (three scan chunks, a prefix past the ring of
    16), then three decode steps, each package on its own cache: logits
    and every cache leaf after each."""
    jcfg, cfg, jparams, params = _models("float32")
    tol = TOLS["float32"]
    scfg = ServeConfig.from_reference(_jscfg())
    tokens = _tokens(2, 96, cfg.vocab_size)
    lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                           scfg, MAX_LEN)
    jlg, jcache = jax.jit(functools.partial(
        JD.prefill, cfg=jcfg, scfg=_jscfg(), max_len=MAX_LEN))(
            jparams, {"tokens": jnp.asarray(tokens)})
    assert TD.cache_bytes(cache) == JD.cache_bytes(jcache)
    assert cache["ssm.h"].shape == (4, 2, H, P, N) and \
        cache["k_codes"].shape == (2, 2, MAX_LEN, 4, 16)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=tol,
                               atol=tol)
    _compare_cache(cache, jcache, tol)
    step = jax.jit(functools.partial(JD.decode_step, cfg=jcfg,
                                     scfg=_jscfg()))
    tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
    pos = np.full((2,), 96, np.int32)
    for _ in range(3):
        lg, _ = TD.decode_step(params, cache, torch.tensor(tok),
                               torch.tensor(pos), cfg, scfg)
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=tol,
                                   atol=tol)
        _compare_cache(cache, jcache, tol)
        tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
        pos = pos + 1


def test_cache_round_trips_through_interop():
    """``cache_from_numpy`` of the reference's hybrid cache (state
    [G, period, B, ...]) gives the port's flat leaves in their dtypes, and
    ``cache_to_numpy`` gives the reference's layout back."""
    jcfg, cfg, _, _ = _models("float32")
    jcache = jax.tree_util.tree_map(
        np.asarray, JD.init_cache(jcfg, _jscfg(), 3, MAX_LEN))
    rng = np.random.default_rng(1)
    jcache["ssm"]["h"] = rng.standard_normal(
        jcache["ssm"]["h"].shape).astype(np.float32)
    jcache["k_scales"] = rng.standard_normal(
        jcache["k_scales"].shape).astype(np.float32)
    cache = interop.cache_from_numpy(jcache, device="cpu")
    own = TD.init_cache(cfg, ServeConfig.from_reference(_jscfg()), 3,
                        MAX_LEN, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in cache.items()} == \
        {k: (v.shape, v.dtype) for k, v in own.items()}
    back = interop.cache_to_numpy(cache)
    for k in ("k_scales", "cold_len", "k_codes"):
        assert np.array_equal(back[k], jcache[k])
    for k in ("h", "conv"):
        assert np.array_equal(back["ssm"][k],
                              jcache["ssm"][k].astype(np.float32))


def test_float32_leaves_stay_float32_in_bf16():
    """The Mamba2 leaves the reference uses in float32 without a cast
    (A_log, dt_bias, D, conv_w, conv_b) stay float32 under bf16, through
    interop and through the port's own init; the projections and the
    gated norm's weight are bf16, as are the shared blocks."""
    _, cfg, _, params = _models("bfloat16")
    own = TT.init_params(cfg, seed=0, device="cpu")
    for tree in (params, own):
        for lp in tree["layers"]:
            assert set(lp["mixer"]) == TSSM.F32_PARAMS | {
                "in_proj", "norm_w", "out_proj"}
            for k, v in lp["mixer"].items():
                want = torch.float32 if k in TSSM.F32_PARAMS else \
                    torch.bfloat16
                assert v.dtype == want, k
        for sp in tree["shared"]:
            assert sp["attn"]["wq"].dtype == torch.bfloat16
