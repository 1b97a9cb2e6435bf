"""The port's MLA model (minicpm3-4b's family) against the reference on
REDUCED minicpm3 (2 layers, d 256, 4 heads, q_lora 64, kv_lora 32, nope
16, rope 8, v 16, vocab 512), params made by the reference's
``init_params(PRNGKey(0))`` and carried across with
``interop.params_from_numpy``: ``forward``, ``prefill`` (right-padded, with
``lens``) and three ``decode_step``s over the compressed latent cache, the
paper mode against the fused one, and the parameter count.

Tolerances: the logits within 2e-2 in bf16 and 1e-4 in float32, the model
tests' bounds (tests/test_torch_model.py). The latent is computed by float
math that the two packages round at different points, so a cache compared
end to end agrees up to flips: a latent value within rounding of a
quantization (or bf16) boundary may land on either side, moving it by one
scale (or one bf16 ulp), under 1 in 100 values. Given the same latent rows
the cache writes are bit for bit the reference's: ``lat_codes``,
``lat_scales``, ``lat_hot`` and ``cold_len`` after prefill and after decode
steps (``test_latent_cache_bit_identical``, both packages' ``mla_latent``
replaced by one table of rows).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import ServeConfig as JServeConfig
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core.compressor import dequantize_blocks as jdeq
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.common.types import ServeConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack
from repro_torch.models import decode as TD
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

ARCH = "minicpm3_4b"
JSCFG = JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                     kv_rate_bits=8)
SCFG = ServeConfig.from_reference(JSCFG)
MAX_LEN = 64
LENS = (40, 23)            # one row longer than the ring, one padded
S = 40
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}
MAX_FLIPS = 1e-2


@pytest.fixture(scope="module", params=["bfloat16", "float32"])
def setup(request):
    dtype = request.param
    jcfg = dataclasses.replace(jget_reduced(ARCH), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(ARCH), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    tokens[1, LENS[1]:] = 0
    return dtype, jcfg, cfg, jparams, params, tokens


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_param_count_and_tree():
    """The reference's formula for MLA; the reference's layer tree carried
    across key for key, shape for shape."""
    assert get_config(ARCH).param_count() == 4_262_952_960 == \
        jget_config(ARCH).param_count()
    assert get_reduced(ARCH).param_count() == 1_155_072
    jcfg = jget_reduced(ARCH)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    p = interop.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                  get_reduced(ARCH), device="cpu")
    own = TT.init_params(get_reduced(ARCH), device="cpu")
    for tree in (p, own):
        for i, lp in enumerate(tree["layers"]):
            assert set(lp["attn"]) == {"wq_a", "wq_b", "wkv_a", "wkv_b", "wo",
                                       "q_norm", "kv_norm"}
            for k, t in lp["attn"].items():
                assert tuple(t.shape) == jp["layers"]["attn"][k].shape[1:], k
    assert sum(t.numel() for lp in own["layers"] for d in lp.values()
               for t in (d.values() if isinstance(d, dict) else [d])
               if t.dim() == 2) + sum(
        own[k].numel() for k in ("tok_embed", "lm_head")) == \
        get_reduced(ARCH).param_count()


def test_forward_matches(setup):
    dtype, jcfg, cfg, jparams, params, tokens = setup
    got, _ = TT.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    want, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, {"tokens": jnp.asarray(tokens)})
    assert got.shape == (2, S, cfg.vocab_size)
    _close(got, want, TOLS[dtype])


def _latent_view(cache: dict, R: int, bits: int) -> dict:
    return {"lat": np.asarray(jdeq(jnp.asarray(cache["lat_codes"]),
                                   jnp.asarray(cache["lat_scales"])[
                                       ..., None], bits, R, jnp.float32)),
            "scale": np.asarray(cache["lat_scales"]),
            "hot": np.asarray(cache["lat_hot"], np.float32),
            "cold_len": np.asarray(cache["cold_len"])}


def _close_up_to_flips(got, want, tol: float, step, max_frac: float):
    diff = np.abs(got - want)
    bound = tol + tol * np.abs(want)
    assert np.all(diff <= bound + step * 1.001)
    assert np.mean(diff > bound) <= max_frac


def _compare_caches(port: dict, ref, cfg, tol: float) -> None:
    R = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    a = _latent_view(interop.cache_to_numpy(port), R, SCFG.kv_rate_bits)
    b = _latent_view(jax.tree_util.tree_map(np.asarray, ref), R,
                     SCFG.kv_rate_bits)
    assert np.array_equal(a["cold_len"], b["cold_len"])
    np.testing.assert_allclose(a["scale"], b["scale"], atol=tol, rtol=tol)
    _close_up_to_flips(a["lat"], b["lat"], tol,
                       np.abs(b["scale"])[..., None], MAX_FLIPS)
    _close_up_to_flips(a["hot"], b["hot"], tol, np.abs(b["hot"]) * 2.0 ** -7,
                       MAX_FLIPS)


def test_prefill_and_decode_match(setup):
    """Prefill, then three decode steps, each fed the reference's cache; the
    port's own cache, chained through the three steps, compared after
    them."""
    dtype, jcfg, cfg, jparams, params, tokens = setup
    tol = TOLS[dtype]
    lens = np.asarray(LENS, np.int32)
    lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                           SCFG, MAX_LEN, lens=torch.from_numpy(lens))
    assert set(cache) == {"lat_codes", "lat_scales", "lat_hot", "cold_len"}
    jlg, jcache = jax.jit(functools.partial(
        JD.prefill, cfg=jcfg, scfg=JSCFG, max_len=MAX_LEN))(
            jparams, {"tokens": jnp.asarray(tokens)}, lens=jnp.asarray(lens))
    _close(lg, jlg, tol)
    _compare_caches(cache, jcache, cfg, tol)

    step = jax.jit(functools.partial(JD.decode_step, cfg=jcfg, scfg=JSCFG))
    tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
    pos = lens.copy()
    for _ in range(3):
        fed = interop.cache_from_numpy(
            jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
        lg, _ = TD.decode_step(params, fed, torch.tensor(tok),
                               torch.tensor(pos), cfg, SCFG)
        TD.decode_step(params, cache, torch.tensor(tok), torch.tensor(pos),
                       cfg, SCFG)
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos))
        _close(lg, jlg, tol)
        _compare_caches(fed, jcache, cfg, tol)
        tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
        pos = pos + 1
    _compare_caches(cache, jcache, cfg, tol)


@pytest.mark.parametrize("bits", [4, 8])
def test_latent_cache_bit_identical(setup, bits, monkeypatch):
    """With both packages' ``mla_latent`` replaced by one table of rows
    (indexed by position; bf16-exact values, an all-zero row, a +-0 row and
    .5 ties), the prefill's latent fill and three decode steps' ring steps
    write ``lat_codes``, ``lat_scales``, ``lat_hot`` and ``cold_len`` bit
    for bit as the reference does."""
    dtype, jcfg, cfg, jparams, params, tokens = setup
    jscfg = dataclasses.replace(JSCFG, kv_rate_bits=bits)
    scfg = ServeConfig.from_reference(jscfg)
    R = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    rng = np.random.default_rng(bits)
    table = (rng.standard_normal((MAX_LEN, R)) * 2).astype(np.float32)
    table[3] = 0.0
    table[5, ::3] = -0.0
    table[7] = rng.integers(-7, 7, R) + 0.5
    table = np.array(jnp.asarray(table).astype(jnp.bfloat16)
                     .astype(jnp.float32))

    def jlatent(p, x, positions, cfg_):
        rows = jnp.asarray(table)[positions]
        return jnp.broadcast_to(rows, x.shape[:2] + (R,)).astype(x.dtype)

    def tlatent(p, x, positions, cfg_):
        rows = torch.from_numpy(table)[positions.long()]
        return rows.expand(x.shape[:2] + (R,)).to(x.dtype)

    monkeypatch.setattr(JL, "mla_latent", jlatent)
    monkeypatch.setattr(TL, "mla_latent", tlatent)
    lens = np.asarray(LENS, np.int32)
    _, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                          scfg, MAX_LEN, lens=torch.from_numpy(lens))
    jlg, jcache = JD.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcfg,
                             jscfg, MAX_LEN, lens=jnp.asarray(lens))

    def same(port, ref):
        a = interop.cache_to_numpy(port)
        for k, v in a.items():
            np.testing.assert_array_equal(
                v.view(np.uint32) if v.dtype == np.float32 else v,
                np.asarray(ref[k], v.dtype).view(np.uint32)
                if v.dtype == np.float32 else np.asarray(ref[k]),
                err_msg=k)

    same(cache, jcache)
    tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
    pos = lens.copy()
    for _ in range(3):
        TD.decode_step(params, cache, torch.tensor(tok), torch.tensor(pos),
                       cfg, scfg)
        _, jcache = JD.decode_step(jparams, jcache, jnp.asarray(tok),
                                   jnp.asarray(pos), jcfg, jscfg)
        same(cache, jcache)
        pos = pos + 1
    # the steps evicted from the ring into the codes region
    assert np.all(np.asarray(jcache["cold_len"]) == np.maximum(
        pos - 1 - JSCFG.hot_window + 1, np.maximum(lens - JSCFG.hot_window,
                                                   0)))


def test_paper_mode_decode_matches_fused(setup):
    """Promote-then-read (the latent dequantized by B4 at its block, then
    plain attention) against the fused latent partial (B5's latent form):
    logits within 2e-2; on the CPU neither launches a kernel."""
    dtype, _, cfg, _, params, tokens = setup
    lens = torch.tensor(LENS, dtype=torch.int32)
    out = []
    d0, l0 = qpack.decode_launches, KA.latent_launches
    for fused in (True, False):
        scfg = dataclasses.replace(SCFG, fused_dequant_attention=fused)
        lg, cache = TD.prefill(params, {"tokens": torch.from_numpy(tokens)},
                               cfg, scfg, MAX_LEN, lens=lens)
        tok = lg.argmax(dim=-1).to(torch.int32)
        lg, _ = TD.decode_step(params, cache, tok, lens.clone(), cfg, scfg)
        out.append(lg)
    _close(out[0], out[1].to(torch.float32).numpy(), 2e-2)
    assert (qpack.decode_launches, KA.latent_launches) == (d0, l0)
