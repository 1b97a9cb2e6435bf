"""The port's dense models against the reference on REDUCED llama3-8b
(2 layers, d 256, 4 heads, 2 KV heads, vocab 512), on REDUCED
codeqwen1.5-7b and deepseek-7b (the dense MHA configs: 4 heads, 4 KV
heads, group 1), and on the frontend backbones REDUCED chameleon-34b (8/2
heads of 32) and musicgen-medium (4/4 heads of 32), whose batches supply
seeded embeddings instead of tokens; params made by the
reference's ``init_params(PRNGKey(0))`` and carried across with
``interop.params_from_numpy``: ``forward``, ``prefill`` (right-padded, with
``lens``) and three ``decode_step``s.

Tolerances: in bf16 the logits agree within 2e-2 (the reference's kernel
bound): XLA on the CPU and PyTorch round bf16 products, ``cos``/``sin`` and
reductions at different points. In float32 they agree within 1e-4. Caches
compare after dequantization within the same bounds, except where a value
flipped by one rounding step: a K/V value that lands within rounding of a
quantization boundary (or of a bf16 boundary, for the ring) may round
either way in the two packages, and the flip moves it by one scale (or one
bf16 ulp). Such flips must stay under 1 in 100 values (about 0.3% of the
codes in bf16, under 0.1% in float32, on these inputs).
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
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.common.types import ModelConfig, ServeConfig
from repro_torch.configs import get_reduced
from repro_torch.kernels import qpack
from repro_torch.models import decode as TD
from repro_torch.models import transformer as TT

JSCFG = JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                     kv_rate_bits=8)
SCFG = ServeConfig.from_reference(JSCFG)
MAX_LEN = 64
LENS = (40, 23)            # one row longer than the ring, one padded
S = 40
TOLS = {"bfloat16": 2e-2, "float32": 1e-4}
MAX_FLIPS = 1e-2


@pytest.fixture(scope="module", params=[
    pytest.param(("llama3_8b", "bfloat16"), id="bfloat16"),
    pytest.param(("llama3_8b", "float32"), id="float32"),
    pytest.param(("codeqwen15_7b", "bfloat16"), id="codeqwen15_7b-bfloat16"),
    pytest.param(("deepseek_7b", "float32"), id="deepseek_7b-float32"),
    pytest.param(("chameleon_34b", "bfloat16"), id="chameleon_34b-bfloat16"),
    pytest.param(("chameleon_34b", "float32"), id="chameleon_34b-float32"),
    pytest.param(("musicgen_medium", "float32"),
                 id="musicgen_medium-float32")])
def setup(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=dtype)
    cfg = dataclasses.replace(get_reduced(arch), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cfg.vocab_size, (2, S)).astype(np.int32)
    tokens[1, LENS[1]:] = 0
    # the frontend stub's input: embeddings for the prompt and each of the
    # three decode steps (None: the model reads tokens)
    embeds = None if cfg.frontend == "none" else rng.standard_normal(
        (2, S + 3, cfg.d_model)).astype(np.float32)
    return dtype, jcfg, cfg, jparams, params, tokens, embeds


def _batch(tokens, embeds, jax_side: bool) -> dict:
    """The prefill batch: tokens, and the prompt's embeddings if any."""
    conv = jnp.asarray if jax_side else torch.from_numpy
    out = {"tokens": conv(tokens)}
    if embeds is not None:
        out["embeds"] = conv(np.ascontiguousarray(embeds[:, :S]))
    return out


def _step_embeds(embeds, t: int, jax_side: bool):
    """Decode step t's embeddings [B, d], or None."""
    if embeds is None:
        return None
    e = np.ascontiguousarray(embeds[:, S + t])
    return jnp.asarray(e) if jax_side else torch.from_numpy(e)


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_forward_matches(setup):
    dtype, jcfg, cfg, jparams, params, tokens, embeds = setup
    got, _ = TT.forward(params, _batch(tokens, embeds, False), cfg)
    want, _ = jax.jit(functools.partial(JT.forward, cfg=jcfg))(
        jparams, _batch(tokens, embeds, True))
    _close(got, want, TOLS[dtype])


def _dequant_cache(cache: dict, D: int, bits: int) -> dict:
    out = {}
    for kind in ("k", "v"):
        out[kind] = np.asarray(jdeq(jnp.asarray(cache[f"{kind}_codes"]),
                                    jnp.asarray(cache[f"{kind}_scales"])[
                                        ..., None], bits, D, jnp.float32))
        out[f"{kind}_scale"] = np.asarray(cache[f"{kind}_scales"])
        out[f"{kind}_hot"] = np.asarray(cache[f"{kind}_hot"], np.float32)
    out["cold_len"] = np.asarray(cache["cold_len"])
    return out


def _close_up_to_flips(got, want, tol: float, step, max_frac: float):
    """Within tol, except values one rounding step away (see the module
    docstring), which must stay under ``max_frac`` of all values."""
    diff = np.abs(got - want)
    bound = tol + tol * np.abs(want)
    assert np.all(diff <= bound + step * 1.001)
    frac = np.mean(diff > bound)
    assert frac <= max_frac, frac


def _compare_caches(port: dict, ref, cfg: ModelConfig, tol: float) -> None:
    D, bits = cfg.resolved_head_dim, SCFG.kv_rate_bits
    a = _dequant_cache(interop.cache_to_numpy(port), D, bits)
    b = _dequant_cache(jax.tree_util.tree_map(np.asarray, ref), D, bits)
    assert np.array_equal(a["cold_len"], b["cold_len"])
    for kind in ("k", "v"):
        np.testing.assert_allclose(a[f"{kind}_scale"], b[f"{kind}_scale"],
                                   atol=tol, rtol=tol)
        # a code flips by one scale; a bf16 ring value by one bf16 ulp
        _close_up_to_flips(a[kind], b[kind], tol,
                           np.abs(b[f"{kind}_scale"])[..., None], MAX_FLIPS)
        _close_up_to_flips(a[f"{kind}_hot"], b[f"{kind}_hot"], tol,
                           np.abs(b[f"{kind}_hot"]) * 2.0 ** -7, MAX_FLIPS)


def test_prefill_and_decode_match(setup):
    """Prefill, then three decode steps. Each step is fed the reference's
    cache (so a code flipped in an earlier step cannot leak into the next
    step's logits); the port's own cache, chained through the three steps,
    is compared after them."""
    dtype, jcfg, cfg, jparams, params, tokens, embeds = setup
    tol = TOLS[dtype]
    lens = np.asarray(LENS, np.int32)
    lg, cache = TD.prefill(params, _batch(tokens, embeds, False), cfg,
                           SCFG, MAX_LEN, lens=torch.from_numpy(lens))
    jlg, jcache = jax.jit(functools.partial(
        JD.prefill, cfg=jcfg, scfg=JSCFG, max_len=MAX_LEN))(
            jparams, _batch(tokens, embeds, True), lens=jnp.asarray(lens))
    _close(lg, jlg, tol)
    _compare_caches(cache, jcache, cfg, tol)

    step = jax.jit(functools.partial(JD.decode_step, cfg=jcfg, scfg=JSCFG))
    tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
    pos = lens.copy()
    for t in range(3):
        fed = interop.cache_from_numpy(
            jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
        e = _step_embeds(embeds, t, False)
        lg, _ = TD.decode_step(params, fed, torch.tensor(tok),
                               torch.tensor(pos), cfg, SCFG, e)
        TD.decode_step(params, cache, torch.tensor(tok), torch.tensor(pos),
                       cfg, SCFG, e)
        jlg, jcache = step(jparams, jcache, jnp.asarray(tok),
                           jnp.asarray(pos),
                           embeds=_step_embeds(embeds, t, True))
        _close(lg, jlg, tol)
        _compare_caches(fed, jcache, cfg, tol)
        tok = np.asarray(jnp.argmax(jlg, axis=-1), np.int32)
        pos = pos + 1
    _compare_caches(cache, jcache, cfg, tol)


def test_paper_mode_decode_matches_fused(setup):
    """The promote-then-read path (B4 + plain attention) and the fused path
    (B5) read the same compressed prefix: their logits agree within the
    dtype's bound, and in bf16 the paper path rounds the prefix to bf16
    first, exactly as the reference's does."""
    dtype, _, cfg, _, params, tokens, embeds = setup
    lens = torch.tensor(LENS, dtype=torch.int32)
    out = []
    for fused in (True, False):
        scfg = dataclasses.replace(SCFG, fused_dequant_attention=fused)
        lg, cache = TD.prefill(params, _batch(tokens, embeds, False),
                               cfg, scfg, MAX_LEN, lens=lens)
        tok = lg.argmax(dim=-1).to(torch.int32)
        lg, _ = TD.decode_step(params, cache, tok, lens.clone(), cfg, scfg,
                               _step_embeds(embeds, 0, False))
        out.append(lg)
    _close(out[0], out[1].to(torch.float32).numpy(), 2e-2)
    assert qpack.decode_launches == 0          # CPU: plain versions only
