"""The port's MoE layer (``repro_torch/models/moe.py``) against the JAX
package's (``repro/models/moe.py``) at REDUCED qwen3-moe (8 experts, top-2)
and arctic (the same plus a dense residual MLP) in float32, params made by
the reference's ``init_params(PRNGKey(0))`` and carried across with
``interop.params_from_numpy``, inputs from numpy seeds: the expert choices
equal, outputs within 1e-5 and the aux loss within 1e-6 for the sorted and
grouped forms and for ``moe_apply`` on either side of its switch (1,023
and 1,024 tokens); cases built so that capacity drops pairs (asserted);
exact ties between experts (the lower index chosen, as ``jax.lax.top_k``
chooses); and B5's plain version at 16 query heads a KV head against the
reference kernel (interpret mode) and its decode partial.

The routing of random inputs is compared as it comes, unseeded for luck:
each case reports the smallest gap between a token's k-th and (k+1)-th
routing probability (the margin a rounding difference would have to
cross to flip a choice) in its assertion message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.core.compressor import quantize_blocks as jquant
from repro.kernels import ops as jops
from repro.models import decode as JD
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import get_reduced
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack
from repro_torch.models import moe as TM

ARCHS = ("qwen3_moe_235b_a22b", "arctic_480b")


def _cfgs(arch):
    return (dataclasses.replace(jget_reduced(arch), dtype="float32"),
            dataclasses.replace(get_reduced(arch), dtype="float32"))


@pytest.fixture(scope="module")
def layer0():
    """(reference cfg, port cfg, reference layer-0 MLP params, port's) per
    arch."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp = jax.tree_util.tree_map(
            np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
        tp = interop.params_from_numpy(jp, cfg, device="cpu")
        jmlp = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                      jp["layers"]["mlp"])
        out[arch] = (jcfg, cfg, jmlp, tp["layers"][0]["mlp"])
    return out


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_choices(jmlp, x, k):
    probs = jax.nn.softmax(
        (jnp.asarray(x) @ jmlp["router"]).astype(jnp.float32), axis=-1)
    top_p, top_i = jax.lax.top_k(probs, k)
    srt = np.sort(np.asarray(probs), axis=-1)[..., ::-1]
    margin = float((srt[..., k - 1] - srt[..., k]).min())
    return np.asarray(top_i), margin


def _check(arch, layer0, x, fn_name):
    """Port against reference on x [B,S,D] through ``fn_name``: choices,
    outputs, aux. Returns the reference's choices and the margin."""
    jcfg, cfg, jmlp, tmlp = layer0[arch]
    k = cfg.moe.top_k
    want_i, margin = _ref_choices(jmlp, x, k)
    _, _, got_i = TM.route(tmlp["router"], torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), want_i,
                                  err_msg=f"choices differ (margin {margin})")
    out, aux = getattr(TM, fn_name)(tmlp, torch.from_numpy(x), cfg)
    jout, jaux = getattr(JM, fn_name)(jmlp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5, err_msg=f"margin {margin}")
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)
    return want_i, margin


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn_name,shape", [
    ("moe_apply_sorted", (2, 20)), ("moe_apply_sorted", (8, 1)),
    ("moe_apply_grouped", (2, 512)), ("moe_apply_grouped", (4, 256)),
    ("moe_apply", (1, 1023)), ("moe_apply", (1, 1024)),
    ("moe_apply", (3, 341))])
def test_moe_matches_reference(layer0, arch, fn_name, shape):
    cfg = layer0[arch][1]
    x = _x(shape + (cfg.d_model,), seed=sum(shape) + len(arch))
    _, margin = _check(arch, layer0, x, fn_name)
    assert margin > 0, "a random input tied two experts exactly"


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_switches_form_at_two_groups(layer0, arch, monkeypatch):
    """B*S >= 2 * GROUP_TOKENS (padding counted) takes the grouped form,
    as the reference does."""
    cfg, tmlp = layer0[arch][1], layer0[arch][3]
    taken = []
    for name in ("moe_apply_sorted", "moe_apply_grouped"):
        fn = getattr(TM, name)
        monkeypatch.setattr(TM, name, lambda *a, _f=fn, _n=name: (
            taken.append(_n), _f(*a))[1])
    for n in (1023, 1024):
        TM.moe_apply(tmlp, torch.zeros((1, n, cfg.d_model)), cfg)
    assert taken == ["moe_apply_sorted", "moe_apply_grouped"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn_name,shape", [
    ("moe_apply_sorted", (8, 1)), ("moe_apply_sorted", (2, 40)),
    ("moe_apply_grouped", (2, 512))])
def test_moe_drops_match_reference(layer0, arch, fn_name, shape):
    """Half the tokens are one repeated row, so their choices pile onto the
    same experts past the capacity: pairs are dropped (asserted from the
    counts), and the port drops the same ones as the reference."""
    cfg = layer0[arch][1]
    mo = cfg.moe
    x = _x(shape + (cfg.d_model,), seed=7 + shape[0])
    x[:, ::2] = x[0, 0]
    want_i, _ = _check(arch, layer0, x, fn_name)
    n = shape[0] * shape[1]
    if fn_name == "moe_apply_grouped":
        sg = min(TM.GROUP_TOKENS, n)
        groups = want_i.reshape(n // sg, sg * mo.top_k)
        cap = TM.capacity(mo.top_k, sg, mo.num_experts)
    else:
        groups = want_i.reshape(1, n * mo.top_k)
        cap = TM.capacity(mo.top_k, n, mo.num_experts)
    dropped = sum(int(np.maximum(np.bincount(g, minlength=mo.num_experts)
                                 - cap, 0).sum()) for g in groups)
    assert dropped > 0, f"no pair dropped at capacity {cap}"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("fn_name", ["moe_apply_sorted", "moe_apply_grouped"])
def test_moe_ties_take_the_lower_index(layer0, arch, fn_name):
    """Exact ties: a zero router ties every expert (experts 0..k-1 are
    chosen); a router whose columns 4 and 7 are equal, under a larger
    column 2, over integer inputs (exact sums) ties 4 and 7 for second
    place (4 is chosen). The port chooses as ``jax.lax.top_k`` does and
    computes the reference's outputs."""
    jcfg, cfg, jmlp, tmlp = layer0[arch]
    d, e, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    shape = (2, 512) if fn_name == "moe_apply_grouped" else (2, 20)
    x = np.random.default_rng(3).integers(1, 4, shape + (d,)).astype(
        np.float32) / 16
    zero = np.zeros((d, e), np.float32)
    cols = zero.copy()
    cols[:, 2], cols[:, 4], cols[:, 7] = 2 / 64, 1 / 64, 1 / 64
    for router, want in ((zero, list(range(k))), (cols, [2, 4])):
        jl = dict(jmlp, router=jnp.asarray(router))
        tl = dict(tmlp, router=torch.from_numpy(router))
        _, _, got_i = TM.route(tl["router"], torch.from_numpy(x), k)
        assert (got_i.numpy() == np.asarray(want)).all()
        out, aux = getattr(TM, fn_name)(tl, torch.from_numpy(x), cfg)
        jout, jaux = getattr(JM, fn_name)(jl, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6,
                                   rtol=1e-6)


def test_moe_params_carry_across(layer0):
    """``params_from_numpy`` carries the router, the three expert weights
    and arctic's nested dense MLP, at the reference's shapes."""
    for arch in ARCHS:
        jcfg, cfg, jmlp, tmlp = layer0[arch]
        mo = cfg.moe
        d, f, e = cfg.d_model, mo.expert_d_ff, mo.num_experts
        want = {"router": (d, e), "wi": (e, d, f), "wg": (e, d, f),
                "wo": (e, f, d)}
        if mo.dense_residual:
            assert set(tmlp["dense"]) == {"wi", "wg", "wo"}
            for name in ("wi", "wg", "wo"):
                np.testing.assert_array_equal(
                    tmlp["dense"][name].numpy(), np.asarray(
                        jmlp["dense"][name]))
        assert set(tmlp) == set(want) | ({"dense"} if mo.dense_residual
                                         else set())
        for name, shape in want.items():
            assert tuple(tmlp[name].shape) == shape
            np.testing.assert_array_equal(tmlp[name].numpy(),
                                          np.asarray(jmlp[name]))


# -- B5 at a group of 16 query heads a KV head (qwen3-moe's 64/4) ----------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("S,lengths", [(256, [256, 129, 0]),
                                       (128, [1, 128, 127])])
def test_kvc_plain_group16_matches_reference(bits, S, lengths):
    """B5's plain version at Hq 16 / Hkv 1, D 128: the normalised form
    against the reference kernel in interpret mode, and the partial
    against the reference decode's partial (live rows), within 2e-2."""
    B, Hq, Hkv, D = 3, 16, 1, 128
    rng = np.random.default_rng(bits + S)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kc, ks = qpack.encode_plain(torch.from_numpy(k), bits, D)
    vc, vs = qpack.encode_plain(torch.from_numpy(v), bits, D)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    lt = torch.tensor(lengths, dtype=torch.int32)
    jc, js = jquant(jnp.asarray(k), bits, D)
    jvc, jvs = jquant(jnp.asarray(v), bits, D)
    qj, lj = jnp.asarray(q).astype(jnp.bfloat16), jnp.asarray(lengths,
                                                               jnp.int32)
    got = KA.kvc_decode_attention(qt, kc, ks, vc, vs, lt, bits=bits)
    want = jops.kvc_decode_attention(qj, jc, js[..., 0], jvc, jvs[..., 0],
                                     lj, bits=bits, t_blk=128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2,
                               rtol=2e-2)
    sm = 1.0 / D ** 0.5
    m, l, acc = KA.kvc_decode_partial(qt, kc, ks, vc, vs, lt, bits=bits,
                                      sm_scale=sm)
    ref = JD.quantized_attention_partial(qj, jc, js[..., 0], jvc, jvs[..., 0],
                                         lj, bits=bits, chunk=128,
                                         sm_scale=sm)
    live = np.asarray(lengths) > 0
    for a, b in ((m, ref.m), (l, ref.l), (acc, ref.acc)):
        np.testing.assert_allclose(a.numpy()[live], np.asarray(b)[live],
                                   atol=2e-2, rtol=2e-2)


def test_kvc_group_cap_is_sixteen():
    """The card's B5 takes up to 16 query heads a KV head (two slices of
    eight); a group of 17 is refused before any launch, never sent to the
    plain version."""
    assert (KA.SLICE_HEADS, KA.MAX_GROUP) == (8, 16)
    assert [KA.head_slices(g) for g in (1, 7, 8, 9, 16)] == [1, 1, 1, 2, 2]
    with pytest.raises(ValueError, match="up to 16"):
        KA.head_slices(17)
