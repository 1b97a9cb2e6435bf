"""The port's train step for the MLA family (minicpm3-4b) and the MoE
family (qwen3-moe-235b-a22b: 128 experts top-8 at its widths, 8 top-2
REDUCED; arctic-480b: top-2 plus the dense residual MLP) against the
reference's on REDUCED configs in float32 (``torch_train_parity.py``:
params from the reference's ``init_params``, the same batches, the
tolerances of ``test_torch_train.py``), and B6's autograd Function at the
head counts and dims these families train with on the card.

MoE: 4 x 32 tokens take the sorted dispatch and 8 x 128 (>= 2 x
``GROUP_TOKENS``) the grouped one; both carry the load-balance loss into
the loss and its gradient into the router. Expert choices are float32
here, so both packages route every pair alike (C9 concerns bf16).

On (data, model) meshes of gloo ranks (``TP.mesh_runs``: (2, 1), (1, 2),
(2, 2)) the three steps are held against the same reference run (losses
and grad norms rtol 1e-5, params and moments normwise 1e-4; measured at
most 8.6e-08, 4.3e-07, 1.2e-05 and 8.6e-06): MLA's heads, the experts
and arctic's dense MLP over
``model``, each MoE routing call the reference's across the data ranks
(microbatches 2: the rows re-dealt). qwen3-moe at a global 2 x 512 on
(2, 1) takes the grouped form with one group a rank (measured as
above); MLA with its normed input entered as well as its latents misses
the reference's first grad norm by 2.09x (14.354 against 6.879).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as TP
from repro.models import layers as JL
from repro_torch.common import tree as TR
from repro_torch.kernels import flash_attn as FA
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TT
from repro_torch.train import trainer

ARCHS = ["minicpm3_4b", "qwen3_moe_235b_a22b", "arctic_480b"]
ATTN_TOL = 1e-5


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return TP.setup(request.param)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_grads_and_loss_match_reference(family, microbatches):
    cfg, jcfg, jparams = family
    n = TP.check_grads(cfg, jcfg, jparams, microbatches)
    assert n == {"minicpm3-4b": 15, "qwen3-moe-235b-a22b": 13,
                 "arctic-480b": 16}[cfg.name]


def test_three_train_steps_match_reference_jit(family):
    cfg, jcfg, jparams = family
    losses = TP.check_three_steps(cfg, jcfg, jparams)
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_compressed_step_tracks_eager_reference(family):
    """C11: the reference's jitted compressed step cannot run; the port's
    compressed step matches its eager grads and update. Every whole-leaf
    block of these configs is even (B3's contract): REDUCED minicpm3's
    q_norm (128) and kv_norm (64), the MoE configs' norms."""
    cfg, jcfg, jparams = family
    blocks, (flips, total) = TP.check_compressed_steps(cfg, jcfg, jparams)
    assert total > 0 and all(b % 2 == 0 for b in blocks.values())
    if cfg.attn_kind == "mla":
        assert blocks["layers/attn/q_norm"] == 128
        assert blocks["layers/attn/kv_norm"] == 64


def test_moe_grouped_dispatch_grads_match_reference():
    """8 x 128 tokens take the grouped dispatch in both packages; the aux
    loss, the loss and every grad leaf as above."""
    cfg, jcfg, jparams = TP.setup("qwen3_moe_235b_a22b")
    B, S = 8, 128
    assert B * S >= 2 * MOE.GROUP_TOKENS
    from repro.data.pipeline import make_batch as jmake_batch
    from repro_torch.data.pipeline import make_batch
    jg, jl = TP.jgrads(jcfg)(jparams, jmake_batch(jcfg, 0, global_batch=B,
                                                  seq_len=S))
    p = TP.params(cfg, jparams)
    b = make_batch(cfg, 0, global_batch=B, seq_len=S, device="cpu")
    loss, aux = TT.loss_fn(trainer.model_view(p, cfg), b, cfg)
    assert float(aux["aux"]) > 0
    g, gl = trainer.grads_and_loss(p, b, cfg, 1)
    np.testing.assert_allclose(float(gl), float(jl), rtol=TP.LOSS_RTOL)
    want = dict(TR.leaves_with_paths(jg))
    for path, x in TR.leaves_with_paths(g):
        assert TP.norm_err(x, want[path]) <= TP.GRAD_TOL, path


@pytest.mark.parametrize("Hq,Hkv,D,Dv", [(40, 40, 96, 64), (64, 4, 128, 128)],
                         ids=["mla-40x96-64", "qwen3-moe-64-4x128"])
def test_attention_function_at_train_heads(Hq, Hkv, D, Dv):
    """B6's Function at minicpm3-4b's (40 heads, qk 96 / v 64) and
    qwen3-moe's (64/4 x 128) heads, causal, against ``jax.vjp`` of the
    reference's ``chunked_attention``: output and grads normwise 1e-5."""
    rng = np.random.default_rng(Hq + D)
    B, S = 1, 48
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dv)).astype(np.float32)
    do = rng.standard_normal((B, S, Hq, Dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(
        q, k, v, causal=True, chunk=16), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention_trainable(tq, tk, tv, causal=True)
    o.backward(torch.from_numpy(do))
    assert TP.norm_err(o.detach(), out) <= ATTN_TOL
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert TP.norm_err(g, w) <= ATTN_TOL


def test_moe_aux_loss_is_in_the_loss(family):
    """The MoE families' loss is the cross entropy plus the summed
    load-balance loss, as the reference's ``loss_fn``; MLA's aux is 0."""
    cfg, jcfg, jparams = family
    from repro.models import transformer as JT
    jl, jaux = jax.jit(lambda p, b: JT.loss_fn(p, b, jcfg))(
        jparams, TP.jbatch(jcfg))
    loss, aux = TT.loss_fn(trainer.model_view(TP.params(cfg, jparams), cfg),
                           TP.batch(cfg), cfg)
    np.testing.assert_allclose(float(aux["aux"]), float(jaux["aux"]),
                               rtol=TP.LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(float(loss), float(aux["xent"] + aux["aux"]),
                               rtol=1e-7)
    assert (float(aux["aux"]) > 0) == (cfg.family == "moe")


GROUPED = ("grouped", "qwen3_moe_235b_a22b", TP.train_cfgs(
    1, 2, 512, 1)[1], 2, 512, False)
MLA_TWICE = ("mla_entered_twice", "minicpm3_4b", TP.train_cfgs(1)[1],
             TP.BATCH, TP.SEQ, True)


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return TP.mesh_runs(ARCHS, tmp_path_factory.mktemp("mesh"),
                        {(2, 1): [GROUPED], (1, 2): [MLA_TWICE]})


@pytest.mark.parametrize("shape", TP.MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(mesh, arch, shape):
    """Three steps (microbatches 2) on the mesh against the reference's
    jitted one-device step: every param and raw moment gathered whole."""
    errs = TP.check_mesh(mesh[(arch, shape)], TP.ref_steps(arch))
    assert errs["leaves"] == 3 * {"minicpm3-4b": 15, "qwen3-moe-235b-a22b":
                                  13, "arctic-480b": 16}[
        TP.setup(arch)[0].name]


def test_mesh_grouped_moe_across_data_ranks(mesh):
    """qwen3-moe at a global 2 x 512 on (2, 1): the call's 1,024 tokens
    take the grouped form, each rank's 512 one whole group; one step
    against the reference's at that batch (aux loss over the whole
    call)."""
    _, arch, tcfg, gb, seq, _ = GROUPED
    assert gb * seq >= 2 * MOE.GROUP_TOKENS and seq == MOE.GROUP_TOKENS
    TP.check_mesh(mesh[("grouped", (2, 1))],
                  TP.ref_steps(arch, 1, gb, seq, 1))


def test_mesh_mla_enters_latents_not_input(mesh):
    """MLA at (1, 2) with its normed input entered too: the gradients that
    reach ``wq_a``, ``wkv_a`` and the residual stream are counted twice,
    and the first step's grad norm misses the reference's (the parity
    case above holds it to 1e-5)."""
    got = mesh[("mla_entered_twice", (1, 2))]["grad_norms"][0]
    want = TP.ref_steps("minicpm3_4b")["grad_norms"][0]
    assert abs(got - want) > 100 * TP.LOSS_RTOL * want, (got, want)
