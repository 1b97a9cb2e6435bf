"""The port's training path against the JAX package on REDUCED llama3-8b
(2 layers, d 256, 4/2 heads of 64, d_ff 512, vocab 512) in float32, params
made by the reference's ``init_params(PRNGKey(0))`` and carried across in
the reference's stacked layout (``interop.stacked_params_from_numpy``).

Tolerances, each measured on these inputs and stated with its margin:
  * B6's autograd Function (forward, and FlashAttention-2's backward in
    PyTorch) against ``jax.vjp`` of ``layers.chunked_attention``, float32:
    normwise 1e-5 (measured 2e-7 to 5e-7);
  * the loss at rtol 1e-5, every grad leaf normwise 1e-4 (float32 sums in
    another order);
  * ``adamw.update`` raw against the reference's: params and moments
    normwise 1e-6 (float32 pow and divisions rounded at other points);
  * compressed: the 8-bit codes of m and sqrt(v) equal to the reference's
    eager ``adamw.update`` but for codes one apart at a rounding boundary,
    under 1 in 1,000 (the scales within 1e-6 relative on identical grads;
    within 1e-4 where the grads are each package's own, normwise 1e-4
    apart);
  * three train steps (microbatches 2) against the reference's jitted
    step: losses at rtol 1e-5, params normwise 1e-4.
C11 is pinned: the reference's jitted step with ``compress_state=True``
raises ``ConcretizationTypeError``; the port's runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.types import OptimizerConfig as JOpt
from repro.common.types import TrainConfig as JTrain
from repro.configs import get_reduced as jget_reduced
from repro.data.pipeline import make_batch as jmake_batch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim import gradcomp as JG
from repro.train import trainer as JTR
from repro_torch import interop
from repro_torch.common import tree as TR
from repro_torch.common.types import OptimizerConfig, TrainConfig
from repro_torch.configs import get_reduced
from repro_torch.data.pipeline import make_batch
from repro_torch.kernels import flash_attn as FA
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw, gradcomp
from repro_torch.train import trainer

ATTN_TOL = 1e-5
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5
RAW_TOL = 1e-6
MAX_CODE_FLIPS = 1e-3


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / (den if den else 1.0))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax.tree_util.tree_map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)[0])
    return cfg, jcfg, jparams


def _params(cfg, jparams):
    return interop.stacked_params_from_numpy(jparams, cfg, device="cpu")


def _jbatch(jcfg, step=0, b=4, s=32):
    return jmake_batch(jcfg, step, global_batch=b, seq_len=s)


def _batch(cfg, step=0, b=4, s=32):
    return make_batch(cfg, step, global_batch=b, seq_len=s, device="cpu")


# -- B6 under autograd --------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D,Dv,chunk", [
    (48, 48, 4, 2, 64, 64, 16), (40, 64, 4, 4, 96, 64, 32),
    (33, 33, 4, 1, 96, 64, 8), (32, 32, 4, 2, 128, 128, 512)])
def test_attention_backward_matches_jax_vjp(causal, Sq, Sk, Hq, Hkv, D, Dv,
                                            chunk):
    rng = np.random.default_rng(Sq * D + causal)
    B = 2
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, Dv)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(
        q, k, v, causal=causal, chunk=16 if Sk % 16 == 0 else Sk), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention_trainable(tq, tk, tv, causal=causal)
    assert o.grad_fn is not None
    o.backward(torch.from_numpy(do))
    assert _norm_err(o.detach(), out) <= ATTN_TOL
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert _norm_err(g, w) <= ATTN_TOL
    # the backward in row chunks gives the same grads
    d2 = FA.flash_attention_backward(
        tq.detach(), tk.detach(), tv.detach(), o.detach(),
        torch.from_numpy(do), causal=causal, sm_scale=1.0 / D ** 0.5,
        chunk=chunk)
    for g, w in zip(d2, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


# -- loss and grads -----------------------------------------------------------

def test_loss_and_grads_match_reference(setup):
    cfg, jcfg, jparams = setup
    jb = _jbatch(jcfg)
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg), has_aux=True)(jparams)
    params = _params(cfg, jparams)
    loss, aux = TT.loss_fn(trainer.model_view(params, cfg), _batch(cfg), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(aux["xent"]), float(jaux["xent"]),
                               rtol=LOSS_RTOL)
    grads, gl = trainer.grads_and_loss(params, _batch(cfg), cfg, 1)
    assert float(gl) == float(loss)
    want = dict(TR.leaves_with_paths(jgrads))
    got = dict(TR.leaves_with_paths(grads))
    assert set(got) == set(want) and len(got) == 12
    for path, g in got.items():
        assert tuple(g.shape) == want[path].shape, path
        assert _norm_err(g, want[path]) <= GRAD_TOL, path


def test_grads_accumulate_in_place_into_the_stacked_buffer(setup):
    """Each layer's view is a graph leaf whose ``.grad`` is a view of the
    stacked buffer: the buffer holds the grads and no stacked copy is made."""
    cfg, _, jparams = setup
    params = _params(cfg, jparams)
    grads = TR.map_tree(torch.zeros_like, params)
    ptrs = {p: g.data_ptr() for p, g in TR.leaves_with_paths(grads)}
    trainer._backward_into(params, grads, _batch(cfg), cfg, "auto")
    for p, g in TR.leaves_with_paths(grads):
        assert g.data_ptr() == ptrs[p] and g.abs().sum() > 0, p


def test_remat_reruns_each_layer_forward(setup, monkeypatch):
    cfg, _, jparams = setup
    params = _params(cfg, jparams)
    calls = []
    inner = TT._attn_block
    monkeypatch.setattr(TT, "_attn_block",
                        lambda *a: calls.append(1) or inner(*a))
    for remat, want in ((True, 2 * cfg.num_layers), (False, cfg.num_layers)):
        calls.clear()
        c = dataclasses.replace(cfg, remat=remat)
        g1, l1 = trainer.grads_and_loss(params, _batch(cfg), c, 1)
        assert len(calls) == want
    calls.clear()
    with torch.no_grad():
        TT.forward(trainer.model_view(params, cfg), _batch(cfg), cfg)
    assert len(calls) == cfg.num_layers     # serving: no layer wrapped


def test_microbatched_grads_match_reference(setup):
    cfg, jcfg, jparams = setup
    jg, jl = JTR.grads_and_loss(jparams, _jbatch(jcfg), jcfg, 2)
    g, l = trainer.grads_and_loss(_params(cfg, jparams), _batch(cfg), cfg, 2)
    np.testing.assert_allclose(float(l), float(jl), rtol=LOSS_RTOL)
    want = dict(TR.leaves_with_paths(jg))
    for path, x in TR.leaves_with_paths(g):
        assert x.dtype == torch.float32
        assert _norm_err(x, want[path]) <= GRAD_TOL, path


# -- the optimizer ------------------------------------------------------------

@pytest.mark.parametrize("step0", [0, 7])
def test_adamw_raw_matches_reference(setup, step0):
    cfg, _, jparams = setup
    rng = np.random.default_rng(step0)

    def rnd(scale, pos=False):
        t = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape)
                                              * scale).astype(np.float32),
                                   jparams)
        return jax.tree_util.tree_map(np.abs, t) if pos else t
    grads, m0, v0 = rnd(1e-2), rnd(1e-3), rnd(1e-4, pos=True)
    ocfg = JOpt(lr=1e-3, warmup_steps=3)
    jstate = JA.AdamState(jnp.int32(step0), m0, v0)
    jp, jst, jm = JA.update(grads, jstate, jparams, ocfg)
    params = _params(cfg, jparams)
    state = interop.opt_state_from_numpy((step0, m0, v0), device="cpu")
    tgrads = interop.stacked_params_from_numpy(grads, cfg, device="cpu")
    p, st, m = adamw.update(tgrads, state, params,
                            OptimizerConfig(**dataclasses.asdict(ocfg)))
    assert int(st.step) == step0 + 1
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    for got, want in ((p, jp), (st.m, jst.m), (st.v, jst.v)):
        want = dict(TR.leaves_with_paths(want))
        for path, x in TR.leaves_with_paths(got):
            assert _norm_err(x, want[path]) <= RAW_TOL, path


def _compressed_state(jparams, seed, block):
    """A reference compressed state from random moments (eager)."""
    rng = np.random.default_rng(seed)
    m = jax.tree_util.tree_map(lambda p: JA._compress_leaf(
        jnp.asarray(rng.standard_normal(p.shape) * 1e-3, jnp.float32), block),
        jparams)
    v = jax.tree_util.tree_map(lambda p: JA._compress_leaf(
        jnp.asarray(np.abs(rng.standard_normal(p.shape)) * 1e-2,
                    jnp.float32), block), jparams)
    return JA.AdamState(jnp.int32(3), m, v)


def _assert_codes_close(got_state, want_state, what, scale_rtol=1e-6):
    """Codes equal but for flips of one at a rounding boundary, under
    MAX_CODE_FLIPS of them; scales within ``scale_rtol`` (float32 rounding
    on identical grads)."""
    flips = total = 0
    for tree_g, tree_w in ((got_state.m, want_state.m),
                           (got_state.v, want_state.v)):
        want = dict(TR.leaves_with_paths(jax.tree_util.tree_map(
            np.asarray, tree_w)))
        for path, x in TR.leaves_with_paths(tree_g):
            w = want[path]
            if path[-1] == "block":
                assert x == int(w), path
            elif path[-1] == "codes":
                d = np.abs(x.numpy().view(np.int8).astype(np.int32) -
                           w.view(np.int8).astype(np.int32))
                assert d.max() <= 1, (what, path, d.max())
                flips += int((d > 0).sum())
                total += d.size
            else:
                np.testing.assert_allclose(x.numpy(), w, rtol=scale_rtol,
                                           err_msg=str(path))
    assert flips <= MAX_CODE_FLIPS * total, (what, flips, total)
    return flips, total


@pytest.mark.parametrize("block", [512, 256])
def test_adamw_compressed_matches_eager_reference(setup, block):
    """Eager (the jitted compressed step cannot run: C11). At block 512 the
    stacked ln1/ln2 leaves ([2, 256], 512 values) are one block across
    both layers, final_norm (256) one block of its own: the block rule is
    the stacked leaf's."""
    cfg, _, jparams = setup
    rng = np.random.default_rng(1)
    grads = jax.tree_util.tree_map(lambda p: (rng.standard_normal(p.shape)
                                              * 1e-2).astype(np.float32),
                                   jparams)
    ocfg = JOpt(lr=1e-3, warmup_steps=3, compress_state=True,
                state_block=block)
    jstate = _compressed_state(jparams, 2, block)
    jp, jst, _ = JA.update(grads, jstate, jparams, ocfg)
    state = interop.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert state.m["layers"]["ln1"]["block"] == 512 if block == 512 else 256
    assert state.m["final_norm"]["block"] == 256
    p, st, _ = adamw.update(
        interop.stacked_params_from_numpy(grads, cfg, device="cpu"), state,
        _params(cfg, jparams), OptimizerConfig(**dataclasses.asdict(ocfg)))
    want = dict(TR.leaves_with_paths(jp))
    for path, x in TR.leaves_with_paths(p):
        assert _norm_err(x, want[path]) <= RAW_TOL, path
    _assert_codes_close(st, jst, f"block {block}")


def test_update_in_slices_equals_one_slice(setup, monkeypatch):
    """Slices of whole blocks give the same update as whole leaves."""
    cfg, _, jparams = setup
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, compress_state=True)
    out = []
    for slice_values in (1 << 26, 1024):
        monkeypatch.setattr(adamw, "SLICE_VALUES", slice_values)
        params = _params(cfg, jparams)
        state = adamw.init(params, ocfg)
        grads, _ = trainer.grads_and_loss(params, _batch(cfg), cfg, 1)
        for _ in range(2):
            params, state, m = adamw.update(grads, state, params, ocfg)
        out.append((params, state, m))
    (p1, s1, m1), (p2, s2, m2) = out
    torch.testing.assert_close(m1["grad_norm"], m2["grad_norm"], rtol=1e-6,
                               atol=0)
    for (_, a), (_, b) in zip(TR.leaves_with_paths((p1, s1)),
                              TR.leaves_with_paths((p2, s2))):
        if isinstance(a, torch.Tensor) and a.dtype == torch.uint8:
            assert torch.equal(a, b)
        elif isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_state_bytes_and_compressed_state_smaller(setup):
    cfg, _, jparams = setup
    params = _params(cfg, jparams)
    for comp in (False, True):
        ocfg = OptimizerConfig(compress_state=comp)
        want = JA.state_bytes(JA.init(jparams, JOpt(compress_state=comp)))
        assert adamw.state_bytes(adamw.init(params, ocfg)) == want
    dense = adamw.state_bytes(adamw.init(params, OptimizerConfig()))
    comp = adamw.state_bytes(adamw.init(params, OptimizerConfig(
        compress_state=True)))
    assert comp < 0.35 * dense


def test_compressed_init_equals_reference(setup):
    cfg, _, jparams = setup
    jst = JA.init(jparams, JOpt(compress_state=True))
    st = adamw.init(_params(cfg, jparams), OptimizerConfig(
        compress_state=True))
    want = dict(TR.leaves_with_paths(interop.opt_state_to_numpy(st)))
    for path, w in TR.leaves_with_paths(jax.tree_util.tree_map(np.asarray,
                                                               jst)):
        np.testing.assert_array_equal(want[path], w, err_msg=str(path))


def test_odd_leaf_refused_not_taken_plain():
    """A whole-leaf block must be even (B3's contract): an odd leaf
    raises, it never takes another path."""
    p = {"w": torch.zeros((7,))}
    with pytest.raises(ValueError, match="even"):
        adamw.init(p, OptimizerConfig(compress_state=True))


# -- the train step -----------------------------------------------------------

def test_three_train_steps_match_reference_jit(setup):
    cfg, jcfg, jparams = setup
    jt = JTrain(steps=3, seq_len=32, global_batch=4, microbatches=2,
                optimizer=JOpt(lr=1e-3, warmup_steps=1))
    tcfg = TrainConfig(steps=3, seq_len=32, global_batch=4, microbatches=2,
                       optimizer=OptimizerConfig(lr=1e-3, warmup_steps=1))
    jstep, _ = JTR.make_train_step(jcfg, jt)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jopt = JA.init(jp, jt.optimizer)
    step, shard = trainer.make_train_step(cfg, tcfg)
    assert shard is None
    params = _params(cfg, jparams)
    opt = adamw.init(params, tcfg.optimizer)
    for i in range(3):
        jp, jopt, jm = jstep(jp, jopt, _jbatch(jcfg, i))
        params, opt, m = step(params, opt, _batch(cfg, i))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    want = dict(TR.leaves_with_paths(jax.tree_util.tree_map(np.asarray, jp)))
    for path, x in TR.leaves_with_paths(params):
        assert _norm_err(x, want[path]) <= GRAD_TOL, path


def test_c11_reference_jitted_compressed_step_raises(setup):
    _, jcfg, jparams = setup
    jt = JTrain(steps=1, seq_len=32, global_batch=4,
                optimizer=JOpt(compress_state=True))
    jstep, _ = JTR.make_train_step(jcfg, jt)
    jopt = JA.init(jparams, jt.optimizer)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jstep(jax.tree_util.tree_map(jnp.asarray, jparams), jopt,
              _jbatch(jcfg))


def test_c11_port_compressed_step_tracks_eager_reference(setup):
    """The port's compressed step runs, and matches the reference's eager
    grads + update step by step (each step fed the reference's params and
    state, so a code flip does not compound)."""
    cfg, jcfg, jparams = setup
    ocfg = JOpt(lr=1e-3, warmup_steps=1, compress_state=True)
    tcfg = TrainConfig(seq_len=32, global_batch=4, optimizer=OptimizerConfig(
        **dataclasses.asdict(ocfg)))
    step, _ = trainer.make_train_step(cfg, tcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jopt = JA.init(jp, ocfg)
    flips = total = 0
    for i in range(2):
        params = _params(cfg, jax.tree_util.tree_map(np.asarray, jp))
        opt = interop.opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jopt), device="cpu")
        g, jl = JTR.grads_and_loss(jp, _jbatch(jcfg, i), jcfg, 1)
        jp, jopt, _ = JA.update(g, jopt, jp, ocfg)
        params, opt, m = step(params, opt, _batch(cfg, i))
        np.testing.assert_allclose(float(m["loss"]), float(jl),
                                   rtol=LOSS_RTOL)
        want = dict(TR.leaves_with_paths(jp))
        for path, x in TR.leaves_with_paths(params):
            assert _norm_err(x, want[path]) <= GRAD_TOL, path
        f, t = _assert_codes_close(opt, jopt, f"step {i}", GRAD_TOL)
        flips, total = flips + f, total + t
    print(f"C11 step codes: {flips} of {total} one apart")
    assert total > 0


# -- gradient compression ------------------------------------------------------

def test_gradcomp_codes_equal_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((4, 512)).astype(np.float32) * 0.01,
         "b": rng.standard_normal((300,)).astype(np.float32)}
    r = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-4
         for k, v in g.items()}
    jq, jr = JG.compress_with_feedback(g, r, block=256)
    tq, tr = gradcomp.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in g.items()},
        {k: torch.from_numpy(v) for k, v in r.items()}, block=256)
    for k in g:
        np.testing.assert_array_equal(tq[k]["codes"].numpy(),
                                      np.asarray(jq[k]["codes"]))
        np.testing.assert_array_equal(tq[k]["scales"].numpy(),
                                      np.asarray(jq[k]["scales"]))
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]),
                                   atol=1e-7)
    back = gradcomp.decompress(tq, {k: torch.from_numpy(v)
                                    for k, v in g.items()}, block=256)
    jback = JG.decompress(jq, g, block=256)
    for k in g:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))
    assert gradcomp.compressed_bytes(tq) == JG.compressed_bytes(jq)


def test_gradcomp_error_feedback_reduces_bias():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.standard_normal(2048).astype(
        np.float32) * 0.01)}
    r = gradcomp.init_residual(g)
    acc_true = torch.zeros(2048)
    acc_comp = torch.zeros(2048)
    for i in range(16):
        gi = {"w": torch.from_numpy(np.random.default_rng(i + 1)
                                    .standard_normal(2048).astype(
                                        np.float32) * 0.01)}
        q, r = gradcomp.compress_with_feedback(gi, r, block=256)
        acc_true += gi["w"]
        acc_comp += gradcomp.decompress(q, gi, block=256)["w"]
    err = float(torch.linalg.norm(acc_comp - acc_true) /
                torch.linalg.norm(acc_true))
    assert err < 0.05, err


def test_gradcomp_bytes():
    g = {"w": torch.zeros((4096,), dtype=torch.float32)}
    q, _ = gradcomp.compress_with_feedback(g, gradcomp.init_residual(g))
    assert gradcomp.compressed_bytes(q) < 0.3 * 4096 * 4


def test_init_residual_flat_is_zeros(setup):
    cfg, _, jparams = setup
    params = _params(cfg, jparams)
    res = trainer.init_residual_flat(params, 4)
    want = JTR.init_residual_flat(jparams, 4)
    for (path, x), (_, w) in zip(TR.leaves_with_paths(res),
                                 TR.leaves_with_paths(want)):
        assert tuple(x.shape) == w.shape and not x.any(), path
