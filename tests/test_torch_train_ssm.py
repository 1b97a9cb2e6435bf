"""The port's train step for the SSM family (falcon-mamba-7b, Mamba1) and
the hybrid family (zamba2-2.7b: Mamba2 groups, each followed by one of two
shared attention blocks, remat over a whole group) against the
reference's on REDUCED configs in float32 (``torch_train_parity.py``:
params from the reference's ``init_params``, the same batches, the
tolerances of ``test_torch_train.py``); the scan under autograd
(``models/ssm.py::_ScanChunk``) against ``jax.vjp`` of the reference's
``_chunked_ssm_scan_out``; what autograd keeps of a mixer against the
dry run's count; B6's Function at zamba2's 32/32 x 80.

On (data, model) meshes of gloo ranks (``TP.mesh_runs``: (2, 1), (1, 2),
(2, 2)) the three steps are held against the same reference run (losses
and grad norms rtol 1e-5, params and moments normwise 1e-4; measured at
most 1.6e-07, 1.1e-06, 1.9e-05 and 1.3e-05): the mixers' channels and
heads over ``model``, ``in_proj`` gathered whole and sliced, zamba2's
shared blocks at the rank's heads.

The scan: its forward equal bit for bit to serving's and within rtol
1e-5 (atol 1e-6) of the reference's; its gradients normwise within 1e-5
of the reference's VJP (measured 1e-7 to 3e-7) and elementwise within
rtol 1e-5 with an atol of 1e-5 of the gradient's largest value (XLA's
odd/even scan and the port's Hillis-Steele passes and reverse scan round
in other orders: one value in 768 is 1.7e-5 off relative to itself).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_parity as TP
from repro.models import layers as JL
from repro.models import ssm as JSSM
from repro_torch.common.types import OptimizerConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attn as FA
from repro_torch.launch import train as TL
from repro_torch.models import ssm as TSSM
from repro_torch.roofline import count as C
from repro_torch.train import trainer

ARCHS = ["falcon_mamba_7b", "zamba2_2p7b"]
SCAN_TOL = 1e-5
D_IN, N, H, P, CHUNK = 12, 4, 3, 4, 32


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    return TP.setup(request.param)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_grads_and_loss_match_reference(family, microbatches):
    cfg, jcfg, jparams = family
    n = TP.check_grads(cfg, jcfg, jparams, microbatches)
    assert n == {"falcon-mamba-7b": 13, "zamba2-2.7b": 21}[cfg.name]


def test_three_train_steps_match_reference_jit(family):
    cfg, jcfg, jparams = family
    losses = TP.check_three_steps(cfg, jcfg, jparams)
    assert len(losses) == 3 and all(np.isfinite(losses))


def test_compressed_step_tracks_eager_reference(family):
    """C11: the reference's jitted compressed step cannot run; the port's
    compressed step matches its eager grads and update. REDUCED zamba2's
    per-head leaves (dt_bias, A_log, D: [2, 2, 8], 32 values) are one
    whole-leaf block of 32, even; the published config's are 4,320."""
    cfg, jcfg, jparams = family
    blocks, (flips, total) = TP.check_compressed_steps(cfg, jcfg, jparams)
    assert total > 0 and all(b % 2 == 0 for b in blocks.values())
    if cfg.family == "hybrid":
        for leaf in ("dt_bias", "A_log", "D"):
            assert blocks[f"layers/mixer/{leaf}"] == 32


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def _scan_case(kind: str, T: int):
    """(ins, h0, A, grads of y and h_T, the decay/inp maker and C
    contraction for numpy module ``xp``): Mamba1's form (decay per channel
    and state) or Mamba2's (a decay a head, broadcast)."""
    if kind == "mamba1":
        ins = [np.abs(_normal(3, (2, T, D_IN), 0.05)) + 1e-3,
               _normal(4, (2, T, D_IN)), _normal(5, (2, T, N)),
               _normal(6, (2, T, N))]
        h0, A = _normal(7, (2, D_IN, N)), -np.exp(_normal(8, (D_IN, N), 0.5))
        gy, gh = _normal(9, (2, T, D_IN)), _normal(10, (2, D_IN, N))

        def fns(xp):
            def make_di(xs, a):
                dtc, xc, bc, _ = xs
                return xp.exp(dtc[..., None] * a), \
                    (dtc * xc)[..., None] * bc[:, :, None, :]
            return make_di, lambda h, xs: xp.einsum("btdn,btn->btd", h,
                                                    xs[3])
    else:
        ins = [np.abs(_normal(3, (2, T, H), 0.05)) + 1e-3,
               _normal(4, (2, T, H, P)), _normal(5, (2, T, H, N)),
               _normal(6, (2, T, H, N))]
        h0, A = _normal(7, (2, H, P, N)), -np.exp(_normal(8, (H,), 0.5))
        gy, gh = _normal(9, (2, T, H, P)), _normal(10, (2, H, P, N))

        def fns(xp):
            def make_di(xs, a):
                dtc, xc, bc, _ = xs
                return xp.exp(dtc * a)[..., None, None], \
                    (dtc[..., None] * xc)[..., None] * bc[:, :, :, None, :]
            return make_di, lambda h, xs: xp.einsum("bthpn,bthn->bthp", h,
                                                    xs[3])
    return ins, h0, A, gy, gh, fns


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
@pytest.mark.parametrize("T", [20, 32, 96])
def test_scan_vjp_matches_reference(kind, T):
    """Under a chunk (20), one chunk (32) and three (96), from a nonzero
    state: the gradients of the inputs, the state before the scan and the
    decay's param against the reference's VJP; the forward under autograd
    equal bit for bit to the serving route's."""
    ins, h0, A, gy, gh, fns = _scan_case(kind, T)
    jmd, jct = fns(jnp)

    def ref(ins, h0, A):
        return JSSM._chunked_ssm_scan_out(tuple(ins), h0,
                                          lambda xs: jmd(xs, A), jct, CHUNK)
    (jy, jh), vjp = jax.vjp(ref, [jnp.asarray(a) for a in ins],
                            jnp.asarray(h0), jnp.asarray(A))
    jgi, jgh, jgA = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    tmd, tct = fns(torch)
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    th, tA = (torch.from_numpy(a).requires_grad_() for a in (h0, A))
    y, hT = TSSM._chunked_ssm_scan_out(tuple(leaves), th, tmd, tct, CHUNK,
                                       (tA,))
    with torch.no_grad():
        sy, sh = TSSM._chunked_ssm_scan_out(
            tuple(torch.from_numpy(a) for a in ins), torch.from_numpy(h0),
            tmd, tct, CHUNK, (torch.from_numpy(A),))
    assert torch.equal(y.detach(), sy) and torch.equal(hT.detach(), sh)
    for got, want in ((y, jy), (hT, jh)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=SCAN_TOL, atol=1e-6)
    torch.autograd.backward([y, hT], [torch.from_numpy(gy),
                                      torch.from_numpy(gh)])
    for got, want in zip([*leaves, th, tA], [*jgi, jgh, jgA]):
        assert TP.norm_err(got.grad, want) <= SCAN_TOL
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=SCAN_TOL,
                                   atol=SCAN_TOL * np.abs(want).max())


def test_scan_refuses_under_training_too():
    """C10 under autograd: T = 45 at chunk 32 raises before any chunk."""
    ins, h0, A, _, _, fns = _scan_case("mamba1", 45)
    with pytest.raises(ValueError, match="ROADMAP C10"):
        TSSM._chunked_ssm_scan_out(
            tuple(torch.from_numpy(a).requires_grad_() for a in ins),
            torch.from_numpy(h0), *fns(torch), CHUNK,
            (torch.from_numpy(A).requires_grad_(),))


@pytest.mark.parametrize("arch", ARCHS)
def test_autograd_keeps_no_scan_pass(arch):
    """A mixer at its published widths (float32, 1 x 256 tokens: two chunks
    of 128) under autograd: no tensor autograd saves is a [B, chunk, ...,
    N] scan tensor (the largest is a [B, T, d_in] activation), and their
    bytes are the dry run's ``MIXER_SAVED`` count within 2% (bf16 mixers,
    whose activations are 2 bytes, measured 0.3-0.5% from it too)."""
    cfg = get_config(arch)
    kind = cfg.ssm.kind
    init, apply = (TSSM.mamba1_init, TSSM.mamba1_apply_train) \
        if kind == "mamba1" else (TSSM.mamba2_init, TSSM.mamba2_apply_train)
    p = init(torch.Generator().manual_seed(0), cfg, torch.float32, "cpu")
    for t in p.values():
        t.requires_grad_()
    T = 256
    u = torch.randn((1, T, cfg.d_model)).requires_grad_()
    skip = {t.untyped_storage().data_ptr() for t in (*p.values(), u)}
    saved = {}

    def pack(t):
        st = t.untyped_storage()
        if st.data_ptr() not in skip:
            saved[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        y = apply(p, u, cfg)
    d_in = cfg.ssm.expand * cfg.d_model
    chunk_bytes = cfg.ssm.chunk * d_in * cfg.ssm.d_state * 4
    assert max(saved.values()) < chunk_bytes
    a, b = C.MIXER_SAVED[kind]
    count = T * d_in * (a + b * 4) + (T // cfg.ssm.chunk) * \
        d_in * cfg.ssm.d_state * 4
    assert abs(sum(saved.values()) - count) <= 0.02 * count, \
        (sum(saved.values()), count)
    assert y.grad_fn is not None


def test_attention_function_at_zamba2_heads():
    """B6's Function at zamba2-2.7b's shared blocks' 32/32 heads of 80,
    causal, against ``jax.vjp`` of ``chunked_attention``: normwise 1e-5."""
    rng = np.random.default_rng(80)
    B, S, Hq, D = 1, 48, 32, 80
    q, k, v, do = (rng.standard_normal((B, S, Hq, D)).astype(np.float32)
                   for _ in range(4))
    out, vjp = jax.vjp(lambda q, k, v: JL.chunked_attention(
        q, k, v, causal=True, chunk=16), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = FA.flash_attention_trainable(tq, tk, tv, causal=True)
    o.backward(torch.from_numpy(do))
    assert TP.norm_err(o.detach(), out) <= 1e-5
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert TP.norm_err(g, w) <= 1e-5


def test_launcher_refuses_what_does_not_fit(monkeypatch):
    """The launcher's count on one card (``HBM_BYTES``) at 8 x 512 with the
    compressed state: zamba2-2.7b fits (the others' fits:
    ``test_torch_dryrun.py``); qwen3-moe is refused before anything is
    allocated, both byte counts named; so is a step the count puts under
    the card but within ``COUNT_MARGIN`` of it (deepseek-7b with float32
    moments at 8 x 128: 78.6 GiB counted of 79.2)."""
    from repro_torch.roofline import analyze as RA
    monkeypatch.setattr(TL, "device_memory_bytes", lambda dev: RA.HBM_BYTES)
    tcfg = TrainConfig(optimizer=OptimizerConfig(compress_state=True))
    cuda = torch.device("cuda", 0)
    assert TL.check_fits(get_config("zamba2_2p7b"), tcfg, cuda) * (
        1 + TL.COUNT_MARGIN) <= RA.HBM_BYTES
    with pytest.raises(SystemExit, match=rf"needs \d+ B .* past the "
                       rf"{RA.HBM_BYTES} B of cuda:0"):
        TL.check_fits(get_config("qwen3_moe_235b_a22b"), tcfg, cuda)
    near = TrainConfig(seq_len=128, optimizer=OptimizerConfig())
    need = TL.dryrun.count_cell(
        get_config("deepseek_7b"), TL.ShapeConfig("launch", 128, 8, "train"),
        TL.MeshConfig((1, 1), ("data", "model")), near)["peak_bytes"]
    assert need < RA.HBM_BYTES < need * (1 + TL.COUNT_MARGIN)
    with pytest.raises(SystemExit, match=rf"needs {need} B "):
        TL.check_fits(get_config("deepseek_7b"), near, cuda)
    assert TL.check_fits(dataclasses.replace(
        get_config("zamba2_2p7b"), num_layers=6), tcfg,
        torch.device("cpu")) > 0


def test_remat_unit_is_the_group(family, monkeypatch):
    """With remat the hybrid reruns each group (its Mamba2 layers and its
    shared block) in the backward, the SSM family each layer: every mixer
    runs twice a step, as the reference's ``jax.checkpoint`` units."""
    cfg, _, jparams = family
    calls = []
    name = "mamba2_apply_train" if cfg.family == "hybrid" else \
        "mamba1_apply_train"
    inner = getattr(TSSM, name)
    monkeypatch.setattr(TSSM, name, lambda *a: calls.append(1) or inner(*a))
    trainer.grads_and_loss(TP.params(cfg, jparams), TP.batch(cfg), cfg, 1)
    assert len(calls) == 2 * cfg.num_layers


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    return TP.mesh_runs(ARCHS, tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("shape", TP.MESHES, ids=lambda s: "%dx%d" % s)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_step_matches_reference(mesh, arch, shape):
    """Three steps (microbatches 2) on the mesh against the reference's
    jitted one-device step: every param and raw moment gathered whole."""
    errs = TP.check_mesh(mesh[(arch, shape)], TP.ref_steps(arch))
    assert errs["leaves"] == 3 * {"falcon-mamba-7b": 13, "zamba2-2.7b": 21}[
        TP.setup(arch)[0].name]
