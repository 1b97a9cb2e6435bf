"""The port's Mamba1 layer (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on REDUCED falcon-mamba-7b (d 128, d_in
256, d_state 8, d_conv 4, chunk 32) in float32, inputs made from a seed
with numpy, the mixer's params from the reference's
``mamba1_init(PRNGKey(0))``.

Tolerance: 1e-5 relative (and 1e-6 absolute, for values near 0). The two
packages sum the conv taps in the same order, but their scans associate
the products differently (XLA's associative scan is an odd/even tree, the
port's a Hillis-Steele scan) and their einsums block the N-contraction
differently: each rounds an f32 value a few times, in another order. The
bf16 conv tail of a decode state may differ by one bf16 step where the
f32 input it rounds lies at a rounding boundary.

C10 (ROADMAP): a scan of T steps needs T <= chunk or T % chunk == 0; both
packages refuse T = 45 at chunk 32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import ssm as JSSM
from repro_torch.configs import get_reduced
from repro_torch.models import ssm as TSSM

JCFG = dataclasses.replace(jget_reduced("falcon_mamba_7b"), dtype="float32")
CFG = dataclasses.replace(get_reduced("falcon_mamba_7b"), dtype="float32")
D_IN = CFG.ssm.expand * CFG.d_model
N, K, CHUNK = CFG.ssm.d_state, CFG.ssm.d_conv, CFG.ssm.chunk
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def mixer():
    jp, _ = JSSM.mamba1_init(jax.random.PRNGKey(0), JCFG)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) *
            scale).astype(np.float32)


def test_config_matches_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert TSSM._dt_rank(CFG) == JSSM._dt_rank(JCFG)


def test_mixer_init_distributions(mixer):
    """The port's own init has the reference's leaves, shapes, dtypes and
    constants (the random leaves come from another generator)."""
    jp, tp = mixer
    gen = torch.Generator().manual_seed(0)
    own = TSSM.mamba1_init(gen, CFG, torch.float32, "cpu")
    assert own.keys() == tp.keys()
    for k in own:
        assert own[k].shape == tp[k].shape and own[k].dtype == tp[k].dtype
    for k in ("conv_b", "dt_bias", "D"):
        assert torch.equal(own[k], tp[k]), k
    # log(1..N): XLA's and PyTorch's logs may round one step apart
    torch.testing.assert_close(own["A_log"], tp["A_log"], rtol=2.0 ** -23,
                               atol=0.0)


@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches(mixer, with_state):
    jp, tp = mixer
    x = _normal(1, (2, 20, D_IN))
    init = None
    if with_state:
        init = _normal(2, (2, K - 1, D_IN)).astype(jnp.bfloat16)
    want = JSSM._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"],
                             None if init is None else jnp.asarray(init))
    got = TSSM._causal_conv(
        torch.from_numpy(x), tp["conv_w"], tp["conv_b"],
        None if init is None else
        torch.from_numpy(init.astype(np.float32)).to(torch.bfloat16))
    assert got.dtype == torch.float32
    _close(got, want)


def _scan_fns(np_mod):
    """The Mamba1 core's decay/inp maker and C contraction, for jnp (the
    reference's own) or for torch (the port's)."""
    A = -np.exp(np.log(np.tile(np.arange(1, N + 1, dtype=np.float32),
                               (D_IN, 1))))
    if np_mod is jnp:
        A = jnp.asarray(A)

        def make_di(xs):
            dtc, xc, bc, _ = xs
            return jnp.exp(dtc[..., None] * A), \
                (dtc * xc)[..., None] * bc[:, :, None, :]
        return make_di, lambda h, xs: jnp.einsum("btdn,btn->btd", h, xs[3])
    A = torch.from_numpy(A)

    def make_di(xs):
        dtc, xc, bc, _ = xs
        return torch.exp(dtc[..., None] * A), \
            (dtc * xc)[..., None] * bc[:, :, None, :]
    return make_di, lambda h, xs: torch.einsum("btdn,btn->btd", h, xs[3])


@pytest.mark.parametrize("T", [20, 32, 96])
def test_chunked_scan_matches(T):
    """Under a chunk (20), one chunk (32) and three chunks (96), from a
    nonzero h0: the outputs and the final state."""
    ins = [np.abs(_normal(3, (2, T, D_IN), 0.05)) + 1e-3,   # dt > 0
           _normal(4, (2, T, D_IN)), _normal(5, (2, T, N)),
           _normal(6, (2, T, N))]
    h0 = _normal(7, (2, D_IN, N))
    jmd, jct = _scan_fns(jnp)
    want_y, want_h = JSSM._chunked_ssm_scan_out(
        tuple(jnp.asarray(a) for a in ins), jnp.asarray(h0), jmd, jct, CHUNK)
    tmd, tct = _scan_fns(torch)
    got_y, got_h = TSSM._chunked_ssm_scan_out(
        tuple(torch.from_numpy(a) for a in ins), torch.from_numpy(h0), tmd,
        tct, CHUNK)
    assert got_y.shape == (2, T, D_IN) and got_h.shape == (2, D_IN, N)
    _close(got_y, want_y)
    _close(got_h, want_h)


def test_scan_refuses_what_the_reference_refuses():
    """C10: T = 45 at chunk 32 is neither under a chunk nor a multiple of
    it; the reference asserts, the port raises naming the rule."""
    T = 45
    ins = [np.ones((1, T, D_IN), np.float32), np.ones((1, T, D_IN),
                                                      np.float32),
           np.ones((1, T, N), np.float32), np.ones((1, T, N), np.float32)]
    h0 = np.zeros((1, D_IN, N), np.float32)
    with pytest.raises(AssertionError):
        JSSM._chunked_ssm_scan_out(tuple(jnp.asarray(a) for a in ins),
                                   jnp.asarray(h0), *_scan_fns(jnp), CHUNK)
    with pytest.raises(ValueError, match="ROADMAP C10"):
        TSSM._chunked_ssm_scan_out(tuple(torch.from_numpy(a) for a in ins),
                                   torch.from_numpy(h0), *_scan_fns(torch),
                                   CHUNK)


@pytest.mark.parametrize("T", [20, 96])
def test_apply_train_matches(mixer, T):
    jp, tp = mixer
    u = _normal(8, (2, T, CFG.d_model))
    want = jax.jit(lambda p, u: JSSM.mamba1_apply_train(p, u, JCFG))(
        jp, jnp.asarray(u))
    got = TSSM.mamba1_apply_train(tp, torch.from_numpy(u), CFG)
    _close(got, want)


def test_decode_chain_matches(mixer):
    """Five chained decode steps from a random state, each package carrying
    its own state: the outputs, h and the bf16 conv tail."""
    jp, tp = mixer
    h = _normal(9, (2, D_IN, N), 0.5)
    conv = _normal(10, (2, K - 1, D_IN)).astype(jnp.bfloat16)
    jst = JSSM.Mamba1State(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tst = TSSM.Mamba1State(torch.from_numpy(h), torch.from_numpy(
        conv.astype(np.float32)).to(torch.bfloat16))
    step = jax.jit(lambda p, u, s: JSSM.mamba1_decode(p, u, s, JCFG))
    for t in range(5):
        u = _normal(11 + t, (2, 1, CFG.d_model))
        want, jst = step(jp, jnp.asarray(u), jst)
        got, tst = TSSM.mamba1_decode(tp, torch.from_numpy(u), tst, CFG)
        _close(got, want)
        _close(tst.h, jst.h)
        want_conv = np.asarray(jst.conv, np.float32)
        # one bf16 step (at most 2^-7 of the value) where the f32
        # input sat at a rounding boundary
        _close(tst.conv, want_conv, rtol=2.0 ** -7, atol=0.0)
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == torch.bfloat16


def test_init_state_matches():
    jst = JSSM.mamba1_init_state(JCFG, 3)
    tst = TSSM.mamba1_init_state(CFG, 3, "cpu")
    for a, b in zip(tst, jst):
        assert tuple(a.shape) == b.shape and not a.any()
    assert tst.h.dtype == torch.float32 and tst.conv.dtype == torch.bfloat16


@pytest.mark.parametrize("T", [20, 32])
def test_scan_forms_agree_bitwise(T):
    """The scan's two routes (serving's ``out=`` buffers, which reuse the
    inputs as scratch, and training's ``_ScanChunk``, whose forward runs
    the same products) give equal outputs bit for bit; under autograd the
    route takes the Function, whose gradient reaches every input, the
    state before the chunk and the params."""
    ins = [np.abs(_normal(3, (2, T, D_IN), 0.05)) + 1e-3,
           _normal(4, (2, T, D_IN)), _normal(5, (2, T, N)),
           _normal(6, (2, T, N))]
    h0 = torch.from_numpy(_normal(7, (2, D_IN, N)))
    A = -torch.exp(torch.from_numpy(_normal(8, (D_IN, N), 0.5)))

    def make_di(xs, a):
        dtc, xc, bc, _ = xs
        return torch.exp(dtc[..., None] * a), \
            (dtc * xc)[..., None] * bc[:, :, None, :]

    def contract(h, xs):
        return torch.einsum("btdn,btn->btd", h, xs[3])

    d, i = make_di([torch.from_numpy(a) for a in ins], A)
    dd, ii = TSSM._scan_into(d.clone(), i.clone())
    assert torch.equal(TSSM._chunk_states(
        [torch.from_numpy(a) for a in ins], h0, (A,), make_di),
        dd * h0[:, None] + ii)
    with torch.no_grad():
        want = TSSM._chunked_ssm_scan_out(
            tuple(torch.from_numpy(a) for a in ins), h0, make_di, contract,
            CHUNK, (A,))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    hg, Ag = h0.clone().requires_grad_(), A.clone().requires_grad_()
    got = TSSM._chunked_ssm_scan_out(tuple(leaves), hg, make_di, contract,
                                     CHUNK, (Ag,))
    assert all(torch.equal(a.detach(), b) for a, b in zip(got, want))
    assert "_ScanChunk" in type(got[1].grad_fn).__name__
    (got[0].sum() + got[1].sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (*leaves, hg, Ag))
