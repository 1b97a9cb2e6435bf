"""The port's attention kernels' plain versions against the reference:

  * B5, decode attention over the compressed KV region: the partial
    (m, l, acc) against ``models/decode.py::quantized_attention_partial``
    (the reference's jnp path) and the normalised form against the Pallas
    ``kvc_decode_attention`` (interpret mode), at the reference's kernel
    tolerance atol/rtol 2e-2 (``tests/test_kernels.py``), lengths 0,
    ragged and full; the length mask.
  * B6, prefill attention, against the Pallas ``flash_attention``
    (interpret mode, small tiles) and ``kernels/ref.py::mha_ref``, at
    2e-2 for bf16 and 2e-3 for f32 (the reference's own bounds).

Both packages get the same inputs, made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressor import quantize_blocks as jquant
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import decode as JD
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack
from repro_torch.kernels import ref as tref
from repro_torch.models import decode as TD

TOL = 2e-2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


def _kv_case(B, S, Hq, Hkv, D, bits, seed, lengths):
    """q (bf16) and quantized K/V in both packages."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kc, ks = qpack.encode_plain(torch.from_numpy(k), bits, D)
    vc, vs = qpack.encode_plain(torch.from_numpy(v), bits, D)
    port = (qt, kc, ks[..., 0].contiguous(), vc, vs[..., 0].contiguous(),
            torch.tensor(lengths, dtype=torch.int32))
    jc, js = jquant(jnp.asarray(k), bits, D)
    jvc, jvs = jquant(jnp.asarray(v), bits, D)
    ref = (jnp.asarray(q).astype(jnp.bfloat16), jc, js[..., 0], jvc,
           jvs[..., 0], jnp.asarray(lengths, jnp.int32))
    return port, ref


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,lengths", [
    (3, 256, 4, 2, 64, [256, 131, 0]),
    (2, 256, 8, 2, 128, [1, 200]),
    (2, 128, 4, 4, 128, [128, 77])])
def test_kvc_partial_matches_reference(bits, B, S, Hq, Hkv, D, lengths):
    (qt, kc, ks, vc, vs, lt), (qj, jc, js, jvc, jvs, lj) = _kv_case(
        B, S, Hq, Hkv, D, bits, seed=bits + S + D, lengths=lengths)
    sm = 1.0 / D ** 0.5
    m, l, acc = KA.kvc_decode_partial(qt, kc, ks, vc, vs, lt, bits=bits,
                                      sm_scale=sm)
    ref = JD.quantized_attention_partial(qj, jc, js, jvc, jvs, lj, bits=bits,
                                         chunk=min(128, S), sm_scale=sm)
    live = np.asarray(lengths) > 0
    for got, want in ((m, ref.m), (l, ref.l), (acc, ref.acc)):
        np.testing.assert_allclose(_np(got)[live], np.asarray(want)[live],
                                   atol=TOL, rtol=TOL)
    # an empty prefix is the neutral partial; merged with any other it
    # gives what the reference's merge gives
    assert np.all(_np(m)[~live] == -1e30)
    assert np.all(_np(l)[~live] == 0) and np.all(_np(acc)[~live] == 0)
    rng = np.random.default_rng(1)
    hot = [rng.standard_normal(a.shape).astype(np.float32)
           for a in (m, l, acc)]
    hot[1] = np.abs(hot[1]) + 1.0
    got = TD.finish(TD.merge_partials(
        TD.Partial(m, l, acc), TD.Partial(*map(torch.from_numpy, hot))),
        torch.float32)
    want = JD.finish(JD.merge_partials(
        ref, JD.Partial(*map(jnp.asarray, hot))), jnp.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,lengths", [
    (3, 256, 4, 2, 64, [256, 128, 0]), (1, 256, 8, 2, 128, [97])])
def test_kvc_attention_matches_pallas(bits, B, S, Hq, Hkv, D, lengths):
    """The normalised form against the TPU kernel in interpret mode and
    the reference oracle, length 0 included (both average V uniformly)."""
    (qt, kc, ks, vc, vs, lt), (qj, jc, js, jvc, jvs, lj) = _kv_case(
        B, S, Hq, Hkv, D, bits, seed=3 * bits + D, lengths=lengths)
    got = _np(KA.kvc_decode_attention(qt, kc, ks, vc, vs, lt, bits=bits))
    for want in (jops.kvc_decode_attention(qj, jc, js, jvc, jvs, lj,
                                           bits=bits, t_blk=128),
                 jref.kvc_attn_ref(qj, jc, js, jvc, jvs, bits=bits,
                                   lengths=lj)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, _np(tref.kvc_attn_ref(
        qt, kc, ks, vc, vs, bits=bits, lengths=lt)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("length", [100, 0])
def test_kvc_respects_length_mask(length):
    """Tokens at or beyond ``length`` do not influence the partial (the
    reference test's tail scaled by 100; length 0 is the empty partial)."""
    B, S, Hq, Hkv, D = 1, 256, 2, 1, 64
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32))
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    out = []
    for tail in (1.0, 100.0):
        k2, v2 = k.copy(), v.copy()
        k2[:, 100:] *= tail
        v2[:, 100:] *= tail
        kc, ks = qpack.encode_plain(torch.from_numpy(k2), 8, D)
        vc, vs = qpack.encode_plain(torch.from_numpy(v2), 8, D)
        out.append(KA.kvc_decode_partial(
            q.to(torch.bfloat16), kc, ks[..., 0], vc, vs[..., 0],
            torch.tensor([length], dtype=torch.int32), bits=8))
    for a, b in zip(*out):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


def _qkv(B, Sq, Sk, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, Hq, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,Hq,Hkv,D", [
    (2, 128, 4, 2, 64), (1, 128, 8, 2, 128), (1, 128, 2, 1, 128)])
def test_flash_plain_matches_pallas_bf16(causal, B, S, Hq, Hkv, D):
    arrs = _qkv(B, S, S, Hq, Hkv, D, seed=S + D + Hq)
    got = FA.flash_attention(*[torch.from_numpy(a).to(torch.bfloat16)
                               for a in arrs], causal=causal)
    jq, jk, jv = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrs]
    for want in (jops.flash_attention(jq, jk, jv, causal=causal, tq=64,
                                      tk=64),
                 jref.mha_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=TOL, rtol=TOL)


def test_flash_plain_matches_pallas_small_tiles_f32():
    arrs = _qkv(1, 64, 64, 2, 2, 64, seed=5)
    got = FA.flash_attention(*map(torch.from_numpy, arrs), causal=True)
    jq, jk, jv = map(jnp.asarray, arrs)
    for want in (jops.flash_attention(jq, jk, jv, causal=True, tq=32, tk=32),
                 jref.mha_ref(jq, jk, jv, causal=True)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk", [(1, 1), (37, 37), (24, 200), (200, 1000)])
def test_flash_plain_ragged_matches_mha_ref(causal, Sq, Sk):
    """Lengths that are no multiple of a tile, and Sq < Sk (causal rows see
    keys up to i + Sk - Sq, as in mha_ref)."""
    arrs = _qkv(2, Sq, Sk, 4, 2, 64, seed=Sq + Sk)
    got = FA.flash_attention(*map(torch.from_numpy, arrs), causal=causal)
    want = jref.mha_ref(*map(jnp.asarray, arrs), causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3,
                               rtol=2e-3)
    np.testing.assert_allclose(_np(got), _np(tref.mha_ref(
        *map(torch.from_numpy, arrs), causal=causal)), atol=2e-3, rtol=2e-3)
