"""The arithmetic of the Hopper designs of the two attention kernels,
checked on the CPU against the reference:

  * B5 (decode attention over the compressed KV region) splits each
    lane's sequence by the wrapper's own chunk plan and merges the chunks'
    partials: the plain partial computed chunk by chunk and merged with
    ``models/decode.py::merge_partials`` equals the unsplit plain partial
    (f32, 1e-5) and holds to the reference's ``quantized_attention_partial``
    and ``kvc_attn_ref`` at their 2e-2, the ``empty_uniform`` form included.
  * B6 (prefill attention) on the tensor cores scales the f32 scores after
    the product, rounds P to bf16 before the second product, walks key
    tiles of the kernel's width (``TC_KEYS``: 96 at D 128, 128 at D 64 and
    80) and
    masks only the tiles that cross the diagonal or the end Sk: a model of
    exactly that rounding and tile schedule holds to the JAX
    ``ref.mha_ref`` at 2e-2 element-wise and 1e-2 normwise on bf16 inputs.
  * The wrappers' dispatch tables: which input types and head dims go to
    which route, and which inputs raise, without a card; and the wrappers'
    tile constants against the kernel sources'.

Inputs are made with numpy from a seed and given to both packages.
"""
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.compressor import quantize_blocks as jquant
from repro.kernels import ref as jref
from repro.models import decode as JD
from repro_torch.kernels import flash_attn as FA
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack
from repro_torch.models import decode as TD

TOL = 2e-2


def _np(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy()


# -- B5: the split and its merge ---------------------------------------------

def _kv(B, S, Hq, Hkv, D, bits, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    kc, ks = qpack.encode_plain(torch.from_numpy(k), bits, D)
    vc, vs = qpack.encode_plain(torch.from_numpy(v), bits, D)
    port = (torch.from_numpy(q).to(torch.bfloat16), kc, ks[..., 0].contiguous(),
            vc, vs[..., 0].contiguous())
    jc, js = jquant(jnp.asarray(k), bits, D)
    jvc, jvs = jquant(jnp.asarray(v), bits, D)
    ref = (jnp.asarray(q).astype(jnp.bfloat16), jc, js[..., 0], jvc,
           jvs[..., 0])
    return port, ref


def _split_partial(q, kc, ks, vc, vs, lens, bits, sm, c0, c1, uniform):
    """The partial of tokens [c0, c1): the plain version on the slice, or,
    in the empty_uniform form, every token of a length-0 row taking part at
    score -1e30 (the kernel's span is then all S tokens)."""
    local = (lens - c0).clamp(0, c1 - c0)
    args = (q, kc[:, c0:c1], ks[:, c0:c1], vc[:, c0:c1], vs[:, c0:c1])
    if not uniform:
        return TD.Partial(*KA.kvc_decode_partial_plain(*args, local, bits, sm))
    B, Hq, D = q.shape
    k = KA._dequant(kc[:, c0:c1], ks[:, c0:c1], bits, D)
    v = KA._dequant(vc[:, c0:c1], vs[:, c0:c1], bits, D)
    s, _ = KA._scores(q, k, local, sm)
    S = kc.shape[1]
    span = torch.where(lens == 0, S, lens)
    inside = (torch.arange(c0, c1)[None, :] < span[:, None])[:, None, None]
    m = torch.where(inside, s, KA.NEG_INF).amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * inside
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    return TD.Partial(m.reshape(B, Hq, 1),
                      p.sum(dim=-1, keepdim=True).reshape(B, Hq, 1),
                      acc.reshape(B, Hq, D))


@pytest.mark.parametrize("bits,D", [(4, 64), (8, 128), (4, 80), (8, 80)])
def test_kvc_split_merge_matches_unsplit_and_reference(bits, D):
    B, Hq, Hkv = 6, 4, 2
    chunk = KA.CHUNK
    S = 2 * chunk + 44
    lengths = [0, 1, chunk - 1, chunk, chunk + 1, S]
    (q, kc, ks, vc, vs), (qj, jc, js, jvc, jvs) = _kv(B, S, Hq, Hkv, D, bits,
                                                      seed=bits + D)
    lens = torch.tensor(lengths, dtype=torch.int32)
    sm = 1.0 / D ** 0.5
    plan = KA.chunk_plan(S)
    assert plan == [(0, chunk), (chunk, 2 * chunk), (2 * chunk, S)]
    for uniform in (False, True):
        parts = [_split_partial(q, kc, ks, vc, vs, lens, bits, sm, c0, c1,
                                uniform) for c0, c1 in plan]
        merged = parts[0]
        for p in parts[1:]:
            merged = TD.merge_partials(merged, p)
        if not uniform:
            whole = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits,
                                                sm)
            for got, want in zip(merged, whole):
                torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            ref = JD.quantized_attention_partial(
                qj, jc, js, jvc, jvs, jnp.asarray(lengths, jnp.int32),
                bits=bits, chunk=S, sm_scale=sm)
            live = np.asarray(lengths) > 0
            for got, want in zip(merged, (ref.m, ref.l, ref.acc)):
                np.testing.assert_allclose(_np(got)[live],
                                           np.asarray(want)[live], atol=TOL,
                                           rtol=TOL)
            assert np.all(_np(merged.m)[~live] == KA.NEG_INF)
            assert np.all(_np(merged.l)[~live] == 0)
            assert np.all(_np(merged.acc)[~live] == 0)
        else:
            got = TD.finish(merged, torch.float32)
            # q's bf16 values in f32, so that the output is not rounded
            want = KA.kvc_decode_attention_plain(q.float(), kc, ks, vc, vs,
                                                 lens, bits, sm)
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
            ref = jref.kvc_attn_ref(qj, jc, js, jvc, jvs, bits=bits,
                                    lengths=jnp.asarray(lengths, jnp.int32))
            np.testing.assert_allclose(_np(got), np.asarray(ref, np.float32),
                                       atol=TOL, rtol=TOL)


# -- B6: the tensor-core route's rounding and tile schedule -------------------

def _tc_model(q, k, v, causal, rows=64):
    """The tensor-core kernel's arithmetic in PyTorch: per group of 64 query
    rows (a consumer warpgroup), key tiles of ``TC_KEYS[D]`` up to its
    causal limit,
    scores f32 from bf16 operands scaled after the product by sm_scale *
    log2 e, masks (-1e30) only on tiles crossing the diagonal or Sk, exp2,
    P rounded to bf16 for the second product, l from the f32 P."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    bk = FA.TC_KEYS[D]
    scale = (1.0 / math.sqrt(D)) * math.log2(math.e)
    off = Sk - Sq
    kf = k.float().repeat_interleave(Hq // Hkv, dim=2)       # [B,Sk,Hq,D]
    vf = v.float().repeat_interleave(Hq // Hkv, dim=2)
    out = torch.zeros((B, Sq, Hq, D), dtype=torch.float32)
    for r0 in range(0, Sq, rows):
        r1 = min(r0 + rows, Sq)
        qf = q[:, r0:r1].float()
        end = min(Sk, r0 + rows + off) if causal else Sk
        m = torch.full((B, Hq, r1 - r0), -1e30)
        l = torch.zeros((B, Hq, r1 - r0))
        acc = torch.zeros((B, Hq, r1 - r0, D))
        for j0 in range(0, end, bk):
            j1 = min(j0 + bk, Sk)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kf[:, j0:j1]) * scale
            if (causal and j0 + bk - 1 > r0 + off) or j0 + bk > Sk:
                row = torch.arange(r0, r1)[:, None]
                col = torch.arange(j0, j1)[None, :]
                keep = ~(causal & (col > row + off))
                s = torch.where(keep, s, -1e30)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqk,bkhd->bhqd",
                              p.to(torch.bfloat16).float(), vf[:, j0:j1])
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)
        out[:, r0:r1] = o.transpose(1, 2)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D", [
    (200, 200, 4, 2, 64), (100, 300, 4, 1, 128), (130, 130, 2, 2, 128),
    (200, 200, 2, 2, 80)])
def test_tc_rounding_model_matches_mha_ref(causal, Sq, Sk, Hq, Hkv, D):
    rng = np.random.default_rng(Sq + Sk + D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, Sq, Hq, D), (2, Sk, Hkv, D), (2, Sk, Hkv, D))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    got = _tc_model(q, k, v, causal)
    want = jref.mha_ref(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrs),
                        causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)
    want = np.asarray(want, np.float32)
    assert np.linalg.norm(_np(got) - want) <= 1e-2 * np.linalg.norm(want)


# -- dispatch tables ----------------------------------------------------------

def test_dispatch_tables_without_a_card():
    """B6: bf16 -> tensor cores, f32 -> CUDA cores, D 64/80/128 only; every
    other input raises before anything is launched. B5: the chunk plan the
    launch's grid follows, and the inputs its kernel refuses."""
    assert FA.route_for(torch.bfloat16, 128) == "tensor_cores"
    assert FA.route_for(torch.bfloat16, 64) == "tensor_cores"
    assert FA.route_for(torch.float32, 128) == "cuda_cores"
    assert FA.route_for(torch.float32, 64) == "cuda_cores"
    assert FA.route_for(torch.bfloat16, 80) == "tensor_cores"
    assert FA.route_for(torch.float32, 80) == "cuda_cores"
    for dt, d in ((torch.float16, 128), (torch.float64, 64),
                  (torch.bfloat16, 96), (torch.float32, 256)):
        with pytest.raises(ValueError):
            FA.route_for(dt, d)
    bf = dict(dtype=torch.bfloat16)
    q, k = torch.zeros((1, 8, 4, 128), **bf), torch.zeros((1, 8, 2, 128), **bf)
    with pytest.raises(ValueError, match="devices"):
        FA.route(q, k, k)                               # a route, but no card
    with pytest.raises(ValueError, match="types differ"):
        FA.route(q, k.float(), k)
    with pytest.raises(ValueError, match="Sq"):
        FA.route(torch.zeros((1, 9, 4, 128), **bf), k, k, causal=True)
    with pytest.raises(ValueError, match="GQA"):
        FA.route(torch.zeros((1, 8, 3, 128), **bf), k, k)
    with pytest.raises(ValueError, match="head dim"):
        FA.route(torch.zeros((1, 8, 4, 32), **bf),
                 torch.zeros((1, 8, 2, 32), **bf),
                 torch.zeros((1, 8, 2, 32), **bf))

    for S, chunk in ((8, 128), (2048, 128), (2047, 64), (257, 256)):
        plan = KA.chunk_plan(S, chunk)
        assert len(plan) == -(-S // chunk) and plan[-1][1] == S
        assert all(b - a == chunk for a, b in plan[:-1])
    qq = torch.zeros((2, 8, 64), **bf)
    codes = torch.zeros((2, 16, 2, 32), dtype=torch.uint8)
    scales = torch.zeros((2, 16, 2))
    lens = torch.tensor([3, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="bits"):
        KA._launch(qq, codes, scales, codes, scales, lens, bits=5,
                   sm_scale=0.125, empty_uniform=False)
    with pytest.raises(ValueError, match="empty cache"):
        KA._launch(qq, codes[:, :0], scales[:, :0], codes[:, :0],
                   scales[:, :0], lens, 4, 0.125, False)
    with pytest.raises(ValueError, match="query heads"):
        KA._launch(torch.zeros((2, 34, 64), **bf), codes, scales, codes,
                   scales, lens, 4, 0.125, False)


def test_wrapper_tiles_match_kernel_sources():
    """The wrappers size B5's scratch by ``CHUNK`` and model B6's schedule
    by ``TC_KEYS``: both must be the compile-time tiles of the sources."""
    csrc = Path(FA.__file__).resolve().parents[1] / "csrc"
    fa = (csrc / "flash_attn.cu").read_text()
    kv = (csrc / "kvc_attn.cu").read_text()
    assert int(re.search(r"#define FLASH_TC_BK (\d+)", fa).group(1)) == \
        FA.TC_KEYS[128]
    assert int(re.search(r"struct Tile<64> \{\s*static constexpr int kBK = "
                         r"(\d+)", fa).group(1)) == FA.TC_KEYS[64]
    assert int(re.search(r"struct Tile<80, 80> \{\s*static constexpr int "
                         r"kBK = (\d+)", fa).group(1)) == FA.TC_KEYS[80]
    assert int(re.search(r"#define KVC_CHUNK (\d+)", kv).group(1)) == \
        KA.CHUNK
    assert int(re.search(r"constexpr int kMaxG = (\d+);", kv).group(1)) == \
        KA.SLICE_HEADS
    assert int(re.search(r"constexpr int kMaxGroup = (\d+);", kv)
               .group(1)) == KA.MAX_GROUP
    assert set(FA.TC_KEYS) == set(FA.HEAD_DIMS)
