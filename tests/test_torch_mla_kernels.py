"""The port's MLA kernel forms, their plain versions, against the
reference on the CPU:

  * the latent ring step (``qpack.latent_ring_step_plain``, and
    ``latent_ring_step`` on CPU tensors), in place, against the JAX
    ``_evict_latent`` then ``_hot_insert`` on ``lat_*``, bit for bit;
  * the latent prefill fill (``latent_prefill_fill_plain``, and
    ``latent_prefill_fill`` on CPU tensors) against the reference MLA
    prefill's quantize of the padded latent and its ring gather, bit for
    bit;
  * the latent lane flush (``latent_lane_flush_plain``, and
    ``latent_lane_flush``) against the JAX ``_ring_to_codes`` on
    ``lat_*``, bit for bit;
  * B5's latent form (``kvc_latent_partial_plain``/``kvc_latent_partial``)
    against the reference's ``quantized_attention_partial`` with the
    latent codes as K and as V (``lc[:, :, None, :]``), at REDUCED
    minicpm3's widths (4 heads, R 40) and at the full model's (40 heads, R
    288) with a short cache;
  * B6's plain version at a qk head dim other than v's (24/16 at REDUCED,
    96/64 at full width) against ``chunked_attention``, and the wrapper's
    dispatch tables for such pairs.

Shapes are the latent's: rows of R = kv_lora_rank + rope values, no head
axis. Tolerance for the attention partials: 1e-5 (f32 on both sides; the
chunked and the single-pass softmax sum in other orders). The CUDA kernels
are held against these plain versions on the card (test_torch_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.compressor import quantize_blocks as jquantize  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.kernels import flash_attn as FA  # noqa: E402
from repro_torch.kernels import kvc_attn as KA  # noqa: E402
from repro_torch.kernels import qpack  # noqa: E402

# latent widths: REDUCED minicpm3 (kv_lora_rank 32 + rope 8) and the full
# model's (256 + 32)
WIDTHS = {"reduced": 40, "full": 288}
W = 8


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint8
                  if a.itemsize == 1 else np.uint32)


def _ring(rng, shape) -> np.ndarray:
    """A bf16-exact ring of normal values with an all-zero slot, a +-0 slot
    and a slot of .5 ties (slot axis 1 from the end of the leading ones)."""
    hot = (rng.standard_normal(shape) * 0.7).astype(np.float32)
    hot[..., 1, :] = 0.0
    hot[..., 2, 1::2] = -0.0
    hot[..., 3, :] = rng.integers(-7, 7, shape[:-2] + (shape[-1],)) + 0.5
    return np.array(jnp.asarray(hot).astype(jnp.bfloat16).astype(jnp.float32))


# (pos, cold_len) per lane at W 8, S 40: before the window fills, at pos ==
# W, a resumed lane (pos - W < cold_len), evictions at 0, in the middle
# and near the end
RING_LANES = ([3, 8, 21, 9, 30, 39], [0, 0, 18, 0, 10, 2])


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("new", ["bf16", "f32"])
def test_latent_ring_step_plain_vs_reference(width, bits, new):
    R, S = WIDTHS[width], 40
    pos_np, cold_np = (np.array(a, np.int32) for a in RING_LANES)
    B = len(pos_np)
    rng = np.random.default_rng(bits + R)
    codes = rng.integers(0, 256, (B, S, R * bits // 8)).astype(np.uint8)
    scales = rng.standard_normal((B, S)).astype(np.float32)
    hot = _ring(rng, (B, W, R))
    newv = (rng.standard_normal((B, R)) * 3).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[new]
    jhot = jnp.asarray(hot).astype(jnp.bfloat16)
    c, s = jdec._evict_latent(
        {"lat_codes": jnp.asarray(codes), "lat_scales": jnp.asarray(scales),
         "lat_hot": jhot}, jnp.asarray(pos_np), jnp.asarray(cold_np), W, bits)
    h = jdec._hot_insert(jhot, jnp.asarray(newv).astype(jdt),
                         jnp.asarray(pos_np))
    for step in (qpack.latent_ring_step_plain, qpack.latent_ring_step):
        tc = torch.from_numpy(codes.copy())
        ts = torch.from_numpy(scales.copy())
        th = torch.from_numpy(hot).to(torch.bfloat16)
        n0 = qpack.latent_ring_step_launches
        step(tc, ts, th, torch.from_numpy(newv).to(tdt),
             torch.from_numpy(pos_np), torch.from_numpy(cold_np), bits)
        assert qpack.latent_ring_step_launches == n0
        np.testing.assert_array_equal(tc.numpy(), np.asarray(c))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(s))
        np.testing.assert_array_equal(
            _bits(th.float().numpy()), _bits(h.astype(jnp.float32)))
    evicted = pos_np - W >= cold_np
    changed = (np.asarray(c) != codes).any(axis=(1, 2))
    assert evicted.any() and (changed <= evicted).all()


# (S, lens): full rows, short prompts whose ring keeps slots of no real
# token, a one-token row, a window wider than the prompt
FILL_CASES = {"full": (24, [24, 24]), "short": (24, [5, 24, 1, 13]),
              "wide_window": (6, [6, 3])}


@pytest.mark.parametrize("case", list(FILL_CASES))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_latent_prefill_fill_plain_vs_reference(case, width, bits, dtype):
    """The reference MLA prefill's cache writes for one layer: the padded
    latent quantized with its ``quantize_blocks`` (code 0, scale 1 past the
    prompt), the ring gathered from the latest real token of each slot."""
    S, lens_l = FILL_CASES[case]
    R, B, max_len, layers, i = WIDTHS[width], len(lens_l), S + 5, 3, 1
    rng = np.random.default_rng(bits + R + S)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[dtype]
    lat = (rng.standard_normal((B, S, R)) * 2).astype(np.float32)
    lat[:, 0] = 0.0
    lat[:, 1, ::3] = -0.0
    lat = np.array(jnp.asarray(lat).astype(jdt).astype(jnp.float32))
    lens = np.array(lens_l, np.int32)
    jl = jnp.asarray(lat).astype(jdt)
    c, s = jquantize(jnp.pad(jl, ((0, 0), (0, max_len - S), (0, 0))), bits, R)
    last = jnp.asarray(lens) - 1
    p = last[:, None] - ((last[:, None] - jnp.arange(W)[None, :]) % W)
    hot = jnp.take_along_axis(jl, jnp.clip(p, 0, S - 1)[:, :, None], axis=1)
    want = (np.asarray(c), np.asarray(s[..., 0]),
            np.asarray(hot.astype(jnp.bfloat16).astype(jnp.float32)))
    for fill in (qpack.latent_prefill_fill_plain, qpack.latent_prefill_fill):
        cache = {"lat_codes": torch.zeros((layers, B, max_len, R * bits // 8),
                                          dtype=torch.uint8),
                 "lat_scales": torch.zeros((layers, B, max_len)),
                 "lat_hot": torch.zeros((layers, B, W, R),
                                        dtype=torch.bfloat16)}
        cache["lat_scales"][:, :, S:] = 1.0
        before = {k: v.clone() for k, v in cache.items()}
        n0 = qpack.latent_prefill_fill_launches
        fill(torch.from_numpy(lat).to(tdt), cache["lat_codes"][i],
             cache["lat_scales"][i], cache["lat_hot"][i],
             torch.from_numpy(lens), bits)
        assert qpack.latent_prefill_fill_launches == n0
        np.testing.assert_array_equal(cache["lat_codes"][i].numpy(), want[0])
        np.testing.assert_array_equal(_bits(cache["lat_scales"][i].numpy()),
                                      _bits(want[1]))
        np.testing.assert_array_equal(
            _bits(cache["lat_hot"][i].float().numpy()), _bits(want[2]))
        for name, leaf in cache.items():
            for other in (0, 2):
                assert torch.equal(leaf[other], before[name][other]), name


# (T, pos, cold_len per layer): a live ring wider than what is left above
# cold_len, a resumed lane, a short lane, an empty flush, pos at the end
FLUSH_CASES = {"steady": (40, 30, [0, 22, 25]),
               "resumed": (40, 21, [18, 20, 13]),
               "short": (40, 5, [0, 0, 3]), "empty": (40, 17, [17, 17, 17]),
               "at_end": (24, 24, [10, 16, 0])}


@pytest.mark.parametrize("case", list(FLUSH_CASES))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("bits", [4, 8])
def test_latent_lane_flush_plain_vs_reference(case, width, bits):
    """In place on lane 1's slice of a 3-lane latent cache, against the
    JAX ``_ring_to_codes`` on ``lat_*``; cold_len comes back as
    max(cold_len, pos), the other lanes untouched."""
    T_, pos, cold_l = FLUSH_CASES[case]
    R, Lyr, B, lane = WIDTHS[width], len(cold_l), 3, 1
    rng = np.random.default_rng(bits + R + pos)
    codes = rng.integers(0, 256, (Lyr, B, T_, R * bits // 8)).astype(np.uint8)
    scales = rng.standard_normal((Lyr, B, T_)).astype(np.float32)
    hot = _ring(rng, (Lyr, B, W, R))
    cold = np.zeros((Lyr, B), np.int32)
    cold[:, lane] = cold_l
    wc, ws = jengine._ring_to_codes(
        jnp.asarray(codes[:, lane]), jnp.asarray(scales[:, lane]),
        jnp.asarray(hot[:, lane]).astype(jnp.bfloat16),
        jnp.asarray(cold[:, lane]), pos, W, bits, impl="jnp")
    for flush in (qpack.latent_lane_flush_plain, qpack.latent_lane_flush):
        c, s = torch.from_numpy(codes.copy()), torch.from_numpy(scales.copy())
        h = torch.from_numpy(hot).to(torch.bfloat16)
        cl = torch.from_numpy(cold.copy())
        n0 = qpack.latent_lane_flush_launches
        new_cold = flush(c[:, lane], s[:, lane], h[:, lane], cl[:, lane], pos,
                         bits)
        assert qpack.latent_lane_flush_launches == n0
        np.testing.assert_array_equal(new_cold.numpy(),
                                      np.maximum(cold[:, lane], pos))
        np.testing.assert_array_equal(c[:, lane].numpy(), np.asarray(wc))
        np.testing.assert_array_equal(_bits(s[:, lane].numpy()), _bits(ws))
        for other in (0, 2):
            assert np.array_equal(c[:, other].numpy(), codes[:, other])
            assert np.array_equal(s[:, other].numpy(), scales[:, other])


# (heads, R, S, lengths): REDUCED minicpm3, and the full model's widths with
# a short cache (lengths 0, 1, ragged, full)
PARTIAL_CASES = {"reduced": (4, 40, 40, [0, 1, 23, 40]),
                 "full": (40, 288, 24, [0, 1, 13, 24])}


@pytest.mark.parametrize("case", list(PARTIAL_CASES))
@pytest.mark.parametrize("bits", [4, 8])
def test_latent_partial_plain_vs_reference(case, bits):
    """B5's latent form against the reference MLA decode's call
    ``quantized_attention_partial(q_eff, lc[:, :, None, :], ls[:, :, None],
    lc[:, :, None, :], ls[:, :, None], ...)``: m, l and acc over the live
    rows (a row of length 0 is the empty partial: l = 0, acc = 0, whatever
    m the reference's chunk merge gives it)."""
    H, R, S, lens_l = PARTIAL_CASES[case]
    B = len(lens_l)
    rng = np.random.default_rng(bits + R)
    q = rng.standard_normal((B, H, R)).astype(np.float32)
    c, s = jquantize(jnp.asarray(rng.standard_normal((B, S, R)) * 2,
                                 jnp.float32), bits, R)
    codes, scales = np.array(c), np.array(s[..., 0])
    lens = np.array(lens_l, np.int32)
    sm = 1.0 / math.sqrt(96)
    lc, ls = jnp.asarray(codes)[:, :, None, :], jnp.asarray(scales)[:, :, None]
    want = jdec.quantized_attention_partial(
        jnp.asarray(q), lc, ls, lc, ls, jnp.asarray(lens), bits=bits,
        chunk=8, sm_scale=sm)
    for fn in (lambda *a: KA.kvc_latent_partial_plain(*a, bits, sm),
               lambda *a: KA.kvc_latent_partial(*a, bits=bits, sm_scale=sm)):
        n0 = KA.latent_launches
        m, l, acc = fn(torch.from_numpy(q), torch.from_numpy(codes),
                       torch.from_numpy(scales), torch.from_numpy(lens))
        assert KA.latent_launches == n0
        assert m.shape == l.shape == (B, H, 1) and acc.shape == (B, H, R)
        live = lens > 0
        for got, ref in ((m, want.m), (l, want.l), (acc, want.acc)):
            np.testing.assert_allclose(got.numpy()[live],
                                       np.asarray(ref)[live], atol=1e-5,
                                       rtol=1e-5)
        assert np.all(l.numpy()[~live] == 0)
        assert np.all(acc.numpy()[~live] == 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Dqk,Dv,S", [(4, 24, 16, 40), (40, 96, 64, 32)])
def test_flash_plain_split_head_dims_vs_chunked_attention(causal, H, Dqk, Dv,
                                                          S):
    """B6's plain version at MLA's expanded prefill (MHA, q/k dim nope +
    rope, v dim v_head_dim, scale 1/sqrt(q/k dim)) against the reference's
    ``chunked_attention``, which takes a v dim other than q's on purpose."""
    rng = np.random.default_rng(Dqk + S)
    q, k = (rng.standard_normal((2, S, H, Dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, S, H, Dv)).astype(np.float32)
    sm = 1.0 / math.sqrt(Dqk)
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     sm_scale=sm)
    got = FA.flash_attention_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, sm_scale=sm)
    assert got.shape == (2, S, H, Dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if (Dqk, Dv) in FA.SPLIT_HEAD_DIMS:      # the wrapper, on CPU tensors
        got2 = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  causal=causal, sm_scale=sm)
        assert torch.equal(got, got2)


def test_split_head_dim_dispatch_without_a_card():
    """(96, 64) takes both routes; other unequal pairs, and 96 with an equal
    v, raise before anything is launched; the latent kernel refuses shapes
    other than 40 heads of 288."""
    assert FA.route_for(torch.bfloat16, 96, 64) == "tensor_cores"
    assert FA.route_for(torch.float32, 96, 64) == "cuda_cores"
    for d, dv in ((96, 96), (96, 128), (64, 96), (24, 16), (128, 64)):
        with pytest.raises(ValueError, match="head dim"):
            FA.route_for(torch.bfloat16, d, dv)
    bf = dict(dtype=torch.bfloat16)
    q, k = torch.zeros((1, 8, 40, 96), **bf), torch.zeros((1, 8, 40, 96), **bf)
    with pytest.raises(ValueError, match="devices"):
        FA.route(q, k, torch.zeros((1, 8, 40, 64), **bf))
    with pytest.raises(ValueError, match="head dims"):
        FA.route(q, k, torch.zeros((1, 8, 40, 32), **bf))
    with pytest.raises(ValueError, match="head dims"):
        FA.flash_attention(torch.zeros((1, 8, 4, 24)),
                           torch.zeros((1, 8, 4, 24)),
                           torch.zeros((1, 8, 4, 16)))
    codes = torch.zeros((2, 16, 144), dtype=torch.uint8)
    scales = torch.zeros((2, 16))
    lens = torch.tensor([3, 16], dtype=torch.int32)
    with pytest.raises(ValueError, match="40 heads"):
        KA._launch_latent(torch.zeros((2, 32, 288), **bf), codes, scales,
                          lens, 4, 0.1)
    with pytest.raises(ValueError, match="bits"):
        KA._launch_latent(torch.zeros((2, 40, 288), **bf), codes, scales,
                          lens, 5, 0.1)


@pytest.mark.parametrize("lengths,want", [
    ([0, 1, 32, 33], 2 * (0 + 1 + 1 + 2)),
    # 13b's kind of lengths: 8 lanes of a few hundred tokens fill 132 SMs
    ([87, 672, 300, 450, 128, 200, 500, 640], 2 * 96)])
def test_latent_working_ctas(lengths, want):
    """The CUDA-core latent kernel's (f32 q) CTAs that do work: a cluster of
    LATENT_CLUSTER for each LATENT_CHUNK tokens a lane's length reaches."""
    assert (KA.LATENT_CHUNK, KA.LATENT_CLUSTER) == (32, 2)
    assert KA.latent_working_ctas(np.array(lengths), torch.float32) == want


@pytest.mark.parametrize("lengths,want", [
    ([0, 1, 96, 97], 5 * (0 + 1 + 1 + 2)),
    # phase 13d's lengths: above the H100's 132 SMs
    ([672, 522, 434, 265, 291, 104, 128, 87], 5 * 30)])
def test_latent_tc_working_ctas(lengths, want):
    """The tensor-core latent kernel's (bf16 q) CTAs that do work: one a
    64-wide column box (LATENT_TC_BOXES) for each span of LATENT_TC_TOKENS
    tokens a lane's length reaches."""
    assert (KA.LATENT_TC_TOKENS, KA.LATENT_TC_BOXES) == (96, 5)
    assert KA.latent_working_ctas(np.array(lengths)) == want
