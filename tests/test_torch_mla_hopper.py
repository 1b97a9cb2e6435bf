"""B5's latent form on the tensor cores (``csrc/kvc_attn.cu``'s
``kvc_latent_partial_tc``), checked on the CPU:

  * its rounding model (``kvc_attn.kvc_latent_partial_tc_model``: q in
    bf16, the codes as exact integers, f32 scores times scale * sm_scale
    after the product, P = p * scale as bf16 hi + lo against the codes
    with f32 sums per span of a CTA's tokens, the spans merged in index
    order)
    against the reference MLA decode's call
    ``quantized_attention_partial(q_eff, lc[:, :, None, :], ls[:, :, None],
    lc[:, :, None, :], ls[:, :, None], ...)`` at minicpm3-4b's widths (40
    heads x 288), 4 and 8 bits, lengths 0, 1, around a span, past two
    spans and of many spans: 2e-2 element-wise (the reference kernel
    tests' bound, as for B6's tensor-core route) and 1e-2 normwise, at the
    shipped span and at the sweep's others;
  * that every 4-bit and 8-bit code is exact in bf16, through the kernel's
    own int-to-float conversion (``dequant_word``'s magic-number form);
  * the route table without a card (bf16 -> tensor cores, f32 -> CUDA
    cores, every other input refused) and the wrapper's tile constants
    against the kernel source's (the routes' working CTAs:
    test_torch_mla_kernels.py).

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
from repro.models import decode as JD
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack

H, R = KA.LATENT_HEADS, KA.LATENT_DIM
SM = 1.0 / math.sqrt(96)           # minicpm3-4b: 1/sqrt(nope 64 + rope 32)
TOL, NORM_TOL = 2e-2, 1e-2
# tokens a CTA: the shipped span first, then the sweep's others
TOKENS = [KA.LATENT_TC_TOKENS, 64, 128]


def _latent(bits: int, S: int, B: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, R)).astype(np.float32)
    c, s = jquant(jnp.asarray(rng.standard_normal((B, S, R)) * 2,
                              jnp.float32), bits, R)
    qb = np.asarray(jnp.asarray(q).astype(jnp.bfloat16).astype(jnp.float32))
    return qb, np.array(c), np.array(s[..., 0])


@pytest.mark.parametrize("tok", TOKENS)
@pytest.mark.parametrize("bits", [4, 8])
def test_tc_rounding_model_matches_reference(bits, tok):
    S = 600
    lengths = [0, 1, tok - 1, tok, tok + 1, 2 * tok + 1, S]
    B = len(lengths)
    q, codes, scales = _latent(bits, S, B, seed=bits + tok)
    lens = np.array(lengths, np.int32)
    lc, ls = jnp.asarray(codes)[:, :, None, :], jnp.asarray(scales)[:, :, None]
    want = JD.quantized_attention_partial(
        jnp.asarray(q).astype(jnp.bfloat16), lc, ls, lc, ls,
        jnp.asarray(lens), bits=bits, chunk=S, sm_scale=SM)
    m, l, acc = KA.kvc_latent_partial_tc_model(
        torch.from_numpy(q).to(torch.bfloat16), torch.from_numpy(codes),
        torch.from_numpy(scales), torch.from_numpy(lens), bits, SM,
        tokens=tok)
    assert m.shape == l.shape == (B, H, 1) and acc.shape == (B, H, R)
    live = lens > 0
    for got, ref in ((m, want.m), (l, want.l), (acc, want.acc)):
        np.testing.assert_allclose(got.numpy()[live], np.asarray(ref)[live],
                                   atol=TOL, rtol=TOL)
    ref_acc = np.asarray(want.acc)[live]
    assert np.linalg.norm(acc.numpy()[live] - ref_acc) <= \
        NORM_TOL * np.linalg.norm(ref_acc)
    # the empty partial of a lane of length 0, as the kernel writes it
    assert np.all(m.numpy()[~live] == KA.NEG_INF)
    assert np.all(l.numpy()[~live] == 0) and np.all(acc.numpy()[~live] == 0)


@pytest.mark.parametrize("bits", [4, 8])
def test_every_code_is_exact_in_bf16(bits):
    """The kernel's conversions of a code c with its sign bit flipped are
    exact for every code, so the tile holds the codes themselves: 8-bit as
    the low mantissa of the f32 2^23 + c + 128 (``dequant_word``), then
    bf16; 4-bit as the mantissa of the bf16 128 + c + 8 (0x4300 | nibble),
    less 136 in bf16 (``codes_bf16``). The port's decode with scale 1 gives
    the same integers."""
    half = 1 << (bits - 1)
    raw = np.arange(1 << bits, dtype=np.uint32)           # the stored bits
    code = np.where(raw >= half, raw.astype(np.int64) - (1 << bits), raw)
    want = torch.from_numpy(code).float()
    if bits == 8:
        magic = ((raw ^ half) | 0x4B000000).astype(np.uint32).view(np.float32)
        as_f32 = magic - np.float32(8388608 + half)
        np.testing.assert_array_equal(as_f32, code.astype(np.float32))
        got = torch.from_numpy(as_f32).to(torch.bfloat16)
    else:
        magic = torch.from_numpy(((raw ^ half) | 0x4300).astype(np.int16)) \
            .view(torch.bfloat16)
        assert torch.equal(magic.float(), want + 136)  # exact before the sub
        got = magic - torch.tensor(136.0, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got.float(), want)
    # one row of R stored codes (4-bit: low nibble first) through the
    # port's decode, scale 1
    row = np.resize(raw, R)
    packed = row[0::2] | (row[1::2] << 4) if bits == 4 else row
    dec = qpack.decode_plain(torch.from_numpy(packed.astype(np.uint8))[None],
                             torch.ones((1, 1)), bits, R, torch.bfloat16)
    np.testing.assert_array_equal(dec.float()[0].numpy(),
                                  np.resize(code, R).astype(np.float32))


def test_latent_routes_without_a_card():
    """bf16 -> the tensor cores, f32 -> the CUDA cores, at 40 heads of 288;
    every other input raises before anything is launched, and a CPU tensor
    that a route would take raises for want of a card."""
    bf = torch.bfloat16
    assert KA.latent_route_for(bf, H, R) == "tensor_cores"
    assert KA.latent_route_for(torch.float32, H, R) == "cuda_cores"
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(ValueError, match="bf16/f32"):
            KA.latent_route_for(dt, H, R)
    for h, r in ((32, 288), (40, 256), (64, 288), (4, 40)):
        with pytest.raises(ValueError, match="H <= 64, R % 16 == 0"):
            KA.latent_route_for(bf, h, r)
    B, S = 2, 48
    q = torch.zeros((B, H, R), dtype=bf)
    codes = torch.zeros((B, S, R // 2), dtype=torch.uint8)
    scales = torch.zeros((B, S))
    lens = torch.tensor([3, 48], dtype=torch.int32)
    with pytest.raises(ValueError, match="device"):
        KA.latent_route(q, codes, scales, lens, 4)
    with pytest.raises(ValueError, match="device"):
        KA.latent_route(q.float(), codes, scales, lens, 4)
    with pytest.raises(ValueError, match="bits"):
        KA.latent_route(q, codes, scales, lens, 5)
    with pytest.raises(ValueError, match="codes"):
        KA.latent_route(q, codes[:, :, :100], scales, lens, 4)
    with pytest.raises(ValueError, match="scales"):
        KA.latent_route(q, codes, scales[:, :10], lens, 4)
    with pytest.raises(ValueError, match="lengths"):
        KA.latent_route(q, codes, scales, lens[:1], 4)
    long_s = (KA._tc_max_spans() + 1) * KA.LATENT_TC_TOKENS
    with pytest.raises(ValueError, match="merge"):
        KA.latent_route(q[:1], torch.zeros((1, long_s, R // 2),
                                           dtype=torch.uint8),
                        torch.zeros((1, long_s)), lens[:1], 4)


def test_latent_tiles_match_kernel_source():
    """The wrapper sizes the scratch and the counters by its tile constants:
    they must be the compile-time tiles of csrc/kvc_attn.cu."""
    src = (Path(KA.__file__).resolve().parents[1] / "csrc" /
           "kvc_attn.cu").read_text()
    define = lambda n: int(re.search(rf"#define {n} (\d+)", src).group(1))  # noqa: E731
    assert define("KVC_TC_TOKENS") == KA.LATENT_TC_TOKENS
    assert (define("KVC_LAT_CHUNK"), define("KVC_LAT_CLUSTER")) == \
        (KA.LATENT_CHUNK, KA.LATENT_CLUSTER)
    # a merge record: a 64-wide box of 40 heads' columns, and (m, l); five
    # boxes a span of 96 tokens
    assert KA.LATENT_TC_BOXES == 5
    assert KA.latent_tc_scratch_floats(8, 2048) == 8 * 22 * 5 * (40 * 64 + 80)
