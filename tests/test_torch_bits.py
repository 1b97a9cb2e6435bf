"""Bit-level parity of the port (common/utils, core/bitpack, core/metadata,
core/mcache) against the reference package: same numpy inputs,
bit-identical outputs."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common import utils as ju  # noqa: E402
from repro.core import bitpack as jb  # noqa: E402
from repro.core import metadata as jm  # noqa: E402
from repro_torch.common import utils as tu  # noqa: E402
from repro_torch.core import bitpack as tb  # noqa: E402
from repro_torch.core import metadata as tm  # noqa: E402

RNG = np.random.default_rng(11)


def _words(n=257):
    w = RNG.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    return w


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bf16_edge_blocks(v=512):
    """Blocks of every class as bf16 bit patterns: zeros, +-0 mixed, exact
    4-bit grid, exact 8-bit grid, random finite bf16, .5 ties, saturation."""
    out = []
    z = np.zeros(v, np.float32)
    out.append(z)
    pm = z.copy()
    pm[1::2] = -0.0
    out.append(pm)
    g4 = RNG.integers(-7, 8, v).astype(np.float32)
    g4[0] = 7
    out.append(g4)
    g8 = RNG.integers(-126, 127, v).astype(np.float32)
    g8[0] = 127
    out.append(g8)
    bits = RNG.integers(0, 2 ** 16, v, dtype=np.uint32)
    exp = (bits >> 7) & 0xFF
    bits = np.where(exp == 0xFF, bits & ~np.uint32(0x4000), bits)   # finite
    out.append((bits.astype(np.uint32) << 16).view(np.float32))
    ties = (RNG.integers(-7, 7, v) + 0.5).astype(np.float32)
    ties[0] = 7.0
    out.append(ties)
    sat = np.full(v, -8.0, np.float32)
    sat[0] = 7.0
    out.append(sat)
    mixed0 = g4.copy()
    mixed0[5] = -0.0
    out.append(mixed0)
    x = np.stack(out)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_get_set_bits():
    w = _words()
    vals = RNG.integers(0, 2 ** 32, size=w.size, dtype=np.uint64).astype(np.uint32)
    for lo, width in [(0, 2), (5, 3), (20, 4), (24, 4), (31, 1), (0, 29)]:
        np.testing.assert_array_equal(
            np.asarray(ju.get_bits(jnp.asarray(w), lo, width)),
            tu.get_bits(_t(w), lo, width).numpy())
        np.testing.assert_array_equal(
            np.asarray(ju.set_bits(jnp.asarray(w), lo, width, jnp.asarray(vals))),
            tu.set_bits(_t(w), lo, width, _t(vals)).numpy())
        # the host path (Python ints) agrees with the tensor path
        assert tu.set_bits(int(w[5]), lo, width, int(vals[5])) == \
            int(np.asarray(ju.set_bits(jnp.uint32(w[5]), lo, width,
                                       jnp.uint32(vals[5]))))


def test_byte_views():
    f = RNG.standard_normal(64).astype(np.float32)
    f[:3] = [0.0, -0.0, 1e-40]
    jb_ = np.asarray(ju.f32_to_bytes(jnp.asarray(f)))
    tb_ = tu.f32_to_bytes(torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(jb_, tb_)
    np.testing.assert_array_equal(
        tu.bytes_to_f32(torch.from_numpy(tb_)).numpy().view(np.uint32),
        f.view(np.uint32))
    x = _bf16_edge_blocks(64).ravel()
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    u_j = np.asarray(ju.bitcast_bf16_to_u16(xb_j))
    np.testing.assert_array_equal(u_j, tu.bitcast_bf16_to_u16(xb_t).numpy())
    np.testing.assert_array_equal(np.asarray(ju.u16_to_bytes(jnp.asarray(u_j))),
                                  tu.u16_to_bytes(torch.from_numpy(u_j.astype(np.int32))).numpy())
    back = tu.bitcast_u16_to_bf16(tu.bitcast_bf16_to_u16(xb_t))
    np.testing.assert_array_equal(back.view(torch.int16).numpy(),
                                  xb_t.view(torch.int16).numpy())


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_pack_roundtrip(bits):
    x = _bf16_edge_blocks()
    xr = RNG.standard_normal((6, 512)).astype(np.float32) * 3
    for arr in (x, xr):
        qj, sj = jb.quantize_block(jnp.asarray(arr), bits)
        qt, st = tb.quantize_block(torch.from_numpy(arr), bits)
        np.testing.assert_array_equal(np.asarray(qj), qt.numpy())
        np.testing.assert_array_equal(np.asarray(sj).view(np.uint32),
                                      st.numpy().view(np.uint32))
        dj = np.asarray(jb.dequantize_block(qj, sj).astype(jnp.float32))
        dt = tb.dequantize_block(qt, st).to(torch.float32).numpy()
        np.testing.assert_array_equal(dj.view(np.uint32), dt.view(np.uint32))
        if bits == 4:
            pj, pt = jb.pack4(qj), tb.pack4(qt)
            np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
            np.testing.assert_array_equal(np.asarray(jb.unpack4(pj, 512)),
                                          tb.unpack4(pt, 512).numpy())
        else:
            pj, pt = jb.pack8(qj), tb.pack8(qt)
            np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
            np.testing.assert_array_equal(np.asarray(jb.unpack8(pj)),
                                          tb.unpack8(pt).numpy())
    raw_j = np.asarray(jb.raw_to_bytes(jnp.asarray(x).astype(jnp.bfloat16)))
    raw_t = tb.raw_to_bytes(torch.from_numpy(x).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(raw_j, raw_t)
    np.testing.assert_array_equal(
        tb.bytes_to_raw(torch.from_numpy(raw_t)).view(torch.int16).numpy(),
        np.asarray(jb.bytes_to_raw(jnp.asarray(raw_j))).view(np.int16))


def test_metadata_fields_and_headers():
    w = _words()
    wj, wt = jnp.asarray(w), _t(w)
    for get in ("get_num_chunks", "get_wr_cntr", "get_shadow_valid",
                "get_dirty", "get_promoted", "get_valid"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, get)(wj)),
                                      getattr(tm, get)(wt).numpy())
    for i in range(4):
        np.testing.assert_array_equal(np.asarray(jm.get_block_type(wj, i)),
                                      tm.get_block_type(wt, i).numpy())
        np.testing.assert_array_equal(np.asarray(jm.get_block_sz(wj, i)),
                                      tm.get_block_sz(wt, i).numpy())
        for v in (0, 1, 2, 3):
            np.testing.assert_array_equal(
                np.asarray(jm.set_block_type(wj, i, v)),
                tm.set_block_type(wt, i, v).numpy())
    blocks = RNG.integers(0, 4, w.size)
    np.testing.assert_array_equal(
        np.asarray(jm.get_block_type_dyn(wj, jnp.asarray(blocks))),
        tm.get_block_type(wt, torch.from_numpy(blocks)).numpy())
    for rates in ([0, 1, 2, 3], [3, 3, 3, 3], [0, 0, 0, 0], [2, 1, 0, 2]):
        h = int(jm.header_from_rates(jnp.asarray(rates, jnp.int32)))
        assert tm.header_from_rates(rates) == h
        assert tm.rates_from_header(h) == \
            np.asarray(jm.rates_from_header(jnp.uint32(h))).tolist()
    for a, r, o in [(1, 1, 5), (1, 0, (1 << 30) - 1), (0, 1, 123456)]:
        e = int(jm.act_pack(a, r, o))
        assert tm.act_pack(a, r, o) == e
        assert tm.act_set_referenced(e, 0) == int(jm.act_set_referenced(jnp.uint32(e), 0))
        assert (tm.act_allocated(e), tm.act_referenced(e), tm.act_ospn(e)) == \
            (int(jm.act_allocated(jnp.uint32(e))),
             int(jm.act_referenced(jnp.uint32(e))), int(jm.act_ospn(jnp.uint32(e))))
    entry = _words(8).tolist()
    for slot in range(7):
        assert tm.get_ptr(entry, slot) == \
            int(jm.get_ptr(jnp.asarray(entry, jnp.uint32), slot))


def test_mcache_ops_match_reference():
    """access, access_window, probe and invalidate on one seeded stream of
    pages, through both packages: same hits, evictions and cache state."""
    from repro.core import mcache as JM
    from repro_torch.core import mcache as TM
    rng = np.random.default_rng(5)
    jc = JM.make_mcache(4, 4)
    tc = TM.make_mcache(4, 4, "cpu")
    for step in range(60):
        if step % 5 == 4:
            pages = rng.integers(0, 40, size=8).astype(np.int32)
            jc, jh, je = JM.access_window(jc, jnp.asarray(pages))
            th, te = TM.access_window(tc, torch.from_numpy(pages))
            np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        else:
            o = int(rng.integers(0, 40))
            jc, jh, je = JM.access(jc, jnp.asarray(o))
            th, te = TM.access(tc, o)
            assert (bool(th), int(te)) == (bool(jh), int(je))
        if step % 7 == 6:
            o = int(rng.integers(0, 40))
            jc = JM.invalidate(jc, jnp.asarray(o))
            TM.invalidate(tc, o)
        probe = rng.integers(0, 40, size=6).astype(np.int32)
        np.testing.assert_array_equal(
            TM.probe(tc, torch.from_numpy(probe)).numpy(),
            np.asarray([JM.probe(jc, jnp.asarray(q)) for q in probe]))
        np.testing.assert_array_equal(tc.tags.numpy(), np.asarray(jc.tags))
        np.testing.assert_array_equal(tc.age.numpy(), np.asarray(jc.age))
