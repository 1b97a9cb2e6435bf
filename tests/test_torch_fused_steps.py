"""The port's fused steps against the reference, on the CPU, bit for bit
in every case:

  * the pool's demotion: ``compressor.demote_pages``/``encode_pages`` (the
    plain path) and the demote kernel's plain version
    ``qpack.fused_demote_plain`` (through the ``qpack.fused_demote``
    wrapper on CPU tensors) against the JAX
    ``repro.core.compressor.encode_pages`` (jnp path): page streams, rates,
    quanta, chunk counts and the record the host fetches;
  * the decode step's ring step: ``qpack.ring_step_plain`` (and
    ``qpack.ring_step`` on CPU tensors), in place, against the JAX
    ``_evict_to_codes`` for K and V then ``_hot_insert`` for K and V
    (``repro/models/decode.py``);
  * the prefill fill: ``qpack.prefill_fill_plain`` (and ``prefill_fill``
    on CPU tensors), in place on a layer of a stacked cache, against the
    reference prefill's ``fill_gqa`` (its ``quantize_blocks`` of the padded
    prompt and its ring gather);
  * the lane flush: ``qpack.lane_flush_plain`` (and ``lane_flush``), in
    place on a lane's slice, against the JAX ``serve/engine.py::
    _ring_to_codes`` for K and V.

The pool's promotion step has its own file, test_torch_promote_step.py.

The CUDA kernels are held against these plain versions on the card, in
test_torch_cuda.py."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common.types import PoolConfig as JConfig  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.core.compressor import quantize_blocks as jquantize  # noqa: E402
from repro.models import decode as jdec  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core import compressor as comp  # noqa: E402
from repro_torch.kernels import qpack  # noqa: E402
from repro_torch.simx.trace import make_block_content  # noqa: E402

# -- demotion ----------------------------------------------------------------

# lossy tolerances at which all four rates occur: only an exact 4-bit grid
# passes 4-bit (its worst error is amax/14 > 0.05 otherwise), an exact 8-bit
# grid 8-bit (amax/254 > 0.003), the rest is raw
LOSSY = dict(tol4=0.05, tol8=0.003)


def _pages(nb: int, vals: int, seed: int) -> np.ndarray:
    """float32 [P, nb*vals] pages, every value exact in bf16: pages mixing
    all four content classes, an all-raw page (its quanta fill the page),
    all-zero, all-4-bit and all-8-bit pages, and pages of normal values."""
    rng = np.random.default_rng(seed)
    if nb == 4:
        classes = [[0, 1, 2, 3], [3, 2, 1, 0], [3, 3, 3, 3], [0, 0, 0, 0],
                   [1, 1, 1, 1], [2, 2, 2, 2], [2, 3, 0, 1], [1, 0, 3, 3]]
    else:
        classes = [[0], [1], [2], [3], [3], [1]]
    rates = np.array(classes + rng.integers(0, 4, (4, nb)).tolist())
    x = make_block_content(rates, vals, seed=seed).reshape(len(rates), -1)
    x[-1] = rng.standard_normal(nb * vals) * 0.7
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _configs(coloc: bool, lossless: bool, ze: bool):
    kw = dict(coloc=coloc, lossless=lossless, zero_elision=ze,
              compress_impl="jnp", **({} if lossless else LOSSY))
    jcfg = JConfig(**kw)
    return jcfg, PoolConfig(**dataclasses.asdict(jcfg))


def _ref_pages(xs: np.ndarray, jcfg) -> list:
    out = jcomp.encode_pages(jnp.asarray(xs).astype(jnp.bfloat16), jcfg)
    return [np.asarray(a) for a in out]


CASES = [(c, l, z) for c in (True, False) for l in (True, False)
         for z in (True, False)]


@pytest.mark.parametrize("coloc,lossless,ze", CASES)
def test_encode_pages_plain_vs_reference(coloc, lossless, ze):
    """compressor.encode_pages (the plain path, the only CPU path) equals
    the reference's, and every rate the settings allow occurs."""
    jcfg, tcfg = _configs(coloc, lossless, ze)
    nb = jcfg.blocks_per_page if coloc else 1
    xs = _pages(nb, jcfg.vals_per_page // nb, seed=11 + 2 * coloc + ze)
    ref = _ref_pages(xs, jcfg)
    got = comp.encode_pages(torch.from_numpy(xs).to(torch.bfloat16), tcfg)
    assert len(got) == 4
    for name, a, b in zip(("bufs", "rates", "quanta", "nchunks"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    rates = set(ref[1].ravel().tolist())
    assert rates == ({0, 1, 2, 3} if ze else {1, 2, 3})
    raw = (ref[1] == 3).all(axis=1)          # all-raw pages fill the page
    assert raw.any()
    assert (ref[2][raw].sum(axis=1) * 128 == jcfg.page_bytes).all()
    assert (ref[3][raw] == jcfg.page_bytes // jcfg.chunk_bytes).all()


@pytest.mark.parametrize("coloc,lossless,ze", CASES)
def test_demote_from_slots_vs_reference(coloc, lossless, ze):
    """Demotion read straight from a store's rows: compressor.demote_pages
    (plain path) and the demote kernel's plain version (the wrapper on CPU
    tensors, no launch counted) equal the reference's encode_pages of the
    gathered pages; the record is the rates, then the chunk counts."""
    jcfg, tcfg = _configs(coloc, lossless, ze)
    nb = jcfg.blocks_per_page if coloc else 1
    store = _pages(nb, jcfg.vals_per_page // nb, seed=5 + coloc)
    slots = np.random.default_rng(3).integers(0, store.shape[0], 9)
    slots[4] = slots[1]                      # a repeated victim (padding)
    ref = _ref_pages(store[slots], jcfg)
    rec = np.concatenate([ref[1].ravel(), ref[3]])
    xt = torch.from_numpy(store).to(torch.bfloat16)
    st = torch.from_numpy(slots).to(torch.int64)
    n0 = qpack.fused_demote_launches
    for got in (comp.demote_pages(xt, st, tcfg),
                qpack.fused_demote(
                    xt, st, blocks=nb, chunk_bytes=jcfg.chunk_bytes,
                    tol4=jcfg.tol4, tol8=jcfg.tol8, lossless=lossless,
                    zero_elision=ze,
                    quanta=comp.quanta_per_rate(jcfg.vals_per_page // nb))):
        for name, a, b in zip(("bufs", "rates", "quanta", "nchunks",
                               "record"), got, ref + [rec]):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert qpack.fused_demote_launches == n0


@pytest.mark.parametrize("nb,vals", [(4, 512), (1, 2048)])
def test_compaction_vs_reference(nb, vals):
    """qpack.compact_pages_plain against the reference's _compact_page over
    random dense rows and every quanta split the page allows."""
    rng = np.random.default_rng(nb)
    cfg = JConfig()
    top = 2 * vals // 128
    dense = rng.integers(0, 256, (16, nb, 2 * vals)).astype(np.uint8)
    quanta = rng.integers(0, top + 1, (16, nb)).astype(np.int32)
    quanta[0], quanta[1] = top, 0
    got = qpack.compact_pages_plain(torch.from_numpy(dense),
                                    torch.from_numpy(quanta), cfg.page_bytes)
    for p in range(16):
        want = jcomp._compact_page(jnp.asarray(dense[p]),
                                   jnp.asarray(quanta[p]), cfg)
        np.testing.assert_array_equal(got[p].numpy(), np.asarray(want))


# -- the ring step -----------------------------------------------------------

W, S, H, D = 8, 24, 2, 32
# (pos, cold_len) per lane: before the window fills (pos < W), at pos == W,
# a resumed lane (pos - W < cold_len) and lanes of every kind in one batch
SCENARIOS = {
    "before_window": ([3, 7], [0, 0]),
    "at_window": ([8, 8], [0, 0]),
    "resumed": ([12, 20], [10, 13]),
    "mixed": ([3, 8, 12, 19, 23, 9], [0, 0, 10, 2, 15, 1]),
}
TYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
         "f32": (torch.float32, jnp.float32)}


def _ring_inputs(B: int, bits: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    dp = D * bits // 8
    hot = (rng.standard_normal((2, B, W, H, D)) * 0.7).astype(np.float32)
    hot[:, :, 1] = 0.0                       # an all-zero slot (scale 1)
    hot[:, :, 2, :, 1::2] = -0.0
    hot[:, :, 3] = rng.integers(-7, 7, (2, B, H, D)) + 0.5   # .5 ties
    hot[:, :, 3, :, 0] = 7.0
    return {
        "codes": rng.integers(0, 256, (2, B, S, H, dp)).astype(np.uint8),
        "scales": rng.standard_normal((2, B, S, H)).astype(np.float32),
        "hot": hot,
        "new": (rng.standard_normal((2, B, H, D)) * 3).astype(np.float32),
    }


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16 if a.itemsize == 2 else np.uint8
                  if a.itemsize == 1 else np.uint32)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ring,new", [("bf16", "bf16"), ("bf16", "f32"),
                                      ("f32", "f32")])
def test_ring_step_plain_vs_reference(scenario, bits, ring, new):
    pos_l, cold_l = SCENARIOS[scenario]
    B = len(pos_l)
    inp = _ring_inputs(B, bits, seed=bits + B)
    (t_ring, j_ring), (t_new, j_new) = TYPES[ring], TYPES[new]
    pos_np, cold_np = np.array(pos_l, np.int32), np.array(cold_l, np.int32)

    want = {}
    for i, kind in enumerate("kv"):
        hot = jnp.asarray(inp["hot"][i]).astype(j_ring)
        c, s = jdec._evict_to_codes(
            jnp.asarray(inp["codes"][i]), jnp.asarray(inp["scales"][i]), hot,
            jnp.asarray(pos_np), jnp.asarray(cold_np), W, bits)
        h = jdec._hot_insert(hot, jnp.asarray(inp["new"][i]).astype(j_new),
                             jnp.asarray(pos_np))
        want[kind] = (np.asarray(c), np.asarray(s),
                      np.asarray(h.astype(jnp.float32)))

    for step in (qpack.ring_step_plain, qpack.ring_step):
        t = {k: [torch.from_numpy(inp[k][i].copy()) for i in range(2)]
             for k in ("codes", "scales")}
        t["hot"] = [torch.from_numpy(inp["hot"][i].copy()).to(t_ring)
                    for i in range(2)]
        t["new"] = [torch.from_numpy(inp["new"][i]).to(t_new)
                    for i in range(2)]
        pos, cold = torch.from_numpy(pos_np), torch.from_numpy(cold_np)
        n0 = qpack.ring_step_launches
        step(t["codes"][0], t["scales"][0], t["hot"][0], t["codes"][1],
             t["scales"][1], t["hot"][1], t["new"][0], t["new"][1], pos,
             cold, bits)
        assert qpack.ring_step_launches == n0
        assert torch.equal(pos, torch.from_numpy(pos_np))
        assert torch.equal(cold, torch.from_numpy(cold_np))
        for i, kind in enumerate("kv"):
            c, s, h = want[kind]
            np.testing.assert_array_equal(t["codes"][i].numpy(), c,
                                          err_msg=f"{kind} codes")
            np.testing.assert_array_equal(_bits(t["scales"][i].numpy()),
                                          _bits(s), err_msg=f"{kind} scales")
            assert t["hot"][i].dtype == t_ring
            np.testing.assert_array_equal(
                _bits(t["hot"][i].float().numpy()), _bits(h),
                err_msg=f"{kind} ring")
    # the scenario did what its name says
    evicted = (pos_np - W >= cold_np)
    changed = (want["k"][0] != inp["codes"][0]).any(axis=(1, 2, 3))
    assert (changed <= evicted).all()
    assert evicted.any() == (scenario in ("at_window", "mixed"))


# -- the prefill fill and the lane flush -------------------------------------

# (S, W, lens): rows of full length, short prompts whose ring keeps slots of
# no real token (p < 0), a one-token row, and a window wider than the prompt
FILL_CASES = {
    "full": (24, 8, [24, 24]),
    "short": (24, 8, [5, 24, 1, 13]),
    "wide_window": (6, 8, [6, 3]),
}


def _ref_fill(t, lens, max_len: int, W: int, bits: int) -> tuple:
    """The reference prefill's ``fill_gqa`` for one of K or V: the padded
    prompt quantized with its ``quantize_blocks``, and the ring gathered
    from the latest real token of each slot."""
    B, S, _, Dh = t.shape
    tp = jnp.pad(t, ((0, 0), (0, max_len - S), (0, 0), (0, 0)))
    c, s = jquantize(tp, bits, Dh)
    last = jnp.asarray(lens) - 1
    p = last[:, None] - ((last[:, None] - jnp.arange(W)[None, :]) % W)
    safe = jnp.clip(p, 0, S - 1)[:, :, None, None]
    hot = jnp.take_along_axis(t, safe, axis=1).astype(jnp.bfloat16)
    return (np.asarray(c), np.asarray(s[..., 0]),
            np.asarray(hot.astype(jnp.float32)))


@pytest.mark.parametrize("case", list(FILL_CASES))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("H,Dh,dtype", [(2, 128, "bf16"), (3, 64, "f32"),
                                        (2, 16, "bf16"), (2, 16, "f32")])
def test_prefill_fill_plain_vs_reference(case, bits, H, Dh, dtype):
    """qpack.prefill_fill_plain (and prefill_fill on CPU tensors) writes
    the reference prefill's cache leaves bit for bit into a layer of a
    stacked cache prepared as models/decode.py's prefill prepares it
    (codes 0, scales 1 past the prompt), and no other layer."""
    S, W, lens_l = FILL_CASES[case]
    B, max_len, layers, i = len(lens_l), S + 5, 3, 1
    rng = np.random.default_rng(bits + H + Dh + S)
    tdt, jdt = TYPES[dtype]
    kv = (rng.standard_normal((2, B, S, H, Dh)) * 2).astype(np.float32)
    kv[:, :, 0] = 0.0                        # an all-zero token (scale 1)
    kv[:, :, 1, :, ::3] = -0.0
    kv = np.array(jnp.asarray(kv).astype(jdt).astype(jnp.float32))
    lens = np.array(lens_l, np.int32)
    want = [_ref_fill(jnp.asarray(kv[j]).astype(jdt), lens, max_len, W, bits)
            for j in range(2)]
    dp = Dh * bits // 8
    for fill in (qpack.prefill_fill_plain, qpack.prefill_fill):
        cache = {}
        for kind in "kv":
            cache[f"{kind}_codes"] = torch.zeros(
                (layers, B, max_len, H, dp), dtype=torch.uint8)
            cache[f"{kind}_scales"] = torch.zeros((layers, B, max_len, H))
            cache[f"{kind}_scales"][:, :, S:] = 1.0
            cache[f"{kind}_hot"] = torch.zeros((layers, B, W, H, Dh),
                                               dtype=torch.bfloat16)
        before = {k: v.clone() for k, v in cache.items()}
        n0 = qpack.prefill_fill_launches
        fill(torch.from_numpy(kv[0]).to(tdt), torch.from_numpy(kv[1]).to(tdt),
             *(cache[n][i] for n in ("k_codes", "k_scales", "k_hot",
                                     "v_codes", "v_scales", "v_hot")),
             torch.from_numpy(lens), bits)
        assert qpack.prefill_fill_launches == n0
        for j, kind in enumerate("kv"):
            c, s, h = want[j]
            np.testing.assert_array_equal(cache[f"{kind}_codes"][i].numpy(),
                                          c, err_msg=f"{kind} codes")
            np.testing.assert_array_equal(
                _bits(cache[f"{kind}_scales"][i].numpy()), _bits(s),
                err_msg=f"{kind} scales")
            np.testing.assert_array_equal(
                _bits(cache[f"{kind}_hot"][i].float().numpy()), _bits(h),
                err_msg=f"{kind} ring")
        for name, leaf in cache.items():
            for other in (0, 2):
                assert torch.equal(leaf[other], before[name][other]), name


# (T, W, pos, cold_len per layer): a live ring wider than what is left
# above cold_len, cold_len above pos - W, a short lane (pos < W), an
# empty flush (cold_len == pos), and pos at the end of the region
FLUSH_CASES = {
    "steady": (40, 8, 30, [0, 22, 25]),
    "resumed": (40, 8, 21, [18, 20, 13]),
    "short": (40, 8, 5, [0, 0, 3]),
    "empty": (40, 8, 17, [17, 17, 17]),
    "at_end": (24, 8, 24, [10, 16, 0]),
}


@pytest.mark.parametrize("case", list(FLUSH_CASES))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("Dh", [64, 16])
def test_lane_flush_plain_vs_reference(case, bits, Dh):
    """qpack.lane_flush_plain (and lane_flush on CPU tensors), in place on a
    lane's slice of a batch cache, against the reference's
    ``_ring_to_codes`` for K and V, bit for bit; cold_len comes back as
    max(cold_len, pos) and the other lanes are untouched."""
    T_, W, pos, cold_l = FLUSH_CASES[case]
    Lyr, B, H, lane = len(cold_l), 3, 2, 1
    rng = np.random.default_rng(bits + Dh + pos)
    dp = Dh * bits // 8
    codes = rng.integers(0, 256, (2, Lyr, B, T_, H, dp)).astype(np.uint8)
    scales = rng.standard_normal((2, Lyr, B, T_, H)).astype(np.float32)
    hot = (rng.standard_normal((2, Lyr, B, W, H, Dh)) * 0.7).astype(np.float32)
    hot[:, :, :, 1] = 0.0
    hot[:, :, :, 2, :, 1::2] = -0.0
    hot[:, :, :, 3] = rng.integers(-7, 7, (2, Lyr, B, H, Dh)) + 0.5
    hot = np.array(jnp.asarray(hot).astype(jnp.bfloat16).astype(jnp.float32))
    cold = np.zeros((Lyr, B), np.int32)
    cold[:, lane] = cold_l
    want = [jengine._ring_to_codes(
        jnp.asarray(codes[j][:, lane]), jnp.asarray(scales[j][:, lane]),
        jnp.asarray(hot[j][:, lane]).astype(jnp.bfloat16),
        jnp.asarray(cold[:, lane]), pos, W, bits, impl="jnp")
        for j in range(2)]
    for flush in (qpack.lane_flush_plain, qpack.lane_flush):
        c = torch.from_numpy(codes.copy())
        s = torch.from_numpy(scales.copy())
        h = torch.from_numpy(hot).to(torch.bfloat16)
        cl = torch.from_numpy(cold.copy())
        n0 = qpack.lane_flush_launches
        new_cold = flush(c[0][:, lane], s[0][:, lane], h[0][:, lane],
                         c[1][:, lane], s[1][:, lane], h[1][:, lane],
                         cl[:, lane], pos, bits)
        assert qpack.lane_flush_launches == n0
        np.testing.assert_array_equal(new_cold.numpy(),
                                      np.maximum(cold[:, lane], pos))
        assert torch.equal(cl, torch.from_numpy(cold))
        for j, kind in enumerate("kv"):
            np.testing.assert_array_equal(c[j][:, lane].numpy(),
                                          np.asarray(want[j][0]),
                                          err_msg=f"{kind} codes")
            np.testing.assert_array_equal(
                _bits(s[j][:, lane].numpy()), _bits(want[j][1]),
                err_msg=f"{kind} scales")
            for other in (0, 2):
                assert np.array_equal(c[j][:, other].numpy(),
                                      codes[j][:, other])
                assert np.array_equal(s[j][:, other].numpy(),
                                      scales[j][:, other])
    flushed = (np.asarray(want[0][0]) != codes[0][:, lane]).any()
    assert flushed == (case != "empty")
