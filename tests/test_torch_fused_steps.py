"""The port's two fused steps against the reference, on the CPU, bit for
bit in every case:

  * the pool's demotion: ``compressor.demote_pages``/``encode_pages`` (the
    plain path) and the demote kernel's plain version
    ``qpack.fused_demote_plain`` (through the ``qpack.fused_demote``
    wrapper on CPU tensors) against the JAX
    ``repro.core.compressor.encode_pages`` (jnp path): page streams, rates,
    quanta, chunk counts and the record the host fetches;
  * the decode step's ring step: ``qpack.ring_step_plain`` (and
    ``qpack.ring_step`` on CPU tensors), in place, against the JAX
    ``_evict_to_codes`` for K and V then ``_hot_insert`` for K and V
    (``repro/models/decode.py``).

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
from repro.models import decode as jdec  # noqa: E402
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
