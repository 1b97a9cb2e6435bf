"""The CUDA kernels on the card: each against its plain PyTorch version
(byte for byte for the compression kernels and the fused steps: demote,
promote, ring step, prefill fill and lane flush, and the latter three's
MLA latent forms; within the reference's tolerance for attention,
including B5's latent form and B6 at MLA's head dims 96/64), the payload
pool's whole path with the kernels against the plain compressor, and a
small llama3 and a 2-layer minicpm3 at full width served with the kernels
against the plain versions; the frontend backbones' shapes (B3's steps at
24 KV heads of 64, B5 and B6 at 24/24 x 64 and 64/8 x 128), and REDUCED
falcon-mamba on the card against the CPU. Needs no JAX; every test carries the ``gpu``
marker and skips where no card is present:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.common.types import PoolConfig
from repro_torch.core import compressor as comp
from repro_torch.core import engine as E
from repro_torch.core.engine import batch
from repro_torch.kernels import qpack
from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                    make_rates_table, make_trace)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _blocks(n: int, v: int) -> np.ndarray:
    """Rows of the four content classes plus +-0 mixes and normal values
    that are not exact in bf16."""
    rng = np.random.default_rng(v + n)
    x = make_block_content(np.arange(n) % 4, v, seed=v)
    x[4::6] = np.where(np.arange(v) % 3 == 0, np.float32(-0.0), x[4::6])
    x[5::6] = rng.standard_normal((len(x[5::6]), v)) * 0.7
    return x.astype(np.float32)


@pytest.mark.parametrize("v", [512, 2048])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("ze", [True, False])
def test_kernels_vs_plain(cuda, v, dtype, lossless, ze):
    x = torch.from_numpy(_blocks(67, v)).to(cuda).to(dtype)
    kw = dict(lossless=lossless, zero_elision=ze,
              quanta=comp.quanta_per_rate(v))
    e0 = qpack.fused_encode_launches
    got = qpack.fused_encode(x, **kw)
    want = qpack.fused_encode_plain(x, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    out = qpack.fused_decode(got[0], got[1])
    ref = qpack.fused_decode_plain(got[0], got[1])
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert qpack.fused_encode_launches == e0 + 1


def test_whole_path_kernel_vs_plain(cuda):
    base = PoolConfig(n_pages=256, n_pchunks=32, n_cchunks=2048,
                      mcache_sets=8, mcache_ways=4, store_payload=True,
                      lossless=True, fused_demote="on")
    rates = make_rates_table(WORKLOADS["mcf"], 64, 4, seed=3)
    content = torch.from_numpy(make_block_content(rates, 512, seed=3)
                               .reshape(64, -1)).to(cuda).to(torch.bfloat16)
    trace = make_trace(WORKLOADS["mcf"], n_accesses=512, n_pages=64, seed=3)
    out, demotes, promotes = {}, {}, {}
    for impl in ("kernel", "jnp"):
        cfg = dataclasses.replace(base, compress_impl=impl)
        pol = E.POLICIES["ibex"]
        pool = E.make_pool(cfg, seed=3)
        assert pool.meta.device.type == "cuda"
        n0 = qpack.fused_demote_launches
        p0 = qpack.fused_promote_launches
        for i in range(content.shape[0]):
            E.host_write_page(pool, cfg, pol, i, content[i])
        batch.replay_trace(pool, cfg, pol, *trace)
        out[impl] = interop.pool_to_numpy(pool)
        demotes[impl] = qpack.fused_demote_launches - n0
        promotes[impl] = qpack.fused_promote_launches - p0
    assert demotes["kernel"] > 0 and demotes["jnp"] == 0
    assert promotes["kernel"] > 0 and promotes["jnp"] == 0
    for k in out["kernel"]:
        np.testing.assert_array_equal(out["kernel"][k], out["jnp"][k],
                                      err_msg=k)


def test_cuda_tensor_never_takes_the_plain_version(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(qpack, "fused_encode_plain", boom)
    monkeypatch.setattr(qpack, "fused_decode_plain", boom)
    x = torch.zeros((4, 512), dtype=torch.bfloat16, device=cuda)
    dense, rates, _ = qpack.fused_encode(x)
    qpack.fused_decode(dense, rates)
    torch.cuda.synchronize()


def _store(nb: int, vals: int, seed: int) -> np.ndarray:
    """float32 pages [16, nb*vals]: every content class mixed in a page,
    all-raw pages, and pages of normal values not exact in bf16."""
    rng = np.random.default_rng(seed)
    classes = rng.integers(0, 4, (16, nb))
    classes[0], classes[1] = 3, np.arange(nb) % 4
    x = make_block_content(classes, vals, seed=seed).reshape(16, -1)
    x[2] = rng.standard_normal(nb * vals) * 0.7
    x[3, ::5] = np.float32(-0.0)
    return x.astype(np.float32)


@pytest.mark.parametrize("nb,vals", [(4, 512), (1, 2048)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("ze", [True, False])
def test_fused_demote_vs_plain(cuda, nb, vals, dtype, lossless, ze):
    """The demote kernel against its plain version byte for byte: pages
    read through slots (repeats included) and without, every output."""
    store = torch.from_numpy(_store(nb, vals, nb + vals)).to(cuda).to(dtype)
    kw = dict(blocks=nb, chunk_bytes=512, lossless=lossless,
              zero_elision=ze, quanta=comp.quanta_per_rate(vals),
              **({} if lossless else dict(tol4=0.05, tol8=0.003)))
    slots = torch.tensor([5, 0, 1, 15, 1, 2, 3, 3], dtype=torch.int64,
                         device=cuda)
    for sl in (slots, None):
        n0 = qpack.fused_demote_launches
        got = qpack.fused_demote(store, sl, **kw)
        want = qpack.fused_demote_plain(store, sl, **kw)
        torch.cuda.synchronize()
        assert qpack.fused_demote_launches == n0 + 1
        for name, a, b in zip(("bufs", "rates", "quanta", "nchunks",
                               "record"), got, want):
            assert torch.equal(a, b), name
        assert len(set(want[1].flatten().tolist())) >= 3


# -- the ring step -------------------------------------------------------------

RING_SCENARIOS = {
    "before_window": ([3, 7], [0, 0]),
    "at_window": ([8, 8], [0, 0]),
    "resumed": ([12, 20], [10, 13]),
    "mixed": ([3, 8, 12, 19, 23, 9, 40, 47], [0, 0, 10, 2, 15, 1, 0, 40]),
}


def _ring_case(cuda, B, H, D, bits, ring, new, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    S, W = 48, 8
    codes = [torch.randint(0, 256, (B, S, H, D * bits // 8), generator=g,
                           device=cuda, dtype=torch.uint8) for _ in range(2)]
    scales = [torch.randn((B, S, H), generator=g, device=cuda)
              for _ in range(2)]
    hot = [(torch.randn((B, W, H, D), generator=g, device=cuda) * 0.7)
           for _ in range(2)]
    for h in hot:
        h[:, 1] = 0.0
        h[:, 2, :, 1::2] = -0.0
        h[:, 3] = torch.randint(-7, 7, (B, H, D), generator=g,
                                device=cuda) + 0.5
        h[:, 3, :, 0] = 7.0
    hot = [h.to(ring) for h in hot]
    newv = [(torch.randn((B, H, D), generator=g, device=cuda) * 3).to(new)
            for _ in range(2)]
    return codes, scales, hot, newv


@pytest.mark.parametrize("scenario", list(RING_SCENARIOS))
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ring,new", [(torch.bfloat16, torch.bfloat16),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.float32)])
@pytest.mark.parametrize("H,D", [(8, 128), (2, 64), (3, 16), (24, 64),
                                 (32, 80)])
def test_ring_step_vs_plain(cuda, scenario, bits, ring, new, H, D):
    """The ring step kernel against its plain version, in place, byte for
    byte: codes, scales and both rings."""
    pos_l, cold_l = RING_SCENARIOS[scenario]
    B = len(pos_l)
    codes, scales, hot, newv = _ring_case(cuda, B, H, D, bits, ring, new,
                                          seed=bits + D + B)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=cuda)
    cold = torch.tensor(cold_l, dtype=torch.int32, device=cuda)
    state = {}
    for name, fn in (("kernel", qpack.ring_step),
                     ("plain", qpack.ring_step_plain)):
        c, s, h = ([t.clone() for t in ts] for ts in (codes, scales, hot))
        n0 = qpack.ring_step_launches
        fn(c[0], s[0], h[0], c[1], s[1], h[1], newv[0], newv[1], pos, cold,
           bits)
        torch.cuda.synchronize()
        assert qpack.ring_step_launches == n0 + (name == "kernel")
        state[name] = (c, s, h)
    (kc, ks, kh), (pc, ps, ph) = state["kernel"], state["plain"]
    iv = torch.int16 if ring == torch.bfloat16 else torch.int32
    for i in range(2):
        assert torch.equal(kc[i], pc[i])
        assert torch.equal(ks[i].view(torch.int32), ps[i].view(torch.int32))
        assert torch.equal(kh[i].view(iv), ph[i].view(iv))
    evicted = bool(((pos - 8) >= cold).any())
    assert evicted == (not torch.equal(pc[0], codes[0]))


def test_ring_step_rejects_other_types(cuda):
    codes, scales, hot, newv = _ring_case(cuda, 2, 2, 64, 4, torch.bfloat16,
                                          torch.bfloat16, seed=1)
    pos = torch.tensor([9, 9], dtype=torch.int32, device=cuda)
    cold = torch.zeros(2, dtype=torch.int32, device=cuda)
    for bad in (torch.float16, torch.int32):
        with pytest.raises(ValueError, match="new"):
            qpack.ring_step(codes[0], scales[0], hot[0], codes[1], scales[1],
                            hot[1], newv[0].to(bad), newv[1].to(bad), pos,
                            cold, 4)


def test_cuda_tensor_never_takes_the_fused_steps_plain_versions(cuda,
                                                                monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    for fn in ("fused_demote_plain", "fused_encode_plain",
               "compact_pages_plain", "ring_step_plain", "encode_plain",
               "fused_promote_plain", "fused_decode_plain",
               "dense_rows_plain", "prefill_fill_plain", "fill_plain",
               "lane_flush_plain", "ring_to_codes_plain"):
        monkeypatch.setattr(qpack, fn, boom)
    x = torch.zeros((4, 2048), dtype=torch.bfloat16, device=cuda)
    qpack.fused_demote(x, None, blocks=4, chunk_bytes=512)
    c_store, p_store, record, kw = _promote_case(cuda, True, True, 3, seed=1)
    qpack.fused_promote(c_store, p_store, record, **kw)
    codes, scales, hot, newv = _ring_case(cuda, 2, 2, 64, 4, torch.bfloat16,
                                          torch.bfloat16, seed=2)
    pos = torch.tensor([9, 3], dtype=torch.int32, device=cuda)
    qpack.ring_step(codes[0], scales[0], hot[0], codes[1], scales[1], hot[1],
                    newv[0], newv[1], pos, torch.zeros_like(pos), 4)
    kv, cache, lens = _fill_case(cuda, 2, 24, 40, 8, 2, 64, 4,
                                 torch.bfloat16, [24, 5], seed=3)
    qpack.prefill_fill(kv[0], kv[1], *cache, lens, 4)
    leaves, cold = _flush_case(cuda, 3, 2, 40, 8, 2, 64, 4, [0, 20, 25],
                               seed=4)
    qpack.lane_flush(*(t[:, 1] for t in leaves), cold[:, 1], 30, 4)
    torch.cuda.synchronize()


# -- the promotion step --------------------------------------------------------

def _promote_case(cuda, coloc: bool, lossless: bool, k: int, seed: int):
    """(c_store, p_store, record, kwargs) of ``k`` promotions: the page
    streams of ``_store`` pages (the port's own encode_pages) written into
    the chunks of a store of random bytes, single chunks or an 8-chunk
    group, and a record per page (chunk ids, rates, a distinct slot of a
    store of random rows, a mask cycling through the full page, each
    single block and random sets of ranges)."""
    cfg = PoolConfig(coloc=coloc, lossless=lossless, compress_impl="kernel",
                     **({} if lossless else dict(tol4=0.05, tol8=0.003)))
    nb = cfg.blocks_per_page if coloc else 1
    vals = cfg.vals_per_page // nb
    rng = np.random.default_rng(seed)
    pages = torch.from_numpy(np.concatenate(
        [_store(nb, vals, seed + i) for i in range(-(-k // 16))])[:k]) \
        .to(cuda).to(torch.bfloat16)
    bufs, rates, _, nch = comp.encode_pages(pages, cfg)
    bufs, rates, nch = bufs.cpu(), rates.cpu().tolist(), nch.cpu().tolist()
    cpp, cb = cfg.chunks_per_page, cfg.chunk_bytes
    n_rows = 8 * k + 64
    c_store = torch.from_numpy(rng.integers(0, 256, (n_rows, cb))
                               .astype(np.uint8))
    free = iter(rng.permutation(n_rows // 8).tolist())
    n_ranges = cfg.page_bytes // cfg.block_bytes
    masks = [(1 << n_ranges) - 1] + [1 << r for r in range(n_ranges)]
    rows = []
    for p in range(k):
        base = 8 * next(free)               # the page's own 8 chunks
        if nch[p] == 8:
            ids = list(range(base, base + 8))
        else:
            own = rng.permutation(8)[:nch[p]] + base
            ids = [int(own[i]) if i < nch[p] else 0 for i in range(cpp)]
        for i in range(min(nch[p], cpp)):
            c_store[ids[i]] = bufs[p, i * cb:(i + 1) * cb]
        mask = masks[p] if p < len(masks) else \
            int(rng.integers(1, 1 << n_ranges))
        rows.append(ids + rates[p] + [k + 7 - p, mask])
    p_store = torch.from_numpy(rng.integers(0, 256, (k + 8, cfg.page_bytes))
                               .astype(np.uint8)).to(cuda)
    record = torch.tensor(rows, dtype=torch.int32, device=cuda)
    kw = dict(blocks=nb, chunk_bytes=cb, range_bytes=cfg.block_bytes,
              quanta=comp.quanta_per_rate(vals))
    return c_store.to(cuda), p_store, record, kw


@pytest.mark.parametrize("coloc", [True, False])
@pytest.mark.parametrize("lossless", [True, False])
@pytest.mark.parametrize("k", [1, 6, 64])
def test_fused_promote_vs_plain(cuda, coloc, lossless, k):
    """The promote kernel against its plain version, byte for byte in
    every P-chunk row (the rows not promoted included)."""
    c_store, p_store, record, kw = _promote_case(cuda, coloc, lossless, k,
                                                 seed=k + 2 * coloc)
    got, want = p_store.clone(), p_store.clone()
    n0 = qpack.fused_promote_launches
    qpack.fused_promote(c_store, got, record, **kw)
    qpack.fused_promote_plain(c_store, want, record, **kw)
    torch.cuda.synchronize()
    assert qpack.fused_promote_launches == n0 + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, p_store)


def test_fused_promote_rejects_bad_records(cuda):
    c_store, p_store, record, kw = _promote_case(cuda, True, True, 2, seed=5)
    with pytest.raises(ValueError, match="record"):
        qpack.fused_promote(c_store, p_store, record[:, :-1].contiguous(),
                            **kw)
    with pytest.raises(ValueError, match="quanta"):
        qpack.fused_promote(c_store, p_store, record,
                            **dict(kw, quanta=(0, 3, 5, 9)))
    with pytest.raises(ValueError, match="p_store"):
        qpack.fused_promote(c_store, p_store[:, :-16], record, **kw)


# -- the prefill fill and the lane flush ---------------------------------------

def _fill_case(cuda, B, S, L, W, H, D, bits, dtype, lens, seed):
    """(k and v [B, S, H, D], a layer's six cache leaves, lens): the
    layer's leaves are slices [1] of stacked leaves of 3 layers."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    kv = [(torch.randn((B, S, H, D), generator=g, device=cuda) * 2)
          for _ in range(2)]
    for t in kv:
        t[:, 0] = 0.0
        t[:, 1, :, ::3] = -0.0
    kv = [t.to(dtype) for t in kv]
    dp = D * bits // 8
    cache = []
    for _ in range(2):
        cache += [torch.randint(0, 256, (3, B, L, H, dp), generator=g,
                                device=cuda, dtype=torch.uint8)[1],
                  torch.randn((3, B, L, H), generator=g, device=cuda)[1],
                  torch.randn((3, B, W, H, D), generator=g,
                              device=cuda).to(torch.bfloat16)[1]]
    return kv, cache, torch.tensor(lens, dtype=torch.int32, device=cuda)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("H,D", [(8, 128), (2, 64), (3, 16), (24, 64),
                                 (32, 80)])
@pytest.mark.parametrize("S,W,lens", [(40, 8, [40, 40]),
                                      (40, 8, [5, 40, 1, 23]),
                                      (6, 8, [6, 3])])
def test_prefill_fill_vs_plain(cuda, bits, dtype, H, D, S, W, lens):
    """The prefill fill against its plain version, byte for byte in each
    of the six leaves (positions past S untouched)."""
    kv, cache, lens_t = _fill_case(cuda, len(lens), S, S + 9, W, H, D, bits,
                                   dtype, lens, seed=S + H + D + bits)
    out = {}
    for name, fn in (("kernel", qpack.prefill_fill),
                     ("plain", qpack.prefill_fill_plain)):
        leaves = [t.clone() for t in cache]
        n0 = qpack.prefill_fill_launches
        fn(kv[0], kv[1], *leaves, lens_t, bits)
        torch.cuda.synchronize()
        assert qpack.prefill_fill_launches == n0 + (name == "kernel")
        out[name] = leaves
    for a, b in zip(out["kernel"], out["plain"]):
        iv = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
              torch.uint8: torch.uint8}[a.dtype]
        assert torch.equal(a.view(iv), b.view(iv))


def _flush_case(cuda, Lyr, B, T, W, H, D, bits, cold, seed):
    """(six leaves [Lyr, B, ...] of a batch cache, cold_len [Lyr, B])."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    dp = D * bits // 8
    leaves = []
    for _ in range(2):
        hot = torch.randn((Lyr, B, W, H, D), generator=g, device=cuda) * 0.7
        hot[:, :, 1] = 0.0
        hot[:, :, 2, :, 1::2] = -0.0
        hot[:, :, 3] = torch.randint(-7, 7, (Lyr, B, H, D), generator=g,
                                     device=cuda) + 0.5
        leaves += [torch.randint(0, 256, (Lyr, B, T, H, dp), generator=g,
                                 device=cuda, dtype=torch.uint8),
                   torch.randn((Lyr, B, T, H), generator=g, device=cuda),
                   hot.to(torch.bfloat16)]
    cold_len = torch.zeros((Lyr, B), dtype=torch.int32, device=cuda)
    cold_len[:, 1] = torch.tensor(cold, dtype=torch.int32, device=cuda)
    return leaves, cold_len


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("H,D", [(8, 128), (2, 64), (3, 16), (24, 64),
                                 (32, 80)])
@pytest.mark.parametrize("T,W,pos,cold", [
    (40, 8, 30, [0, 22, 25]), (40, 8, 21, [18, 20, 13]),
    (40, 8, 5, [0, 0, 3]), (40, 8, 17, [17, 17, 17]),
    (24, 8, 24, [10, 16, 0]), (300, 256, 290, [34, 100, 280])])
def test_lane_flush_vs_plain(cuda, bits, H, D, T, W, pos, cold):
    """The lane flush on lane 1's slice of a batch cache against its plain
    version, byte for byte in every leaf of every lane, and the clamped
    cold_len."""
    leaves, cold_len = _flush_case(cuda, len(cold), 3, T, W, H, D, bits,
                                   cold, seed=T + pos + D + bits)
    out = {}
    for name, fn in (("kernel", qpack.lane_flush),
                     ("plain", qpack.lane_flush_plain)):
        ls = [t.clone() for t in leaves]
        n0 = qpack.lane_flush_launches
        new = fn(*(t[:, 1] for t in ls), cold_len[:, 1], pos, bits)
        torch.cuda.synchronize()
        assert qpack.lane_flush_launches == n0 + (name == "kernel")
        out[name] = (ls, new)
    (kl, kc), (pl, pc) = out["kernel"], out["plain"]
    assert torch.equal(kc, pc)
    for a, b in zip(kl, pl):
        iv = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
              torch.uint8: torch.uint8}[a.dtype]
        assert torch.equal(a.view(iv), b.view(iv))


# -- fixed-rate quantize/pack (B3/B4) ----------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("block", [64, 128, 512, 6, 288])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fixed_rate_vs_plain(cuda, bits, block, dtype):
    """Byte for byte, over the edge classes (zeros, +-0, .5 ties,
    saturation, random bf16) and a block of 6 (the 2-value path)."""
    rng = np.random.default_rng(block + bits)
    x = (rng.standard_normal((48, block)) * 0.7).astype(np.float32)
    x[0::6] = 0.0
    x[1::6] = rng.integers(-7, 7, size=(8, block)) + 0.5
    x[2::6], x[3::6] = -8.0, -128.0
    x[2::6, 0], x[3::6, 0] = 7.0, 127.0
    x[4::6] = np.where(np.arange(block) % 2, np.float32(-0.0), x[4::6])
    x = torch.from_numpy(x).reshape(4, 3, 4 * block).to(cuda).to(dtype)
    e0, d0 = qpack.encode_launches, qpack.decode_launches
    got = qpack.encode(x, bits, block)
    want = qpack.encode_plain(x, bits, block)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for out in (torch.bfloat16, torch.float32):
        a = qpack.decode(*want, bits, block, out)
        b = qpack.decode_plain(*want, bits, block, out)
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int16) if out == torch.bfloat16
                           else a.view(torch.int32),
                           b.view(torch.int16) if out == torch.bfloat16
                           else b.view(torch.int32))
    assert qpack.encode_launches == e0 + 1 and qpack.decode_launches == d0 + 2


# -- decode attention over compressed KV (B5) and prefill attention (B6) -----

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("D,G", [(64, 2), (128, 4), (128, 1), (64, 8),
                                 (128, 16), (128, 7), (64, 12), (80, 1),
                                 (80, 4)])
def test_kvc_attn_vs_plain(cuda, bits, D, G):
    from repro_torch.kernels import kvc_attn as KA
    B, S, Hkv = 4, 300, 2
    g = torch.Generator(device=cuda).manual_seed(D + G + bits)
    q = torch.randn((B, Hkv * G, D), generator=g, device=cuda)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda)
    v = torch.randn((B, S, Hkv, D), generator=g, device=cuda)
    kc, ks = qpack.encode(k, bits, D)
    vc, vs = qpack.encode(v, bits, D)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    lens = torch.tensor([0, 1, 157, S], dtype=torch.int32, device=cuda)
    for qq in (q, q.to(torch.bfloat16)):
        got = KA.kvc_decode_partial(qq, kc, ks, vc, vs, lens, bits=bits)
        want = KA.kvc_decode_partial_plain(qq, kc, ks, vc, vs, lens, bits,
                                           1.0 / D ** 0.5)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)
        got = KA.kvc_decode_attention(qq, kc, ks, vc, vs, lens, bits=bits)
        want = KA.kvc_decode_attention_plain(qq, kc, ks, vc, vs, lens, bits,
                                             1.0 / D ** 0.5)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,Hq,Hkv,D", [
    (1, 1, 4, 4, 64), (37, 37, 4, 1, 64), (128, 128, 8, 2, 128),
    (24, 200, 4, 2, 128), (512, 512, 32, 8, 128), (100, 100, 8, 1, 128),
    (1000, 1000, 16, 2, 64), (2048, 2048, 8, 1, 128),
    (1024, 1024, 24, 24, 64), (1000, 1000, 64, 8, 128),
    (1024, 1024, 32, 32, 80), (100, 100, 4, 4, 80), (24, 200, 4, 1, 80)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_vs_plain(cuda, causal, Sq, Sk, Hq, Hkv, D, dtype):
    """bf16 runs on the tensor cores (launches_tc counts it), f32 on the
    CUDA cores. Element-wise within 2e-2 (bf16) / 2e-3 (f32), and normwise
    within 1e-2 / 1e-4, which a skipped or repeated key tile would not
    be."""
    from repro_torch.kernels import flash_attn as FA
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q, k, v = (torch.randn((2, s, h, D), generator=g, device=cuda).to(dtype)
               for s, h in ((Sq, Hq), (Sk, Hkv), (Sk, Hkv)))
    tc0 = FA.launches_tc
    got = FA.flash_attention(q, k, v, causal=causal)
    want = FA.flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    norm_tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want.float()).norm() <= \
        norm_tol * want.float().norm()
    assert FA.launches_tc == tc0 + (dtype == torch.bfloat16)


@pytest.mark.parametrize("bits,D,G", [(4, 128, 4), (8, 64, 8), (4, 128, 16),
                                    (8, 128, 16), (4, 128, 7)])
def test_kvc_attn_split_boundaries_and_repeats(cuda, bits, D, G):
    """The split kernel at lengths around its chunk and at S, with S 2048
    (many splits) and 8 (one): both forms within 2e-2 of the plain
    versions, and a second call bit-identical to the first."""
    from repro_torch.kernels import kvc_attn as KA
    c = KA.CHUNK
    g = torch.Generator(device=cuda).manual_seed(bits + D)
    for S, lengths in ((2048, [0, 1, c - 1, c, c + 1, 2047, 2048]),
                       (8, [0, 1, 7, 8])):
        B, Hkv = len(lengths), 2
        q = torch.randn((B, Hkv * G, D), generator=g,
                        device=cuda).to(torch.bfloat16)
        kc, ks = qpack.encode(torch.randn((B, S, Hkv, D), generator=g,
                                          device=cuda), bits, D)
        vc, vs = qpack.encode(torch.randn((B, S, Hkv, D), generator=g,
                                          device=cuda), bits, D)
        ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        sm = 1.0 / D ** 0.5
        got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
        again = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
        want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits, sm)
        torch.cuda.synchronize()
        for a, b, w in zip(got, again, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            torch.testing.assert_close(a, w, atol=2e-2, rtol=2e-2)
        got = KA.kvc_decode_attention(q, kc, ks, vc, vs, lens, bits=bits)
        want = KA.kvc_decode_attention_plain(q, kc, ks, vc, vs, lens, bits,
                                             sm)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("Hq,Hkv,D", [(24, 24, 64), (64, 8, 128),
                                      (32, 32, 80)])
def test_kvc_attn_frontend_shapes(cuda, bits, Hq, Hkv, D):
    """B5 at the frontend backbones' heads (musicgen-medium's 24/24 x 64,
    a group of 1; chameleon-34b's 64/8 x 128, a group of 8) and the
    hybrid's (zamba2-2.7b's 32/32 x 80), bf16 q, at lengths around its
    chunk of S 2,048: within 2e-2 of the plain version, a second call
    bit-identical, one launch a call at its group."""
    from repro_torch.kernels import kvc_attn as KA
    c, S = KA.CHUNK, 2048
    lengths = [0, 1, c - 1, c, c + 1, S]
    B = len(lengths)
    g = torch.Generator(device=cuda).manual_seed(Hq + bits)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(torch.bfloat16)
    kc, ks = qpack.encode(torch.randn((B, S, Hkv, D), generator=g,
                                      device=cuda), bits, D)
    vc, vs = qpack.encode(torch.randn((B, S, Hkv, D), generator=g,
                                      device=cuda), bits, D)
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    KA.group_launches.clear()
    got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
    again = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
    want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits,
                                       1.0 / D ** 0.5)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, w, atol=2e-2, rtol=2e-2)
    assert KA.group_launches == {Hq // Hkv: 2}


def test_kvc_attn_refuses_groups_past_sixteen(cuda):
    """A group of 17 query heads a KV head raises before any launch: the
    CUDA tensor never takes the plain version."""
    from repro_torch.kernels import kvc_attn as KA
    kc, ks = qpack.encode(torch.randn((1, 8, 1, 128), device=cuda), 4, 128)
    ks = ks[..., 0].contiguous()
    q = torch.randn((1, 17, 128), device=cuda, dtype=torch.bfloat16)
    n = KA.launches
    with pytest.raises(ValueError, match="up to 16"):
        KA.kvc_decode_partial(q, kc, ks, kc, ks,
                              torch.tensor([8], device=cuda), bits=4)
    assert KA.launches == n


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "arctic_480b"])
@pytest.mark.parametrize("tokens", [(8, 1), (3, 200), (2, 512)])
def test_moe_on_the_card_matches_the_cpu(cuda, arch, tokens):
    """The MoE layer (REDUCED, float32) on the card against the same code
    on the CPU: the card's stable sorts and scatters choose, drop and
    place the same pairs (choices equal, outputs within 1e-5), repeated
    rows included so that pairs are dropped."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as TM
    from repro_torch.models import transformer as TT
    cfg = dataclasses.replace(get_reduced(arch), dtype="float32",
                              num_layers=1)
    p = TT.init_params(cfg, seed=5, device="cpu")["layers"][0]["mlp"]
    x = torch.from_numpy(np.random.default_rng(sum(tokens)).standard_normal(
        tokens + (cfg.d_model,)).astype(np.float32))
    x[:, ::3] = x[0, 0]
    pc = {k: ({kk: vv.to(cuda) for kk, vv in v.items()} if isinstance(v, dict)
              else v.to(cuda)) for k, v in p.items()}
    want, waux = TM.moe_apply(p, x, cfg)
    got, gaux = TM.moe_apply(pc, x.to(cuda), cfg)
    k = cfg.moe.top_k
    assert torch.equal(TM.route(pc["router"], x.to(cuda), k)[2].cpu(),
                       TM.route(p["router"], x, k)[2])
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gaux.cpu(), waux, atol=1e-6, rtol=1e-6)


def test_small_llama_serves_alike_with_kernels_and_plain(cuda):
    """REDUCED llama3 served with the kernels and with the plain versions:
    the same generations (float32, so the argmax has margin), and each
    kernel launched in the kernel run only."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    params = T.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (16, 12, 32, 20, 16)]
    out = {}
    for impl, q_impl in (("kernel", "kernel"), ("plain", "jnp")):
        scfg = ServeConfig(max_running=2, hot_window=16, kv_rate_bits=8,
                           attn_impl=impl, quantize_impl=q_impl)
        launches = lambda: (  # noqa: E731
            qpack.prefill_fill_launches, qpack.lane_flush_launches,
            KA.launches, FA.launches, qpack.ring_step_launches,
            qpack.encode_launches)
        n0 = launches()
        eng = Engine(cfg, scfg, params, max_len=128)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done(max_steps=400)
        out[impl] = ([eng.result(r) for r in rids],
                     [b - a for a, b in zip(n0, launches())])
    assert out["kernel"][0] == out["plain"][0]
    # every step of the path launched, and B3's own encode no more
    assert all(n > 0 for n in out["kernel"][1][:-1])
    assert out["kernel"][1][-1] == 0
    assert out["plain"][1] == [0] * 6


def test_small_falcon_mamba_on_the_card_matches_the_cpu(cuda):
    """REDUCED falcon-mamba (float32, TF32 off) on the card against the
    same params on the CPU: prefill and decode logits within 1e-4, the
    states alike, and the same generations through Engine (the SSM path
    launches no kernel)."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("falcon_mamba_7b"),
                              dtype="float32")
    params = T.init_params(cfg, seed=0, device="cpu")
    pc = {k: ([{kk: {a: b.to(cuda) for a, b in vv.items()}
                if isinstance(vv, dict) else vv.to(cuda)
                for kk, vv in lp.items()} for lp in v]
              if k == "layers" else v.to(cuda)) for k, v in params.items()}
    scfg = ServeConfig(max_running=2, hot_window=16, kv_rate_bits=4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 96)).astype(np.int32))
    lg, cache = D.prefill(params, {"tokens": tokens}, cfg, scfg, 256)
    lgc, cachec = D.prefill(pc, {"tokens": tokens.to(cuda)}, cfg, scfg, 256)
    tok, pos = lg.argmax(-1).to(torch.int32), torch.full((2,), 96,
                                                          dtype=torch.int32)
    for _ in range(3):
        torch.testing.assert_close(lgc.cpu(), lg, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(cachec["ssm.h"].cpu(), cache["ssm.h"],
                                   atol=1e-4, rtol=1e-4)
        lg, _ = D.decode_step(params, cache, tok, pos, cfg, scfg)
        lgc, _ = D.decode_step(pc, cachec, tok.to(cuda), pos.to(cuda), cfg,
                               scfg)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (32, 64, 32, 96, 20)]
    out = []
    n0 = (KA.launches, FA.launches, qpack.ring_step_launches)
    for p_, dev in ((params, "cpu"), (pc, cuda)):
        eng = Engine(cfg, scfg, p_, max_len=256, device=dev)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_done(max_steps=400)
        out.append(([eng.result(r) for r in rids], eng.counters))
    assert out[0] == out[1]
    assert (KA.launches, FA.launches, qpack.ring_step_launches) == n0


def test_small_zamba2_on_the_card_matches_the_cpu(cuda):
    """REDUCED zamba2 with attention heads of 80 (the published head dim;
    float32, TF32 off) on the card, through the kernels at D 80 (B3's
    steps, B5 and B6 on the CUDA cores), against the same params on the
    CPU: prefill and decode logits within 2e-3 of each row's largest
    (the f32 attention kernels' tolerance), and the same generations and
    counters through Engine, with the kernels launched."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("zamba2_2p7b"), dtype="float32",
                              head_dim=80)
    params = T.init_params(cfg, seed=0, device="cpu")

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return tree.to(cuda)

    pc = to(params)
    scfg = ServeConfig(max_running=2, hot_window=16, kv_rate_bits=4)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 96)).astype(np.int32))
    n0 = (KA.launches, FA.launches, qpack.ring_step_launches)
    lg, cache = D.prefill(params, {"tokens": tokens}, cfg, scfg, 256)
    lgc, cachec = D.prefill(pc, {"tokens": tokens.to(cuda)}, cfg, scfg, 256)
    tok, pos = lg.argmax(-1).to(torch.int32), torch.full((2,), 96,
                                                          dtype=torch.int32)
    for _ in range(3):
        bound = 2e-3 * lg.abs().amax(dim=-1)
        assert bool(((lgc.cpu() - lg).abs().amax(dim=-1) <= bound).all())
        assert torch.equal(lgc.cpu().argmax(-1), lg.argmax(-1))
        lg, _ = D.decode_step(params, cache, tok, pos, cfg, scfg)
        lgc, _ = D.decode_step(pc, cachec, tok.to(cuda), pos.to(cuda), cfg,
                               scfg)
        tok, pos = lg.argmax(-1).to(torch.int32), pos + 1
    assert (KA.launches - n0[0], FA.launches - n0[1],
            qpack.ring_step_launches - n0[2]) == (6, 2, 6)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (32, 64, 20)]
    out = []
    for p_, dev in ((params, "cpu"), (pc, cuda)):
        eng = Engine(cfg, scfg, p_, max_len=256, device=dev)
        rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_done(max_steps=400)
        out.append(([eng.result(r) for r in rids], eng.counters))
    assert out[0] == out[1]


# -- MLA: the latent forms of B3's steps, B5's latent form, B6 at 96/64 ------

def _iv(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32,
                   torch.uint8: torch.uint8, torch.int32: torch.int32}[
                       t.dtype])


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("new", [torch.bfloat16, torch.float32])
def test_latent_ring_step_vs_plain(cuda, bits, new):
    """minicpm3's latent (R 288) over 8 lanes of RING_SCENARIOS' kinds
    (before the window fills, resumed, evicting), byte for byte."""
    from repro_torch.kernels import qpack as Q
    B, S, W, R = 8, 2048, 256, 288
    g = torch.Generator(device=cuda).manual_seed(bits)
    codes = torch.randint(0, 256, (B, S, R * bits // 8), generator=g,
                          device=cuda, dtype=torch.uint8)
    scales = torch.randn((B, S), generator=g, device=cuda)
    hot = (torch.randn((B, W, R), generator=g, device=cuda) * 0.7)
    hot[:, 1] = 0.0
    hot[:, 3] = torch.randint(-7, 7, (B, R), generator=g, device=cuda) + 0.5
    hot = hot.to(torch.bfloat16)
    newv = (torch.randn((B, R), generator=g, device=cuda) * 3).to(new)
    pos = torch.tensor([100, 256, 600, 700, 1500, 2303, 257, 2000],
                       dtype=torch.int32, device=cuda)
    cold = torch.tensor([0, 0, 500, 0, 1244, 0, 2, 100], dtype=torch.int32,
                        device=cuda)
    out = []
    n0 = Q.latent_ring_step_launches
    for fn in (Q.latent_ring_step, Q.latent_ring_step_plain):
        c, s_, h = codes.clone(), scales.clone(), hot.clone()
        fn(c, s_, h, newv, pos, cold, bits)
        out.append((c, s_, h))
    torch.cuda.synchronize()
    assert Q.latent_ring_step_launches == n0 + 1
    assert all(torch.equal(_iv(a), _iv(b)) for a, b in zip(*out))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,L,W,lens", [(1024, 2048, 256, [1000, 37]),
                                        (40, 49, 8, [40, 5, 1, 23])])
def test_latent_fill_vs_plain(cuda, bits, dtype, S, L, W, lens):
    from repro_torch.kernels import qpack as Q
    B, R = len(lens), 288
    g = torch.Generator(device=cuda).manual_seed(bits + S)
    lat = torch.randn((B, S, R), generator=g, device=cuda) * 2
    lat[:, 0] = 0.0
    lat = lat.to(dtype)
    leaves = [torch.randint(0, 256, (3, B, L, R * bits // 8), generator=g,
                            device=cuda, dtype=torch.uint8)[1],
              torch.randn((3, B, L), generator=g, device=cuda)[1],
              torch.randn((3, B, W, R), generator=g, device=cuda)
              .to(torch.bfloat16)[1]]
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    out = []
    for fn in (Q.latent_prefill_fill, Q.latent_prefill_fill_plain):
        ls = [t.clone() for t in leaves]
        fn(lat, *ls, lens_t, bits)
        out.append(ls)
    torch.cuda.synchronize()
    assert all(torch.equal(_iv(a), _iv(b)) for a, b in zip(*out))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("pos,cold", [(1000, [0, 744, 900]),
                                      (100, [0, 0, 60]),
                                      (2048, [1792, 2000, 0]),
                                      (500, [500, 500, 500])])
def test_latent_flush_vs_plain(cuda, bits, pos, cold):
    """Lane 1 of a 3-lane latent cache of 3 layers, byte for byte in every
    lane and the clamped cold_len."""
    from repro_torch.kernels import qpack as Q
    Lyr, B, T, W, R = 3, 3, 2048, 256, 288
    g = torch.Generator(device=cuda).manual_seed(bits + pos)
    leaves = [torch.randint(0, 256, (Lyr, B, T, R * bits // 8), generator=g,
                            device=cuda, dtype=torch.uint8),
              torch.randn((Lyr, B, T), generator=g, device=cuda),
              torch.randn((Lyr, B, W, R), generator=g, device=cuda)
              .to(torch.bfloat16)]
    cold_len = torch.zeros((Lyr, B), dtype=torch.int32, device=cuda)
    cold_len[:, 1] = torch.tensor(cold, dtype=torch.int32, device=cuda)
    out = []
    for fn in (Q.latent_lane_flush, Q.latent_lane_flush_plain):
        ls = [t.clone() for t in leaves]
        new = fn(*(t[:, 1] for t in ls), cold_len[:, 1], pos, bits)
        out.append(ls + [new])
    torch.cuda.synchronize()
    assert all(torch.equal(_iv(a), _iv(b)) for a, b in zip(*out))


@pytest.mark.parametrize("bits", [4, 8])
def test_kvc_latent_vs_plain(cuda, bits):
    """B5's latent form (40 heads of 288, K = V) at lengths around both
    routes' tiles (the CUDA cores' chunk, the tensor cores' span) and at
    S, S 2048 (many splits) and 64 (one), bf16 queries on the tensor cores
    and f32 on the CUDA cores: within 2e-2 of the plain version, a second
    call bit-identical."""
    from repro_torch.kernels import kvc_attn as KA
    c, t = KA.LATENT_CHUNK, KA.LATENT_TC_TOKENS
    g = torch.Generator(device=cuda).manual_seed(bits)
    sm = 1.0 / 96 ** 0.5
    for S, lengths in ((2048, [0, 1, c - 1, c, c + 1, t - 1, t + 1, 2 * t,
                               2 * t + 1, 700, 2047, 2048]),
                       (64, [0, 1, 63, 64])):
        B = len(lengths)
        codes, scales = qpack.encode(torch.randn((B, S, 288), generator=g,
                                                 device=cuda), bits, 288)
        scales = scales[..., 0].contiguous()
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        for dt in (torch.bfloat16, torch.float32):
            q = torch.randn((B, 40, 288), generator=g, device=cuda).to(dt)
            n0, tc0 = KA.latent_launches, KA.latent_launches_tc
            got = KA.kvc_latent_partial(q, codes, scales, lens, bits=bits,
                                        sm_scale=sm)
            again = KA.kvc_latent_partial(q, codes, scales, lens, bits=bits,
                                          sm_scale=sm)
            want = KA.kvc_latent_partial_plain(q, codes, scales, lens, bits,
                                               sm)
            torch.cuda.synchronize()
            assert KA.latent_launches == n0 + 2
            assert KA.latent_launches_tc == tc0 + 2 * (dt == torch.bfloat16)
            for a, b, w in zip(got, again, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                torch.testing.assert_close(a, w, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("bits", [4, 8])
def test_kvc_latent_tc_vs_rounding_model(cuda, bits):
    """The tensor-core route against ``kvc_latent_partial_tc_model`` on the
    card, at lengths around a CTA's span of tokens and of many spans,
    within ``LATENT_TC_MODEL_TOL`` (1e-4 normwise, 2e-5 for m and l): far
    more tightly than the plain version's 2e-2, so that a layout error
    cannot hide inside it."""
    from repro_torch.kernels import kvc_attn as KA
    t = KA.LATENT_TC_TOKENS
    S = 2048
    lengths = [0, 1, t - 1, t, t + 1, 2 * t - 1, 2 * t + 1, 672, 1500, S]
    B = len(lengths)
    g = torch.Generator(device=cuda).manual_seed(10 + bits)
    sm = 1.0 / 96 ** 0.5
    codes, scales = qpack.encode(torch.randn((B, S, 288), generator=g,
                                             device=cuda), bits, 288)
    scales = scales[..., 0].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    q = torch.randn((B, 40, 288), generator=g, device=cuda).to(torch.bfloat16)
    got = KA.kvc_latent_partial(q, codes, scales, lens, bits=bits,
                                sm_scale=sm)
    model = KA.kvc_latent_partial_tc_model(q, codes, scales, lens, bits, sm)
    torch.cuda.synchronize()
    tol = KA.LATENT_TC_MODEL_TOL
    for a, w in zip(got[:2], model[:2]):
        assert float(((a - w).abs() / (1 + w.abs())).max()) <= tol["ml"]
    assert float((got[2] - model[2]).norm()) <= \
        tol["acc_norm"] * float(model[2].norm())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Sk,B", [(1, 1, 2), (100, 100, 2), (24, 200, 2),
                                     (1024, 1024, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_mla_dims_vs_plain(cuda, causal, Sq, Sk, B, dtype):
    """B6 at MLA's expanded prefill: 40 heads, q/k 96, v 64, scale
    1/sqrt(96); the tolerances of test_flash_attn_vs_plain."""
    from repro_torch.kernels import flash_attn as FA
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q, k = (torch.randn((B, s, 40, 96), generator=g, device=cuda).to(dtype)
            for s in (Sq, Sk))
    v = torch.randn((B, Sk, 40, 64), generator=g, device=cuda).to(dtype)
    sm = 1.0 / 96 ** 0.5
    tc0 = FA.launches_tc
    got = FA.flash_attention(q, k, v, causal=causal, sm_scale=sm)
    want = FA.flash_attention_plain(q, k, v, causal=causal, sm_scale=sm)
    assert got.shape == (B, Sq, 40, 64)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-3
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    norm_tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    assert (got.float() - want.float()).norm() <= \
        norm_tol * want.float().norm()
    assert FA.launches_tc == tc0 + (dtype == torch.bfloat16)


def test_small_minicpm_serves_alike_with_kernels_and_plain(cuda):
    """minicpm3-4b at its full widths, 2 layers, float32, served with the
    kernels and with the plain versions (5 requests over 2 lanes): the same
    generations, each MLA kernel launched in the kernel run only."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = dataclasses.replace(get_config("minicpm3_4b"), num_layers=2,
                              dtype="float32")
    params = T.init_params(cfg, seed=0, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (40, 12, 70, 20, 33)]
    out = {}
    for impl, q_impl in (("kernel", "kernel"), ("plain", "jnp")):
        scfg = ServeConfig(max_running=2, hot_window=16, kv_rate_bits=4,
                           attn_impl=impl, quantize_impl=q_impl)
        launches = lambda: (  # noqa: E731
            qpack.latent_prefill_fill_launches,
            qpack.latent_lane_flush_launches, KA.latent_launches,
            FA.launches, qpack.latent_ring_step_launches)
        n0 = launches()
        eng = Engine(cfg, scfg, params, max_len=256)
        rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
        eng.run_until_done(max_steps=400)
        out[impl] = ([eng.result(r) for r in rids],
                     [b - a for a, b in zip(n0, launches())])
    assert out["kernel"][0] == out["plain"][0]
    assert all(n > 0 for n in out["kernel"][1])
    assert out["plain"][1] == [0] * 5


# -- the training path: B3/B4 on the AdamW moments, B6 under autograd --------

@pytest.mark.parametrize("n,block", [(4096, 512), (256, 256),
                                     (4096 * 4096, 512), (3 * 2 ** 21, 512),
                                     (1024 * 14336, 512)])
def test_fixed_rate_at_the_optimizer_shapes(cuda, n, block):
    """8 bits, f32 in, flat leaves (a norm, a whole-leaf block, wq, a
    slice of the MLP's leaves): codes, scales and the decoded f32
    byte-identical to the plain versions."""
    g = torch.Generator(device=cuda).manual_seed(n % 9973)
    x = torch.randn((n,), generator=g, device=cuda) * 1e-3
    x[: min(n, 1024)] = 0.0
    got = qpack.encode(x, 8, block)
    want = qpack.encode_plain(x, 8, block)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    a = qpack.decode(*want, 8, block, torch.float32)
    b = qpack.decode_plain(*want, 8, block, torch.float32)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_compressed_adamw_kernels_vs_plain(cuda):
    """Two compressed AdamW updates of REDUCED llama3's stacked leaves on
    the card, B3/B4 against their plain versions: every code, scale and
    param identical (the same arithmetic around them)."""
    from repro_torch.common import tree as TR
    from repro_torch.common.types import OptimizerConfig
    from repro_torch.configs import get_reduced
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = get_reduced("llama3_8b")
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=1, compress_state=True)
    out = {}
    for impl in ("kernel", "jnp"):
        params = trainer.init_params(cfg, 0, cuda)
        state = adamw.init(params, ocfg, impl)
        g = torch.Generator(device=cuda).manual_seed(1)
        grads = TR.map_tree(lambda p: torch.randn(
            p.shape, generator=g, device=cuda).to(p.dtype) * 1e-2, params)
        e0 = qpack.encode_launches
        for _ in range(2):
            params, state, _ = adamw.update(grads, state, params, ocfg, impl)
        assert (qpack.encode_launches > e0) == (impl == "kernel")
        out[impl] = (params, state)
    for (p, a), (_, b) in zip(TR.leaves_with_paths(out["kernel"]),
                              TR.leaves_with_paths(out["jnp"])):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), p
        else:
            assert a == b, p


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,Dv", [(8, 512, 32, 8, 128, 128),
                                             (2, 256, 40, 40, 96, 64),
                                             (2, 300, 4, 2, 64, 64)])
def test_flash_attention_function_on_the_card(cuda, dtype, B, S, Hq, Hkv, D,
                                              Dv):
    """B6's autograd Function: the forward is B6's launch; dq/dk/dv
    against autograd through the plain version in f32 on the card,
    normwise within 1e-2 (bf16) / 1e-4 (f32)."""
    from repro_torch.kernels import flash_attn as FA
    g = torch.Generator(device=cuda).manual_seed(S + D)
    q = torch.randn((B, S, Hq, D), generator=g, device=cuda)
    k = torch.randn((B, S, Hkv, D), generator=g, device=cuda)
    v = torch.randn((B, S, Hkv, Dv), generator=g, device=cuda)
    do = torch.randn((B, S, Hq, Dv), generator=g, device=cuda)
    ins = [t.to(dtype).requires_grad_() for t in (q, k, v)]
    n0 = FA.launches
    o = FA.flash_attention_trainable(*ins, causal=True)
    assert FA.launches == n0 + 1 and o.grad_fn is not None
    o.backward(do.to(dtype))
    ref = [t.to(dtype).float().requires_grad_() for t in (q, k, v)]
    FA.flash_attention_plain(*ref, causal=True).backward(
        do.to(dtype).float())
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(ins, ref):
        assert (a.grad.float() - b.grad).norm() <= tol * b.grad.norm()
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(*ins)
