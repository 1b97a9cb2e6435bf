"""The pool's promotion step against the reference, on the CPU, byte for
byte: ``compressor.promote_pages`` (the plain path), the promote kernel's
plain version ``qpack.fused_promote_plain`` and the ``qpack.fused_promote``
wrapper on CPU tensors (no launch counted), each writing the P-chunk rows
of one record of pages, against the JAX ``_gather_page_buf`` +
``decode_page`` + masked ``p_store`` set of ``repro.core.engine.ops``
(``promote``'s fine-grained and full materialization, ``_update_promote``'s
fill of the ranges that are not hot).

The pages are the reference's own ``encode_pages`` streams, scattered into
a C-chunk store of random bytes through entries built with the
reference's metadata helpers: single chunks for compressed pages, an
8-chunk group for the all-raw ones (whose last block starts at
``page_bytes - 2V``, the bound of the slicing's clamp). The CUDA kernel is
held against this plain version on the card, in test_torch_cuda.py."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common.types import PoolConfig as JConfig  # noqa: E402
from repro.core import compressor as jcomp  # noqa: E402
from repro.core import metadata as jmd  # noqa: E402
from repro.core.engine import ops as jops  # noqa: E402
from repro_torch.common.types import PoolConfig  # noqa: E402
from repro_torch.core import compressor as comp  # noqa: E402
from repro_torch.core.engine import ops  # noqa: E402
from repro_torch.kernels import qpack  # noqa: E402
from repro_torch.simx.trace import make_block_content  # noqa: E402

N_CCHUNKS = 256
# lossy tolerances at which all four rates occur (as in
# test_torch_fused_steps.py)
LOSSY = dict(tol4=0.05, tol8=0.003)


def _configs(coloc: bool, lossless: bool):
    kw = dict(coloc=coloc, lossless=lossless, store_payload=True,
              n_cchunks=N_CCHUNKS, compress_impl="jnp",
              **({} if lossless else LOSSY))
    jcfg = JConfig(**kw)
    return jcfg, PoolConfig(**dataclasses.asdict(jcfg))


def _pages(nb: int, vals: int, seed: int) -> np.ndarray:
    """bf16-exact float32 pages: every content class mixed in a page,
    all-raw, all-zero, all-4-bit and all-8-bit pages, random rates, and a
    page of normal values."""
    rng = np.random.default_rng(seed)
    if nb == 4:
        classes = [[0, 1, 2, 3], [3, 3, 3, 3], [0, 0, 0, 0], [1, 1, 1, 1],
                   [2, 2, 2, 2], [3, 2, 1, 0], [1, 3, 0, 3]]
    else:
        classes = [[0], [1], [2], [3], [3]]
    rates = np.array(classes + rng.integers(0, 4, (4, nb)).tolist())
    x = make_block_content(rates, vals, seed=seed).reshape(len(rates), -1)
    x[-1] = rng.standard_normal(nb * vals) * 0.7
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _stored(jcfg, coloc: bool, seed: int):
    """(c_store uint8[N_CCHUNKS, chunk_bytes], JAX entries): the reference's
    page streams of ``_pages`` written into their chunks of a store of
    random bytes."""
    nb = jcfg.blocks_per_page if coloc else 1
    xs = _pages(nb, jcfg.vals_per_page // nb, seed)
    bufs, rates, _, nch = (np.asarray(a) for a in jcomp.encode_pages(
        jnp.asarray(xs).astype(jnp.bfloat16), jcfg))
    rng = np.random.default_rng(seed)
    store = rng.integers(0, 256, (N_CCHUNKS, jcfg.chunk_bytes)) \
        .astype(np.uint8)
    groups = iter(range(0, 64, 8))             # aligned 8-chunk groups
    singles = iter(rng.permutation(np.arange(64, N_CCHUNKS)).tolist())
    entries = []
    for p in range(xs.shape[0]):
        n = int(nch[p])
        w = jmd.header_from_rates(jnp.asarray(rates[p])) if coloc else \
            jops._header_4kb(jnp.int32(rates[p, 0]), n)
        entry = jnp.zeros((8,), jnp.uint32).at[0].set(
            jmd.set_num_chunks(w, n))
        if n == 8:
            base = next(groups)
            ids = list(range(base, base + 8))
            entry = jmd.set_ptr(entry, 0, base)
        else:
            ids = [next(singles) for _ in range(n)]
            for i, c in enumerate(ids):
                entry = jmd.set_ptr(entry, i, c)
        for i, c in enumerate(ids):
            store[c] = bufs[p, i * jcfg.chunk_bytes:(i + 1) * jcfg.chunk_bytes]
        entries.append(entry)
    assert (nch == 8).any() and (nch < 8).any()
    assert set(rates.ravel().tolist()) == {0, 1, 2, 3}
    return store, entries


def _masks(jcfg, n_pages: int, seed: int) -> list:
    """Per page a list of range masks: the full page, each single block,
    and a random set of ranges that are not hot."""
    rng = np.random.default_rng(seed)
    n = jcfg.page_bytes // jcfg.block_bytes
    full = (1 << n) - 1
    return [[full] + [1 << r for r in range(n)] +
            [int(rng.integers(1, full))] for _ in range(n_pages)]


def _ref_pages(jcfg, c_store, entries) -> np.ndarray:
    """The reference's promoted bytes of each entry's page, uint8[P,
    page_bytes]: ``_gather_page_buf``, ``decode_page``, ``_page_to_bytes``
    (jitted once per config)."""
    def one(cs, entry):
        buf = jops._gather_page_buf(SimpleNamespace(c_store=cs), jcfg, entry)
        return jops._page_to_bytes(jcomp.decode_page(
            buf, jops._rates_of(entry, jcfg), jcfg))
    fn = jax.jit(one)
    cs = jnp.asarray(c_store)
    return np.stack([np.asarray(fn(cs, e)) for e in entries])


def _range_masks(jcfg, mask: int, single) -> np.ndarray:
    """bool[page_bytes]: the bytes a promotion writes. A single block's is
    the reference's own ``_block_mask``; a set of ranges is
    ``_update_promote``'s fill of those that are not hot."""
    if single is not None:
        return np.asarray(jops._block_mask(jcfg, single, jnp.asarray(False)))
    pos = np.arange(jcfg.page_bytes) // jcfg.block_bytes
    return ((mask >> pos) & 1) == 1


def _record(tcfg, entries, slots, masks) -> torch.Tensor:
    rows = []
    for e, s, m in zip(entries, slots, masks):
        ints = [int(w) for w in np.asarray(e)]
        rows.append(ops._page_chunk_ids(tcfg, ints, N_CCHUNKS) +
                    ops._rates_of(ints, tcfg) + [s, m])
    return torch.tensor(rows, dtype=torch.int32)


def _steps(tcfg):
    nb = tcfg.blocks_per_page if tcfg.coloc else 1
    kw = dict(blocks=nb, chunk_bytes=tcfg.chunk_bytes,
              range_bytes=tcfg.block_bytes,
              quanta=comp.quanta_per_rate(tcfg.vals_per_page // nb))
    return {
        "promote_pages": lambda c, p, r: comp.promote_pages(c, p, r, tcfg),
        "fused_promote_plain": lambda c, p, r: qpack.fused_promote_plain(
            c, p, r, **kw),
        "fused_promote": lambda c, p, r: qpack.fused_promote(c, p, r, **kw),
    }


@pytest.mark.parametrize("coloc", [True, False])
@pytest.mark.parametrize("lossless", [True, False])
def test_promote_step_vs_reference(coloc, lossless):
    """Every page under every mask, one page a record (the pool's K = 1)
    and all pages of a mask kind in one record, into rows of random
    bytes."""
    jcfg, tcfg = _configs(coloc, lossless)
    c_store, entries = _stored(jcfg, coloc, seed=7 + 2 * coloc + lossless)
    P = len(entries)
    masks = _masks(jcfg, P, seed=P)
    n_kinds = len(masks[0])
    rng = np.random.default_rng(3)
    p_store = rng.integers(0, 256, (P * n_kinds, jcfg.page_bytes)) \
        .astype(np.uint8)
    n_ranges = jcfg.page_bytes // jcfg.block_bytes
    # page p under mask kind j goes to slot j * P + p
    pages = _ref_pages(jcfg, c_store, entries)
    singles = {r: _range_masks(jcfg, 1 << r, r) for r in range(n_ranges)}
    want = p_store.copy()
    for p in range(P):
        for j in range(n_kinds):
            sel = singles[j - 1] if 1 <= j <= n_ranges else \
                _range_masks(jcfg, masks[p][j], None)
            want[j * P + p] = np.where(sel, pages[p], p_store[j * P + p])
    ct = torch.from_numpy(c_store)
    n0 = qpack.fused_promote_launches
    for name, step in _steps(tcfg).items():
        one = torch.from_numpy(p_store.copy())
        for p in range(P):
            for j in range(n_kinds):
                step(ct, one, _record(tcfg, [entries[p]], [j * P + p],
                                      [masks[p][j]]))
        np.testing.assert_array_equal(one.numpy(), want,
                                      err_msg=f"{name}, one page a record")
        batch = torch.from_numpy(p_store.copy())
        for j in range(n_kinds):
            step(ct, batch, _record(tcfg, entries,
                                    [j * P + p for p in range(P)],
                                    [masks[p][j] for p in range(P)]))
        np.testing.assert_array_equal(batch.numpy(), want,
                                      err_msg=f"{name}, {P} pages a record")
    assert qpack.fused_promote_launches == n0
    assert torch.equal(ct, torch.from_numpy(c_store))


def test_promote_step_empty_mask_and_record():
    """A record whose masks select nothing, and a record of no pages,
    leave the P-chunk rows as they were."""
    jcfg, tcfg = _configs(True, True)
    c_store, entries = _stored(jcfg, True, seed=1)
    p_store = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (len(entries), jcfg.page_bytes)).astype(np.uint8))
    before = p_store.clone()
    for step in _steps(tcfg).values():
        step(torch.from_numpy(c_store), p_store,
             _record(tcfg, entries, list(range(len(entries))),
                     [0] * len(entries)))
        step(torch.from_numpy(c_store), p_store,
             torch.zeros((0, 8 + 4 + 2), dtype=torch.int32))
    assert torch.equal(p_store, before)
