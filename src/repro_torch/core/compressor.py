"""Rate-adaptive block compressor producing IBEX's chunked layout (PyTorch
port of ``repro.core.compressor``).

A 4KB page = 4 x 1KB blocks (co-location, §4.6), each encoded at one of four
rates (zero / 4-bit / 8-bit / raw) and compacted at 128B quanta; the page's
quanta total sets ``num_chunks`` (512B C-chunks). 4KB-block mode treats the
page as one 2048-value block.

Two implementations of one format: the plain oracle here
(``compress_impl="jnp"``) and the fused kernels (``"kernel"``,
kernels/qpack.py: a demotion is one launch of the demote-and-compact
kernel, a promotion one launch of the promote kernel), byte-identical to
each other.

The flat fixed-rate quantization of the KV cache (``quantize_blocks`` and
its kin, at the end) is a second format with the same two
implementations, switched by ``ServeConfig.quantize_impl``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.common.types import PoolConfig
from repro_torch.common.utils import f32_to_bytes
from repro_torch.core.bitpack import (RATE_4BIT, RATE_8BIT, RATE_RAW,
                                      RATE_ZERO, dequantize_block, pack4,
                                      pack8, quantize_block, unpack4, unpack8)
from repro_torch.kernels import qpack

QUANTUM = qpack.QUANTUM


def resolve_impl(cfg: PoolConfig, device: torch.device) -> str:
    """``cfg.compress_impl`` for tensors on ``device``: "auto" is the CUDA
    kernel for CUDA tensors and the plain version for CPU tensors; "kernel"
    on a CPU tensor raises."""
    impl = cfg.compress_impl
    if impl == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "jnp"
    if impl == "kernel" and torch.device(device).type != "cuda":
        raise ValueError("compress_impl='kernel' needs CUDA tensors")
    if impl not in ("kernel", "jnp"):
        raise ValueError(f"compress_impl={impl!r}")
    return impl


def quanta_per_rate(vals_per_block: int) -> Tuple[int, int, int, int]:
    """Quanta per rate code for a ``vals_per_block`` block."""
    b4 = -(-(4 + vals_per_block // 2) // QUANTUM)
    b8 = -(-(4 + vals_per_block) // QUANTUM)
    braw = (2 * vals_per_block) // QUANTUM
    return (0, b4, b8, braw)


def select_rate(x: torch.Tensor, cfg: PoolConfig) -> torch.Tensor:
    """Cheapest admissible rate for blocks ``x[..., vals]`` (int32)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    q4, s4 = quantize_block(x, 4)
    q8, s8 = quantize_block(x, 8)
    if cfg.lossless:
        xb = x.to(torch.bfloat16)
        ok4 = (dequantize_block(q4, s4) == xb).all(dim=-1)
        ok8 = (dequantize_block(q8, s8) == xb).all(dim=-1)
    else:
        err4 = (dequantize_block(q4, s4).to(torch.float32) - xf).abs().amax(dim=-1)
        err8 = (dequantize_block(q8, s8).to(torch.float32) - xf).abs().amax(dim=-1)
        safe = torch.where(amax > 0, amax, torch.ones_like(amax))
        f32 = lambda tol: torch.tensor(tol, dtype=torch.float32, device=x.device)
        ok4 = err4 / safe <= f32(cfg.tol4)
        ok8 = err8 / safe <= f32(cfg.tol8)
    rate = torch.where(ok8, RATE_8BIT, RATE_RAW)
    rate = torch.where(ok4, RATE_4BIT, rate)
    rate = torch.where(amax == 0, RATE_ZERO, rate)
    return rate.to(torch.int32)


def _encode_block_dense(x: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Blocks x [N, V] at ``rate`` [N] -> dense worst-case buffers
    uint8[N, 2V]; only the first ``quanta*128`` bytes of a row matter."""
    n, vals = x.shape
    zeros = torch.zeros((n, 2 * vals), dtype=torch.uint8, device=x.device)
    q4, s4 = quantize_block(x, 4)
    q8, s8 = quantize_block(x, 8)
    enc4 = zeros.clone()
    enc4[:, :4] = f32_to_bytes(s4[:, None])
    enc4[:, 4:4 + vals // 2] = pack4(q4)
    enc8 = zeros.clone()
    enc8[:, :4] = f32_to_bytes(s8[:, None])
    enc8[:, 4:4 + vals] = pack8(q8)
    raw = x.to(torch.bfloat16).contiguous().view(torch.uint8)
    r = rate[:, None]
    out = torch.where(r == RATE_4BIT, enc4, zeros)
    out = torch.where(r == RATE_8BIT, enc8, out)
    return torch.where(r == RATE_RAW, raw, out)


def _decode_block_dense(buf: torch.Tensor, rate: torch.Tensor,
                        vals: int) -> torch.Tensor:
    """Inverse of ``_encode_block_dense``: buf [N, 2V], rate [N] -> bf16."""
    scale = buf[:, 0:4].contiguous().view(torch.float32)[:, 0]
    dec4 = dequantize_block(unpack4(buf[:, 4:4 + vals // 2], vals), scale)
    dec8 = dequantize_block(unpack8(buf[:, 4:4 + vals]), scale)
    raw = buf[:, :2 * vals].contiguous().view(torch.bfloat16)
    r = rate[:, None]
    out = torch.where(r == RATE_4BIT, dec4, torch.zeros_like(dec4))
    out = torch.where(r == RATE_8BIT, dec8, out)
    return torch.where(r == RATE_RAW, raw, out)


def _encode_blocks(blocks: torch.Tensor, *, cfg: PoolConfig, quanta: tuple,
                   **_):
    """The oracle's rate pick and dense encode with ``fused_encode``'s
    contract: (dense uint8[N, 2V], rates int32[N], quanta int32[N])."""
    rates = select_rate(blocks, cfg)
    if not cfg.zero_elision:
        rates = torch.clamp(rates, min=RATE_4BIT)
    qt = torch.tensor(quanta, dtype=torch.int32, device=blocks.device)
    return _encode_block_dense(blocks, rates), rates, qt[rates.long()]


def demote_pages(x: torch.Tensor, slots, cfg: PoolConfig):
    """The pages x[slots] (all of x when ``slots`` is None; x [N,
    vals_per_page] bf16, e.g. the promoted store read as bf16) -> (bufs
    uint8[K, page_bytes], rates int32[K, B], quanta int32[K, B],
    num_chunks int32[K], record int32[K*B + K]: the rates, then num_chunks,
    what the host fetches in one read). The kernel path is one launch of
    the demote kernel (gather, encode, compaction and chunk counts); the
    plain path is that kernel's plain composition with the oracle's rate
    pick and dense encode."""
    nblocks = cfg.blocks_per_page if cfg.coloc else 1
    kw = dict(blocks=nblocks, chunk_bytes=cfg.chunk_bytes, tol4=cfg.tol4,
              tol8=cfg.tol8, lossless=cfg.lossless,
              zero_elision=cfg.zero_elision,
              quanta=quanta_per_rate(x.shape[-1] // nblocks))
    if resolve_impl(cfg, x.device) == "kernel":
        return qpack.fused_demote(x, slots, **kw)
    return qpack.fused_demote_plain(
        x, slots, encode=functools.partial(_encode_blocks, cfg=cfg), **kw)


def encode_pages(xs: torch.Tensor, cfg: PoolConfig):
    """Pages xs [P, vals_per_page] -> (bufs uint8[P, page_bytes], rates
    int32[P, B], quanta int32[P, B], num_chunks int32[P]). On the kernel
    path all P pages go through one demote launch."""
    return demote_pages(xs, None, cfg)[:4]


def encode_page(x: torch.Tensor, cfg: PoolConfig):
    """One page of ``vals_per_page`` values: (buf, rates, quanta, num_chunks)."""
    bufs, rates, quanta, nch = encode_pages(x[None], cfg)
    return bufs[0], rates[0], quanta[0], nch[0]


def _page_dense_blocks(bufs: torch.Tensor, rates: torch.Tensor,
                       vals: int) -> torch.Tensor:
    """Slice compacted page streams [P, page_bytes] back into dense
    per-block buffers [P, B, 2V] (slice starts clamped to fit)."""
    npages, nblocks = rates.shape
    return qpack.dense_rows_plain(bufs, rates, vals, quanta_per_rate(vals)) \
        .reshape(npages, nblocks, 2 * vals)


def decode_pages(bufs: torch.Tensor, rates: torch.Tensor,
                 cfg: PoolConfig) -> torch.Tensor:
    """(bufs [P, page_bytes], rates [P, B]) -> bf16 [P, vals_per_page].
    Kernel path: one fused-decode launch over all P*B blocks."""
    npages, nblocks = rates.shape
    vals = cfg.vals_per_page // nblocks
    dense = _page_dense_blocks(bufs, rates, vals) \
        .reshape(npages * nblocks, 2 * vals)
    flat = rates.reshape(npages * nblocks).to(torch.int32)
    if resolve_impl(cfg, bufs.device) == "kernel":
        out = qpack.fused_decode(dense, flat)
    else:
        out = _decode_block_dense(dense, flat, vals)
    return out.reshape(npages, nblocks * vals)


def decode_page(buf: torch.Tensor, rates: torch.Tensor,
                cfg: PoolConfig) -> torch.Tensor:
    return decode_pages(buf[None], rates[None], cfg)[0]


def promote_pages(c_store: torch.Tensor, p_store: torch.Tensor,
                  record: torch.Tensor, cfg: PoolConfig) -> None:
    """The pool's promotion step, in place on ``p_store``: ``record``
    int32[K, chunks_per_page + B + 2] holds, per page, its chunk ids, its
    block rates, its P-chunk slot and its mask over the page's
    ``block_bytes`` ranges. The kernel path is one launch of the promote
    kernel (chunk gather, dense slicing, decode, masked store); the plain
    path is that kernel's plain composition with the oracle's decode."""
    nblocks = cfg.blocks_per_page if cfg.coloc else 1
    vals = cfg.vals_per_page // nblocks
    kw = dict(blocks=nblocks, chunk_bytes=cfg.chunk_bytes,
              range_bytes=cfg.block_bytes, quanta=quanta_per_rate(vals))
    if resolve_impl(cfg, c_store.device) == "kernel":
        return qpack.fused_promote(c_store, p_store, record, **kw)
    return qpack.fused_promote_plain(
        c_store, p_store, record,
        decode=lambda dense, rates: _decode_block_dense(dense, rates, vals),
        **kw)


def page_compressed_bytes(rates, vals_per_block: int) -> int:
    """Bytes a page with these block rates (host ints) occupies."""
    table = quanta_per_rate(vals_per_block)
    return sum(table[r] for r in rates) * QUANTUM


# ---------------------------------------------------------------------------
# Flat fixed-rate tensor quantization (the KV cache's compressed region).
# ---------------------------------------------------------------------------

def resolve_quantize_impl(impl: str, device) -> str:
    """``ServeConfig.quantize_impl`` for tensors on ``device``: "auto" is
    the CUDA kernel for CUDA tensors and the plain version for CPU tensors;
    "kernel" on a CPU tensor raises; "jnp" (the reference's name) is the
    plain version everywhere."""
    if impl == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "jnp"
    if impl == "kernel" and torch.device(device).type != "cuda":
        raise ValueError("quantize_impl='kernel' needs CUDA tensors")
    if impl not in ("kernel", "jnp"):
        raise ValueError(f"quantize_impl={impl!r}")
    return impl


def quantize_blocks(x: torch.Tensor, bits: int, block: int):
    """x[..., N] -> (packed codes uint8[..., N*bits/8], scales
    f32[..., N/block]); the plain version."""
    return qpack.encode_plain(x, bits, block)


def dequantize_blocks(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                      block: int, dtype=torch.bfloat16,
                      impl: str = "auto") -> torch.Tensor:
    """Inverse of ``quantize_blocks``, routed by ``impl`` as
    ``quantize_blocks_fast`` is: "auto" launches the CUDA decode kernel for
    CUDA tensors (the reference has only its jnp path here)."""
    if resolve_quantize_impl(impl, codes.device) == "kernel":
        return qpack.decode(codes, scales, bits, block, dtype)
    return qpack.decode_plain(codes, scales, bits, block, dtype)


def quantize_blocks_fast(x: torch.Tensor, bits: int, block: int,
                         impl: str = "auto"):
    """``quantize_blocks`` with the reference's impl switch: "kernel" is
    the CUDA kernel (bit-identical to the plain version), "jnp" the plain
    version, "auto" the kernel for CUDA tensors."""
    if resolve_quantize_impl(impl, x.device) == "kernel":
        return qpack.encode(x, bits, block)
    return qpack.encode_plain(x, bits, block)
