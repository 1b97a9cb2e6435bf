"""The compression engine's CUDA kernels, their plain PyTorch versions,
and the wrappers the compressor calls.

  * ``fused_encode``/``fused_decode`` (``csrc/qpack_fused.cu``) replace the
    JAX package's TPU kernels ``kernels/qpack.py::qpack_fused_encode_2d``
    and ``qpack_fused_decode_2d``: the pool's rate-adaptive demote/promote.
  * ``fused_demote`` is the pool's whole demotion step in one launch of the
    same encode kernel: the victims' pages read from the store, encoded,
    compacted into page streams, and their chunk counts and the record the
    host fetches.
  * ``encode``/``decode`` (``csrc/qpack_fixed.cu``) replace
    ``qpack_encode_2d`` and ``qpack_decode_2d`` with the shape contract of
    their wrappers ``kernels/ops.py::qpack_encode``/``qpack_decode``:
    fixed-rate 4/8-bit quantize and pack over blocks of any even size,
    any leading shape (the KV cache's compressed region).
  * ``ring_step`` is one decode step's hot-window update of a layer (the
    eviction of the token aging out of the ring into the compressed region
    with the encode's quantize, then the new token's insert) in one launch.

All are memory-bound single passes; the source notes in the ``.cu`` files
give the bound and the design.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. There is no
fallback from one to the other. ``*_launches`` count kernel launches (not
plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common.utils import f32_to_bytes
from repro_torch.core.bitpack import (RATE_4BIT, RATE_8BIT, RATE_RAW,
                                      RATE_ZERO, dequantize_block, pack4,
                                      pack8, quantize_block, unpack4, unpack8)
from repro_torch.kernels import build as _build

fused_encode_launches = 0
fused_decode_launches = 0
fused_demote_launches = 0
encode_launches = 0
decode_launches = 0
ring_step_launches = 0

QUANTUM = 128                   # bytes of a compaction quantum


# ---------------------------------------------------------------------------
# Plain versions: formula for formula the TPU kernel bodies
# (_fused_encode_kernel / _fused_decode_kernel).
# ---------------------------------------------------------------------------

def _quantize_rows(xf: torch.Tensor, bits: int):
    qmax = float(2 ** (bits - 1) - 1)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    c = torch.tensor(1.0 / qmax, dtype=torch.float32, device=xf.device)
    scale = torch.where(amax > 0, amax * c, torch.ones_like(amax))
    recip = torch.ones_like(scale) / scale
    q = torch.clamp(torch.round(xf * recip), -qmax - 1, qmax).to(torch.int32)
    return q, scale


def fused_encode_plain(x: torch.Tensor, *, tol4: float = 0.10,
                       tol8: float = 0.01, lossless: bool = False,
                       zero_elision: bool = True,
                       quanta: tuple = (0, 3, 5, 8)):
    """x [N, V] bf16/f32 -> (dense uint8[N, 2V], rates int32[N],
    quanta int32[N])."""
    xf = x.to(torch.float32)
    t, v = xf.shape
    amax = xf.abs().amax(dim=-1, keepdim=True)
    q4, s4 = _quantize_rows(xf, 4)
    q8, s8 = _quantize_rows(xf, 8)
    deq4 = (q4.to(torch.float32) * s4).to(torch.bfloat16)
    deq8 = (q8.to(torch.float32) * s8).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    if lossless:
        ok4 = (deq4 == xb).all(dim=-1, keepdim=True)
        ok8 = (deq8 == xb).all(dim=-1, keepdim=True)
    else:
        err4 = (deq4.to(torch.float32) - xf).abs().amax(dim=-1, keepdim=True)
        err8 = (deq8.to(torch.float32) - xf).abs().amax(dim=-1, keepdim=True)
        safe = torch.where(amax > 0, amax, torch.ones_like(amax))
        f32 = lambda tol: torch.tensor(tol, dtype=torch.float32, device=x.device)
        ok4 = err4 / safe <= f32(tol4)
        ok8 = err8 / safe <= f32(tol8)
    rate = torch.where(ok8, RATE_8BIT, RATE_RAW)
    rate = torch.where(ok4, RATE_4BIT, rate)
    rate = torch.where(amax == 0, RATE_ZERO, rate).to(torch.int32)
    if not zero_elision:
        rate = torch.clamp(rate, min=RATE_4BIT)
    qtab = torch.tensor(tuple(quanta), dtype=torch.int32, device=x.device)
    qnt = qtab[rate.long()]

    nb = 2 * v
    u4 = (q4 & 0xF).to(torch.uint8)
    p4 = u4[:, 0::2] | (u4[:, 1::2] << 4)
    c4 = torch.cat([f32_to_bytes(s4), p4,
                    torch.zeros((t, nb - 4 - v // 2), dtype=torch.uint8,
                                device=x.device)], dim=1)
    p8 = (q8 & 0xFF).to(torch.uint8)
    c8 = torch.cat([f32_to_bytes(s8), p8,
                    torch.zeros((t, nb - 4 - v), dtype=torch.uint8,
                                device=x.device)], dim=1)
    raw = xb.contiguous().view(torch.uint8).reshape(t, nb)   # little-endian
    dense = torch.where(rate == RATE_4BIT, c4, torch.zeros_like(c4))
    dense = torch.where(rate == RATE_8BIT, c8, dense)
    dense = torch.where(rate == RATE_RAW, raw, dense)
    return dense, rate[:, 0], qnt[:, 0]


def fused_decode_plain(dense: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """(dense uint8[N, 2V], rates int32[N]) -> bf16 [N, V]."""
    t, nb = dense.shape
    v = nb // 2
    rate = rates.reshape(t, 1)
    scale = dense[:, 0:4].contiguous().view(torch.float32)       # [T, 1]
    c4 = dense[:, 4:4 + v // 2]
    lo = (c4 & 0xF).to(torch.int8)
    hi = (c4 >> 4).to(torch.int8)
    qn = torch.stack([lo, hi], dim=-1).reshape(t, v)
    qn = torch.where(qn >= 8, qn - 16, qn)
    out4 = (qn.to(torch.float32) * scale).to(torch.bfloat16)
    q8 = dense[:, 4:4 + v].contiguous().view(torch.int8)
    out8 = (q8.to(torch.float32) * scale).to(torch.bfloat16)
    raw = dense.contiguous().view(torch.bfloat16)                # little-endian
    out = torch.where(rate == RATE_4BIT, out4, torch.zeros_like(out4))
    out = torch.where(rate == RATE_8BIT, out8, out)
    return torch.where(rate == RATE_RAW, raw, out)


def offsets(quanta: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-block quanta [P, B] (int64)."""
    q = quanta.to(torch.int64)
    return torch.cumsum(q, dim=-1) - q


def compact_pages_plain(dense: torch.Tensor, quanta: torch.Tensor,
                        page_bytes: int) -> torch.Tensor:
    """Dense per-block buffers [P, B, 2V] -> page streams uint8[P,
    page_bytes]: block i's bytes live at [start_i, start_i + quanta_i*128).
    A block's buffer is placed at its start clamped so it fits the page, as
    the reference's ``dynamic_update_slice`` does."""
    npages, nblocks, nb = dense.shape
    starts = offsets(quanta) * QUANTUM                          # [P, B]
    ends = starts + quanta.to(torch.int64) * QUANTUM
    placed = torch.clamp(starts, max=page_bytes - nb)
    pos = torch.arange(page_bytes, device=dense.device)
    live = (pos[None, None, :] >= starts[..., None]) & \
        (pos[None, None, :] < ends[..., None])                  # [P, B, page]
    rel = torch.clamp(pos[None, None, :] - placed[..., None], 0, nb - 1)
    vals = torch.gather(dense, 2, rel)
    inside = (pos[None, None, :] >= placed[..., None]) & \
        (pos[None, None, :] < placed[..., None] + nb)
    vals = torch.where(inside, vals, torch.zeros_like(vals))
    buf = torch.zeros((npages, page_bytes), dtype=torch.uint8,
                      device=dense.device)
    for i in range(nblocks):          # later blocks win, as in the reference
        buf = torch.where(live[:, i], vals[:, i], buf)
    return buf


def num_chunks(quanta: torch.Tensor, chunk_bytes: int) -> torch.Tensor:
    """Chunks a page of these block quanta [P, B] occupies: int32[P]."""
    qpc = chunk_bytes // QUANTUM
    return (-(-quanta.sum(dim=-1) // qpc)).to(torch.int32)


def fused_demote_plain(x: torch.Tensor, slots, *, blocks: int,
                       chunk_bytes: int, tol4: float = 0.10,
                       tol8: float = 0.01, lossless: bool = False,
                       zero_elision: bool = True, quanta: tuple = (0, 3, 5, 8),
                       encode=fused_encode_plain):
    """The pages x[slots] (all of x when ``slots`` is None), x [N,
    vals_per_page] bf16/f32, as ``fused_demote`` returns them: the encode
    of their blocks (``encode``, ``fused_encode_plain``; the kernel
    ``fused_encode`` gives the composition the demote kernel replaced),
    the compaction and the chunk counts."""
    rows = x if slots is None else x.index_select(0, slots)
    k, vals = rows.shape[0], rows.shape[1] // blocks
    dense, rates, qnt = encode(
        rows.reshape(k * blocks, vals), tol4=tol4, tol8=tol8,
        lossless=lossless, zero_elision=zero_elision, quanta=quanta)
    qnt = qnt.reshape(k, blocks)
    bufs = compact_pages_plain(dense.reshape(k, blocks, 2 * vals), qnt,
                               2 * rows.shape[1])
    nch = num_chunks(qnt, chunk_bytes)
    return (bufs, rates.reshape(k, blocks), qnt, nch,
            torch.cat([rates.reshape(-1), nch]))


# ---------------------------------------------------------------------------
# CUDA libraries (kernels/build.py: nvcc -> shared library, loaded by ctypes).
# ---------------------------------------------------------------------------

def _fused_lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load("qpack_fused", {
        "qpack_fused_encode": [P, I, P, P, P, I, I, F, F, I, I, I, I, I, I, P],
        "qpack_fused_demote": [P, I, P, P, P, P, P, I, I, I, I, F, F, I, I,
                               I, I, I, I, P],
        "qpack_fused_decode": [P, P, P, I, I, P]})


def _fixed_lib() -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.load("qpack_fixed", {
        "qpack_fixed_encode": [P, I, P, P, I, I, I, I, P],
        "qpack_fixed_decode": [P, P, P, I, I, I, I, I, P],
        "qpack_ring_step": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                            I, P]})


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a view at an odd offset is
    copied)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_shape(v: int) -> None:
    if v % 256 or not 256 <= v <= 2048:
        raise ValueError(f"block of {v} values: the kernels take V a "
                         "multiple of 256 in [256, 2048]")


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def fused_encode(x: torch.Tensor, *, tol4: float = 0.10, tol8: float = 0.01,
                 lossless: bool = False, zero_elision: bool = True,
                 quanta: tuple = (0, 3, 5, 8)):
    """Fused demote over blocks x [N, V] (bf16/f32): (dense uint8[N, 2V],
    rates int32[N], quanta int32[N])."""
    global fused_encode_launches
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be [N, V] bf16/f32, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_encode_plain(x, tol4=tol4, tol8=tol8, lossless=lossless,
                                  zero_elision=zero_elision, quanta=quanta)
    if x.device.type != "cuda":
        raise ValueError(f"no fused encode for device {x.device}")
    n, v = x.shape
    _check_shape(v)
    _check_cuda(x, "x")
    dense = torch.empty((n, 2 * v), dtype=torch.uint8, device=x.device)
    rates = torch.empty((n,), dtype=torch.int32, device=x.device)
    qnt = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return dense, rates, qnt
    q = tuple(int(a) for a in quanta)
    err = _fused_lib().qpack_fused_encode(
        x.data_ptr(), int(x.dtype == torch.float32), dense.data_ptr(),
        rates.data_ptr(), qnt.data_ptr(), n, v, tol4, tol8, int(lossless),
        int(zero_elision), q[0], q[1], q[2], q[3],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "qpack_fused_encode")
    fused_encode_launches += 1
    return dense, rates, qnt


def fused_demote(x: torch.Tensor, slots, *, blocks: int, chunk_bytes: int,
                 tol4: float = 0.10, tol8: float = 0.01,
                 lossless: bool = False, zero_elision: bool = True,
                 quanta: tuple = (0, 3, 5, 8)):
    """Demote the pages x[slots] (all of x when ``slots`` is None): x [N,
    vals_per_page] bf16/f32, each page ``blocks`` blocks; ``slots``
    int64[K] on x's device. Returns (bufs uint8[K, page_bytes] compacted
    page streams, rates int32[K, blocks], quanta int32[K, blocks], nchunks
    int32[K], record int32[K*blocks + K]: the rates, then nchunks). The
    record is the storage of rates and nchunks, so the host reads both in
    one fetch. One kernel launch for a CUDA tensor."""
    global fused_demote_launches
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be [N, vals_per_page] bf16/f32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    kw = dict(blocks=blocks, chunk_bytes=chunk_bytes, tol4=tol4, tol8=tol8,
              lossless=lossless, zero_elision=zero_elision, quanta=quanta)
    if x.device.type == "cpu":
        return fused_demote_plain(x, slots, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no fused demote for device {x.device}")
    if x.shape[1] % blocks or not 1 <= blocks <= 8:
        raise ValueError(f"{blocks} blocks do not split a page of "
                         f"{x.shape[1]} values (1 to 8 blocks)")
    v = x.shape[1] // blocks
    _check_shape(v)
    _check_cuda(x, "x")
    if chunk_bytes % QUANTUM or chunk_bytes < QUANTUM:
        raise ValueError(f"chunk_bytes={chunk_bytes}: a multiple of "
                         f"{QUANTUM}")
    if max(quanta) * QUANTUM > 2 * v:     # the kernel copies from the row
        raise ValueError(f"quanta {quanta} exceed a dense row of {2 * v} B")
    if slots is None:
        k, sp = x.shape[0], None
    else:
        if slots.dtype != torch.int64 or slots.dim() != 1 or \
                slots.device != x.device or not slots.is_contiguous():
            raise ValueError("slots must be contiguous int64[K] on x's device")
        k, sp = slots.shape[0], slots.data_ptr()
    page_bytes = 2 * x.shape[1]
    bufs = torch.empty((k, page_bytes), dtype=torch.uint8, device=x.device)
    record = torch.empty((k * blocks + k,), dtype=torch.int32,
                         device=x.device)
    qnt = torch.empty((k, blocks), dtype=torch.int32, device=x.device)
    rates, nch = record[:k * blocks].view(k, blocks), record[k * blocks:]
    if k == 0:
        return bufs, rates, qnt, nch, record
    q = tuple(int(a) for a in quanta)
    err = _fused_lib().qpack_fused_demote(
        x.data_ptr(), int(x.dtype == torch.float32), sp, bufs.data_ptr(),
        record.data_ptr(), qnt.data_ptr(), nch.data_ptr(), k, blocks, v,
        chunk_bytes // QUANTUM, tol4, tol8, int(lossless), int(zero_elision),
        q[0], q[1], q[2], q[3], torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "qpack_fused_demote")
    fused_demote_launches += 1
    return bufs, rates, qnt, nch, record


def fused_decode(dense: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Fused promote over dense blocks [N, 2V] + rates [N] -> bf16 [N, V]."""
    global fused_decode_launches
    if dense.dim() != 2 or dense.dtype != torch.uint8:
        raise ValueError("dense must be uint8 [N, 2V]")
    if dense.device.type == "cpu":
        return fused_decode_plain(dense, rates)
    if dense.device.type != "cuda":
        raise ValueError(f"no fused decode for device {dense.device}")
    n, nb = dense.shape
    v = nb // 2
    _check_shape(v)
    rates = rates.to(torch.int32).contiguous()
    if rates.shape != (n,) or rates.device != dense.device:
        raise ValueError("rates must be int32[N] on the same device")
    _check_cuda(dense, "dense")
    out = torch.empty((n, v), dtype=torch.bfloat16, device=dense.device)
    if n == 0:
        return out
    err = _fused_lib().qpack_fused_decode(
        dense.data_ptr(), rates.data_ptr(), out.data_ptr(), n, v,
        torch.cuda.current_stream(dense.device).cuda_stream)
    _build.check_launch(err, "qpack_fused_decode")
    fused_decode_launches += 1
    return out


# ---------------------------------------------------------------------------
# Fixed-rate quantize + pack (the KV cache's compressed region).
# ---------------------------------------------------------------------------

def _check_fixed(n: int, bits: int, block: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}: the fixed-rate kernels take 4 or 8")
    if block < 2 or block % 2 or n % block:
        raise ValueError(f"block={block} must be even and divide the last "
                         f"axis ({n})")


def encode_plain(x: torch.Tensor, bits: int, block: int):
    """x[..., N] (bf16/f32) -> (codes uint8[..., N*bits/8], scales
    f32[..., N/block]): formula for formula ``_encode_kernel``."""
    lead, n = x.shape[:-1], x.shape[-1]
    _check_fixed(n, bits, block)
    q, s = quantize_block(x.reshape(lead + (n // block, block)), bits)
    packed = pack4(q) if bits == 4 else pack8(q)
    return packed.reshape(lead + (n * bits // 8,)), s


def decode_plain(codes: torch.Tensor, scales: torch.Tensor, bits: int,
                 block: int, dtype=torch.bfloat16) -> torch.Tensor:
    """(codes uint8[..., nb*block*bits/8], scales f32[..., nb]) ->
    dtype[..., nb*block]: formula for formula ``_decode_kernel``."""
    lead, nb = scales.shape[:-1], scales.shape[-1]
    _check_fixed(nb * block, bits, block)
    if bits == 4:
        q = unpack4(codes.reshape(lead + (nb, block // 2)), block)
    else:
        q = unpack8(codes.reshape(lead + (nb, block)))
    return dequantize_block(q, scales, dtype).reshape(lead + (nb * block,))


def encode(x: torch.Tensor, bits: int, block: int):
    """Fixed-rate quantize + pack, ``encode_plain``'s contract: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    global encode_launches
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be bf16/f32, got {x.dtype}")
    if x.device.type == "cpu":
        return encode_plain(x, bits, block)
    if x.device.type != "cuda":
        raise ValueError(f"no fixed-rate encode for device {x.device}")
    lead, n = x.shape[:-1], x.shape[-1]
    _check_fixed(n, bits, block)
    x = _aligned(x)
    nblk = x.numel() // block
    codes = torch.empty(lead + (n * bits // 8,), dtype=torch.uint8,
                        device=x.device)
    scales = torch.empty(lead + (n // block,), dtype=torch.float32,
                         device=x.device)
    if nblk == 0:
        return codes, scales
    vec = int(block % 8 == 0)
    err = _fixed_lib().qpack_fixed_encode(
        x.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
        scales.data_ptr(), nblk, block, bits, vec,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch(err, "qpack_fixed_encode")
    encode_launches += 1
    return codes, scales


def decode(codes: torch.Tensor, scales: torch.Tensor, bits: int, block: int,
           dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``encode`` (``decode_plain``'s contract): the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors."""
    global decode_launches
    if codes.dtype != torch.uint8 or scales.dtype != torch.float32:
        raise ValueError("codes must be uint8 and scales float32")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"no fixed-rate decode to {dtype}")
    if codes.device.type == "cpu":
        return decode_plain(codes, scales, bits, block, dtype)
    if codes.device.type != "cuda" or scales.device != codes.device:
        raise ValueError(f"no fixed-rate decode for devices {codes.device}, "
                         f"{scales.device}")
    lead, nb = scales.shape[:-1], scales.shape[-1]
    _check_fixed(nb * block, bits, block)
    if codes.shape != lead + (nb * block * bits // 8,):
        raise ValueError(f"codes {tuple(codes.shape)} do not match scales "
                         f"{tuple(scales.shape)} at block {block}")
    codes, scales = _aligned(codes), scales.contiguous()
    out = torch.empty(lead + (nb * block,), dtype=dtype, device=codes.device)
    nblk = scales.numel()
    if nblk == 0:
        return out
    vec = int(block % 8 == 0)
    err = _fixed_lib().qpack_fixed_decode(
        codes.data_ptr(), scales.data_ptr(), out.data_ptr(),
        int(dtype == torch.float32), nblk, block, bits, vec,
        torch.cuda.current_stream(codes.device).cuda_stream)
    _build.check_launch(err, "qpack_fixed_decode")
    decode_launches += 1
    return out


# ---------------------------------------------------------------------------
# The decode step's ring step (the hot window's eviction and insert).
# ---------------------------------------------------------------------------

def _evict_plain(codes, scales, hot, pos, cold_len, bits: int,
                 quantize) -> None:
    """Compress the token aging out of the ring (position pos-W) into the
    compressed region, in place. Skipped when the slot holds no real token
    (pos < W, or a resumed lane whose older tokens are already compressed:
    pos-W < cold_len)."""
    B, W = hot.shape[:2]
    bsel = torch.arange(B, device=hot.device)
    evict_pos = pos - W
    do = evict_pos >= cold_len
    old = hot[bsel, (pos % W).long()].to(torch.float32)   # pre-overwrite
    c, s = quantize(old, bits, old.shape[-1])
    idx = torch.where(do, torch.clamp(evict_pos, min=0),
                      torch.zeros_like(evict_pos)).long()
    codes[bsel, idx] = torch.where(do[:, None, None], c, codes[bsel, idx])
    scales[bsel, idx] = torch.where(do[:, None], s[..., 0], scales[bsel, idx])


def _hot_insert_plain(hot: torch.Tensor, new: torch.Tensor,
                      pos: torch.Tensor) -> None:
    """hot [B,W,...] gets new [B,...] at slot pos%W, in place."""
    bsel = torch.arange(hot.shape[0], device=hot.device)
    hot[bsel, (pos % hot.shape[1]).long()] = new.to(hot.dtype)


def ring_step_plain(k_codes, k_scales, k_hot, v_codes, v_scales, v_hot,
                    k_new, v_new, pos, cold_len, bits: int, *,
                    quantize=encode_plain) -> None:
    """``ring_step``'s plain version: the eviction of K and of V, then the
    two inserts, as the reference's ``_evict_to_codes`` and
    ``_hot_insert`` do them. ``quantize`` is the block quantizer
    (``encode_plain``; the kernel ``encode`` gives the composition the ring
    step replaced)."""
    for codes, scales, hot in ((k_codes, k_scales, k_hot),
                               (v_codes, v_scales, v_hot)):
        _evict_plain(codes, scales, hot, pos, cold_len, bits, quantize)
    _hot_insert_plain(k_hot, k_new, pos)
    _hot_insert_plain(v_hot, v_new, pos)


def ring_step(k_codes, k_scales, k_hot, v_codes, v_scales, v_hot, k_new,
              v_new, pos, cold_len, bits: int) -> None:
    """One decode step's hot-window update of one layer, in place: for each
    lane b, the ring slot pos[b] % W is quantized into codes/scales at
    position pos[b] - W when pos[b] - W >= cold_len[b], then k_new/v_new
    [B, Hkv, D] take the slot. codes [B, S, Hkv, D*bits/8] uint8, scales
    [B, S, Hkv] f32, hot [B, W, Hkv, D] bf16/f32, pos and cold_len [B].
    One kernel launch for CUDA tensors, no host sync; the plain version
    for CPU tensors."""
    global ring_step_launches
    if k_hot.device.type == "cpu":
        return ring_step_plain(k_codes, k_scales, k_hot, v_codes, v_scales,
                               v_hot, k_new, v_new, pos, cold_len, bits)
    if k_hot.device.type != "cuda":
        raise ValueError(f"no ring step for device {k_hot.device}")
    B, W, H, D = k_hot.shape
    S = k_codes.shape[1]
    if bits not in (4, 8) or D % 8:
        raise ValueError(f"bits={bits}, D={D}: the ring step takes 4 or 8 "
                         "bits and D a multiple of 8")
    ftypes = (torch.bfloat16, torch.float32)
    for t, shape, dtypes, name in (
            (k_codes, (B, S, H, D * bits // 8), (torch.uint8,), "codes"),
            (v_codes, (B, S, H, D * bits // 8), (torch.uint8,), "codes"),
            (k_scales, (B, S, H), (torch.float32,), "scales"),
            (v_scales, (B, S, H), (torch.float32,), "scales"),
            (k_hot, (B, W, H, D), ftypes, "hot"),
            (v_hot, (B, W, H, D), (k_hot.dtype,), "hot"),
            (k_new, (B, H, D), ftypes, "new"),
            (v_new, (B, H, D), (k_new.dtype,), "new")):
        if tuple(t.shape) != shape or t.dtype not in dtypes or \
                t.device != k_hot.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: the ring step takes {shape} of "
                             f"{dtypes} on {k_hot.device}")
        if name != "new":               # updated in place
            _check_cuda(t, name)
    k_new, v_new = _aligned(k_new), _aligned(v_new)
    pos, cold_len = (t.to(torch.int32).contiguous() for t in (pos, cold_len))
    if pos.shape != (B,) or cold_len.shape != (B,):
        raise ValueError("pos and cold_len must be [B]")
    err = _fixed_lib().qpack_ring_step(
        k_codes.data_ptr(), k_scales.data_ptr(), k_hot.data_ptr(),
        v_codes.data_ptr(), v_scales.data_ptr(), v_hot.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), pos.data_ptr(),
        cold_len.data_ptr(), int(k_hot.dtype == torch.float32),
        int(k_new.dtype == torch.float32), B, S, W, H, D, bits,
        torch.cuda.current_stream(k_hot.device).cuda_stream)
    _build.check_launch(err, "qpack_ring_step")
    ring_step_launches += 1
