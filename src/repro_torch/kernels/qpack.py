"""The compression engine's CUDA kernels, their plain PyTorch versions,
and the wrappers the compressor calls.

  * ``fused_encode``/``fused_decode`` (``csrc/qpack_fused.cu``) replace the
    JAX package's TPU kernels ``kernels/qpack.py::qpack_fused_encode_2d``
    and ``qpack_fused_decode_2d``: the pool's rate-adaptive demote/promote.
  * ``fused_demote`` is the pool's whole demotion step in one launch of the
    same encode kernel: the victims' pages read from the store, encoded,
    compacted into page streams, and their chunk counts and the record the
    host fetches.
  * ``fused_promote`` is the pool's whole promotion step in one launch,
    with B2's decode body: each page's compacted stream read from the
    C-chunk store through its chunk ids, its blocks decoded, and the bf16
    bytes written into its P-chunk row in the ranges a mask selects.
  * ``encode``/``decode`` (``csrc/qpack_fixed.cu``) replace
    ``qpack_encode_2d`` and ``qpack_decode_2d`` with the shape contract of
    their wrappers ``kernels/ops.py::qpack_encode``/``qpack_decode``:
    fixed-rate 4/8-bit quantize and pack over blocks of any even size,
    any leading shape (the KV cache's compressed region).
  * ``ring_step`` is one decode step's hot-window update of a layer (the
    eviction of the token aging out of the ring into the compressed region
    with the encode's quantize, then the new token's insert) in one launch.
  * ``prefill_fill`` is a prefill layer's cache fill (K and V quantized into
    the codes region, the ring copied) and ``lane_flush`` a lane demotion's
    device half (the live ring tokens of every layer quantized into the
    lane's codes), each one launch with the same quantize.
  * ``latent_ring_step``, ``latent_prefill_fill`` and ``latent_lane_flush``
    are the same three steps on MLA's latent cache (one stream of rows of
    kv_lora_rank + rope values, no head axis): the same kernels launched
    with one stream instead of K and V.

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
fused_promote_launches = 0
prefill_fill_launches = 0
lane_flush_launches = 0
# MLA's latent stream through the same three kernels (one stream a launch)
latent_ring_step_launches = 0
latent_prefill_fill_launches = 0
latent_lane_flush_launches = 0

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


def dense_rows_plain(bufs: torch.Tensor, rates: torch.Tensor, vals: int,
                     quanta: tuple) -> torch.Tensor:
    """Slice compacted page streams [P, page_bytes] back into dense
    per-block rows [P*B, 2V]: block i at 128 * sum(quanta[rates[:i]]),
    clamped to fit (the reference's ``dynamic_slice``)."""
    page_bytes = bufs.shape[-1]
    qt = torch.tensor(tuple(quanta), dtype=torch.int64, device=bufs.device)
    starts = torch.clamp(offsets(qt[rates.long()]) * QUANTUM,
                         max=page_bytes - 2 * vals)             # [P, B]
    idx = starts[..., None] + torch.arange(2 * vals, device=bufs.device)
    npages, nblocks = rates.shape
    return torch.gather(bufs, 1, idx.reshape(npages, nblocks * 2 * vals)) \
        .reshape(npages * nblocks, 2 * vals)


def fused_promote_plain(c_store: torch.Tensor, p_store: torch.Tensor,
                        record: torch.Tensor, *, blocks: int,
                        chunk_bytes: int, range_bytes: int,
                        quanta: tuple = (0, 3, 5, 8),
                        decode=fused_decode_plain) -> None:
    """``fused_promote``'s plain version, in place on ``p_store``: for each
    page k of ``record`` int32[K, cpp + blocks + 2] (its cpp chunk ids, its
    block rates, its P-chunk slot, its range mask), the page stream is
    gathered from ``c_store`` rows, sliced into dense rows, decoded
    (``decode``: ``fused_decode_plain``, or the kernel ``fused_decode``
    for the composition the step replaced) and written into
    ``p_store[slot]`` where bit r of the mask selects bytes [r *
    range_bytes, (r + 1) * range_bytes)."""
    k = record.shape[0]
    cpp = record.shape[1] - blocks - 2
    page_bytes = cpp * chunk_bytes
    vals = page_bytes // (2 * blocks)
    bufs = c_store.index_select(0, record[:, :cpp].reshape(-1).long()) \
        .reshape(k, page_bytes)
    rates = record[:, cpp:cpp + blocks]
    page = decode(dense_rows_plain(bufs, rates, vals, quanta),
                  rates.reshape(-1)).reshape(k, blocks * vals).contiguous() \
        .view(torch.uint8)
    ranges = torch.arange(page_bytes // range_bytes, dtype=torch.int32,
                          device=record.device)
    sel = ((record[:, cpp + blocks + 1:] >> ranges) & 1).bool() \
        .repeat_interleave(range_bytes, dim=1)
    slots = record[:, cpp + blocks].long()
    p_store[slots] = torch.where(sel, page, p_store[slots])


# ---------------------------------------------------------------------------
# CUDA libraries (kernels/build.py: nvcc -> shared library, loaded by ctypes).
# ---------------------------------------------------------------------------

def _fused_lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load("qpack_fused", {
        "qpack_fused_encode": [P, I, P, P, P, I, I, F, F, I, I, I, I, I, I, P],
        "qpack_fused_demote": [P, I, P, P, P, P, P, I, I, I, I, F, F, I, I,
                               I, I, I, I, P],
        "qpack_fused_decode": [P, P, P, I, I, P],
        "qpack_fused_promote": [P, P, P, I, I, I, I, I, I, I, I, I, I, P]})


def _fixed_lib() -> ctypes.CDLL:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load("qpack_fixed", {
        "qpack_fixed_encode": [P, I, P, P, I, I, I, I, P],
        "qpack_fixed_decode": [P, P, P, I, I, I, I, I, P],
        "qpack_ring_step": [P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                            I, I, P],
        "qpack_prefill_fill": [P, P, I, P, P, P, P, P, P, P, I, I, I, I, I, I,
                               I, I, P],
        "qpack_lane_flush": [P, P, P, P, P, P, P, P, L, L, L, L, I, I, I, I,
                             I, I, I, I, P]})


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


def _check_rows(t: torch.Tensor, name: str, shape: tuple, dtypes: tuple,
                device, align: int, lead: int = 0) -> None:
    """``t`` of ``shape`` and one of ``dtypes`` on ``device``, contiguous
    after its first ``lead`` dimensions, its start and those dimensions'
    strides multiples of ``align`` bytes."""
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes or \
            t.device != device:
        raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device}: "
                         f"expected {tuple(shape)} of {dtypes} on {device}")
    inner = 1
    for d in range(t.dim() - 1, lead - 1, -1):
        if t.shape[d] > 1 and t.stride(d) != inner:
            raise ValueError(f"{name} must be contiguous after dim {lead}")
        inner *= t.shape[d]
    if t.data_ptr() % align or any(
            t.stride(d) * t.element_size() % align for d in range(lead)):
        raise ValueError(f"{name} must be {align}-byte aligned")


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


def fused_promote(c_store: torch.Tensor, p_store: torch.Tensor,
                  record: torch.Tensor, *, blocks: int, chunk_bytes: int,
                  range_bytes: int, quanta: tuple = (0, 3, 5, 8)) -> None:
    """Promote K pages in place: ``record`` int32[K, cpp + blocks + 2] on
    the stores' device holds, per page, its cpp = page_bytes / chunk_bytes
    chunk ids (rows of ``c_store`` uint8[N, chunk_bytes]), its ``blocks``
    rates, its P-chunk slot (a row of ``p_store`` uint8[M, page_bytes];
    the K slots differ) and its mask over the page's ``range_bytes``
    ranges (at most 31). Each page's blocks are decoded to bf16 and the
    selected ranges of its row written. One kernel launch for CUDA
    tensors; the plain version for CPU tensors."""
    global fused_promote_launches
    kw = dict(blocks=blocks, chunk_bytes=chunk_bytes,
              range_bytes=range_bytes, quanta=quanta)
    if c_store.device.type == "cpu":
        return fused_promote_plain(c_store, p_store, record, **kw)
    if c_store.device.type != "cuda":
        raise ValueError(f"no fused promote for device {c_store.device}")
    page_bytes = p_store.shape[-1]
    for t, name in ((c_store, "c_store"), (p_store, "p_store")):
        if t.dim() != 2 or t.dtype != torch.uint8 or t.device != c_store.device:
            raise ValueError(f"{name} must be uint8[rows, bytes] on "
                             f"{c_store.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        _check_cuda(t, name)
    if not 1 <= blocks <= 8 or page_bytes % (2 * blocks):
        raise ValueError(f"{blocks} blocks do not split a page of "
                         f"{page_bytes} B (1 to 8 blocks)")
    v = page_bytes // (2 * blocks)
    _check_shape(v)
    if c_store.shape[1] != chunk_bytes or chunk_bytes % 16 or \
            page_bytes % chunk_bytes:
        raise ValueError(f"chunks of {chunk_bytes} B (c_store rows of "
                         f"{c_store.shape[1]}) do not split a page of "
                         f"{page_bytes} B in multiples of 16")
    if range_bytes % 16 or page_bytes % range_bytes or \
            page_bytes // range_bytes > 31:
        raise ValueError(f"ranges of {range_bytes} B: multiples of 16 that "
                         f"split a page of {page_bytes} B in at most 31")
    if max(quanta) * QUANTUM > 2 * v:     # a block's bytes in its dense row
        raise ValueError(f"quanta {quanta} exceed a dense row of {2 * v} B")
    cpp = page_bytes // chunk_bytes
    if record.dtype != torch.int32 or record.dim() != 2 or \
            record.shape[1] != cpp + blocks + 2 or \
            record.device != c_store.device or not record.is_contiguous():
        raise ValueError(f"record must be contiguous int32[K, {cpp + blocks + 2}]"
                         f" on {c_store.device}, got {record.dtype} "
                         f"{tuple(record.shape)} on {record.device}")
    if record.shape[0] == 0:
        return None
    q = tuple(int(a) for a in quanta)
    err = _fused_lib().qpack_fused_promote(
        c_store.data_ptr(), p_store.data_ptr(), record.data_ptr(),
        record.shape[0], cpp, blocks, v, chunk_bytes, range_bytes, q[0], q[1],
        q[2], q[3], torch.cuda.current_stream(c_store.device).cuda_stream)
    _build.check_launch(err, "qpack_fused_promote")
    fused_promote_launches += 1
    return None


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


def latent_ring_step_plain(codes, scales, hot, new, pos, cold_len,
                           bits: int, *, quantize=encode_plain) -> None:
    """``latent_ring_step``'s plain version: the reference's
    ``_evict_latent`` and ``_hot_insert`` on the single latent stream (the
    GQA step's eviction with a head axis of 1)."""
    _evict_plain(codes[:, :, None], scales[:, :, None], hot[:, :, None], pos,
                 cold_len, bits, quantize)
    _hot_insert_plain(hot, new, pos)


def _ring_step_launch(k, v, pos, cold_len, bits: int) -> None:
    """One ring-step launch over the streams k and, unless None, v: each
    (codes [B,S,H,D*bits/8], scales [B,S,H], hot [B,W,H,D], new [B,H,D])."""
    k_codes, k_scales, k_hot, k_new = k
    B, W, H, D = k_hot.shape
    S = k_codes.shape[1]
    if bits not in (4, 8) or D % 8:
        raise ValueError(f"bits={bits}, D={D}: the ring step takes 4 or 8 "
                         "bits and D a multiple of 8")
    streams = [(k_codes, k_scales, k_hot, _aligned(k_new))]
    if v is not None:
        streams.append((*v[:3], _aligned(v[3])))
    hot_t, new_t = k_hot.dtype, streams[0][3].dtype
    if hot_t not in (torch.bfloat16, torch.float32) or \
            new_t not in (torch.bfloat16, torch.float32):
        raise ValueError(f"hot {hot_t}, new {new_t}: the ring step takes "
                         "bf16 or f32")
    for codes, scales, hot, new in streams:
        for t, shape, dtype, name in (
                (codes, (B, S, H, D * bits // 8), torch.uint8, "codes"),
                (scales, (B, S, H), torch.float32, "scales"),
                (hot, (B, W, H, D), hot_t, "hot"),
                (new, (B, H, D), new_t, "new")):
            _check_rows(t, name, shape, (dtype,), k_hot.device, 16)
    pos, cold_len = (t.to(torch.int32).contiguous() for t in (pos, cold_len))
    if pos.shape != (B,) or cold_len.shape != (B,):
        raise ValueError("pos and cold_len must be [B]")
    ptrs = [t.data_ptr() for t in streams[0]]
    vptrs = [t.data_ptr() for t in streams[1]] if v is not None else [None] * 4
    err = _fixed_lib().qpack_ring_step(
        ptrs[0], ptrs[1], ptrs[2], vptrs[0], vptrs[1], vptrs[2], ptrs[3],
        vptrs[3], pos.data_ptr(), cold_len.data_ptr(),
        int(hot_t == torch.float32), int(new_t == torch.float32), B, S, W,
        H, D, bits,
        len(streams), torch.cuda.current_stream(k_hot.device).cuda_stream)
    _build.check_launch(err, "qpack_ring_step")


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
    _ring_step_launch((k_codes, k_scales, k_hot, k_new),
                      (v_codes, v_scales, v_hot, v_new), pos, cold_len, bits)
    ring_step_launches += 1


def latent_ring_step(codes, scales, hot, new, pos, cold_len,
                     bits: int) -> None:
    """``ring_step`` on MLA's single latent stream (the key and the value
    of every head), in place: codes [B, S, R*bits/8] uint8, scales [B, S]
    f32, hot [B, W, R] bf16/f32, new [B, R], pos and cold_len [B]. One
    launch of the ring-step kernel with one stream for CUDA tensors; the
    plain version for CPU tensors."""
    global latent_ring_step_launches
    if hot.device.type == "cpu":
        return latent_ring_step_plain(codes, scales, hot, new, pos, cold_len,
                                      bits)
    if hot.device.type != "cuda":
        raise ValueError(f"no ring step for device {hot.device}")
    _ring_step_launch((codes[:, :, None], scales[:, :, None],
                       hot[:, :, None], new[:, None]), None, pos, cold_len,
                      bits)
    latent_ring_step_launches += 1


# ---------------------------------------------------------------------------
# The prefill's cache fill and the lane demotion's flush.
# ---------------------------------------------------------------------------

def ring_sources(lens: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """int64[B, W]: the prompt position each ring slot takes after a
    prefill of ``lens`` [B] real tokens (padded to S): the largest p <=
    lens - 1 with p = slot (mod W), clamped to [0, S - 1] (p < 0 is no
    real token; decode's ring test masks it out)."""
    last = (lens - 1)[:, None]
    slots = last - ((last - torch.arange(W, device=lens.device)[None, :]) % W)
    return torch.clamp(slots, 0, S - 1).long()


def fill_plain(t, codes, scales, hot, where, bits: int,
               quantize=encode_plain) -> None:
    """One of K or V of a prefill layer, in place, as the reference's
    ``fill_gqa`` computes it: t [B, S, H, D] quantized (``quantize``) into
    codes/scales [:, :S], and ``hot`` = t[where] in bf16, ``where`` = (row
    indices [B, 1], ``ring_sources``)."""
    S, D = t.shape[1], t.shape[-1]
    c, s = quantize(t, bits, D)
    codes[:, :S] = c
    scales[:, :S] = s[..., 0]
    hot.copy_(t[where].to(torch.bfloat16))


def prefill_fill_plain(k, v, k_codes, k_scales, k_hot, v_codes, v_scales,
                       v_hot, lens, bits: int, *, quantize=encode_plain
                       ) -> None:
    """``prefill_fill``'s plain version: ``fill_plain`` for K, then V."""
    B, S = k.shape[:2]
    where = (torch.arange(B, device=k.device)[:, None],
             ring_sources(lens, S, k_hot.shape[1]))
    for t, codes, scales, hot in ((k, k_codes, k_scales, k_hot),
                                  (v, v_codes, v_scales, v_hot)):
        fill_plain(t, codes, scales, hot, where, bits, quantize)


def latent_prefill_fill_plain(lat, codes, scales, hot, lens, bits: int, *,
                      quantize=encode_plain) -> None:
    """``latent_prefill_fill``'s plain version: the reference MLA prefill's
    latent quantize and ring gather (``fill_plain`` on the one stream)."""
    B, S = lat.shape[:2]
    where = (torch.arange(B, device=lat.device)[:, None],
             ring_sources(lens, S, hot.shape[1]))
    fill_plain(lat, codes, scales, hot, where, bits, quantize)


def _fill_launch(k, v, lens, bits: int) -> None:
    """One prefill-fill launch over the streams k and, unless None, v: each
    (t [B,S,H,D], codes [B,L,H,D*bits/8], scales [B,L,H], hot [B,W,H,D])."""
    t0 = k[0]
    B, S, H, D = t0.shape
    L, W = k[1].shape[1], k[3].shape[1]
    if bits not in (4, 8) or D % 8 or S > L:
        raise ValueError(f"bits={bits}, D={D}, S={S}, L={L}: the prefill "
                         "fill takes 4 or 8 bits, D a multiple of 8, S <= L")
    dev, x_t = t0.device, t0.dtype
    if x_t not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{x_t}: the prefill fill takes bf16 or f32")
    streams = [(_aligned(k[0]), *k[1:])]
    if v is not None:
        streams.append((_aligned(v[0]), *v[1:]))
    for t, codes, scales, hot in streams:
        for x, shape, dtype, name, align in (
                (t, (B, S, H, D), x_t, "k/v", 16),
                (codes, (B, L, H, D * bits // 8), torch.uint8, "codes", bits),
                (scales, (B, L, H), torch.float32, "scales", 4),
                (hot, (B, W, H, D), torch.bfloat16, "hot", 16)):
            _check_rows(x, name, shape, (dtype,), dev, align)
    _check_rows(lens, "lens", (B,), (torch.int32,), dev, 4)
    kp = [x.data_ptr() for x in streams[0]]
    vp = [x.data_ptr() for x in streams[1]] if v is not None else [None] * 4
    err = _fixed_lib().qpack_prefill_fill(
        kp[0], vp[0], int(x_t == torch.float32), kp[1],
        kp[2], kp[3], vp[1], vp[2], vp[3], lens.data_ptr(), B, S, L, W, H, D,
        bits, len(streams), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "qpack_prefill_fill")


def prefill_fill(k, v, k_codes, k_scales, k_hot, v_codes, v_scales, v_hot,
                 lens, bits: int) -> None:
    """A prefill layer's cache fill, in place: k, v [B, S, Hkv, D]
    (bf16/f32) quantized into codes [B, L, Hkv, D*bits/8] and scales [B, L,
    Hkv] at positions [0, S) (S <= L), and each ring hot [B, W, Hkv, D]
    bf16 filled with the latest of ``lens`` [B] real tokens
    (``ring_sources``). One kernel launch for K and V of CUDA tensors; the
    plain version for CPU tensors."""
    global prefill_fill_launches
    if k.device.type == "cpu":
        return prefill_fill_plain(k, v, k_codes, k_scales, k_hot, v_codes,
                                  v_scales, v_hot, lens, bits)
    if k.device.type != "cuda":
        raise ValueError(f"no prefill fill for device {k.device}")
    _fill_launch((k, k_codes, k_scales, k_hot), (v, v_codes, v_scales, v_hot),
                 lens, bits)
    prefill_fill_launches += 1
    return None


def latent_prefill_fill(lat, codes, scales, hot, lens, bits: int) -> None:
    """``prefill_fill`` on MLA's latent stream, in place: lat [B, S, R]
    (bf16/f32) quantized into codes [B, L, R*bits/8] and scales [B, L] at
    [0, S), the ring hot [B, W, R] bf16 filled from the latest real tokens.
    One launch of the prefill-fill kernel with one stream for CUDA tensors;
    the plain version for CPU tensors."""
    global latent_prefill_fill_launches
    if lat.device.type == "cpu":
        return latent_prefill_fill_plain(lat, codes, scales, hot, lens, bits)
    if lat.device.type != "cuda":
        raise ValueError(f"no prefill fill for device {lat.device}")
    _fill_launch((lat[:, :, None], codes[:, :, None], scales[:, :, None],
                  hot[:, :, None]), None, lens, bits)
    latent_prefill_fill_launches += 1
    return None


def ring_to_codes_plain(codes, scales, hot, cold_len, pos: int, bits: int,
                        quantize=encode_plain):
    """The reference's ``_ring_to_codes``: the whole ring [Lyr, W, ..., D]
    quantized (``quantize``), and its live tokens, positions
    [max(cold_len, pos - W), pos), selected into codes [Lyr, T, ...] and
    scales [Lyr, T, ...] from slot p % W. Returns new tensors."""
    T_, W = codes.shape[1], hot.shape[1]
    c, s = quantize(hot.to(torch.float32), bits, hot.shape[-1])
    t = torch.arange(T_, device=codes.device)
    sel = (t[None, :] >= cold_len[:, None]) & (t[None, :] >= pos - W) & \
        (t[None, :] < pos)                                     # [Lyr, T]
    slot = t % W
    gc = c[:, slot]                                # slot content per position
    gs = s[..., 0][:, slot]
    selc = sel.reshape(sel.shape + (1,) * (codes.dim() - 2))
    sels = sel.reshape(sel.shape + (1,) * (scales.dim() - 2))
    return torch.where(selc, gc, codes), torch.where(sels, gs, scales)


def lane_flush_plain(k_codes, k_scales, k_hot, v_codes, v_scales, v_hot,
                     cold_len, pos: int, bits: int, *,
                     quantize=encode_plain) -> torch.Tensor:
    """``lane_flush``'s plain version: ``ring_to_codes_plain`` for K and V,
    copied into the codes and scales in place; returns max(cold_len,
    pos)."""
    for codes, scales, hot in ((k_codes, k_scales, k_hot),
                               (v_codes, v_scales, v_hot)):
        c, s = ring_to_codes_plain(codes, scales, hot, cold_len, pos, bits,
                                   quantize)
        codes.copy_(c)
        scales.copy_(s)
    return torch.clamp(cold_len, min=pos)


def latent_lane_flush_plain(codes, scales, hot, cold_len, pos: int, bits: int,
                       *, quantize=encode_plain) -> torch.Tensor:
    """``latent_lane_flush``'s plain version: the reference's
    ``_ring_to_codes`` on ``lat_*``, copied into codes and scales in place;
    returns max(cold_len, pos)."""
    c, s = ring_to_codes_plain(codes, scales, hot, cold_len, pos, bits,
                               quantize)
    codes.copy_(c)
    scales.copy_(s)
    return torch.clamp(cold_len, min=pos)


def _flush_launch(k, v, cold_len, pos: int, bits: int) -> torch.Tensor:
    """One lane-flush launch over the streams k and, unless None, v: each
    (codes [Lyr,T,H,D*bits/8], scales [Lyr,T,H], hot [Lyr,W,H,D]), any
    layer strides, shared by the two streams."""
    Lyr, W, H, D = k[2].shape
    T_ = k[0].shape[1]
    if bits not in (4, 8) or D % 8:
        raise ValueError(f"bits={bits}, D={D}: the lane flush takes 4 or 8 "
                         "bits and D a multiple of 8")
    dev = k[2].device
    streams = [k] if v is None else [k, v]
    for codes, scales, hot in streams:
        for t, shape, dtype, name, align in (
                (codes, (Lyr, T_, H, D * bits // 8), torch.uint8, "codes",
                 bits),
                (scales, (Lyr, T_, H), torch.float32, "scales", 4),
                (hot, (Lyr, W, H, D), torch.bfloat16, "hot", 16)):
            _check_rows(t, name, shape, (dtype,), dev, align, lead=1)
    _check_rows(cold_len, "cold_len", (Lyr,), (torch.int32,), dev, 4, lead=1)
    strides = [t.stride(0) for t in (*k, cold_len)]
    if v is not None and any(t.stride(0) != st
                             for t, st in zip(v, strides)):
        raise ValueError("K and V must share their layer strides")
    cold_out = torch.empty((Lyr,), dtype=torch.int32, device=dev)
    kp = [t.data_ptr() for t in k]
    vp = [t.data_ptr() for t in v] if v is not None else [None] * 3
    err = _fixed_lib().qpack_lane_flush(
        kp[0], kp[1], kp[2], vp[0], vp[1], vp[2], cold_len.data_ptr(),
        cold_out.data_ptr(), *strides, Lyr, T_, W, H, D, bits, int(pos),
        len(streams), torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(err, "qpack_lane_flush")
    return cold_out


def lane_flush(k_codes, k_scales, k_hot, v_codes, v_scales, v_hot, cold_len,
               pos: int, bits: int) -> torch.Tensor:
    """A lane demotion's device half, in place: the live ring tokens of
    every layer, positions [max(cold_len, pos - W), pos), quantized from
    ring slot p % W into codes [Lyr, T, Hkv, D*bits/8] and scales [Lyr, T,
    Hkv] at p. hot [Lyr, W, Hkv, D] bf16, cold_len int32[Lyr]; each tensor
    may have any layer stride (a lane's slice of the batch cache). Returns
    the new cold_len, max(cold_len, pos), a fresh int32[Lyr]. One kernel
    launch for K and V of CUDA tensors; the plain version for CPU
    tensors."""
    global lane_flush_launches
    if k_hot.device.type == "cpu":
        return lane_flush_plain(k_codes, k_scales, k_hot, v_codes, v_scales,
                                v_hot, cold_len, pos, bits)
    if k_hot.device.type != "cuda":
        raise ValueError(f"no lane flush for device {k_hot.device}")
    out = _flush_launch((k_codes, k_scales, k_hot), (v_codes, v_scales, v_hot),
                        cold_len, pos, bits)
    lane_flush_launches += 1
    return out


def latent_lane_flush(codes, scales, hot, cold_len, pos: int,
                      bits: int) -> torch.Tensor:
    """``lane_flush`` on MLA's latent stream: codes [Lyr, T, R*bits/8],
    scales [Lyr, T], hot [Lyr, W, R] bf16, cold_len int32[Lyr], any layer
    strides. Returns max(cold_len, pos). One launch of the lane-flush
    kernel with one stream for CUDA tensors; the plain version for CPU
    tensors."""
    global latent_lane_flush_launches
    if hot.device.type == "cpu":
        return latent_lane_flush_plain(codes, scales, hot, cold_len, pos, bits)
    if hot.device.type != "cuda":
        raise ValueError(f"no lane flush for device {hot.device}")
    out = _flush_launch((codes[:, :, None], scales[:, :, None],
                         hot[:, :, None]), None, cold_len, pos, bits)
    latent_lane_flush_launches += 1
    return out
