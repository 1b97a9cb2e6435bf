"""The compression engine's CUDA kernels, their plain PyTorch versions,
and the wrappers the compressor calls.

  * ``fused_encode``/``fused_decode`` (``csrc/qpack_fused.cu``) replace the
    JAX package's TPU kernels ``kernels/qpack.py::qpack_fused_encode_2d``
    and ``qpack_fused_decode_2d``: the pool's rate-adaptive demote/promote.
  * ``encode``/``decode`` (``csrc/qpack_fixed.cu``) replace
    ``qpack_encode_2d`` and ``qpack_decode_2d`` with the shape contract of
    their wrappers ``kernels/ops.py::qpack_encode``/``qpack_decode``:
    fixed-rate 4/8-bit quantize and pack over blocks of any even size,
    any leading shape (the KV cache's compressed region).

All four are memory-bound single passes; the source notes in the ``.cu``
files give the bound and the design.

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
encode_launches = 0
decode_launches = 0


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


# ---------------------------------------------------------------------------
# CUDA libraries (kernels/build.py: nvcc -> shared library, loaded by ctypes).
# ---------------------------------------------------------------------------

def _fused_lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load("qpack_fused", {
        "qpack_fused_encode": [P, I, P, P, P, I, I, F, F, I, I, I, I, I, I, P],
        "qpack_fused_decode": [P, P, P, I, I, P]})


def _fixed_lib() -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    return _build.load("qpack_fixed", {
        "qpack_fixed_encode": [P, I, P, P, I, I, I, I, P],
        "qpack_fixed_decode": [P, P, P, I, I, I, I, I, P]})


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


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
    x = x.contiguous()
    if x.data_ptr() % 16:               # a view at an odd offset
        x = x.clone()
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
    codes, scales = codes.contiguous(), scales.contiguous()
    if codes.data_ptr() % 16:
        codes = codes.clone()
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
