"""Bit-field helpers and byte views shared by the port.

uint32 words (metadata, activity entries, PRNG keys) are held as int64
values in [0, 2**32): CPU PyTorch implements almost no uint32 arithmetic.
Every helper here works on Python ints and on int64 tensors alike, so the
host-side control code and the vectorised window code share one definition.
"""
from __future__ import annotations

import torch

U32 = 0xFFFFFFFF


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    Raises when no device is given and no GPU is present (never falls back
    to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' explicitly "
                               "to run the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (1 for n <= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def get_bits(word, lo: int, width: int):
    """Extract ``width`` bits starting at bit ``lo`` from uint32 word(s)."""
    return (word >> lo) & ((1 << width) - 1)


def set_bits(word, lo: int, width: int, value):
    """Return ``word`` with ``width`` bits at ``lo`` replaced by ``value``."""
    mask = (1 << width) - 1
    return (word & (U32 ^ (mask << lo))) | ((value & mask) << lo)


def bitcast_bf16_to_u16(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> uint16 bit patterns, held as int32."""
    return x.to(torch.bfloat16).view(torch.int16).to(torch.int32) & 0xFFFF


def bitcast_u16_to_bf16(x: torch.Tensor) -> torch.Tensor:
    u = x.to(torch.int32) & 0xFFFF
    return torch.where(u >= 0x8000, u - 0x10000, u).to(torch.int16) \
        .view(torch.bfloat16)


def u16_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """uint16[..., N] (any int dtype) -> uint8[..., 2N] little-endian."""
    x = x.to(torch.int32)
    lo = (x & 0xFF).to(torch.uint8)
    hi = ((x >> 8) & 0xFF).to(torch.uint8)
    return torch.stack([lo, hi], dim=-1).reshape(x.shape[:-1] + (x.shape[-1] * 2,))


def bytes_to_u16(b: torch.Tensor) -> torch.Tensor:
    """uint8[..., 2N] -> uint16 values [..., N] held as int32."""
    pairs = b.reshape(b.shape[:-1] + (b.shape[-1] // 2, 2)).to(torch.int32)
    return pairs[..., 0] | (pairs[..., 1] << 8)


def f32_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """f32[..., N] -> uint8[..., 4N], little-endian IEEE bytes."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & U32
    parts = [((u >> s) & 0xFF).to(torch.uint8) for s in (0, 8, 16, 24)]
    return torch.stack(parts, dim=-1).reshape(x.shape[:-1] + (x.shape[-1] * 4,))


def bytes_to_f32(b: torch.Tensor) -> torch.Tensor:
    """uint8[..., 4N] -> f32[..., N]."""
    q = b.reshape(b.shape[:-1] + (b.shape[-1] // 4, 4)).to(torch.int64)
    u = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16) | (q[..., 3] << 24)
    s = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)
    return s.view(torch.float32)
