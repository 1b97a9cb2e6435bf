"""Bit packing and per-block quantization for the rate-adaptive compressor
(PyTorch port of ``repro.core.bitpack``)."""
from __future__ import annotations

import torch

from repro_torch.common.utils import (bitcast_bf16_to_u16, bitcast_u16_to_bf16,
                                      bytes_to_u16, u16_to_bytes)

# Rate codes (block_type in metadata, 2 bits — §4.6 co-location format):
RATE_ZERO = 0          # all-zero block: no chunks
RATE_4BIT = 1          # 4-bit quantized + per-block scale
RATE_8BIT = 2          # 8-bit quantized + per-block scale
RATE_RAW = 3           # incompressible: raw bf16 payload


def pack4(q: torch.Tensor) -> torch.Tensor:
    """int[N] in [-8,7] -> uint8[N/2]; pairs packed little-nibble-first."""
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def unpack4(b: torch.Tensor, n: int) -> torch.Tensor:
    """uint8[N/2] -> int8[N] sign-extended from 4-bit."""
    lo = (b & 0xF).to(torch.int8)
    hi = (b >> 4).to(torch.int8)
    q = torch.stack([lo, hi], dim=-1).reshape(b.shape[:-1] + (n,))
    return torch.where(q >= 8, q - 16, q)


def pack8(q: torch.Tensor) -> torch.Tensor:
    """int8[N] -> uint8[N] (bit identity)."""
    return q.to(torch.int8).view(torch.uint8)


def unpack8(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.uint8).view(torch.int8)


def quantize_block(x: torch.Tensor, bits: int):
    """Symmetric per-block quantization over the last axis. Returns
    (codes int8, scale f32). Reciprocal multiply, round-half-even, clip."""
    qmax = float(2 ** (bits - 1) - 1)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    c = torch.tensor(1.0 / qmax, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * c, torch.ones_like(amax))
    recip = torch.ones_like(scale) / scale
    q = torch.clamp(torch.round(xf * recip), -qmax - 1, qmax)
    return q.to(torch.int8), scale[..., 0]


def dequantize_block(q: torch.Tensor, scale: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


def raw_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """bf16[N] -> uint8[2N]."""
    return u16_to_bytes(bitcast_bf16_to_u16(x))


def bytes_to_raw(b: torch.Tensor) -> torch.Tensor:
    """uint8[2N] -> bf16[N]."""
    return bitcast_u16_to_bf16(bytes_to_u16(b))
