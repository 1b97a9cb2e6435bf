"""Symmetric block quantization as the configuration states it: per block,
scale = amax / (2^(bits-1) - 1) (1 for an all-zero block), codes =
round-half-even(x * (1 / scale)) clipped to [-2^(bits-1), 2^(bits-1) - 1],
values = codes * scale. Packing into bytes is a layout, not a value, so
the reference keeps the codes as integers."""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor, bits: int, block: int):
    """x[..., N] -> (codes int8[..., N], scales f32[..., N / block])."""
    qmax = float(2 ** (bits - 1) - 1)
    lead, n = x.shape[:-1], x.shape[-1]
    xb = x.to(torch.float32).reshape(lead + (n // block, block))
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * torch.tensor(
        1.0 / qmax, dtype=torch.float32, device=x.device),
        torch.ones_like(amax))
    q = torch.clamp(torch.round(xb * (torch.ones_like(scale) / scale)),
                    -qmax - 1, qmax)
    return q.to(torch.int8).reshape(lead + (n,)), scale[..., 0]


def dequantize(codes: torch.Tensor, scales: torch.Tensor, block: int
               ) -> torch.Tensor:
    lead, n = codes.shape[:-1], codes.shape[-1]
    q = codes.to(torch.float32).reshape(lead + (n // block, block))
    return (q * scales[..., None]).reshape(lead + (n,))


def roundtrip(x: torch.Tensor, bits: int, block: int) -> torch.Tensor:
    """x through its codes and back, in float32."""
    return dequantize(*quantize(x, bits, block), block)


def unpack8(codes_u8: torch.Tensor) -> torch.Tensor:
    """The program's 8-bit codes (bytes) as int8 values."""
    return codes_u8.view(torch.int8)


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor (amax at
    448, the format's largest), back in float32: the control's linear
    inputs."""
    s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s
