"""Transformer layers of the port (``repro.models.layers``, dense GQA):
RMSNorm, RoPE, GQA attention projections, SwiGLU MLP, and the attention
switch between the CUDA kernels and their plain versions.

Parameters are plain dicts of tensors stored in the model's dtype. The
reference keeps f32 params and casts each to the activation dtype at its
use; every such cast rounds to nearest even, so storing the rounded copy
computes the same values. The reference's rounding points are kept:
``rms_norm`` takes the variance in f32 and the products in the input
dtype, ``apply_rope`` rotates in f32 and rounds once.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig
from repro_torch.kernels import flash_attn as FA

Params = Dict[str, torch.Tensor]

# the reference's name for the plain version of the prefill kernel
chunked_attention = FA.flash_attention_plain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def resolve_attn_impl(impl: str, device) -> str:
    """``ServeConfig.attn_impl`` for tensors on ``device``: "auto" is the
    CUDA kernel for CUDA tensors and the plain version for CPU tensors;
    "kernel" on a CPU tensor raises; "plain" is the plain version."""
    if impl == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "plain"
    if impl == "kernel" and torch.device(device).type != "cuda":
        raise ValueError("attn_impl='kernel' needs CUDA tensors")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"attn_impl={impl!r}")
    return impl


def attention(q, k, v, *, causal: bool = True, impl: str = "auto"):
    """Prefill attention: the flash kernel (B6) or its plain version."""
    if resolve_attn_impl(impl, q.device) == "kernel":
        return FA.flash_attention(q, k, v, causal=causal)
    return FA.flash_attention_plain(q, k, v, causal=causal)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x [..., S, H, D] (D even), positions [..., S] -> rotated x."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def init_dense(shape, gen: torch.Generator, dtype, device, scale=None):
    """N(0, 1) * scale (default 1/sqrt(fan_in)), drawn in f32 from ``gen``
    and stored in ``dtype`` (the reference's ``_init`` distribution; the
    numbers differ from JAX's, so tests carry JAX-made params across)."""
    if scale is None:
        scale = 1.0 / (shape[0] ** 0.5)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def gqa_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    return {"wq": init_dense((d, hq * hd), gen, dtype, device),
            "wk": init_dense((d, hkv * hd), gen, dtype, device),
            "wv": init_dense((d, hkv * hd), gen, dtype, device),
            "wo": init_dense((hq * hd, d), gen, dtype, device,
                             scale=1.0 / ((hq * hd) ** 0.5))}


def gqa_project_kv(p: Params, x: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig):
    """K/V for new tokens. x [B,T,d] -> k,v [B,T,Hkv,D]."""
    B, T, _ = x.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    k = (x @ p["wk"].to(x.dtype)).reshape(B, T, hkv, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, T, hkv, hd)
    return apply_rope(k, positions, cfg.rope_theta), v


def gqa_project_q(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    B, T, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, T, cfg.num_heads,
                                          cfg.resolved_head_dim)
    return apply_rope(q, positions, cfg.rope_theta)


def gqa_output(p: Params, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B = o.shape[0]
    return o.reshape(B, -1, cfg.num_heads * cfg.resolved_head_dim) @ \
        p["wo"].to(o.dtype)


def gqa_apply_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    attn_impl: str = "auto") -> torch.Tensor:
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    q = gqa_project_q(p, x, pos, cfg)
    k, v = gqa_project_kv(p, x, pos, cfg)
    o = attention(q, k, v, causal=True, impl=attn_impl)
    return gqa_output(p, o, cfg)


def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    return {"wi": init_dense((d, f), gen, dtype, device),
            "wg": init_dense((d, f), gen, dtype, device),
            "wo": init_dense((f, d), gen, dtype, device,
                             scale=1.0 / (f ** 0.5))}


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
