"""Transformer layers of the port (``repro.models.layers``, dense family):
RMSNorm, RoPE, GQA attention projections, MLA (multi-head latent
attention) projections, SwiGLU MLP, and the attention switch between the
CUDA kernels and their plain versions.

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

from repro_torch.common.types import MLAConfig, ModelConfig
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
    """Prefill and training attention: the flash kernel (B6; under autograd
    its Function, whose backward is FlashAttention-2's in PyTorch) or its
    plain version (autograd's own gradient)."""
    if resolve_attn_impl(impl, q.device) == "kernel":
        if FA.needs_grad(q, k, v):
            return FA.flash_attention_trainable(q, k, v, causal=causal)
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
    if torch.device(device).type == "meta":       # shapes only: no draw
        return torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        scale = 1.0 / (shape[0] ** 0.5)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)      # in place: one f32 copy at a time


# logical axes of each layer's leaves (the reference's ``*_init`` axes;
# ``common/sharding.py`` maps them to mesh axes)
GQA_AXES = {"wq": ("fsdp", "heads"), "wk": ("fsdp", "heads"),
            "wv": ("fsdp", "heads"), "wo": ("heads", "fsdp")}
MLA_AXES = {"wq_a": ("fsdp", "latent"), "wq_b": ("latent", "heads"),
            "wkv_a": ("fsdp", "latent"), "wkv_b": ("latent", "heads"),
            "wo": ("heads", "fsdp"), "q_norm": ("latent",),
            "kv_norm": ("latent",)}
MLP_AXES = {"wi": ("fsdp", "mlp"), "wg": ("fsdp", "mlp"),
            "wo": ("mlp", "fsdp")}


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


# ---------------------------------------------------------------------------
# MLA attention (MiniCPM3 / DeepSeek-V2 style latent KV)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    d, h = cfg.d_model, cfg.num_heads
    m = cfg.mla or MLAConfig()
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim

    def ones(n):
        return torch.ones((n,), dtype=dtype, device=device)

    return {"wq_a": init_dense((d, m.q_lora_rank), gen, dtype, device),
            "wq_b": init_dense((m.q_lora_rank, h * qk), gen, dtype, device),
            "wkv_a": init_dense((d, m.kv_lora_rank + m.qk_rope_head_dim),
                                gen, dtype, device),
            "wkv_b": init_dense((m.kv_lora_rank,
                                 h * (m.qk_nope_head_dim + m.v_head_dim)),
                                gen, dtype, device),
            "wo": init_dense((h * m.v_head_dim, d), gen, dtype, device,
                             scale=1.0 / ((h * m.v_head_dim) ** 0.5)),
            "q_norm": ones(m.q_lora_rank), "kv_norm": ones(m.kv_lora_rank)}


def mla_sm_scale(cfg: ModelConfig) -> float:
    """1/sqrt(qk head dim) for the absorbed decode, whose query is R wide;
    the prefill's query is nope + rope wide, so B6's default is the same."""
    m = cfg.mla or MLAConfig()
    return 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)


def mla_latent(p: Params, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Latent KV of new tokens, [B, T, kv_lora_rank + rope_dim]: the cached
    quantity (a learned KV compression, which IBEX block-compresses)."""
    m = cfg.mla or MLAConfig()
    ckv = x @ p["wkv_a"].to(x.dtype)
    c, k_rope = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0]
    return torch.cat([c, k_rope], dim=-1)


def mla_q_latent(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """The query latent of x [B,T,d]: [B, T, q_lora_rank], normed."""
    return rms_norm(x @ p["wq_a"].to(x.dtype), p["q_norm"], cfg.norm_eps)


def mla_project_q(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, q_latent: torch.Tensor = None):
    """Queries of x [B,T,d] (from its query latent, made here unless
    given): (q_nope [B,T,H,nope], q_rope [B,T,H,rope], rotated)."""
    m = cfg.mla or MLAConfig()
    B, T, _ = x.shape
    q = mla_q_latent(p, x, cfg) if q_latent is None else q_latent
    q = (q @ p["wq_b"].to(x.dtype)).reshape(
        B, T, cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                             dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_attend(p: Params, x: torch.Tensor, latent: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig, *, causal: bool,
               attn_impl: str = "auto",
               q_latent: torch.Tensor = None) -> torch.Tensor:
    """Attention of x's queries over the latent cache, expanded per head:
    MHA over H heads with a qk dim of nope + rope and a v dim of v_head_dim
    (B6 at that pair on the card), the rope key broadcast to every head."""
    m = cfg.mla or MLAConfig()
    h = cfg.num_heads
    B, T, _ = x.shape
    S = latent.shape[1]
    q_nope, q_rope = mla_project_q(p, x, positions, cfg, q_latent)
    c, k_rope = latent.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    kv = (c @ p["wkv_b"].to(x.dtype)).reshape(
        B, S, h, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, h, m.qk_rope_head_dim)], dim=-1)
    qq = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(qq, k, v, causal=causal, impl=attn_impl)
    return o.reshape(B, T, h * m.v_head_dim) @ p["wo"].to(x.dtype)


def mla_apply_train(p: Params, x: torch.Tensor, cfg: ModelConfig,
                    attn_impl: str = "auto", mesh=None) -> torch.Tensor:
    """The full-sequence form. On a mesh (``cfg`` at the rank's heads;
    ``wq_b``/``wkv_b`` the rank's columns, ``wo`` its rows): both latents
    made on every rank from the replicated ``wq_a``/``wkv_a`` and norms,
    then entered, so those leaves and ``x`` take whole, equal gradients;
    the output is partial over ``model``."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :]
    latent = mla_latent(p, x, pos, cfg)
    if mesh is None:
        return mla_attend(p, x, latent, pos, cfg, causal=True,
                          attn_impl=attn_impl)
    q_latent = mesh.enter(mla_q_latent(p, x, cfg))
    return mla_attend(p, x, mesh.enter(latent), pos, cfg, causal=True,
                      attn_impl=attn_impl, q_latent=q_latent)


def mlp_init(gen, d: int, f: int, dtype, device) -> Params:
    return {"wi": init_dense((d, f), gen, dtype, device),
            "wg": init_dense((d, f), gen, dtype, device),
            "wo": init_dense((f, d), gen, dtype, device,
                             scale=1.0 / (f ** 0.5))}


def mlp_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wi"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)
