"""Serving decode path of the port (``repro.models.decode``; the dense
family with GQA/MHA or MLA attention, the MoE family with GQA attention,
the SSM family, the hybrid family):
the IBEX-compressed KV cache and the one-token step.

The KV cache is an IBEX pool specialized for append-only data:

  * hot window (promoted region): the last ``W`` tokens per sequence, a
    bf16 ring. New K/V lands here.
  * compressed region: every token older than ``W``, block-quantized (one
    block per (token, KV head) over the head dim; 4 or 8 bits + f32 scale)
    when it ages out of the ring: the ring step (``qpack.ring_step``, one
    launch a layer with B3's quantize) evicts it and inserts the new token;
    prefill fills the region and the ring with the prefill fill
    (``qpack.prefill_fill``, one launch a layer, the same quantize).

Two read paths for the compressed prefix:
  * fused: dequantize inside attention, the decode attention kernel (B5)
    writing an online-softmax partial that merges with the ring's;
  * paper: promote-then-read, the whole prefix dequantized to bf16 by the
    decode kernel (B4), then attended uncompressed.

Prefill attention is the flash kernel (B6). ``ServeConfig.quantize_impl``
and ``attn_impl`` choose kernels or plain versions ("auto": kernels for
CUDA tensors).

MLA (minicpm3-4b) caches one latent row a token (kv_lora_rank + rope
values, shared by every head) instead of K and V: the same ring, codes
region and ``cold_len``, one stream (``lat_*``), through the latent forms
of the ring step, the prefill fill and the lane flush. Decode is the
absorbed form: q_nope folded through W_uk into the latent space, attention
over the latent (key = value) through the latent decode kernel (B5's MLA
form) and the ring, then W_uv and W_o.

The MoE family (qwen3-moe, arctic) is the GQA path with the experts in
place of the MLP (``transformer.mlp``): a decode step routes every lane's
token as one batch, idle lanes included, as the reference does.

The SSM family (falcon-mamba) has no KV cache: its cache is the raw
recurrent state of every layer (``ssm.h`` [L,B,d_in,N] f32, the scan's
state, and ``ssm.conv`` [L,B,K-1,d_in] bf16, the conv's left context;
the reference's ``{"ssm": {"h", "conv"}}`` subtree, with dotted names
here), which prefill writes and each decode step advances (``models/
ssm.py``); no kernel runs on this path.

The hybrid family (zamba2-2.7b) holds both: a GQA cache of one site a
group (its leading axis the group g, read by the group's shared
attention block through the ring step, B5, B6 and the prefill fill) and
the Mamba2 state of every layer, flat (``ssm.h`` [L,B,H,P,N] f32,
``ssm.conv`` [L,B,K-1,d_in] bf16, layer g * period + j being group g's
j-th), so that every leaf has its lane on axis 1; ``interop`` gives the
reference's [G, period, B, ...] subtree.

Unlike the reference, whose arrays are immutable, the port updates the
cache **in place**: ``decode_step`` writes each layer's codes, scales, ring
and ``cold_len`` into the tensors it was given (and returns the same dict).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.common import contracts
from repro_torch.common.types import MLAConfig, ModelConfig, ServeConfig
from repro_torch.common.utils import resolve_device
from repro_torch.core.compressor import (dequantize_blocks,
                                         resolve_quantize_impl)
from repro_torch.kernels import kvc_attn as KA
from repro_torch.kernels import qpack
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T

Params = Dict[str, Any]
NEG_INF = -1e30
# a GQA site's cache leaves
GQA_KEYS = ("k_codes", "k_scales", "v_codes", "v_scales", "k_hot", "v_hot",
            "cold_len")


# ---------------------------------------------------------------------------
# Online-softmax partials and merging
# ---------------------------------------------------------------------------

class Partial(NamedTuple):
    m: torch.Tensor     # [B, H, 1]
    l: torch.Tensor     # [B, H, 1]
    acc: torch.Tensor   # [B, H, D]


def merge_partials(a: Partial, b: Partial) -> Partial:
    m = torch.maximum(a.m, b.m)
    ea, eb = torch.exp(a.m - m), torch.exp(b.m - m)
    return Partial(m, a.l * ea + b.l * eb, a.acc * ea + b.acc * eb)


def finish(p: Partial, dtype) -> torch.Tensor:
    return (p.acc / torch.clamp(p.l, min=1e-30)).to(dtype)


def _attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, sm_scale: float) -> Partial:
    """q [B,Hq,D]; k,v [B,T,Hkv,D] f32; valid [B,T] -> partial."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    qf = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k) * sm_scale
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    return Partial(m.reshape(B, Hq, 1), l.reshape(B, Hq, 1),
                   acc.reshape(B, Hq, D))


def quantized_attention_partial(q, k_codes, k_scales, v_codes, v_scales,
                                length: torch.Tensor, *, bits: int,
                                sm_scale: float, paper_mode: bool = False,
                                attn_impl: str = "auto",
                                quantize_impl: str = "auto") -> Partial:
    """Attention partial over the compressed prefix (tokens < length).

    fused: the decode attention kernel (or its plain version) dequantizes
    inside attention; the reference's chunk-parallel jnp form computes the
    same partial (its chunk size is a layout choice of XLA's; the kernel
    walks the sequence in its own tiles).

    paper: the whole prefix is dequantized to bf16 first (the promoted-
    region write + read round trip; B4 materializes it), then attended."""
    D = q.shape[-1]
    if paper_mode:
        k = dequantize_blocks(k_codes, k_scales[..., None], bits, D,
                              torch.bfloat16, impl=quantize_impl)
        v = dequantize_blocks(v_codes, v_scales[..., None], bits, D,
                              torch.bfloat16, impl=quantize_impl)
        Sc = k_codes.shape[1]
        valid = torch.arange(Sc, device=q.device)[None, :] < length[:, None]
        return _attend_partial(q, k.to(torch.float32), v.to(torch.float32),
                               valid, sm_scale)
    if L.resolve_attn_impl(attn_impl, q.device) == "kernel":
        return Partial(*KA.kvc_decode_partial(
            q, k_codes, k_scales, v_codes, v_scales, length, bits=bits,
            sm_scale=sm_scale))
    return Partial(*KA.kvc_decode_partial_plain(
        q, k_codes, k_scales, v_codes, v_scales, length, bits, sm_scale))


def latent_attention_partial(q, codes, scales, length: torch.Tensor, *,
                             bits: int, sm_scale: float,
                             paper_mode: bool = False,
                             attn_impl: str = "auto",
                             quantize_impl: str = "auto") -> Partial:
    """MLA's partial over the compressed latent prefix (tokens < length):
    q [B,H,R], codes [B,S,R*bits/8], scales [B,S], the latent both key and
    value (the reference's ``quantized_attention_partial`` with
    ``lc[:, :, None, :]`` as K and as V). fused: the latent decode kernel
    (or its plain version); paper: the prefix dequantized to bf16 once (B4
    at the latent's block), then attended."""
    if paper_mode:
        lat = dequantize_blocks(codes, scales[..., None], bits, q.shape[-1],
                                torch.bfloat16, impl=quantize_impl)
        valid = torch.arange(codes.shape[1], device=q.device)[None, :] < \
            length[:, None]
        latf = lat.to(torch.float32)[:, :, None]
        return _attend_partial(q, latf, latf, valid, sm_scale)
    if L.resolve_attn_impl(attn_impl, q.device) == "kernel":
        return Partial(*KA.kvc_latent_partial(q, codes, scales, length,
                                              bits=bits, sm_scale=sm_scale))
    return Partial(*KA.kvc_latent_partial_plain(q, codes, scales, length,
                                                bits, sm_scale))


# ---------------------------------------------------------------------------
# Cache containers (stacked on a leading layer axis)
# ---------------------------------------------------------------------------

def init_gqa_cache(cfg: ModelConfig, scfg: ServeConfig, batch: int,
                   max_len: int, n_sites: int,
                   device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    Hkv, D = cfg.num_kv_heads, cfg.resolved_head_dim
    W, bits = scfg.hot_window, scfg.kv_rate_bits
    Dp = D * bits // 8

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "k_codes": z((n_sites, batch, max_len, Hkv, Dp), torch.uint8),
        "k_scales": z((n_sites, batch, max_len, Hkv), torch.float32),
        "v_codes": z((n_sites, batch, max_len, Hkv, Dp), torch.uint8),
        "v_scales": z((n_sites, batch, max_len, Hkv), torch.float32),
        "k_hot": z((n_sites, batch, W, Hkv, D), torch.bfloat16),
        "v_hot": z((n_sites, batch, W, Hkv, D), torch.bfloat16),
        # boundary between the compressed region and the ring per lane:
        # positions < cold_len live in codes
        "cold_len": z((n_sites, batch), torch.int32),
    }


def init_mla_cache(cfg: ModelConfig, scfg: ServeConfig, batch: int,
                   max_len: int, device=None) -> Dict[str, torch.Tensor]:
    """MLA's latent cache: one row of kv_lora_rank + rope values a token."""
    dev = resolve_device(device)
    m = cfg.mla or MLAConfig()
    R = m.kv_lora_rank + m.qk_rope_head_dim
    W, bits, Lyr = scfg.hot_window, scfg.kv_rate_bits, cfg.num_layers

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"lat_codes": z((Lyr, batch, max_len, R * bits // 8), torch.uint8),
            "lat_scales": z((Lyr, batch, max_len), torch.float32),
            "lat_hot": z((Lyr, batch, W, R), torch.bfloat16),
            "cold_len": z((Lyr, batch), torch.int32)}


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """Every layer's zero recurrent state: Mamba1's (the SSM family) or
    Mamba2's (the hybrid's)."""
    init = SSM.mamba2_init_state if cfg.family == "hybrid" else \
        SSM.mamba1_init_state
    st = init(cfg, batch, resolve_device(device))
    return {f"ssm.{k}": v.expand((cfg.num_layers,) + v.shape).clone()
            for k, v in st._asdict().items()}


def init_cache(cfg: ModelConfig, scfg: ServeConfig, batch: int,
               max_len: int, device=None) -> Dict[str, torch.Tensor]:
    """Decode cache (GQA/MHA K and V, MLA's latent, the SSM family's
    recurrent state, or the hybrid's GQA sites and Mamba2 state). Leading
    axis = layer (the hybrid's KV leaves: group)."""
    T.check_supported(cfg)
    if cfg.family == "ssm":
        return init_ssm_cache(cfg, batch, device)
    if cfg.family == "hybrid":
        return {**init_ssm_cache(cfg, batch, device),
                **init_gqa_cache(cfg, scfg, batch, max_len,
                                 T.hybrid_groups(cfg)[0], device)}
    if cfg.attn_kind == "mla":
        return init_mla_cache(cfg, scfg, batch, max_len, device)
    return init_gqa_cache(cfg, scfg, batch, max_len, cfg.num_layers, device)


def cache_bytes(cache: Dict[str, torch.Tensor]) -> int:
    return sum(x.numel() * x.element_size() for x in cache.values())


def cache_axes(cfg: ModelConfig, scfg: ServeConfig) -> Dict[str, Any]:
    """The logical axes of ``init_cache``'s leaves, the reference's tree
    (its ``cache_axes``): the SSM state under ``"ssm"``, whose leaves the
    port keys ``"ssm.h"`` and ``"ssm.conv"``; the hybrid's state leads with
    [group, period] there and with its layer here (``leaf_axes``)."""
    gqa = {
        "k_codes": ("layers", "batch", "kv_seq", "kv_heads", None),
        "k_scales": ("layers", "batch", "kv_seq", "kv_heads"),
        "v_codes": ("layers", "batch", "kv_seq", "kv_heads", None),
        "v_scales": ("layers", "batch", "kv_seq", "kv_heads"),
        "k_hot": ("layers", "batch", "kv_hot", "kv_heads", None),
        "v_hot": ("layers", "batch", "kv_hot", "kv_heads", None),
        "cold_len": ("layers", "batch"),
    }
    if cfg.family == "ssm":
        return {"ssm": {"h": ("layers", "batch", "mlp", "state"),
                        "conv": ("layers", "batch", None, "mlp")}}
    if cfg.family == "hybrid":
        return {"ssm": {"h": ("layers", None, "batch", "heads", None, None),
                        "conv": ("layers", None, "batch", None, "mlp")},
                **gqa}
    if cfg.attn_kind == "mla":
        return {"lat_codes": ("layers", "batch", "kv_seq", None),
                "lat_scales": ("layers", "batch", "kv_seq"),
                "lat_hot": ("layers", "batch", "kv_hot", None),
                "cold_len": ("layers", "batch")}
    return gqa


def leaf_axes(cfg: ModelConfig, scfg: ServeConfig) -> Dict[str, Any]:
    """``cache_axes`` keyed as ``init_cache``'s leaves: "ssm.h" for the
    tree's ``["ssm"]["h"]``, the hybrid's [group, period] axes as the
    port's one layer axis."""
    out = {}
    for k, v in cache_axes(cfg, scfg).items():
        if k != "ssm":
            out[k] = v
            continue
        for name, axes in v.items():
            out[f"ssm.{name}"] = axes[:1] + axes[2:] \
                if cfg.family == "hybrid" else axes
    return out


# ---------------------------------------------------------------------------
# Hot-window ring positions
# ---------------------------------------------------------------------------

def _ring_positions(pos: torch.Tensor, W: int) -> torch.Tensor:
    """Position stored in each ring slot after inserting token ``pos``:
    p_s = pos - ((pos%W - s) mod W). [B] -> [B, W]."""
    s = torch.arange(W, device=pos.device)[None, :]
    return pos[:, None] - (((pos % W)[:, None] - s) % W)


# ---------------------------------------------------------------------------
# Per-layer decode: GQA
# ---------------------------------------------------------------------------

@contracts.sync_contract(syncs_per="step", fetches=0)
def gqa_decode_layer(lp: Params, x: torch.Tensor,
                     cache_l: Dict[str, torch.Tensor], pos: torch.Tensor,
                     cfg: ModelConfig, scfg: ServeConfig) -> torch.Tensor:
    """x [B,1,d]; pos [B] current positions; cache_l holds this layer's
    slices (views into the stacked cache), updated in place."""
    W, bits = scfg.hot_window, scfg.kv_rate_bits
    D = cfg.resolved_head_dim
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = L.gqa_project_q(lp["attn"], h, pos[:, None], cfg)[:, 0]   # [B,Hq,D]
    k_new, v_new = L.gqa_project_kv(lp["attn"], h, pos[:, None], cfg)

    # demote the token aging out of the hot window (clean by construction)
    # and insert the new one: the ring step (one launch on the card)
    cold_len = cache_l["cold_len"]
    ring_step = qpack.ring_step if resolve_quantize_impl(
        scfg.quantize_impl, x.device) == "kernel" else qpack.ring_step_plain
    ring_step(cache_l["k_codes"], cache_l["k_scales"], cache_l["k_hot"],
              cache_l["v_codes"], cache_l["v_scales"], cache_l["v_hot"],
              k_new[:, 0], v_new[:, 0], pos, cold_len, bits)
    new_cold = torch.maximum(cold_len, torch.clamp(pos - W + 1, min=0))

    sm = 1.0 / (D ** 0.5)
    cold = quantized_attention_partial(
        q, cache_l["k_codes"], cache_l["k_scales"], cache_l["v_codes"],
        cache_l["v_scales"], new_cold, bits=bits, sm_scale=sm,
        paper_mode=not scfg.fused_dequant_attention,
        attn_impl=scfg.attn_impl, quantize_impl=scfg.quantize_impl)
    hot_valid = _ring_positions(pos, W) >= new_cold[:, None]
    hot = _attend_partial(q, cache_l["k_hot"].to(torch.float32),
                          cache_l["v_hot"].to(torch.float32), hot_valid, sm)
    o = finish(merge_partials(cold, hot), x.dtype)[:, None]       # [B,1,Hq,D]
    x = x + L.gqa_output(lp["attn"], o, cfg)
    x = x + T.mlp(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)[0]
    cold_len.copy_(new_cold)
    return x


# ---------------------------------------------------------------------------
# Per-layer decode: MLA (absorbed latent attention over the compressed
# latent)
# ---------------------------------------------------------------------------

@contracts.sync_contract(syncs_per="step", fetches=0)
def mla_decode_layer(lp: Params, x: torch.Tensor,
                     cache_l: Dict[str, torch.Tensor], pos: torch.Tensor,
                     cfg: ModelConfig, scfg: ServeConfig) -> torch.Tensor:
    """x [B,1,d]; pos [B]; cache_l this layer's latent slices, updated in
    place."""
    m = cfg.mla or MLAConfig()
    W, bits = scfg.hot_window, scfg.kv_rate_bits
    B, hD, Rc = x.shape[0], cfg.num_heads, m.kv_lora_rank
    p = lp["attn"]
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    lat_new = L.mla_latent(p, h, pos[:, None], cfg)[:, 0]          # [B,R]

    # evict the latent aging out of the ring, insert the new one: the
    # latent ring step (one launch on the card)
    cold_len = cache_l["cold_len"]
    step = qpack.latent_ring_step if resolve_quantize_impl(
        scfg.quantize_impl, x.device) == "kernel" \
        else qpack.latent_ring_step_plain
    step(cache_l["lat_codes"], cache_l["lat_scales"], cache_l["lat_hot"],
         lat_new, pos, cold_len, bits)
    new_cold = torch.maximum(cold_len, torch.clamp(pos - W + 1, min=0))

    # absorbed query: q_lat [B,H,Rc] = q_nope W_uk, then [q_lat, q_rope]
    q_nope, q_rope = L.mla_project_q(p, h, pos[:, None], cfg)
    wkv_b = p["wkv_b"].to(h.dtype).reshape(Rc, hD,
                                            m.qk_nope_head_dim + m.v_head_dim)
    w_uk, w_uv = wkv_b.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], w_uk)
    q_eff = torch.cat([q_lat, q_rope[:, 0]], dim=-1)               # [B,H,R]
    sm = L.mla_sm_scale(cfg)

    cold = latent_attention_partial(
        q_eff, cache_l["lat_codes"], cache_l["lat_scales"], new_cold,
        bits=bits, sm_scale=sm, paper_mode=not scfg.fused_dequant_attention,
        attn_impl=scfg.attn_impl, quantize_impl=scfg.quantize_impl)
    hot_valid = _ring_positions(pos, W) >= new_cold[:, None]
    latf = cache_l["lat_hot"].to(torch.float32)[:, :, None, :]     # [B,W,1,R]
    hot = _attend_partial(q_eff, latf, latf, hot_valid, sm)
    ctx = finish(merge_partials(cold, hot), torch.float32)         # [B,H,R]
    o = torch.einsum("bhr,rhv->bhv", ctx[..., :Rc], w_uv.to(torch.float32))
    o = o.reshape(B, 1, hD * m.v_head_dim).to(x.dtype)
    x = x + o @ p["wo"].to(x.dtype)
    x = x + L.mlp_apply(lp["mlp"], L.rms_norm(x, lp["ln2"], cfg.norm_eps))
    cold_len.copy_(new_cold)
    return x


@contracts.sync_contract(syncs_per="step", fetches=0)
def decode_step(params: Params, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
                scfg: ServeConfig, embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. tokens [B] int32 (or embeds [B,d]); pos [B].
    Returns (logits [B,V], the cache, updated in place)."""
    T.check_supported(cfg)
    dtype = L.torch_dtype(cfg)
    if cfg.frontend != "none" and embeds is not None:
        x = embeds[:, None].to(dtype)
    else:
        x = params["tok_embed"].to(dtype)[tokens.long()][:, None]
    if cfg.family in ("ssm", "hybrid"):
        hybrid = cfg.family == "hybrid"
        state, step = (SSM.Mamba2State, SSM.mamba2_decode) if hybrid else \
            (SSM.Mamba1State, SSM.mamba1_decode)
        period = T.hybrid_groups(cfg)[1] if hybrid else 0
        for i, lp in enumerate(params["layers"]):
            st = state(cache["ssm.h"][i], cache["ssm.conv"][i])
            y, new = step(lp["mixer"], L.rms_norm(x, lp["ln"], cfg.norm_eps),
                          st, cfg)
            x = x + y
            st.h.copy_(new.h)
            st.conv.copy_(new.conv)
            if period and (i + 1) % period == 0:      # the group's shared block
                g = i // period
                x = gqa_decode_layer(
                    params["shared"][g % len(params["shared"])], x,
                    {k: cache[k][g] for k in GQA_KEYS}, pos, cfg, scfg)
        return T.unembed(params, x, cfg)[:, 0], cache
    layer = mla_decode_layer if cfg.attn_kind == "mla" else gqa_decode_layer
    for i, lp in enumerate(params["layers"]):
        x = layer(lp, x, {k: v[i] for k, v in cache.items()}, pos, cfg, scfg)
    return T.unembed(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Prefill: full forward that also fills the cache
# ---------------------------------------------------------------------------

def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            scfg: ServeConfig, max_len: int,
            lens: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the full prompt [B,S], return (last-token logits, filled cache).

    Every prompt token is written compressed (the prefill fill, B3's
    quantize, one launch a layer on the card; positions past S hold the
    codes of zeros, as the reference's padded quantize gives: code 0, scale
    1); the last W real tokens populate the ring. ``lens`` [B] gives each
    row's true length for right-padded batches: the ring holds the last W
    real tokens, ``cold_len`` is the real compressed length, and the
    returned logits are each row's last real token's. MLA fills its latent
    (the latent prefill fill) instead of K and V. The SSM family keeps each
    layer's state after all S tokens (h_T and the bf16 conv tail of the
    last K-1 inputs), padded positions included, as the reference does:
    its engines prefill exact-length groups. The hybrid runs each group's
    Mamba2 layers so, then its shared block's attention (B6) and fill of
    the group's KV site."""
    T.check_supported(cfg)
    x = T.embed(params, batch, cfg)
    B, S, _ = x.shape
    W, bits = scfg.hot_window, scfg.kv_rate_bits
    dev = x.device
    pos = torch.arange(S, device=dev)[None, :]
    lens_arr = (torch.full((B,), S, dtype=torch.int32, device=dev)
                if lens is None else lens.to(device=dev, dtype=torch.int32))
    idx = torch.clamp(lens_arr - 1, 0, S - 1).long()
    if cfg.family == "ssm":
        cache = init_ssm_cache(cfg, B, dev)
        for i, lp in enumerate(params["layers"]):
            y, st = SSM.mamba1_prefill(
                lp["mixer"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg)
            x = x + y
            cache["ssm.h"][i] = st.h
            cache["ssm.conv"][i] = st.conv
        x_last = x[torch.arange(B, device=dev), idx][:, None]
        return T.unembed(params, x_last, cfg)[:, 0], cache
    mla = cfg.attn_kind == "mla"
    cache = init_cache(cfg, scfg, B, max_len, dev)
    for k in ("lat_scales",) if mla else ("k_scales", "v_scales"):
        cache[k][:, :, S:] = 1.0
    cache["cold_len"][:] = torch.clamp(lens_arr - W, min=0)
    kernel = resolve_quantize_impl(scfg.quantize_impl, dev) == "kernel"
    fill = qpack.prefill_fill if kernel else qpack.prefill_fill_plain
    lfill = qpack.latent_prefill_fill if kernel else \
        qpack.latent_prefill_fill_plain

    def gqa_layer(lp, x, site: int):
        """A GQA block's prefill, filling KV site ``site``: codes, scales
        and ring of K and V (the ring: slot s holds the largest real
        position p = s mod W; p < 0 is no real token, masked out by
        decode's ring test)."""
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        k, v = L.gqa_project_kv(lp["attn"], h, pos, cfg)
        q = L.gqa_project_q(lp["attn"], h, pos, cfg)
        o = L.attention(q, k, v, causal=True, impl=scfg.attn_impl)
        x = x + L.gqa_output(lp["attn"], o, cfg)
        x = x + T.mlp(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)[0]
        fill(k, v, *(cache[n][site] for n in ("k_codes", "k_scales", "k_hot",
                                              "v_codes", "v_scales",
                                              "v_hot")),
             lens_arr, bits)
        return x

    if cfg.family == "hybrid":
        _, period, _ = T.hybrid_groups(cfg)
        for i, lp in enumerate(params["layers"]):
            y, st = SSM.mamba2_prefill(
                lp["mixer"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg)
            x = x + y
            cache["ssm.h"][i] = st.h
            cache["ssm.conv"][i] = st.conv
            if (i + 1) % period == 0:                 # the group's shared block
                g = i // period
                x = gqa_layer(params["shared"][g % len(params["shared"])], x,
                              g)
    elif not mla:
        for i, lp in enumerate(params["layers"]):
            x = gqa_layer(lp, x, i)
    else:
        for i, lp in enumerate(params["layers"]):
            h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
            lat = L.mla_latent(lp["attn"], h, pos, cfg)            # [B,S,R]
            x = x + L.mla_attend(lp["attn"], h, lat, pos, cfg, causal=True,
                                 attn_impl=scfg.attn_impl)
            x = x + L.mlp_apply(lp["mlp"],
                                L.rms_norm(x, lp["ln2"], cfg.norm_eps))
            lfill(lat, cache["lat_codes"][i], cache["lat_scales"][i],
                  cache["lat_hot"][i], lens_arr, bits)

    x_last = x[torch.arange(B, device=dev), idx][:, None]          # [B,1,d]
    return T.unembed(params, x_last, cfg)[:, 0], cache
