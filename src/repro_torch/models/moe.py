"""Mixture-of-Experts layer of the port (``repro.models.moe``): qwen3-moe
(128 experts, top-8) and arctic (128 experts, top-2, plus a dense residual
MLP).

Capacity dispatch as the reference does it: each (token, choice) pair gets
a row of its expert's buffer of C rows, pairs past C are dropped, and the
experts run as one batched product over [E, C, D]. Two forms, chosen by
the token count as the reference chooses (``moe_apply``):

  * sorted (decode, short prompts): one stable argsort of the flattened
    choices groups the pairs by expert (token order, then choice order
    within an expert), C = ceil(k*N*cf/E) over all N tokens;
  * grouped (B*S >= 2*GROUP_TOKENS): the tokens in groups of GROUP_TOKENS,
    a capacity per group, C = ceil(k*Sg*cf/E), filled choice by choice
    (every token's first choice before any token's second).

The reference builds the grouped form's dispatch and combine as one-hot
[G, Sg, E, C] tensors contracted with einsums; here each kept pair's row
is an index, the dispatch a scatter into [E, G, C, D] and the combine a
gather, which computes the same sums (a row holds one token or zeros).
The expert products are plain ``torch.bmm``: large matrix products that
the reference leaves to XLA, outside any Pallas kernel.

Routing ties: ``jax.lax.top_k`` takes the lower expert index first among
equal probabilities and ``jnp.argsort`` is stable; a stable descending
sort and a stable argsort do the same here. Which pairs a capacity drops
depends on every token of the call, padding and idle lanes included.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig, MoEConfig
from repro_torch.models import layers as L

Params = Dict[str, Any]

CAPACITY_FACTOR = 1.25
GROUP_TOKENS = 512   # grouped dispatch: tokens per routing group


def moe_init(gen, cfg: ModelConfig, dtype, device) -> Params:
    """Router and expert weights (the reference's ``moe_init``: fan-in of
    the expert weights from their leading axis, E, as its ``_init`` takes
    it), plus arctic's dense residual MLP."""
    mo = cfg.moe or MoEConfig()
    d, f, e = cfg.d_model, mo.expert_d_ff, mo.num_experts
    p = {"router": L.init_dense((d, e), gen, dtype, device, scale=0.02),
         "wi": L.init_dense((e, d, f), gen, dtype, device),
         "wg": L.init_dense((e, d, f), gen, dtype, device),
         "wo": L.init_dense((e, f, d), gen, dtype, device,
                            scale=1.0 / (f ** 0.5))}
    if mo.dense_residual:
        p["dense"] = L.mlp_init(gen, d, mo.dense_d_ff or cfg.d_ff, dtype,
                                device)
    return p


def moe_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of ``moe_init``'s leaves (the reference's)."""
    axes: Dict[str, Any] = {"router": ("fsdp", None),
                            "wi": ("expert", "fsdp", "expert_mlp"),
                            "wg": ("expert", "fsdp", "expert_mlp"),
                            "wo": ("expert", "expert_mlp", "fsdp")}
    if (cfg.moe or MoEConfig()).dense_residual:
        axes["dense"] = dict(L.MLP_AXES)
    return axes


def capacity(k: int, tokens: int, e: int) -> int:
    """Rows an expert's buffer holds: ceil(k * tokens * cf / E), at least
    1 (the reference's float arithmetic)."""
    return max(1, int(-(-(k * tokens * CAPACITY_FACTOR) // e)))


def route(router: torch.Tensor, x: torch.Tensor, k: int):
    """x [..., D] -> (probs [..., E] f32, top_p [..., k] f32 summing to 1,
    top_i [..., k] int64): the softmax of the f32 router logits and its k
    largest, the lower expert index first among equal values."""
    probs = torch.softmax((x @ router.to(x.dtype)).to(torch.float32), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = vals[..., :k], idx[..., :k]
    return probs, top_p / top_p.sum(dim=-1, keepdim=True), top_i


def _experts(p: Params, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its rows: xe [E, R, D] -> [E, R, D]."""
    dt = xe.dtype
    h = F.silu(torch.bmm(xe, p["wg"].to(dt))) * torch.bmm(xe, p["wi"].to(dt))
    return torch.bmm(h, p["wo"].to(dt))


def _combine(p: Params, x: torch.Tensor, slots: torch.Tensor,
             xe: torch.Tensor, top_p: torch.Tensor,
             cfg: ModelConfig) -> torch.Tensor:
    """Run the experts over the dispatched rows ``xe`` [E*C'+1, D] (the
    last row the drop bin) and gather each pair's output at its row
    (``slots`` [N, k], the drop bin reading zeros), weighted by its routing
    probability in x's dtype; plus arctic's dense residual."""
    mo = cfg.moe or MoEConfig()
    d = x.shape[-1]
    ye = _experts(p, xe[:-1].reshape(mo.num_experts, -1, d)).reshape(-1, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    out = torch.einsum("nkd,nk->nd", ye[slots], top_p.to(x.dtype))
    out = out.reshape(x.shape)
    if mo.dense_residual and "dense" in p:
        out = out + L.mlp_apply(p["dense"], x)
    return out


def moe_apply_sorted(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch (decode and short prompts)."""
    mo = cfg.moe or MoEConfig()
    B, S, d = x.shape
    e, k = mo.num_experts, mo.top_k
    n = B * S
    cap = capacity(k, n, e)
    xf = x.reshape(n, d)
    probs, top_p, top_i = route(p["router"], xf, k)

    # group the (token, choice) pairs by expert: token, then choice order
    flat_e = top_i.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    sort_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=x.device) - starts[sort_e]
    slot = torch.where(pos < cap, sort_e * cap + pos, e * cap)   # drop bin

    # dispatch: kept rows are unique, so each is 0 + its token exactly
    xe = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    xe.index_add_(0, slot, xf[order // k])
    slots = torch.empty_like(slot)
    slots[order] = slot
    out = _combine(p, x, slots.reshape(n, k), xe, top_p, cfg)

    # switch-style aux loss over the routed (pre-drop) assignment
    frac = counts.to(torch.float32) / (n * k)
    aux = torch.sum(frac * probs.mean(dim=0)) * e * mo.load_balance_coef
    return out, aux


def moe_apply_grouped(p: Params, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped dispatch: groups of GROUP_TOKENS tokens, a
    capacity per (group, expert), choices filled in order j = 0..k-1."""
    mo = cfg.moe or MoEConfig()
    B, S, d = x.shape
    e, k = mo.num_experts, mo.top_k
    n = B * S
    sg = min(GROUP_TOKENS, n)
    g = n // sg
    cap = capacity(k, sg, e)
    xg = x.reshape(g, sg, d)
    probs, top_p, top_i = route(p["router"], xg, k)          # [G,Sg,..]

    gi = torch.arange(g, device=x.device)[:, None]
    fill = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    kept = torch.zeros((e,), dtype=torch.float32, device=x.device)
    slots = []
    for j in range(k):
        ej = top_i[..., j]                                     # [G,Sg]
        oh = F.one_hot(ej, e)                                  # [G,Sg,E]
        # the pair's row: the group's fill so far plus the earlier tokens
        # of the group with the same choice j
        pos = (fill[:, None, :] + torch.cumsum(oh, dim=1) - oh).gather(
            -1, ej[..., None])[..., 0]
        keep = pos < cap
        slots.append(torch.where(keep, (ej * g + gi) * cap + pos,
                                 e * g * cap))
        kept += (oh * keep[..., None]).sum(dim=(0, 1)).to(torch.float32)
        fill = fill + oh.sum(dim=1)
    slots = torch.stack(slots, dim=-1).reshape(n, k)           # [N,k]

    # dispatch into [E, G, C, D] (+ the drop bin); kept rows are unique
    xf = x.reshape(n, d)
    xe = torch.zeros((e * g * cap + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        xe.index_add_(0, slots[:, j], xf)
    out = _combine(p, x, slots, xe, top_p.reshape(n, k), cfg)

    frac = kept / n
    aux = torch.sum(frac * probs.reshape(n, e).mean(dim=0)) * e * \
        mo.load_balance_coef
    return out, aux


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux load-balance loss scalar): the
    grouped form from 2 * GROUP_TOKENS tokens (padding counted), else the
    sorted form."""
    B, S, _ = x.shape
    if B * S >= 2 * GROUP_TOKENS:
        return moe_apply_grouped(p, x, cfg)
    return moe_apply_sorted(p, x, cfg)
