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
             cfg: ModelConfig, xin: torch.Tensor = None) -> torch.Tensor:
    """Run the held experts over the dispatched rows ``xe`` [E'*C'+1, D]
    (the last row the drop bin; E' the experts ``p`` holds) and gather each
    pair's output at its row (``slots`` [N, k], the drop bin reading
    zeros), weighted by its routing probability in x's dtype; plus arctic's
    dense residual of ``xin`` (x where not given)."""
    mo = cfg.moe or MoEConfig()
    d = x.shape[-1]
    ye = _experts(p, xe[:-1].reshape(p["wi"].shape[0], -1, d)).reshape(-1, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))])
    out = torch.einsum("nkd,nk->nd", ye[slots], top_p.to(x.dtype))
    out = out.reshape(x.shape)
    if mo.dense_residual and "dense" in p:
        out = out + L.mlp_apply(p["dense"], x if xin is None else xin)
    return out


class _Call:
    """Where a routing call's tokens and experts lie: on one device, the
    whole call and every expert; on a mesh (``mesh``, a
    ``models/parallel.py::MeshModel``), the call spread over the batch's
    ranks (this rank's tokens the ``batch_index``-th share) and the
    experts over ``model`` (this rank's the ``mi``-th block)."""

    def __init__(self, mesh, n: int, e: int):
        self.mesh = mesh
        self.ways = 1 if mesh is None else mesh.batch_ways
        self.n = n * self.ways                       # the call's tokens
        held = slice(0, e) if mesh is None else mesh.block(e)
        self.e0, self.held = held.start, held.stop - held.start

    def mean(self, probs: torch.Tensor) -> torch.Tensor:
        """The mean of ``probs`` [n, E] over the call (its gradient the
        whole call's: ``MeshModel.batch_sum``)."""
        if self.ways == 1:
            return probs.mean(dim=0)
        return self.mesh.batch_sum(probs.sum(dim=0)) / self.n

    def counts(self, c: torch.Tensor):
        """(counts before this rank's tokens, the call's counts) of the
        per-expert counts ``c``."""
        if self.ways == 1:
            return torch.zeros_like(c), c
        rows = self.mesh.batch_rows(c)
        return rows[:self.mesh.batch_index].sum(dim=0), rows.sum(dim=0)

    def enter(self, x):
        return x if self.mesh is None else self.mesh.enter(x)

    def local(self, ex: torch.Tensor, keep: torch.Tensor):
        """(the held experts' index of ``ex``, whether the pair is kept
        here: kept by the capacity and its expert held)."""
        le = ex - self.e0
        return le, keep & (le >= 0) & (le < self.held)


def moe_apply_sorted(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based capacity dispatch (decode and short prompts). On a mesh
    the call's tokens are spread over the batch's ranks: C counts all of
    them, and a pair's position counts the same expert's pairs of lower
    ranks first (their counts gathered in one all_reduce)."""
    mo = cfg.moe or MoEConfig()
    B, S, d = x.shape
    e, k = mo.num_experts, mo.top_k
    n = B * S
    call = _Call(mesh, n, e)
    cap = capacity(k, call.n, e)
    xf = x.reshape(n, d)
    probs, top_p, top_i = route(p["router"], xf, k)

    # group the (token, choice) pairs by expert: token, then choice order
    flat_e = top_i.reshape(n * k)
    order = torch.argsort(flat_e, stable=True)
    sort_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    before, total = call.counts(counts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=x.device) - starts[sort_e]
    le, kept = call.local(sort_e, pos + before[sort_e] < cap)
    slot = torch.where(kept, le * cap + pos, call.held * cap)   # drop bin

    # dispatch: kept rows are unique, so each is 0 + its token exactly
    xin = call.enter(x)
    xe = torch.zeros((call.held * cap + 1, d), dtype=x.dtype,
                     device=x.device)
    xe.index_add_(0, slot, xin.reshape(n, d)[order // k])
    slots = torch.empty_like(slot)
    slots[order] = slot
    out = _combine(p, x, slots.reshape(n, k), xe, call.enter(top_p), cfg,
                   xin)

    # switch-style aux loss over the routed (pre-drop) assignment
    frac = total.to(torch.float32) / (call.n * k)
    aux = torch.sum(frac * call.mean(probs.reshape(n, e))) * e * \
        mo.load_balance_coef
    return out, aux


def moe_apply_grouped(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped dispatch: groups of GROUP_TOKENS tokens, a
    capacity per (group, expert), choices filled in order j = 0..k-1. On a
    mesh each group lies whole on one of the batch's ranks (a ValueError
    otherwise), and the aux loss's sums are the call's."""
    mo = cfg.moe or MoEConfig()
    B, S, d = x.shape
    e, k = mo.num_experts, mo.top_k
    n = B * S
    call = _Call(mesh, n, e)
    sg = min(GROUP_TOKENS, call.n)
    if n % sg:
        raise ValueError(f"{n} tokens a rank of a routing call of "
                         f"{call.n}: its groups of {sg} would straddle ranks")
    g = n // sg
    cap = capacity(k, sg, e)
    xg = x.reshape(g, sg, d)
    probs, top_p, top_i = route(p["router"], xg, k)          # [G,Sg,..]

    gi = torch.arange(g, device=x.device)[:, None]
    fill = torch.zeros((g, e), dtype=torch.int64, device=x.device)
    kept = torch.zeros((e,), dtype=torch.float32, device=x.device)
    drop = call.held * g * cap
    slots = []
    for j in range(k):
        ej = top_i[..., j]                                     # [G,Sg]
        oh = F.one_hot(ej, e)                                  # [G,Sg,E]
        # the pair's row: the group's fill so far plus the earlier tokens
        # of the group with the same choice j
        pos = (fill[:, None, :] + torch.cumsum(oh, dim=1) - oh).gather(
            -1, ej[..., None])[..., 0]
        keep = pos < cap
        le, here = call.local(ej, keep)
        slots.append(torch.where(here, (le * g + gi) * cap + pos, drop))
        kept += (oh * keep[..., None]).sum(dim=(0, 1)).to(torch.float32)
        fill = fill + oh.sum(dim=1)
    slots = torch.stack(slots, dim=-1).reshape(n, k)           # [N,k]

    # dispatch into [E', G, C, D] (+ the drop bin); kept rows are unique
    xin = call.enter(x)
    xf = xin.reshape(n, d)
    xe = torch.zeros((drop + 1, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        xe.index_add_(0, slots[:, j], xf)
    out = _combine(p, x, slots, xe, call.enter(top_p.reshape(n, k)), cfg,
                   xin)

    frac = call.counts(kept)[1] / call.n
    aux = torch.sum(frac * call.mean(probs.reshape(n, e))) * e * \
        mo.load_balance_coef
    return out, aux


def moe_apply(p: Params, x: torch.Tensor, cfg: ModelConfig, mesh=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (out [B,S,D], aux load-balance loss scalar): the
    grouped form from 2 * GROUP_TOKENS tokens in the call (padding
    counted; on a mesh, over the batch's ranks), else the sorted form. On
    a mesh (``mesh``, the trainer's ``MeshModel``) ``p`` holds the rank's
    experts and the output is their partial sum over ``model``."""
    B, S, _ = x.shape
    ways = 1 if mesh is None else mesh.batch_ways
    form = moe_apply_grouped if B * S * ways >= 2 * GROUP_TOKENS else \
        moe_apply_sorted
    return form(p, x, cfg) if mesh is None else form(p, x, cfg, mesh)
