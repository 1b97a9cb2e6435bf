"""The training forward on a ``(data, model)`` mesh (the reference's GSPMD
step, ``repro.train.trainer.make_train_step(mesh=)``, where XLA places the
collectives from the params' shardings; here they are explicit).

``MeshModel`` is what ``models/transformer.py`` takes as ``mesh``:

* FSDP over ``data``: a layer's leaves arrive as this rank's blocks and are
  gathered over the data axes of their specs inside the layer (``layer``),
  so under remat a layer's gathered weights live only while it runs and
  are gathered again for its recomputed forward. The gather's backward
  sums the gradient over those axes and keeps the rank's block: a layer's
  gradients are reduced the moment they are complete (``_Gather``).
* Tensor parallelism over ``model`` (Megatron-LM's f and g): the
  column-parallel products (wq/wk/wv, wi/wg: whole heads and MLP columns a
  rank) take their input through ``enter`` (identity forward, psum of the
  gradient backward); the row-parallel ones (both ``wo``) hand their
  partial sums through ``leave`` (psum forward, identity backward). B6 sees
  plain tensors of the rank's heads (``cfg``: the config at the rank's
  head counts).
* The vocab-sharded embedding is a masked lookup of the rank's rows, then
  ``leave``. The unembedding's logits are gathered over ``model``
  (``_GatherLogits``, whose backward keeps the rank's columns) and the loss
  is the reference's on the whole logits: B x S x V a rank, what one
  device holds without a mesh.
* Every family: MLA takes its two latents on every rank and enters them
  (not its normed input, which would count each gradient twice): its
  ``wq_b``/``wkv_b`` columns and ``wo`` rows are the rank's heads. MoE
  runs the rank's experts (``("expert", ...)``: E / M a rank) over every
  token, which ``model`` replicates, and leaves the partial combine; a
  routing call over the batch's ranks is the reference's call
  (``models/moe.py``). A mixer's ``in_proj`` is gathered whole, model
  included (``WHOLE``: its contiguous model block is not the rank's
  channels) and sliced to them; Mamba1's partial (dt, B, C) and Mamba2's
  gated norm's sum of squares are summed over ``model`` both ways
  (``mix``). A leaf ``model`` replicates but a rank reads only in part
  (Mamba2's per-head leaves, at the rank's heads) is entered: its
  gradient is partial on every rank, and the copies would drift apart
  after one update without the psum.
* Over the batch's ranks, the MoE aux loss's sums are the whole call's
  (``batch_sum``, whose backward weights the rank's share so that the
  gradient summed over the ranks and scaled as the cross entropy's is the
  reference's) and the dispatch's counts are gathered (``batch_rows``).

``check_splits`` refuses, before anything is made, a model axis that does
not split the heads, KV heads, experts or Mamba heads and channels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common import sharding as SH
from repro_torch.common.types import ModelConfig, MoEConfig, SSMConfig
from repro_torch.models import layers as L

MODEL = "model"
# a layer's leaves gathered whole, their model axis included
WHOLE = frozenset({("mixer", "in_proj")})


def check_splits(cfg: ModelConfig, mesh) -> None:
    """A ValueError where the model axis of ``mesh`` (anything with
    ``sizes``) does not split the heads, KV heads, experts or Mamba heads
    (Mamba2) or channels (Mamba1)."""
    counts = []
    if cfg.attn_kind != "none":
        counts += [("heads", cfg.num_heads), ("KV heads", cfg.num_kv_heads)]
    if cfg.family == "moe":
        counts.append(("experts", (cfg.moe or MoEConfig()).num_experts))
    if cfg.family in ("ssm", "hybrid"):
        ssm = cfg.ssm or SSMConfig()
        d_in = ssm.expand * cfg.d_model
        counts.append(("Mamba heads", d_in // ssm.headdim)
                      if ssm.kind == "mamba2" else ("Mamba channels", d_in))
    m = mesh.sizes.get(MODEL, 1)
    for what, n in counts:
        if n % m:
            raise ValueError(f"{n} {what} do not split over a model axis "
                             f"of {m}")


def without_model(spec: SH.Spec) -> SH.Spec:
    """``spec`` with the model axis taken out: the data axes a rank's
    tensor-parallel block is gathered over."""
    out = []
    for e in spec:
        keep = tuple(a for a in SH._entry_axes(e) if a != MODEL)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


def unit_spec(path, spec: SH.Spec, lead: int) -> SH.Spec:
    """A stacked leaf's spec as a layer gathers it: its ``lead`` stacked
    dims dropped, the model axis kept only for ``WHOLE``."""
    spec = tuple(spec) + (None,) * max(lead - len(spec), 0)
    return (spec if tuple(path[-2:]) in WHOLE else without_model(spec))[lead:]


class _Gather(torch.autograd.Function):
    """A leaf's whole block over the spec's axes; backward: the gradient
    summed over them, this rank's block kept (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.mesh, ctx.spec = mesh, spec
        return mesh.gather(x, spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.scatter(g.contiguous(), ctx.spec), None, None


class _Enter(torch.autograd.Function):
    """Identity forward; the gradient summed over ``model`` backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.psum(g.contiguous(), MODEL), None


class _Leave(torch.autograd.Function):
    """The partial sums summed over ``model``; identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.psum(x.contiguous(), MODEL)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _BatchSum(torch.autograd.Function):
    """The sum over the batch's ranks; backward: the gradient times their
    count (each rank's loss is scaled by 1 / that count, and a value every
    rank shares must count whole once the ranks' gradients are summed)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, ways):
        ctx.ways = ways
        return mesh.psum(x.contiguous(), axes)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.ways, None, None, None


class _GatherLogits(torch.autograd.Function):
    """Every rank's vocab columns of the logits; backward: this rank's
    columns of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        ctx.spec = (None,) * (x.dim() - 1) + (MODEL,)
        return mesh.gather(x.contiguous(), ctx.spec)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.shard(g, ctx.spec), None


class MeshModel:
    """The model's view of a mesh: the params' specs (the trainer's
    stacked layout) as a layer gathers them, the config at the rank's
    head counts, the model axis (``tp``: more than one rank; ``m`` ranks,
    this one ``mi``) and the batch's axes (``batch_ways`` ranks, this one
    ``batch_index``: the loss is one rank's rows', its gradient scaled by
    1 / ``batch_ways``)."""

    def __init__(self, cfg: ModelConfig, mesh: SH.Mesh, specs: Dict[str, Any],
                 batch_spec: SH.Spec):
        self.mesh = mesh
        self.batch_spec = batch_spec
        self.batch_axes = mesh.spec_axes(batch_spec)
        self.batch_ways = mesh.axis_size(self.batch_axes)
        self.batch_index = mesh._ways(batch_spec[0])[1] if batch_spec else 0
        self.m = mesh.axis_size(MODEL) if MODEL in mesh.sizes else 1
        self.mi = mesh.coord.get(MODEL, 0)
        self.tp = self.m > 1
        self.cfg = cfg if cfg.attn_kind == "none" else dataclasses.replace(
            cfg, num_heads=cfg.num_heads // self.m,
            num_kv_heads=cfg.num_kv_heads // self.m,
            head_dim=cfg.resolved_head_dim)
        self.top = {k: without_model(v) for k, v in specs.items()
                    if k not in ("layers", "shared")}
        lead = {"layers": 2 if cfg.family == "hybrid" else 1, "shared": 1}
        self.unit_specs = {
            name: _map_spec_paths(lambda path, s, n=lead[name]:
                                  unit_spec(path, s, n), specs[name])
            for name in lead if name in specs}

    def _gather(self, x, spec):
        if self.mesh.spec_axes(spec):
            return _Gather.apply(x, self.mesh, spec)
        return x

    def layer(self, lp, name: str = "layers"):
        """A layer's leaves gathered over their data axes (``WHOLE`` over
        every axis; in the layer: its remat gathers them again)."""
        return SH.map_specs(lambda s, x: self._gather(x, s),
                            self.unit_specs[name], lp)

    def enter(self, x):
        return _Enter.apply(x, self.mesh) if self.tp else x

    def leave(self, x):
        return _Leave.apply(x, self.mesh) if self.tp else x

    def mix(self, x):
        """The partial sums summed over ``model`` both ways: forward and
        the gradient (a value that is partial on every rank and read by
        every rank's part of the path)."""
        return self.enter(self.leave(x))

    def block(self, n: int) -> slice:
        """The rank's block of n things (heads, channels, experts) that
        ``model`` splits."""
        k = n // self.m
        return slice(self.mi * k, (self.mi + 1) * k)

    def batch_sum(self, x):
        """``x`` summed over the batch's ranks (``_BatchSum``)."""
        if self.batch_ways == 1:
            return x
        return _BatchSum.apply(x, self.mesh, self.batch_axes, self.batch_ways)

    def batch_rows(self, x):
        """Every batch rank's ``x`` (no gradient), [ranks, ...] in the
        batch's order: one all_reduce of a zero-filled buffer."""
        buf = x.new_zeros((self.batch_ways,) + tuple(x.shape))
        buf[self.batch_index] = x
        return self.mesh.psum(buf, self.batch_axes)

    def embed(self, params, batch, cfg: ModelConfig) -> torch.Tensor:
        dtype = L.torch_dtype(cfg)
        if cfg.frontend != "none" and "embeds" in batch:
            return batch["embeds"].to(dtype)
        table = self._gather(params["tok_embed"], self.top["tok_embed"])
        tokens = batch["tokens"].long()
        if not self.tp:
            return table.to(dtype)[tokens]
        n = table.shape[0]
        ids = tokens - self.mesh.coord[MODEL] * n
        hit = ((ids >= 0) & (ids < n)).to(dtype)[..., None]
        return self.leave(table.to(dtype)[ids.clamp(0, n - 1)] * hit)

    def unembed(self, params, x, cfg: ModelConfig) -> torch.Tensor:
        norm = self._gather(params["final_norm"], self.top["final_norm"])
        x = L.rms_norm(x, norm, cfg.norm_eps)
        if cfg.tie_embeddings:
            w = self._gather(params["tok_embed"], self.top["tok_embed"]).T
        else:
            w = self._gather(params["lm_head"], self.top["lm_head"])
        logits = self.enter(x) @ w.to(x.dtype)
        return _GatherLogits.apply(logits, self.mesh) if self.tp else logits


def _map_spec_paths(fn, specs, path=()):
    """``fn(path, spec)`` over a dict tree of specs."""
    if isinstance(specs, dict):
        return {k: _map_spec_paths(fn, v, path + (k,))
                for k, v in specs.items()}
    return fn(path, specs)
