"""The training forward on a ``(data, model)`` mesh (the reference's GSPMD
step, ``repro.train.trainer.make_train_step(mesh=)``, where XLA places the
collectives from the params' shardings; here they are explicit).

``MeshModel`` is what ``models/transformer.py`` takes as ``mesh``:

* FSDP over ``data``: a layer's leaves arrive as this rank's blocks and are
  gathered over the data axes of their specs inside the layer (``layer``),
  so under remat a layer's gathered weights live only while it runs and
  are gathered again for its recomputed forward. The gather's backward
  sums the gradient over those axes and keeps the rank's block: a layer's
  gradients are reduced the moment they are complete (``_DataGather``).
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

The families on a sharded mesh are those of GQA attention and a dense MLP
(``MESH_FAMILIES``); the others raise (ROADMAP A.9.5).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common import sharding as SH
from repro_torch.common.types import ModelConfig
from repro_torch.models import layers as L

MODEL = "model"
MESH_FAMILIES = (("dense", "gqa"), ("vlm", "gqa"), ("audio", "gqa"))


def check_mesh_family(cfg: ModelConfig, mesh: SH.Mesh) -> None:
    """Refuse a family the mesh path does not take on a mesh that shards
    anything (a mesh of one rank shards nothing and runs every family)."""
    if mesh.size > 1 and (cfg.family, cfg.attn_kind) not in MESH_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attn_kind!r} on a mesh "
            f"of {dict(mesh.sizes)}: the mesh takes GQA attention with a "
            "dense MLP (dense, vlm, audio); MLA, MoE (expert parallelism "
            "over model), SSM and hybrid are ROADMAP A.9.5")


def without_model(spec: SH.Spec) -> SH.Spec:
    """``spec`` with the model axis taken out: the data axes a rank's
    tensor-parallel block is gathered over."""
    out = []
    for e in spec:
        keep = tuple(a for a in SH._entry_axes(e) if a != MODEL)
        out.append(None if not keep else keep[0] if len(keep) == 1 else keep)
    return tuple(out)


class _DataGather(torch.autograd.Function):
    """A leaf's whole block over the spec's data axes; backward: the
    gradient summed over them, this rank's block kept."""

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
    stacked layout) without their model axis, the config at the rank's
    head counts, and how many ways the batch is split (``batch_ways``:
    the loss is one rank's rows', its gradient scaled by 1 / that)."""

    def __init__(self, cfg: ModelConfig, mesh: SH.Mesh, specs: Dict[str, Any],
                 batch_ways: int):
        self.mesh, self.batch_ways = mesh, batch_ways
        m = mesh.axis_size(MODEL) if MODEL in mesh.sizes else 1
        self.tp = m > 1
        for what, n in (("heads", cfg.num_heads),
                        ("KV heads", cfg.num_kv_heads)):
            if n % m:
                raise ValueError(f"{n} {what} do not split over a model "
                                 f"axis of {m}")
        self.cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // m,
            num_kv_heads=cfg.num_kv_heads // m,
            head_dim=cfg.resolved_head_dim)
        self.top = {k: without_model(v) for k, v in specs.items()
                    if k != "layers"}
        self.layer_specs = SH.map_specs(lambda s: without_model(s)[1:],
                                        specs["layers"])

    def _gather(self, x, spec):
        if self.mesh.spec_axes(spec):
            return _DataGather.apply(x, self.mesh, spec)
        return x

    def layer(self, lp):
        """A layer's leaves gathered over their data axes (in the layer:
        its remat gathers them again)."""
        return SH.map_specs(lambda s, x: self._gather(x, s),
                            self.layer_specs, lp)

    def enter(self, x):
        return _Enter.apply(x, self.mesh) if self.tp else x

    def leave(self, x):
        return _Leave.apply(x, self.mesh) if self.tp else x

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
