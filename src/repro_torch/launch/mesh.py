"""Meshes over the current ranks and the per-shape rule tables (the
reference's ``repro.launch.mesh``).

``make_mesh``/``make_production_mesh`` lay the ranks of the group
``common.sharding.init_expander_ranks`` joined (one process a device) out
as a ``common.sharding.Mesh``; the world size must be the shape's product.
The rule tables are the reference's, entry for entry: the training table is
``DEFAULT_RULES`` (FSDP over data, tensor parallel over model), decode
shards the batch, long-context decode the KV sequence; an arch whose KV
heads do not divide the model axis shards the KV sequence over model
instead (``rules_for``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from repro_torch.common import sharding as SH
from repro_torch.common.types import MeshConfig, ModelConfig, ShapeConfig


def make_mesh(cfg: MeshConfig, group: Optional[SH.ExpanderGroup] = None
              ) -> SH.Mesh:
    """``cfg``'s mesh over ``group``'s ranks (default: the current group;
    none raises). Every rank calls it."""
    group = SH.current_group() if group is None else group
    if group.world != cfg.num_devices:
        raise ValueError(f"a mesh of {cfg.shape} over {cfg.axes} needs "
                         f"{cfg.num_devices} ranks; the group has "
                         f"{group.world}")
    return SH.Mesh(cfg.shape, cfg.axes, group.rank, group.device)


def make_production_mesh(*, multi_pod: bool = False,
                         group: Optional[SH.ExpanderGroup] = None) -> SH.Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(MeshConfig(shape=shape, axes=axes), group)


# ---------------------------------------------------------------------------
# Rule tables per shape kind.
# ---------------------------------------------------------------------------

TRAIN_RULES = SH.DEFAULT_RULES

# decode: batch carries the data parallelism; KV seq local; heads on model.
DECODE_RULES: Tuple[Tuple[str, object], ...] = tuple(
    dict(SH.DEFAULT_RULES, **{
        "batch": ("pod", "data"),
        "kv_seq": None,
    }).items())

# long-context decode (global_batch=1): the *sequence* carries the data
# parallelism, chunk-parallel attention partials merged by an all-reduce.
LONG_RULES: Tuple[Tuple[str, object], ...] = tuple(
    dict(SH.DEFAULT_RULES, **{
        "batch": None,
        "kv_seq": ("pod", "data"),
        "fsdp": None,              # batch=1: keep params on "model" only
    }).items())


def rules_for(shape: ShapeConfig, mesh_axes: Sequence[str],
              cfg: Optional[ModelConfig] = None, model_size: int = 16):
    if shape.kind == "train":
        return TRAIN_RULES
    base = LONG_RULES if shape.name.startswith("long") else DECODE_RULES
    if cfg is None:
        return base
    # archs whose KV head count does not divide the model axis shard the KV
    # *sequence* over "model" instead
    kv_ok = cfg.attn_kind != "mla" and cfg.num_kv_heads % model_size == 0
    if not kv_ok:
        d = dict(base)
        d["kv_heads"] = None
        prev = d.get("kv_seq")
        d["kv_seq"] = (prev or ()) + ("model",)
        d["kv_hot"] = ("model",)   # ring W axis takes the model shards
        return tuple(d.items())
    return base


def batch_shards(shape: ShapeConfig, mesh) -> int:
    """How many ways the global batch is split on ``mesh`` (a ``Mesh`` or a
    ``MeshConfig``)."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    return sizes.get("data", 1) * sizes.get("pod", 1)
