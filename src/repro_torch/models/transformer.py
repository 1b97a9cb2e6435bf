"""The language model of the port (``repro.models.transformer``): the
dense family with GQA/MHA or MLA attention (the frontend backbones
chameleon-34b and musicgen-medium among them: the batch may supply
embeddings instead of tokens), the MoE family with GQA attention
(``models/moe.py`` in place of the MLP), the SSM family (Mamba1 mixer
layers, ``models/ssm.py``) and the hybrid family (zamba2-2.7b: groups of
``attn_period`` Mamba2 layers, each group followed by one of
``attn_shared_blocks`` shared attention + MLP blocks, taken in turn):
init, embedding, unembedding, the full-sequence forward and the training
loss.

The reference stacks layers and walks them with ``lax.scan`` (the
hybrid's Mamba2 layers as [G, period, ...]); here ``params["layers"]`` is
a list of per-layer dicts walked by a Python loop, the hybrid's Mamba2
layers flat (layer g * period + j is group g's j-th) and its shared
blocks a list of their own, ``params["shared"]``. The trainer keeps the
reference's stacked layout and hands ``forward`` per-layer views
(``train/trainer.py``).

On a ``(data, model)`` mesh the trainer passes ``mesh`` (a
``models/parallel.py::MeshModel``): each layer gathers its leaves over
``data`` and runs its products tensor-parallel over ``model``; without one
every path is the single-device code. ``param_axes`` is the reference's
logical-axes tree in the trainer's stacked layout.

With ``cfg.remat`` and a graph being recorded, each layer (the hybrid: each
group with its shared block, as the reference's ``jax.checkpoint`` does) is
rematerialised in the backward pass (``torch.utils.checkpoint``,
non-reentrant): only its input is kept, and its forward, B6's launch
included, runs again. Without a param that requires grad (serving), no
layer is wrapped.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.types import ModelConfig, SSMConfig
from repro_torch.common.utils import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Refuses what the reference cannot serve either: the SSM family with
    Mamba2 mixers (its decode runs Mamba1's step) and the hybrid family
    with anything but Mamba2 mixers and GQA attention."""
    kind = (cfg.ssm or SSMConfig()).kind
    if (cfg.family, cfg.attn_kind) not in (
            ("dense", "gqa"), ("dense", "mla"), ("moe", "gqa"),
            ("vlm", "gqa"), ("audio", "gqa"), ("ssm", "none"),
            ("hybrid", "gqa")) or \
            (cfg.family == "ssm" and kind != "mamba1") or \
            (cfg.family == "hybrid" and kind != "mamba2"):
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attn_kind!r}: the port "
            "serves the dense family (the vlm and audio backbones too), GQA "
            "or MLA attention, the MoE family with GQA attention, the SSM "
            "family with Mamba1 mixers and the hybrid family with Mamba2 "
            "mixers and GQA attention")


def hybrid_groups(cfg: ModelConfig):
    """The hybrid's (groups, period, shared blocks): group g runs Mamba2
    layers [g * period, (g + 1) * period), then shared block g % shared."""
    period = cfg.attn_period or cfg.num_layers
    return cfg.num_layers // period, period, cfg.attn_shared_blocks


def mlp(lp: Params, h: torch.Tensor, cfg: ModelConfig, mesh=None):
    """A layer's MLP: (out, aux loss), the experts for the MoE family (the
    dense MLP's aux is the number 0: no launch on the decode path). On a
    mesh the output is partial over ``model``; the dense MLP's input is
    entered by the caller, the experts enter their own."""
    if cfg.family == "moe":
        return MOE.moe_apply(lp["mlp"], h, cfg, mesh)
    return L.mlp_apply(lp["mlp"], h), 0.0


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller names another), stored in ``cfg.dtype``. On the
    meta device (shapes and types only, nothing allocated: the dry run)
    no generator is made: the meta device takes none."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg)
    d = cfg.d_model
    params: Params = {
        "tok_embed": L.init_dense((cfg.vocab_size, d), gen, dtype, dev,
                                  scale=0.02),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense((d, cfg.vocab_size), gen, dtype, dev,
                                         scale=0.02)
    if cfg.family in ("ssm", "hybrid"):
        init = SSM.mamba2_init if cfg.family == "hybrid" else \
            SSM.mamba1_init
        params["layers"] = [
            {"mixer": init(gen, cfg, dtype, dev),
             "ln": torch.ones((d,), dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]
        if cfg.family == "hybrid":
            params["shared"] = [_layer_init(gen, cfg, dtype, dev)
                                for _ in range(hybrid_groups(cfg)[2])]
        return params
    params["layers"] = [_layer_init(gen, cfg, dtype, dev)
                        for _ in range(cfg.num_layers)]
    return params


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The logical axes of every leaf in the trainer's stacked layout (the
    tree the reference's ``init_params`` returns): a stacked leaf leads
    with "layers", the hybrid's Mamba2 leaves with two ([G, period])."""
    def stacked(axes, lead=("layers",)):
        return {k: stacked(v, lead) if isinstance(v, dict) else lead + v
                for k, v in axes.items()}

    axes: Dict[str, Any] = {"tok_embed": ("vocab", "embed"),
                            "final_norm": ("embed",)}
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    attn_layer = {
        "attn": dict(L.MLA_AXES if cfg.attn_kind == "mla" else L.GQA_AXES),
        "mlp": MOE.moe_axes(cfg) if cfg.family == "moe" else
        dict(L.MLP_AXES), "ln1": ("embed",), "ln2": ("embed",)}
    if cfg.family == "ssm":
        axes["layers"] = stacked({"mixer": SSM.MAMBA1_AXES, "ln": ("embed",)})
    elif cfg.family == "hybrid":
        axes["layers"] = stacked({"mixer": SSM.MAMBA2_AXES, "ln": ("embed",)},
                                 ("layers", "layers"))
        axes["shared"] = stacked(attn_layer)
    else:
        axes["layers"] = stacked(attn_layer)
    return axes


def _layer_init(gen, cfg: ModelConfig, dtype, dev) -> Params:
    """One attention + MLP (or experts) layer."""
    d = cfg.d_model
    return {"attn": (L.mla_init if cfg.attn_kind == "mla" else L.gqa_init)(
                gen, cfg, dtype, dev),
            "mlp": (MOE.moe_init(gen, cfg, dtype, dev) if cfg.family == "moe"
                    else L.mlp_init(gen, d, cfg.d_ff, dtype, dev)),
            "ln1": torch.ones((d,), dtype=dtype, device=dev),
            "ln2": torch.ones((d,), dtype=dtype, device=dev)}


def embed(params: Params, batch: Dict[str, torch.Tensor],
          cfg: ModelConfig) -> torch.Tensor:
    dtype = L.torch_dtype(cfg)
    if cfg.frontend != "none" and "embeds" in batch:
        return batch["embeds"].to(dtype)
    return params["tok_embed"].to(dtype)[batch["tokens"].long()]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ w.to(x.dtype)


def tensors(tree):
    """The tensors of a nest of dicts and lists, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _remat(on: bool, fn, *args):
    """``fn(*args)``, rematerialised in the backward pass when ``on`` (no
    RNG runs inside a layer, so its state is not stashed)."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            attn_impl: str = "auto", mesh=None):
    """Full-sequence forward. Returns (logits [B,S,V], aux loss: the sum of
    the MoE layers' load-balance losses, 0 for the other families).
    ``mesh``: a ``MeshModel`` (params are this rank's blocks)."""
    check_supported(cfg)
    remat = cfg.remat and torch.is_grad_enabled() and \
        any(t.requires_grad for t in tensors(params))
    x = embed(params, batch, cfg) if mesh is None else \
        mesh.embed(params, batch, cfg)
    aux = 0.0
    if cfg.family in ("ssm", "hybrid"):
        mixer = SSM.mamba2_apply_train if cfg.family == "hybrid" else \
            SSM.mamba1_apply_train
        period = hybrid_groups(cfg)[1] if cfg.family == "hybrid" else 1

        def group(x, g):
            lps = params["layers"][g * period:(g + 1) * period]
            for lp in lps:
                if mesh is not None:
                    lp = mesh.layer(lp)
                x = x + mixer(lp["mixer"], L.rms_norm(x, lp["ln"],
                                                      cfg.norm_eps), cfg,
                              mesh)
            if cfg.family == "hybrid":          # the group's shared block
                sp = params["shared"][g % len(params["shared"])]
                x = _attn_block(sp, x, cfg, attn_impl, mesh, "shared")[0]
            return x

        for g in range(len(params["layers"]) // period):
            x = _remat(remat, group, x, g)
    else:
        for lp in params["layers"]:
            x, a = _remat(remat, _attn_block, lp, x, cfg, attn_impl, mesh)
            aux = aux + a
    logits = unembed(params, x, cfg) if mesh is None else \
        mesh.unembed(params, x, cfg)
    return logits, torch.as_tensor(aux, dtype=torch.float32)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            attn_impl: str = "auto", mesh=None):
    """Mean next-token cross entropy over the labels >= 0, from the logits'
    float32 log-softmax, plus the aux loss: (loss, {"xent", "aux"}). A
    negative label is masked out (the reference gathers it out of bounds
    before masking; the synthetic data has none)."""
    logits, aux = forward(params, batch, cfg, attn_impl, mesh)
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    xent = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return xent + aux, {"xent": xent, "aux": aux}


def _attn_block(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                attn_impl: str, mesh=None, unit: str = "layers"):
    """Pre-norm attention then MLP (or experts): (x, aux loss). On a mesh:
    the layer's leaves gathered over data (``unit``: the stack they come
    from), each product tensor-parallel at the rank's head counts
    (``mesh.cfg``); MLA enters its latents and the experts their input
    (``layers.mla_apply_train``, ``moe.moe_apply``), not the normed
    input."""
    attn = L.mla_apply_train if cfg.attn_kind == "mla" else L.gqa_apply_train
    if mesh is None:
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn(lp["attn"], h, cfg, attn_impl)
        y, a = mlp(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        return x + y, a
    lp = mesh.layer(lp, unit)
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.attn_kind == "mla":
        o = attn(lp["attn"], h, mesh.cfg, attn_impl, mesh)
    else:
        o = attn(lp["attn"], mesh.enter(h), mesh.cfg, attn_impl)
    x = x + mesh.leave(o)
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, a = mlp(lp, h if cfg.family == "moe" else mesh.enter(h), mesh.cfg,
               mesh)
    return x + mesh.leave(y), a
