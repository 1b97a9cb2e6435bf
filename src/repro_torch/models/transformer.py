"""The language model of the port (``repro.models.transformer``): the
dense family with GQA/MHA or MLA attention (the frontend backbones
chameleon-34b and musicgen-medium among them: the batch may supply
embeddings instead of tokens), the MoE family with GQA attention
(``models/moe.py`` in place of the MLP) and the SSM family (Mamba1 mixer
layers, ``models/ssm.py``): init, embedding, unembedding and the
full-sequence forward.

The reference stacks layers and walks them with ``lax.scan``; here
``params["layers"]`` is a list of per-layer dicts walked by a Python loop.
The hybrid family waits for its slice (ROADMAP A.6).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.types import ModelConfig, SSMConfig
from repro_torch.common.utils import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    kind = (cfg.ssm or SSMConfig()).kind
    if (cfg.family, cfg.attn_kind) not in (
            ("dense", "gqa"), ("dense", "mla"), ("moe", "gqa"),
            ("vlm", "gqa"), ("audio", "gqa"), ("ssm", "none")) or \
            (cfg.family == "ssm" and kind != "mamba1"):
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attn_kind!r}: the port "
            "serves the dense family (the vlm and audio backbones too), GQA "
            "or MLA attention, the MoE family with GQA attention and the "
            "SSM family with Mamba1 mixers (ROADMAP A.6)")


def mlp(lp: Params, h: torch.Tensor, cfg: ModelConfig):
    """A layer's MLP: (out, aux loss), the experts for the MoE family (the
    dense MLP's aux is the number 0: no launch on the decode path)."""
    if cfg.family == "moe":
        return MOE.moe_apply(lp["mlp"], h, cfg)
    return L.mlp_apply(lp["mlp"], h), 0.0


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Params:
    """Random params from a seeded ``torch.Generator`` on ``device`` (the
    card unless the caller names another), stored in ``cfg.dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg)
    d = cfg.d_model
    params: Params = {
        "tok_embed": L.init_dense((cfg.vocab_size, d), gen, dtype, dev,
                                  scale=0.02),
        "final_norm": torch.ones((d,), dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = L.init_dense((d, cfg.vocab_size), gen, dtype, dev,
                                         scale=0.02)
    if cfg.family == "ssm":
        params["layers"] = [
            {"mixer": SSM.mamba1_init(gen, cfg, dtype, dev),
             "ln": torch.ones((d,), dtype=dtype, device=dev)}
            for _ in range(cfg.num_layers)]
        return params
    params["layers"] = [
        {"attn": (L.mla_init if cfg.attn_kind == "mla" else L.gqa_init)(
            gen, cfg, dtype, dev),
         "mlp": (MOE.moe_init(gen, cfg, dtype, dev) if cfg.family == "moe"
                 else L.mlp_init(gen, d, cfg.d_ff, dtype, dev)),
         "ln1": torch.ones((d,), dtype=dtype, device=dev),
         "ln2": torch.ones((d,), dtype=dtype, device=dev)}
        for _ in range(cfg.num_layers)]
    return params


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


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            attn_impl: str = "auto"):
    """Full-sequence forward. Returns (logits [B,S,V], aux loss: the sum of
    the MoE layers' load-balance losses, 0 for the other families)."""
    check_supported(cfg)
    x = embed(params, batch, cfg)
    if cfg.family == "ssm":
        for lp in params["layers"]:
            x = x + SSM.mamba1_apply_train(
                lp["mixer"], L.rms_norm(x, lp["ln"], cfg.norm_eps), cfg)
        return unembed(params, x, cfg), torch.zeros((), dtype=torch.float32)
    attn = L.mla_apply_train if cfg.attn_kind == "mla" else L.gqa_apply_train
    aux = 0.0
    for lp in params["layers"]:
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attn(lp["attn"], h, cfg, attn_impl)
        y, a = mlp(lp, L.rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        x = x + y
        aux = aux + a
    return unembed(params, x, cfg), torch.as_tensor(aux, dtype=torch.float32)

