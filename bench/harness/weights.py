"""Seeded weights for the dense family (GQA/MHA or MLA attention, SwiGLU
MLP), made on the device in the type they are served in.

Each leaf is one ``torch.randn`` call in the model's dtype, stacked over
the layers ([L, ...], the trainer's layout), from a generator of its own
seeded by (seed, leaf index): a leaf can be made again alone (the train
cell's reference needs the step-0 params after the program has updated
its own in place). The distribution is the port's ``init_dense``: N(0, 1)
times 1/sqrt(fan_in), 0.02 for the embedding and the output head, ones for
the norms. The serve cells take per-layer views of the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], float]   # path, shape, scale
ONES = -1.0                                             # scale of a norm


def leaves(cfg) -> List[Leaf]:
    """Every leaf of the stacked tree: (path, shape, scale), in a fixed
    order (the index seeds the leaf's generator)."""
    d, V, L, f = cfg.d_model, cfg.vocab_size, cfg.num_layers, cfg.d_ff
    out: List[Leaf] = [(("tok_embed",), (V, d), 0.02),
                       (("final_norm",), (d,), ONES)]
    if not cfg.tie_embeddings:
        out.append((("lm_head",), (d, V), 0.02))
    if cfg.attn_kind == "mla":
        m, h = cfg.mla, cfg.num_heads
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        attn = [("wq_a", (d, m.q_lora_rank), d),
                ("wq_b", (m.q_lora_rank, h * qk), m.q_lora_rank),
                ("wkv_a", (d, m.kv_lora_rank + m.qk_rope_head_dim), d),
                ("wkv_b", (m.kv_lora_rank, h * (m.qk_nope_head_dim +
                                                m.v_head_dim)),
                 m.kv_lora_rank),
                ("wo", (h * m.v_head_dim, d), h * m.v_head_dim),
                ("q_norm", (m.q_lora_rank,), 0),
                ("kv_norm", (m.kv_lora_rank,), 0)]
    else:
        hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        attn = [("wq", (d, hq * hd), d), ("wk", (d, hkv * hd), d),
                ("wv", (d, hkv * hd), d), ("wo", (hq * hd, d), hq * hd)]
    for name, shape, fan in attn:
        out.append((("layers", "attn", name), (L,) + shape,
                    ONES if fan == 0 else fan ** -0.5))
    for name, shape, fan in (("wi", (d, f), d), ("wg", (d, f), d),
                             ("wo", (f, d), f)):
        out.append((("layers", "mlp", name), (L,) + shape, fan ** -0.5))
    out += [(("layers", "ln1"), (L, d), ONES), (("layers", "ln2"), (L, d),
                                                 ONES)]
    return out


def leaf_seed(seed: int, index: int) -> int:
    """A generator seed for leaf ``index`` of run ``seed`` (any whole
    number; seeds past 32 bits included)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9
            ) % (2 ** 63 - 1)


def make_leaf(cfg, seed: int, index: int, device, dtype=None
              ) -> torch.Tensor:
    """Leaf ``index`` of ``leaves(cfg)``, made on ``device``."""
    _, shape, scale = leaves(cfg)[index]
    dtype = dtype or _dtype(cfg)
    if scale == ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return t.mul_(scale)


def _dtype(cfg) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def _put(tree: Dict[str, Any], path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def get(tree: Dict[str, Any], path):
    for k in path:
        tree = tree[k]
    return tree


def stacked_params(cfg, seed: int, device) -> Dict[str, Any]:
    """The trainer's stacked layout (``params["layers"]`` a dict of leaves
    [L, ...])."""
    tree: Dict[str, Any] = {}
    for i, (path, _, _) in enumerate(leaves(cfg)):
        _put(tree, path, make_leaf(cfg, seed, i, device))
    return tree


def per_layer(stacked: Dict[str, Any], cfg) -> Dict[str, Any]:
    """The model's layout (``params["layers"]`` a list of per-layer dicts)
    as views of the stacked leaves."""
    out = {k: v for k, v in stacked.items() if k != "layers"}

    def view(node, i):
        return {k: view(v, i) if isinstance(v, dict) else v[i]
                for k, v in node.items()}

    out["layers"] = [view(stacked["layers"], i)
                     for i in range(cfg.num_layers)]
    return out
