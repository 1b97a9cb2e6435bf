"""Model FLOPs: the products a token needs by the architecture, whatever
the program runs (padding, recomputation and idle lanes are not counted).

A token costs 2 FLOPs a matmul weight (every weight but the input
embedding, which is a lookup) and, at attention, 2 a query-key pair a head
for each of the scores and the weighted values: a token at position t
attends t + 1 keys. Training costs three times the forward (the backward
twice it), remat's second forward not counted.
"""
from __future__ import annotations


def matmul_params(cfg) -> int:
    """Weights a token multiplies: every layer's projections and MLP, and
    the output head (the input embedding tied to it counts once)."""
    d, L, f, V = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    if cfg.attn_kind == "mla":
        m, h = cfg.mla, cfg.num_heads
        attn = d * m.q_lora_rank + \
            m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim) + \
            d * (m.kv_lora_rank + m.qk_rope_head_dim) + \
            m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + \
            h * m.v_head_dim * d
    else:
        hd = cfg.resolved_head_dim
        attn = d * cfg.num_heads * hd + 2 * d * cfg.num_kv_heads * hd + \
            cfg.num_heads * hd * d
    return L * (attn + 3 * d * f) + d * V


def attn_dims(cfg):
    """(query-key width, value width) of a head."""
    if cfg.attn_kind == "mla":
        m = cfg.mla
        return m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def attn_flops_at(cfg, keys: int) -> int:
    """Attention FLOPs of one query over ``keys`` keys, every layer."""
    qk, v = attn_dims(cfg)
    return 2 * cfg.num_layers * cfg.num_heads * keys * (qk + v)


def token_flops(cfg, pos: int) -> int:
    """Forward FLOPs of the token at position ``pos``."""
    return 2 * matmul_params(cfg) + attn_flops_at(cfg, pos + 1)


def tokens_flops(cfg, lo: int, hi: int) -> int:
    """Forward FLOPs of the tokens at positions [lo, hi), in closed form."""
    n = hi - lo
    if n <= 0:
        return 0
    keys = (lo + 1 + hi) * n // 2          # sum of (pos + 1)
    qk, v = attn_dims(cfg)
    return 2 * matmul_params(cfg) * n + \
        2 * cfg.num_layers * cfg.num_heads * keys * (qk + v)


def train_step_flops(cfg, rows: int, seq: int) -> int:
    """Model FLOPs of a training step: 3x the forward of every position
    of every row."""
    return 3 * rows * tokens_flops(cfg, 0, seq)
