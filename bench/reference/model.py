"""The dense family in plain float32 (the configuration's layer equations),
one layer at a time from the benchmark's bf16 weights: RMSNorm, RoPE over
the two halves of a head, GQA/MHA attention or MLA (the latent c_kv normed,
a shared rope key, per-head keys and values expanded from the latent),
SwiGLU MLP, final norm, output head.

Serving: ``served_logits`` runs a request's prompt and served tokens
through the model as the configuration's cache defines it. The prompt's
pass (queries t < P) reads every key and value exactly. A decode query at
t reads those older than its cold boundary, max(P - W, t - W + 1, the last
position <= t at which the request was parked), through their 4-bit codes
(one block a token and KV head over the head dim; MLA: one block over the
latent row) and the rest from the hot ring, which holds them in bf16: the
ring keeps the last W tokens, a park quantizes everything before it, and a
token that passed through the ring is quantized from its bf16 copy.

``prec="fp8"`` is the control: every linear layer's two inputs rounded to
float8 e4m3 (one scale a tensor), the rest as above.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from bench.reference import quant

HEAD_CHUNK = 8          # heads a score block holds


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lin(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    w = w.to(torch.float32)
    if prec == "fp8":
        x = x + (quant.fake_fp8(x) - x).detach()
        w = w + (quant.fake_fp8(w) - w).detach()
    return x @ w


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * \
        w.to(torch.float32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., T, H, D], pos [T]: each head's halves rotated."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = pos.to(torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x.chunk(2, dim=-1)
    return torch.cat([a * cos - b * sin, a * sin + b * cos], dim=-1)


def boundaries(prompt_len: int, total: int, window: int,
               parks: Sequence[int], device) -> torch.Tensor:
    """The cold boundary of each query position [0, total)."""
    out = []
    parks = sorted(parks)
    j, last = 0, 0
    for t in range(total):
        if t < prompt_len:
            out.append(0)
            continue
        while j < len(parks) and parks[j] <= t:
            last = parks[j]
            j += 1
        out.append(max(prompt_len - window, t - window + 1, last, 0))
    return torch.tensor(out, dtype=torch.int64, device=device)


def cache_forms(x: torch.Tensor, prompt_len: int, window: int, bits: int,
                block: int):
    """The forms a key (or value, or latent) row x [T, ...] takes in the
    cache: (exact, the hot ring's bf16 copy, its codes' values). A row
    that passed through the ring (position >= prompt_len - window) was
    quantized from its bf16 copy, an older prompt row from itself."""
    ring = x.to(torch.bfloat16).to(torch.float32)
    pos = torch.arange(x.shape[0], device=x.device)
    through = (pos >= prompt_len - window).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    codes = torch.where(through, quant.roundtrip(ring, bits, block),
                        quant.roundtrip(x, bits, block))
    return x, ring, codes


def mixed_attention(q, ks, vs, bound, prompt_len: int, sm: float
                    ) -> torch.Tensor:
    """Causal attention of q [T, Hq, Dk] over keys and values in their
    three cache forms (``cache_forms``: exact, ring, codes; keys [T, Hkv,
    Dk], values [T, Hkv, Dv]). A query of the prompt's pass (t < P) reads
    every key exactly; a decode query reads a key s < bound[t] through its
    codes and every other through the ring -> [T, Hq, Dv]."""
    T, hq = q.shape[0], q.shape[1]
    g = hq // ks[0].shape[1]
    if g > 1:
        ks = [t.repeat_interleave(g, dim=1) for t in ks]
        vs = [t.repeat_interleave(g, dim=1) for t in vs]
    s_idx = torch.arange(T, device=q.device)
    causal = s_idx[None, :] <= s_idx[:, None]
    cold = (s_idx[None, :] < bound[:, None]).float()
    dec = (s_idx >= prompt_len)[:, None].float()
    sel = [1.0 - dec, dec * (1.0 - cold), cold]     # exact, ring, codes
    out = []
    for h0 in range(0, hq, HEAD_CHUNK):
        hs = slice(h0, h0 + HEAD_CHUNK)
        qh = q[:, hs].transpose(0, 1)                          # [h, T, D]
        s = sum(w * (qh @ k[:, hs].permute(1, 2, 0))
                for w, k in zip(sel, ks)) * sm
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        o = sum((p * w) @ v[:, hs].transpose(0, 1) for w, v in zip(sel, vs))
        out.append(o.transpose(0, 1))
    return torch.cat(out, dim=1)


def attention_layer(lp: Dict, x: torch.Tensor, pos: torch.Tensor, cfg,
                    bound: torch.Tensor, prompt_len: int, window: int,
                    bits: int, prec: str):
    """One layer's attention output for x [T, d] (pre-norm applied by the
    caller)."""
    T = x.shape[0]
    a = lp["attn"]
    if cfg.attn_kind == "mla":
        m, h = cfg.mla, cfg.num_heads
        ckv = lin(x, a["wkv_a"], prec)
        c, kr = ckv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
        c = rms(c, a["kv_norm"], cfg.norm_eps)
        kr = rope(kr[:, None, :], pos, cfg.rope_theta)[:, 0]
        lat = torch.cat([c, kr], dim=-1)
        qa = rms(lin(x, a["wq_a"], prec), a["q_norm"], cfg.norm_eps)
        qq = lin(qa, a["wq_b"], prec).reshape(
            T, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
        qn, qr = qq.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
        qq = torch.cat([qn, rope(qr, pos, cfg.rope_theta)], dim=-1)

        def kv(latent):
            cc, rr = latent.split([m.kv_lora_rank, m.qk_rope_head_dim],
                                  dim=-1)
            e = lin(cc, a["wkv_b"], prec).reshape(
                T, h, m.qk_nope_head_dim + m.v_head_dim)
            kn, vv = e.split([m.qk_nope_head_dim, m.v_head_dim], dim=-1)
            return torch.cat([kn, rr[:, None, :].expand(
                T, h, m.qk_rope_head_dim)], dim=-1), vv

        forms = [kv(f) for f in cache_forms(lat, prompt_len, window, bits,
                                            lat.shape[-1])]
        sm = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
        o = mixed_attention(qq, [f[0] for f in forms], [f[1] for f in forms],
                            bound, prompt_len, sm)
        return lin(o.reshape(T, h * m.v_head_dim), a["wo"], prec)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = rope(lin(x, a["wq"], prec).reshape(T, hq, hd), pos, cfg.rope_theta)
    k = rope(lin(x, a["wk"], prec).reshape(T, hkv, hd), pos, cfg.rope_theta)
    v = lin(x, a["wv"], prec).reshape(T, hkv, hd)
    o = mixed_attention(q, cache_forms(k, prompt_len, window, bits, hd),
                        cache_forms(v, prompt_len, window, bits, hd), bound,
                        prompt_len, hd ** -0.5)
    return lin(o.reshape(T, hq * hd), a["wo"], prec)


def mlp(lp: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    p = lp["mlp"]
    return lin(torch.nn.functional.silu(lin(x, p["wg"], prec)) *
               lin(x, p["wi"], prec), p["wo"], prec)


def layer(lp: Dict, x: torch.Tensor, pos, cfg, bound, prompt_len: int,
          window: int, bits: int, prec: str) -> torch.Tensor:
    x = x + attention_layer(lp, rms(x, lp["ln1"], cfg.norm_eps), pos, cfg,
                            bound, prompt_len, window, bits, prec)
    return x + mlp(lp, rms(x, lp["ln2"], cfg.norm_eps), prec)


def head(params: Dict, x: torch.Tensor, cfg, prec: str) -> torch.Tensor:
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lin(rms(x, params["final_norm"], cfg.norm_eps), w, prec)


@torch.no_grad()
def served_logits(params: Dict, cfg, prompt: List[int], served: List[int],
                  parks: Sequence[int], window: int, bits: int,
                  precs=("f32",)) -> Dict[str, torch.Tensor]:
    """The logits [len(served), V] that produce each served token, one
    float32 tensor for each precision in ``precs``: the prompt and every
    served token but the last are the input, the positions from the
    prompt's last on are read out."""
    no_tf32()
    dev = params["tok_embed"].device
    tokens = torch.tensor(list(prompt) + list(served[:-1]), dtype=torch.long,
                          device=dev)
    T, P = tokens.shape[0], len(prompt)
    pos = torch.arange(T, device=dev)
    bound = boundaries(P, T, window, parks, dev)
    out = {}
    for prec in precs:
        x = params["tok_embed"][tokens].to(torch.float32)
        for lp in params["layers"]:
            x = layer(lp, x, pos, cfg, bound, P, window, bits, prec)
        out[prec] = head(params, x[P - 1:], cfg, prec)
    return out


def served_gaps(logits: torch.Tensor, served: List[int]) -> torch.Tensor:
    """By how much each served token's reference logit lies below the
    reference's best at its position."""
    idx = torch.tensor(served, dtype=torch.long, device=logits.device)
    return logits.max(dim=-1).values - logits.gather(1, idx[:, None])[:, 0]


def control_gaps(ref: torch.Tensor, low: torch.Tensor) -> torch.Tensor:
    """The gap, under the reference, of the token the lower precision puts
    first at each position."""
    return served_gaps(ref, low.argmax(dim=-1).tolist())
