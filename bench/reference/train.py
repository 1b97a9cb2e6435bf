"""The training step in plain float32: the loss (mean next-token cross
entropy), its gradient by autograd one layer at a time (the forward keeps
each layer's input; the backward recomputes one layer and takes its
gradients), then AdamW with both moments stored as the configuration states
them: 8-bit m and 8-bit sqrt(v) in blocks of ``state_block`` (the whole
leaf where the block does not divide it), the update in float32 from the
clipped gradient, the params stored back in bf16.

Params live in the stacked layout ([L, ...] leaves, ``harness.weights``);
grads are float32.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bench.reference import model as M
from bench.reference import quant

HEAD_ROWS = 2048        # rows of the output head's logits at a time


def _layer_params(stacked: Dict, i: int, grad: bool) -> Dict:
    def view(node):
        return {k: view(v) if isinstance(v, dict) else
                v[i].to(torch.float32, copy=True).requires_grad_(grad)
                for k, v in node.items()}
    return view(stacked["layers"])


def _train_layer(lp: Dict, x: torch.Tensor, cfg, prec: str) -> torch.Tensor:
    """One layer over rows x [B, S, d], every key exact (causal)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)
    bound = torch.zeros(S, dtype=torch.int64, device=x.device)
    out = []
    for b in range(B):
        xb = x[b]
        h = M.rms(xb, lp["ln1"], cfg.norm_eps)
        a = _attn_exact(lp, h, pos, cfg, bound, prec)
        xb = xb + a
        out.append(xb + M.mlp(lp, M.rms(xb, lp["ln2"], cfg.norm_eps), prec))
    return torch.stack(out)


def _attn_exact(lp, h, pos, cfg, bound, prec):
    if cfg.attn_kind == "mla":
        raise NotImplementedError("the train reference covers GQA/MHA")
    a = lp["attn"]
    T = h.shape[0]
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = M.rope(M.lin(h, a["wq"], prec).reshape(T, hq, hd), pos,
               cfg.rope_theta)
    k = M.rope(M.lin(h, a["wk"], prec).reshape(T, hkv, hd), pos,
               cfg.rope_theta)
    v = M.lin(h, a["wv"], prec).reshape(T, hkv, hd)
    g = hq // hkv
    if g > 1:
        k, v = (t.repeat_interleave(g, dim=1) for t in (k, v))
    s = (q.transpose(0, 1) @ k.permute(1, 2, 0)) * hd ** -0.5
    causal = torch.ones((T, T), dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = (p @ v.transpose(0, 1)).transpose(0, 1)
    return M.lin(o.reshape(T, hq * hd), a["wo"], prec)


def loss_and_grads(params: Dict, batch: Dict[str, torch.Tensor], cfg,
                   prec: str = "f32") -> Tuple[float, Dict]:
    """(loss, float32 grads in the stacked layout)."""
    M.no_tf32()
    tokens, labels = batch["tokens"].long(), batch["labels"].long()
    B, S = tokens.shape
    L = cfg.num_layers
    grads = _zeros_like_f32(params)
    with torch.no_grad():
        x = params["tok_embed"][tokens].to(torch.float32)
        inputs = []
        for i in range(L):
            inputs.append(x)
            x = _train_layer(_layer_params(params, i, False), x, cfg, prec)
    # the head, in blocks of rows: loss = sum of -log p over all B*S / (B*S)
    top = {k: params[k].to(torch.float32, copy=True).requires_grad_(True)
           for k in ("final_norm", "lm_head") if k in params}
    flat_x = x.reshape(B * S, -1)
    flat_y = labels.reshape(-1)
    dx = torch.empty_like(flat_x)
    total = 0.0
    for r0 in range(0, B * S, HEAD_ROWS):
        xr = flat_x[r0:r0 + HEAD_ROWS].detach().requires_grad_(True)
        w = top["lm_head"] if "lm_head" in top else \
            params["tok_embed"].to(torch.float32).T
        logits = M.lin(M.rms(xr, top["final_norm"], cfg.norm_eps), w, prec)
        lp = torch.log_softmax(logits, dim=-1)
        ll = lp.gather(1, flat_y[r0:r0 + HEAD_ROWS, None])[:, 0]
        part = -ll.sum() / (B * S)
        part.backward()
        total += float(part.detach())
        dx[r0:r0 + HEAD_ROWS] = xr.grad
        del logits, lp, ll, part
    for k, t in top.items():
        grads[k] += t.grad
    dy = dx.reshape(B, S, -1)
    del x
    for i in reversed(range(L)):
        lp = _layer_params(params, i, True)
        xi = inputs[i].detach().requires_grad_(True)
        y = _train_layer(lp, xi, cfg, prec)
        y.backward(dy)
        dy = xi.grad
        _accumulate(grads["layers"], lp, i)
        inputs[i] = None
        del y, lp, xi
    with torch.no_grad():
        grads["tok_embed"].index_add_(0, tokens.reshape(-1),
                                      dy.reshape(B * S, -1))
    return total, grads


def _zeros_like_f32(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_f32(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def _accumulate(gnode: Dict, lnode: Dict, i: int) -> None:
    for k, v in lnode.items():
        if isinstance(v, dict):
            _accumulate(gnode[k], v, i)
        elif v.grad is not None:
            gnode[k][i] += v.grad


def leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, path + (k,))
        return out
    return [(path, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def moment_block(n: int, block: int) -> int:
    return block if n % block == 0 and n >= block else n


class CompressedAdamW:
    """AdamW over the stacked params with 8-bit m and sqrt(v)."""

    def __init__(self, params: Dict, ocfg: Dict):
        self.o = ocfg
        self.step = 0
        self.state = {}
        for path, p in leaves(params):
            n = p.numel()
            b = moment_block(n, ocfg["state_block"])
            z = torch.zeros(n, dtype=torch.float32, device=p.device)
            self.state[path] = [quant.quantize(z, 8, b),
                                quant.quantize(z, 8, b), b]

    def update(self, params: Dict, grads: Dict) -> float:
        """One step, each leaf in slices of whole blocks (every operation
        is elementwise and the codes are per block); returns the clip
        factor the gradient was scaled by."""
        o = self.o
        self.step += 1
        t = self.step
        gsq = 0.0
        for _, g in leaves(grads):
            flat = g.reshape(-1)
            for s0, s1 in _slices(flat.numel(), 1):
                gsq += float(torch.sum(flat[s0:s1].double() ** 2))
        clip = min(o["grad_clip"] / max(gsq ** 0.5, 1e-9), 1.0)
        lr = o["lr"] * min(t / max(o["warmup_steps"], 1), 1.0)
        bc1, bc2 = 1.0 - o["b1"] ** t, 1.0 - o["b2"] ** t
        for path, p in leaves(params):
            g_all = _get(grads, path).reshape(-1)
            p_all = p.view(-1)
            (mc, ms), (vc, vs), b = self.state[path]
            for s0, s1 in _slices(p_all.numel(), b):
                k0, k1 = s0 // b, s1 // b
                g = g_all[s0:s1] * clip
                m = quant.dequantize(mc[s0:s1], ms[k0:k1], b)
                v = quant.dequantize(vc[s0:s1], vs[k0:k1], b) ** 2
                m = o["b1"] * m + (1 - o["b1"]) * g
                v = o["b2"] * v + (1 - o["b2"]) * g * g
                pf = p_all[s0:s1].to(torch.float32)
                upd = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) + \
                    o["weight_decay"] * pf
                p_all[s0:s1] = (pf - lr * upd).to(p.dtype)
                mc[s0:s1], ms[k0:k1] = quant.quantize(m, 8, b)
                vc[s0:s1], vs[k0:k1] = quant.quantize(torch.sqrt(v), 8, b)
        return clip


SLICE = 1 << 26


def _slices(n: int, b: int):
    step = max(SLICE // b, 1) * b
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.reshape(-1).to(torch.float32)))
