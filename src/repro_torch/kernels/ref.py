"""Plain oracles for the attention kernels (port of the reference's
``kernels/ref.py``): dense attention in f32 with a softmax, for the tests
and ``chip_smoke.py``. The port's own code never calls them."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import qpack


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, sm_scale: Optional[float] = None,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,Sq,Hq,D]; k,v [B,Sk,Hkv,D] (GQA broadcast) -> [B,Sq,Hq,D] in
    q's dtype; accumulation in f32."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    kf = k.to(torch.float32).repeat_interleave(g, dim=2)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), kf) * sm_scale
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=Sk - Sq)
        s = torch.where(mask[None, None], s, -1e30)
    if lengths is not None:
        col = torch.arange(Sk, device=q.device)[None, None, None, :]
        s = torch.where(col < lengths.to(q.device)[:, None, None, None], s,
                        -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def kvc_attn_ref(q: torch.Tensor, k_codes, k_scales, v_codes, v_scales, *,
                 bits: int, lengths: torch.Tensor,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over block-quantized KV: dequantize, then mha."""
    D = q.shape[-1]
    k = qpack.decode_plain(k_codes, k_scales[..., None], bits, D)
    v = qpack.decode_plain(v_codes, v_scales[..., None], bits, D)
    return mha_ref(q[:, None], k, v, causal=False, sm_scale=sm_scale,
                   lengths=lengths)[:, 0]
