"""Prefill attention: the CUDA kernel (``csrc/flash_attn.cu``), its plain
PyTorch version, and the wrapper the model calls.

Replaces the JAX package's TPU kernel ``kernels/flash_attn.py::
flash_attention`` (causal or full GQA forward). The reference's serving
path computes the same function with ``layers.chunked_attention``, an
online softmax over key chunks; ``flash_attention_plain`` is that function
(``models/layers.py`` re-exports it under its reference name), so on the
CPU the port computes exactly what the reference computes.

The wrapper dispatches on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. ``launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build

NEG_INF = -1e30
launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key chunks (the reference's
    ``layers.chunked_attention``). q [B,Sq,Hq,D]; k,v [B,Sk,Hkv,D]."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    chunk = min(chunk, Sk)
    if Sk % chunk:
        chunk = Sk
    qf = (q.to(torch.float32) * sm_scale).transpose(1, 2)     # [B,Hq,Sq,D]
    rows = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, Dv), dtype=torch.float32, device=q.device)
    for j in range(Sk // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        kj = k[:, sl].to(torch.float32).repeat_interleave(g, dim=2)
        vj = v[:, sl].to(torch.float32).repeat_interleave(g, dim=2)
        s = torch.einsum("bhqd,bkhd->bhqk", qf, kj)
        if causal:
            cols = j * chunk + torch.arange(chunk, device=q.device)
            mask = cols[None, :] <= (rows + (Sk - Sq))[:, None]
            s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load("flash_attn", {
        "flash_attn_fwd": [P, P, P, P, I, I, I, I, I, I, I, F, I, P]})


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention forward, ``flash_attention_plain``'s contract: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    global launches
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("q [B,Sq,Hq,D], k and v [B,Sk,Hkv,D] expected")
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA attention")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"no flash attention for devices {q.device}, "
                         f"{k.device}, {v.device}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must all be bf16 or all float32")
    if D not in (64, 128):
        raise ValueError(f"head dim {D}: the kernel takes 64 or 128")
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq {Sq} > Sk {Sk} leaves "
                         "rows without a key")
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0 or Sk == 0:
        raise ValueError("empty attention")
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.float32), B, Sq, Sk, Hq, Hkv, D, float(sm_scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "flash_attn_fwd")
    launches += 1
    return out
