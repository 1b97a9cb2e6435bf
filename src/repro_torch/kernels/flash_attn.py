"""Prefill attention: the CUDA kernel (``csrc/flash_attn.cu``), its plain
PyTorch version, and the wrapper the model calls.

Replaces the JAX package's TPU kernel ``kernels/flash_attn.py::
flash_attention`` (causal or full GQA forward). The reference's serving
path computes the same function with ``layers.chunked_attention``, an
online softmax over key chunks; ``flash_attention_plain`` is that function
(``models/layers.py`` re-exports it under its reference name), so on the
CPU the port computes exactly what the reference computes.

The wrapper dispatches on the tensor's device: a CUDA tensor launches a
kernel (or raises), a CPU tensor runs the plain version. On the card the
input type alone picks the route (``ROUTES``): bf16 runs on the tensor
cores (wgmma fed by TMA), f32 on the CUDA cores; nothing gives way to
another route at run time. ``launches`` counts every kernel launch,
``launches_tc`` those of the tensor-core route.

Training: ``flash_attention_trainable`` is B6's forward under autograd (a
``torch.autograd.Function``): the forward is ``flash_attention`` (the kernel
on the card), the backward ``flash_attention_backward``, the FlashAttention-2
formulas written out in PyTorch over query chunks (the reference trains
through jnp autodiff and has no backward kernel). ``flash_attention`` itself
refuses, on the card, inputs that require grad while a graph is recorded:
its output would carry no gradient.

Head dims: q and k share D, and v's dim equals it (``HEAD_DIMS``) except at
the pairs of ``SPLIT_HEAD_DIMS``: MLA's expanded prefill, 96-wide q/k
(nope 64 + rope 32) against 64-wide v (minicpm3-4b).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build

NEG_INF = -1e30
launches = 0
launches_tc = 0

# input type -> route on the card; the C entry point takes the type's code
ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
HEAD_DIMS = (64, 80, 128)
# (qk, v) head-dim pairs with qk != v that both routes take
SPLIT_HEAD_DIMS = ((96, 64),)
# keys per tile of the tensor-core route, per head dim (csrc/flash_attn.cu's
# tc::Tile): at D 128 the widest tile whose registers fit
TC_KEYS = {128: 96, 80: 128, 64: 128}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          sm_scale: Optional[float] = None,
                          chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over key chunks (the reference's
    ``layers.chunked_attention``). q [B,Sq,Hq,D]; k [B,Sk,Hkv,D]; v
    [B,Sk,Hkv,Dv] (MLA: Dv may differ from D) -> [B,Sq,Hq,Dv]."""
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
        "flash_attn_fwd": [P, P, P, P, I, I, I, I, I, I, I, I, F, I, P]})


def _check_gqa(q, k, v) -> None:
    """q [B,Sq,Hq,D], k [B,Sk,Hkv,D], v [B,Sk,Hkv,Dv]: Dv == D, or (D, Dv)
    one of ``SPLIT_HEAD_DIMS``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError("q [B,Sq,Hq,D], k [B,Sk,Hkv,D] and v "
                         "[B,Sk,Hkv,Dv] expected")
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form a GQA attention")
    if v.shape[3] != D and (D, v.shape[3]) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"head dims qk {D}, v {v.shape[3]}: the kernels "
                         f"take v's equal to qk's or the pairs "
                         f"{SPLIT_HEAD_DIMS}")


def route_for(dtype: torch.dtype, head_dim: int,
              v_dim: Optional[int] = None) -> str:
    """The route on the card for this input type and (qk, v) head dims
    (v_dim defaults to head_dim), or a ValueError where no kernel takes
    them."""
    if dtype not in ROUTES:
        raise ValueError(f"no flash attention kernel for {dtype}: q, k, v "
                         "must all be bf16 or all float32")
    v_dim = head_dim if v_dim is None else v_dim
    if not (v_dim == head_dim and head_dim in HEAD_DIMS) and \
            (head_dim, v_dim) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"head dims qk {head_dim}, v {v_dim}: the kernels "
                         f"take {HEAD_DIMS} (v equal) and {SPLIT_HEAD_DIMS}")
    return ROUTES[dtype]


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
          causal: bool = True) -> str:
    """The route the card takes for these inputs, or a ValueError for
    inputs no route takes. Reads shapes, types and devices only."""
    _check_gqa(q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v types differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    path = route_for(q.dtype, q.shape[3], v.shape[3])
    Sq, Sk = q.shape[1], k.shape[1]
    if causal and Sq > Sk:
        raise ValueError(f"causal attention with Sq {Sq} > Sk {Sk} leaves "
                         "rows without a key")
    if q.numel() == 0 or Sk == 0:
        raise ValueError("empty attention")
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"no flash attention kernel for devices {q.device}, "
                         f"{k.device}, {v.device}")
    return path


def _launch(q, k, v, causal: bool, sm_scale: float):
    """One kernel launch on the route of ``route``."""
    global launches, launches_tc
    path = route(q, k, v, causal=causal)
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    err = _lib().flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, Sq, Sk, Hq, Hkv, D, Dv, float(sm_scale),
        int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "flash_attn_fwd")
    launches += 1
    launches_tc += int(path == "tensor_cores")
    return out


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel (any device but the CPU; ``route``
    refuses all but CUDA)."""
    return t.device.type != "cpu"


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether a graph is being recorded through any of ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention forward, ``flash_attention_plain``'s contract (at the
    head dims ``_check_gqa`` takes): a CUDA kernel for CUDA tensors
    (``route``), the plain version for CPU tensors. On the card, inputs
    that require grad raise: use ``flash_attention_trainable``."""
    _check_gqa(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if not _on_card(q):
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    if needs_grad(q, k, v):
        raise RuntimeError("flash_attention: q, k or v requires grad and the "
                           "kernel's output has none; call "
                           "flash_attention_trainable")
    return _launch(q, k, v, causal, sm_scale)


BWD_CHUNK = 512         # query rows a step of the backward


def flash_attention_backward(q, k, v, o, do, *, causal: bool,
                             sm_scale: float, chunk: int = BWD_CHUNK):
    """(dq, dk, dv) of ``flash_attention`` at (q, k, v) with output ``o``
    and output grad ``do``, in float32, cast to the inputs' types: per
    chunk of query rows, P again from q and k (the row log-sum-exp), then
    dV += P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dO * O)),
    dQ = dS K * scale, dK += dS^T Q * scale; K's and V's grads summed over
    each KV head's group of query heads."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    f32 = torch.float32
    kf = k.to(f32).repeat_interleave(g, dim=2).transpose(1, 2)  # [B,Hq,Sk,D]
    vf = v.to(f32).repeat_interleave(g, dim=2).transpose(1, 2)
    dq = torch.empty((B, Hq, Sq, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, Hq, Sk, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, Hq, Sk, Dv), dtype=f32, device=q.device)
    cols = torch.arange(Sk, device=q.device)
    for r0 in range(0, Sq, chunk):
        r1 = min(Sq, r0 + chunk)
        qc = q[:, r0:r1].to(f32).transpose(1, 2)                 # [B,Hq,c,D]
        s = (qc * sm_scale) @ kf.transpose(-1, -2)               # [B,Hq,c,Sk]
        if causal:
            rows = torch.arange(r0, r1, device=q.device) + (Sk - Sq)
            s = s.masked_fill(cols[None, :] > rows[:, None], NEG_INF)
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        doc = do[:, r0:r1].to(f32).transpose(1, 2)               # [B,Hq,c,Dv]
        delta = (doc * o[:, r0:r1].to(f32).transpose(1, 2)).sum(
            dim=-1, keepdim=True)
        dv += p.transpose(-1, -2) @ doc
        ds = p * (doc @ vf.transpose(-1, -2) - delta)
        dq[:, :, r0:r1] = (ds @ kf) * sm_scale
        dk += (ds.transpose(-1, -2) @ qc) * sm_scale

    def per_kv_head(t):                       # [B,Hq,Sk,d] -> [B,Sk,Hkv,d]
        t = t.transpose(1, 2)
        return t.reshape(B, Sk, Hkv, g, t.shape[-1]).sum(dim=3)

    return (dq.transpose(1, 2).to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """B6's forward (``flash_attention``) with the backward of
    ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o = flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, o, do, causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """``flash_attention`` with a gradient: the same forward (the kernel on
    the card, the plain version on the CPU), FlashAttention-2's backward."""
    _check_gqa(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    return _FlashAttention.apply(q, k, v, causal, float(sm_scale))
