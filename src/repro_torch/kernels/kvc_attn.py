"""Decode attention over the compressed KV region: the CUDA kernel
(``csrc/kvc_attn.cu``), its plain PyTorch versions, and the wrappers.

Replaces the JAX package's TPU kernel ``kernels/kvc_attn.py::
kvc_decode_attention``: one-token GQA attention that dequantizes int4/int8
K/V (one f32 scale per token and KV head) inside the kernel, with a length
mask and an online softmax. Two entry points:

  * ``kvc_decode_partial`` -> the unnormalised partial (m [B,Hq,1],
    l [B,Hq,1], acc [B,Hq,D], f32) that the decode path merges with the hot
    window's (``models/decode.py::merge_partials``); the reference computes
    it in jnp (``decode.quantized_attention_partial``). A row of length 0
    comes out as m = -1e30, l = 0, acc = 0, which a merge weights 0.
  * ``kvc_decode_attention`` -> that partial plus ``finish``, the reference
    kernel's normalised output, including its quirk: a length-0 row is the
    uniform average of V over all S tokens (ROADMAP C).

MLA's absorbed decode (minicpm3-4b) reads one latent code stream that is
both K and V of all 40 heads: ``kvc_latent_partial`` (its own kernel in
the same source, ``latent_launches``) gives each ``LATENT_CHUNK`` tokens
of a lane a cluster of ``LATENT_CLUSTER`` CTAs, one group of heads each,
that dequantize each token once for every head and share it through
distributed shared memory; its plain version is the GQA partial with one
KV head and K = V. ``latent_working_ctas`` counts the CTAs that do work.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. ``launches``
counts kernel launches.

On the card one launch splits each lane's sequence into chunks of
``CHUNK`` tokens (``chunk_plan``), one CTA each, and the last CTA of a
(lane, KV head) merges the chunks' partials in index order, as
``models/decode.py::merge_partials`` would. The wrapper allocates the
per-call scratch and keeps the per-device int32 counters the CTAs count
themselves on (zeroed once; the kernel leaves them at 0): one stream at a
time per device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as _build
from repro_torch.kernels import qpack

NEG_INF = -1e30
launches = 0
latent_launches = 0
# tokens per CTA on the card (csrc/kvc_attn.cu's kChunk)
CHUNK = 128
# the latent kernel's one instantiation (csrc/kvc_attn.cu's H, R): minicpm3-4b
LATENT_HEADS, LATENT_DIM = 40, 288
# tokens a cluster (kLatChunk) and CTAs a cluster, each a group of heads
# (KVC_LAT_CLUSTER)
LATENT_CHUNK, LATENT_CLUSTER = 32, 2
_counters: dict = {}


def chunk_plan(S: int, chunk: Optional[int] = None) -> list:
    """The token ranges [start, stop) of the kernel's splits (``CHUNK``
    tokens each) for a cache of S positions; a split past a lane's length
    takes no part."""
    chunk = chunk or CHUNK
    return [(c, min(c + chunk, S)) for c in range(0, S, chunk)]


def latent_working_ctas(lengths) -> int:
    """The latent kernel's CTAs that do work at these lane lengths: a
    cluster for each chunk a lane's length reaches."""
    return LATENT_CLUSTER * sum(-(-max(int(n), 0) // LATENT_CHUNK)
                                for n in lengths)


def _dequant(codes, scales, bits: int, d: int) -> torch.Tensor:
    """codes [B,S,Hkv,D*bits/8], scales [B,S,Hkv] -> f32 [B,S,Hkv,D]."""
    return qpack.decode_plain(codes, scales[..., None], bits, d,
                              torch.float32)


def _scores(q, k, lengths, sm_scale):
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qf = q.to(torch.float32).reshape(B, Hkv, Hq // Hkv, D)
    s = torch.einsum("bhgd,bthd->bhgt", qf, k) * sm_scale
    valid = torch.arange(S, device=q.device)[None, :] < \
        lengths.to(q.device)[:, None]                               # [B,S]
    return torch.where(valid[:, None, None, :], s, NEG_INF), valid


def kvc_decode_partial_plain(q, k_codes, k_scales, v_codes, v_scales,
                             lengths, bits: int, sm_scale: float):
    """The partial the kernel computes, in plain PyTorch."""
    B, Hq, D = q.shape
    k = _dequant(k_codes, k_scales, bits, D)
    v = _dequant(v_codes, v_scales, bits, D)
    s, valid = _scores(q, k, lengths, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid[:, None, None, :]
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    return m.reshape(B, Hq, 1), l.reshape(B, Hq, 1), acc.reshape(B, Hq, D)


def kvc_decode_attention_plain(q, k_codes, k_scales, v_codes, v_scales,
                               lengths, bits: int,
                               sm_scale: float) -> torch.Tensor:
    """The reference kernel's normalised output: masked scores at -1e30,
    so an all-masked row averages V uniformly."""
    B, Hq, D = q.shape
    k = _dequant(k_codes, k_scales, bits, D)
    v = _dequant(v_codes, v_scales, bits, D)
    s, _ = _scores(q, k, lengths, sm_scale)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhgt,bthd->bhgd", p, v)
    out = acc / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)


def kvc_latent_partial_plain(q, codes, scales, lengths, bits: int,
                             sm_scale: float):
    """``kvc_latent_partial``'s function in plain PyTorch: the GQA partial
    with one KV head whose K and V are both the latent codes."""
    c, s = codes[:, :, None], scales[:, :, None]
    return kvc_decode_partial_plain(q, c, s, c, s, lengths, bits, sm_scale)


def _lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return _build.load("kvc_attn", {
        "kvc_attn_partial": [P, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                             I, I, F, I, P],
        "kvc_latent_partial": [P, I, P, P, P, P, P, P, P, P, I, I, I, I, I,
                               F, P]})


def _counter_buffer(device, n: int) -> torch.Tensor:
    """int32 counters for n (lane, KV head) pairs on ``device``, zeroed when
    allocated; the kernel returns each to 0 after its merge."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _launch(q, k_codes, k_scales, v_codes, v_scales, lengths, bits,
            sm_scale, empty_uniform: bool):
    global launches
    B, Hq, D = q.shape
    if k_codes.dim() != 4 or k_codes.shape[0] != B:
        raise ValueError(f"codes {tuple(k_codes.shape)} must be [B,S,Hkv,Dp]")
    S, Hkv = k_codes.shape[1], k_codes.shape[2]
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16/f32, got {q.dtype}")
    if bits not in (4, 8) or D not in (64, 128):
        raise ValueError(f"bits {bits}, head dim {D}: the kernel takes bits "
                         "4/8 and D 64/128")
    if Hkv < 1 or Hq % Hkv or Hq // Hkv > 8:
        raise ValueError(f"Hq {Hq}, Hkv {Hkv}: the kernel takes up to 8 "
                         "query heads per KV head")
    for name, t, shape, dt in (
            ("k_codes", k_codes, (B, S, Hkv, D * bits // 8), torch.uint8),
            ("v_codes", v_codes, (B, S, Hkv, D * bits // 8), torch.uint8),
            ("k_scales", k_scales, (B, S, Hkv), torch.float32),
            ("v_scales", v_scales, (B, S, Hkv), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous() or (dt == torch.uint8 and
                                             t.data_ptr() % 16):
            raise ValueError(f"{name} must be contiguous {dt} {shape} on "
                             f"{q.device} (codes 16-byte aligned)")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")
    if S < 1:
        raise ValueError(f"empty cache: S {S}")
    m = torch.empty((B, Hq, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, Hq, D), dtype=torch.float32, device=q.device)
    scratch = torch.empty((B, Hkv, len(chunk_plan(S)), Hq // Hkv,
                           D + 2), dtype=torch.float32, device=q.device)
    counters = _counter_buffer(q.device, B * Hkv)
    err = _lib().kvc_attn_partial(
        q.data_ptr(), int(q.dtype == torch.float32), k_codes.data_ptr(),
        k_scales.data_ptr(), v_codes.data_ptr(), v_scales.data_ptr(),
        lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), B, S, Hq, Hkv, D, bits,
        float(sm_scale), int(empty_uniform),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "kvc_attn_partial")
    launches += 1
    return m, l, acc


def _device_of(q):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode attention for device {q.device}")
    return q.device.type


def kvc_decode_partial(q, k_codes, k_scales, v_codes, v_scales, lengths, *,
                       bits: int, sm_scale: Optional[float] = None):
    """q [B,Hq,D]; codes uint8 [B,S,Hkv,D*bits/8]; scales f32 [B,S,Hkv];
    lengths int32 [B] -> (m, l, acc) over tokens t < lengths[b]."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _device_of(q) == "cpu":
        return kvc_decode_partial_plain(q, k_codes, k_scales, v_codes,
                                        v_scales, lengths, bits, sm_scale)
    return _launch(q, k_codes, k_scales, v_codes, v_scales, lengths, bits,
                   sm_scale, empty_uniform=False)


def kvc_decode_attention(q, k_codes, k_scales, v_codes, v_scales, lengths,
                         *, bits: int = 4,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """The reference kernel's normalised form -> [B,Hq,D] in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / (q.shape[-1] ** 0.5)
    if _device_of(q) == "cpu":
        return kvc_decode_attention_plain(q, k_codes, k_scales, v_codes,
                                          v_scales, lengths, bits, sm_scale)
    m, l, acc = _launch(q, k_codes, k_scales, v_codes, v_scales, lengths,
                        bits, sm_scale, empty_uniform=True)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _launch_latent(q, codes, scales, lengths, bits, sm_scale):
    global latent_launches
    B, H, R = q.shape
    if (H, R) != (LATENT_HEADS, LATENT_DIM) or bits not in (4, 8):
        raise ValueError(f"q {tuple(q.shape)}, bits {bits}: the latent kernel "
                         f"takes {LATENT_HEADS} heads of {LATENT_DIM} and "
                         "bits 4/8")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16/f32, got {q.dtype}")
    if codes.dim() != 3 or codes.shape[0] != B or codes.shape[1] < 1:
        raise ValueError(f"codes {tuple(codes.shape)} must be [B,S,Rp]")
    S = codes.shape[1]
    if -(-S // LATENT_CHUNK) * (H // LATENT_CLUSTER) > \
            LATENT_CHUNK * (LATENT_DIM + 4):
        raise ValueError(f"S {S}: past the latent kernel's merge")
    for name, t, shape, dt in (
            ("codes", codes, (B, S, R * bits // 8), torch.uint8),
            ("scales", scales, (B, S), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous {dt} {shape} on "
                             f"{q.device}, 16-byte aligned")
    q = q.contiguous()
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    if lengths.shape != (B,):
        raise ValueError("lengths must be [B]")
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, H, R), dtype=torch.float32, device=q.device)
    scratch = torch.empty((B, -(-S // LATENT_CHUNK), H, R + 2),
                          dtype=torch.float32, device=q.device)
    counters = _counter_buffer(q.device, B * LATENT_CLUSTER)
    err = _lib().kvc_latent_partial(
        q.data_ptr(), int(q.dtype == torch.float32), codes.data_ptr(),
        scales.data_ptr(), lengths.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), scratch.data_ptr(), counters.data_ptr(), B, S, H, R,
        bits, float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "kvc_latent_partial")
    latent_launches += 1
    return m, l, acc


def kvc_latent_partial(q, codes, scales, lengths, *, bits: int,
                       sm_scale: float):
    """MLA's absorbed decode over the compressed latent: q [B,H,R]; codes
    uint8 [B,S,R*bits/8] (the key and the value of every head); scales f32
    [B,S]; lengths int32 [B] -> (m [B,H,1], l [B,H,1], acc [B,H,R]) over
    tokens t < lengths[b]. The kernel for CUDA tensors (H 40, R 288), the
    plain version for CPU tensors."""
    if _device_of(q) == "cpu":
        return kvc_latent_partial_plain(q, codes, scales, lengths, bits,
                                        sm_scale)
    return _launch_latent(q, codes, scales, lengths, bits, sm_scale)
