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
both K and V of all 40 heads: ``kvc_latent_partial``, whose plain version
is the GQA partial with one KV head and K = V. On the card q's type alone
picks its route (``LATENT_ROUTES``), neither giving way to the other:

  * bf16 (the serving path) -> the tensor cores (``kvc_latent_partial_tc``
    in the same source): the 40 heads are the rows of one wgmma tile, the
    codes enter both products as exact bf16 integers with the per-token
    scale outside them, P is two bf16 terms (hi + lo); a CTA owns a span of
    ``LATENT_TC_TOKENS`` tokens and one 64-wide box of the output columns
    (``LATENT_TC_BOXES`` a row), and the last CTA of each (lane, box)
    merges the spans' partials of its columns.
    ``kvc_latent_partial_tc_model`` is that arithmetic in plain PyTorch;
  * f32 -> the CUDA cores (``kvc_latent_partial``): each ``LATENT_CHUNK``
    tokens of a lane get a cluster of ``LATENT_CLUSTER`` CTAs, one group of
    heads each, that dequantize each token once for every head and share
    it through distributed shared memory; every product in f32.

``latent_launches`` counts the latent kernels' launches,
``latent_launches_tc`` those of the tensor-core route;
``latent_working_ctas`` counts a route's CTAs that do work.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. ``launches``
counts the GQA kernel's launches, ``group_launches`` the same launches by
group size G = Hq/Hkv.

On the card one launch splits each lane's sequence into chunks of
``CHUNK`` tokens (``chunk_plan``) and each KV head's group of query heads
into slices of ``SLICE_HEADS`` (``head_slices``: two for qwen3-moe's 16,
one for a group of 8 or fewer), one CTA a (chunk, slice), and the last CTA
of a (lane, KV head, slice) merges the chunks' partials in index order, as
``models/decode.py::merge_partials`` would. A group above ``MAX_GROUP``
raises. The GQA wrapper allocates the per-call scratch; the latent one
takes it from a per-device buffer that lives across calls. Both keep per-device int32 counters the CTAs count
themselves on (zeroed once; the kernels leave them at 0): one stream at a
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
group_launches: dict = {}
latent_launches = 0
latent_launches_tc = 0
# tokens per CTA on the card (csrc/kvc_attn.cu's kChunk)
CHUNK = 128
# query heads a CTA (kSliceHeads) and a KV head's group at most (kMaxGroup)
SLICE_HEADS, MAX_GROUP = 8, 16
# the GQA kernel's head dims (csrc/kvc_attn.cu's kvc_attn_partial)
HEAD_DIMS = (64, 80, 128)
# the latent kernels' one instantiation (csrc/kvc_attn.cu's H, R):
# minicpm3-4b
LATENT_HEADS, LATENT_DIM = 40, 288
# q's type -> the latent partial's route on the card
LATENT_ROUTES = {torch.bfloat16: "tensor_cores", torch.float32: "cuda_cores"}
# the CUDA-core route: tokens a cluster (kLatChunk) and CTAs a cluster, each
# a group of heads (KVC_LAT_CLUSTER)
LATENT_CHUNK, LATENT_CLUSTER = 32, 2
# the tensor-core route: tokens a CTA (KVC_TC_TOKENS), and the 64-wide
# boxes of output columns, a CTA each
LATENT_TC_TOKENS = 96
LATENT_TC_BOXES = -(-LATENT_DIM // 64)
_counters: dict = {}
_scratch: dict = {}


def chunk_plan(S: int, chunk: Optional[int] = None) -> list:
    """The token ranges [start, stop) of the kernel's splits (``CHUNK``
    tokens each) for a cache of S positions; a split past a lane's length
    takes no part."""
    chunk = chunk or CHUNK
    return [(c, min(c + chunk, S)) for c in range(0, S, chunk)]


def head_slices(group: int) -> int:
    """CTAs that share a (lane, KV head, chunk) on the card, each
    ``SLICE_HEADS`` of its ``group`` query heads; a ValueError for a group
    the kernel does not take."""
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"a group of {group} query heads: the kernel takes "
                         f"up to {MAX_GROUP} query heads per KV head")
    return -(-group // SLICE_HEADS)


def latent_working_ctas(lengths, dtype=torch.bfloat16) -> int:
    """The CTAs of q's route (``LATENT_ROUTES``) that do work at these lane
    lengths: for each span of tokens a lane's length reaches, one CTA a
    column box on the tensor cores (``LATENT_TC_BOXES`` a span of
    ``LATENT_TC_TOKENS``), a cluster of ``LATENT_CLUSTER`` a
    ``LATENT_CHUNK`` on the CUDA cores."""
    if LATENT_ROUTES[dtype] == "tensor_cores":
        ctas, span = LATENT_TC_BOXES, LATENT_TC_TOKENS
    else:
        ctas, span = LATENT_CLUSTER, LATENT_CHUNK
    return ctas * sum(-(-max(int(n), 0) // span) for n in lengths)


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


# How far the tensor-core route may sit from its rounding model (the card's
# checks): m and l to f32 round-off, |kernel - model| / (1 + |model|); acc
# normwise, where the two differ by f32 sums in another order and where a
# score's last bits move P across a bf16 rounding boundary. A swapped box, a
# wrong swizzle or a lost tile moves the partial by O(1).
LATENT_TC_MODEL_TOL = {"ml": 2e-5, "acc_norm": 1e-4}


def kvc_latent_partial_tc_model(q, codes, scales, lengths, bits: int,
                                sm_scale: float, tokens: Optional[int] = None):
    """The tensor-core route's arithmetic in plain PyTorch, on q's device:
    q rounded to bf16, the codes as exact integers, the f32 scores times
    scale * sm_scale after the product, per span of ``tokens`` tokens (a
    CTA's) the max, p = exp(s - m) (the kernel's to about 2 ulp) and l =
    sum p in f32, P = p * scale as hi = bf16(P) plus lo = bf16(P - hi)
    (their sum exact in f32) against the codes with an f32 sum, then the
    spans merged in index order. Same contract as
    ``kvc_latent_partial_plain``."""
    tok = tokens or LATENT_TC_TOKENS
    B, H, R = q.shape
    S = codes.shape[1]
    n_tiles = -(-S // tok)
    pad = n_tiles * tok - S
    c = qpack.decode_plain(codes, torch.ones_like(scales)[..., None], bits, R,
                           torch.float32)                          # [B,S,R]
    sc = scales.to(torch.float32)
    valid = torch.arange(S, device=q.device)[None, :] < \
        lengths.to(q.device)[:, None]                               # [B,S]
    s = torch.einsum("bhr,btr->bht", q.to(torch.bfloat16).float(), c) * \
        (sc * sm_scale)[:, None, :]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF) \
        .reshape(B, H, n_tiles, tok)
    live = torch.nn.functional.pad(valid, (0, pad)).reshape(B, 1, -1, tok)
    m = s.amax(dim=-1)                                  # [B,H,tiles]
    p = torch.where(live, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    pf = p * torch.nn.functional.pad(sc, (0, pad)).reshape(B, 1, -1, tok)
    hi = pf.to(torch.bfloat16).float()
    pb = hi + (pf - hi).to(torch.bfloat16).float()
    o = torch.einsum("bhnt,bntr->bhnr", pb, torch.nn.functional.pad(
        c, (0, 0, 0, pad)).reshape(B, -1, tok, R))      # [B,H,tiles,R]
    M = m.amax(dim=-1)
    w = torch.exp(m - M[..., None])
    L = torch.zeros_like(M)
    O = torch.zeros_like(o[..., 0, :])
    for j in range(n_tiles):
        L = L + w[..., j] * l[..., j]
        O = O + w[..., j, None] * o[..., j, :]
    return M[..., None], L[..., None], O


def latent_route_for(dtype: torch.dtype, heads: int, dim: int) -> str:
    """The latent partial's route on the card for q's type and shape, or a
    ValueError where no kernel takes them."""
    if dtype not in LATENT_ROUTES:
        raise ValueError(f"q must be bf16/f32, got {dtype}")
    if (heads, dim) != (LATENT_HEADS, LATENT_DIM):
        raise ValueError(
            f"{heads} heads of {dim}: the latent kernels are instantiated for "
            f"{LATENT_HEADS} heads of {LATENT_DIM} (the tensor-core template "
            "takes H <= 64, R % 16 == 0; the CUDA-core one H "
            f"% {LATENT_CLUSTER} == 0 and R % 32 == 0)")
    return LATENT_ROUTES[dtype]


def latent_tc_scratch_floats(B: int, S: int) -> int:
    """The tensor-core route's merge records: B x n_span spans x
    ``LATENT_TC_BOXES`` boxes, each the box's 64 columns of every head plus
    the span's (m, l) per head."""
    n_span = -(-S // LATENT_TC_TOKENS)
    return B * n_span * LATENT_TC_BOXES * (64 + 2) * LATENT_HEADS


def _tc_max_spans() -> int:
    """The spans a lane's last merge can weigh: their (m, l) and weights
    [n_span][3][H] reuse the Q and code tiles (csrc/kvc_attn.cu's
    Shape::kMaxSpans)."""
    H, tok, rb = LATENT_HEADS, LATENT_TC_TOKENS, LATENT_TC_BOXES
    tiles = (rb - 1) * -(-H // 8) * 1024 + 64 * 128 + rb * tok * 128
    return tiles // 4 // (3 * H)


def latent_route(q, codes, scales, lengths, bits: int) -> str:
    """The route the card takes for these inputs (``latent_route_for``),
    or a ValueError for inputs no route takes. Reads shapes, types and
    devices only."""
    if q.dim() != 3:
        raise ValueError(f"q {tuple(q.shape)} must be [B,H,R]")
    B, H, R = q.shape
    route = latent_route_for(q.dtype, H, R)
    if bits not in (4, 8):
        raise ValueError(f"bits {bits}: the latent kernels take bits 4/8")
    if codes.dim() != 3 or codes.shape[0] != B or codes.shape[1] < 1:
        raise ValueError(f"codes {tuple(codes.shape)} must be [B,S,Rp]")
    S = codes.shape[1]
    if route == "tensor_cores":
        too_long = -(-S // LATENT_TC_TOKENS) > _tc_max_spans()
    else:
        too_long = -(-S // LATENT_CHUNK) * (H // LATENT_CLUSTER) > \
            LATENT_CHUNK * (LATENT_DIM + 4)
    if too_long:
        raise ValueError(f"S {S}: past the latent kernel's merge")
    for name, t, shape, dt in (
            ("codes", codes, (B, S, R * bits // 8), torch.uint8),
            ("scales", scales, (B, S), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dt or t.device != q.device \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous {dt} {shape} on "
                             f"{q.device}, 16-byte aligned")
    if tuple(lengths.shape) != (B,):
        raise ValueError("lengths must be [B]")
    if q.device.type != "cuda":
        raise ValueError(f"no latent decode kernel for device {q.device}")
    return route


def _lib() -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    latent = [P, P, P, P, P, P, P, P, P, I, I, I, I, I, F, P]
    return _build.load("kvc_attn", {
        "kvc_attn_partial": [P, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I,
                             I, I, F, I, P],
        "kvc_latent_partial": latent, "kvc_latent_partial_tc": latent})


def _counter_buffer(device, n: int) -> torch.Tensor:
    """int32 counters for n (lane, KV head, slice) triples (or a latent
    route's pairs) on ``device``, zeroed when allocated; the kernel returns
    each to 0 after its merge."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


def _scratch_buffer(device, n: int) -> torch.Tensor:
    """At least n f32 of merge scratch on ``device``, kept across calls (a
    launch reads back all it writes before it ends)."""
    buf = _scratch.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _scratch[device] = buf
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
    if bits not in (4, 8) or D not in HEAD_DIMS:
        raise ValueError(f"bits {bits}, head dim {D}: the kernel takes bits "
                         f"4/8 and D {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq {Hq}, Hkv {Hkv}: not a whole group a KV head")
    n_slices = head_slices(Hq // Hkv)
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
    counters = _counter_buffer(q.device, B * Hkv * n_slices)
    err = _lib().kvc_attn_partial(
        q.data_ptr(), int(q.dtype == torch.float32), k_codes.data_ptr(),
        k_scales.data_ptr(), v_codes.data_ptr(), v_scales.data_ptr(),
        lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), B, S, Hq, Hkv, D, bits,
        float(sm_scale), int(empty_uniform),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, "kvc_attn_partial")
    launches += 1
    group_launches[Hq // Hkv] = group_launches.get(Hq // Hkv, 0) + 1
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
    """One launch on the route of ``latent_route``."""
    global latent_launches, latent_launches_tc
    route = latent_route(q, codes, scales, lengths, bits)
    B, H, R = q.shape
    S = codes.shape[1]
    q = q.contiguous()
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    m = torch.empty((B, H, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    acc = torch.empty((B, H, R), dtype=torch.float32, device=q.device)
    if route == "tensor_cores":
        fn, name = _lib().kvc_latent_partial_tc, "kvc_latent_partial_tc"
        scratch = _scratch_buffer(q.device, latent_tc_scratch_floats(B, S))
        counters = _counter_buffer(q.device, B * LATENT_TC_BOXES)
    else:
        fn, name = _lib().kvc_latent_partial, "kvc_latent_partial"
        scratch = _scratch_buffer(q.device,
                                  B * -(-S // LATENT_CHUNK) * H * (R + 2))
        counters = _counter_buffer(q.device, B * LATENT_CLUSTER)
    err = fn(q.data_ptr(), codes.data_ptr(), scales.data_ptr(),
             lengths.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
             scratch.data_ptr(), counters.data_ptr(), B, S, H, R, bits,
             float(sm_scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch(err, name)
    latent_launches += 1
    latent_launches_tc += int(route == "tensor_cores")
    return m, l, acc


def kvc_latent_partial(q, codes, scales, lengths, *, bits: int,
                       sm_scale: float):
    """MLA's absorbed decode over the compressed latent: q [B,H,R]; codes
    uint8 [B,S,R*bits/8] (the key and the value of every head); scales f32
    [B,S]; lengths int32 [B] -> (m [B,H,1], l [B,H,1], acc [B,H,R]) over
    tokens t < lengths[b]. A kernel for CUDA tensors (H 40, R 288; the
    route of q's type, ``latent_route``), the plain version for CPU
    tensors."""
    if _device_of(q) == "cpu":
        return kvc_latent_partial_plain(q, codes, scales, lengths, bits,
                                        sm_scale)
    return _launch_latent(q, codes, scales, lengths, bits, sm_scale)
