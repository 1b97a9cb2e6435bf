"""Selective state-space layers of the port (``repro.models.ssm``): Mamba1
(falcon-mamba-7b) and Mamba2 / SSD with a scalar decay per head (the
hybrid zamba2-2.7b's mixer).

Prefill runs a chunked scan: a Python loop over time chunks carrying the
state, with a log-depth (Hillis-Steele) scan inside each chunk. Every
[B, chunk, ..., N] operand (the decay, the dt*x (x) B outer product, the
state history) lives only while its chunk runs, and C contracts N away
before the chunk's output is kept; at falcon-mamba's widths one batch row
of a chunk is 128 x 8192 x 16 x 4 B = 64 MiB, at zamba2's 128 x 80 x 64 x
64 x 4 B = 160 MiB (Mamba2's decay [B, chunk, H, 1, 1] broadcasts against
it and is never expanded). Decode is the O(1)-state recurrence.

Training takes the same scan chunk by chunk through ``_ScanChunk``, an
autograd Function that saves only the chunk's inputs and the state before
it, and in the backward recomputes the chunk and runs the recurrence's
adjoint as a reverse scan: autograd holds no Hillis-Steele pass beyond the
chunk being differentiated, where a graph of the passes would hold log2(c)
of them for every chunk of every mixer in a remat unit.

A prompt length T must be at most the chunk or a multiple of it: the
reference asserts so (``ssm._chunked_ssm_scan_out``), and the port keeps
that refusal (ROADMAP C10) with an error that names the rule.

The scan is plain PyTorch: the JAX package has no TPU kernel here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.types import ModelConfig, SSMConfig
from repro_torch.models.layers import init_dense, rms_norm

Params = Dict[str, Any]

# mixer params the reference uses in float32 without a cast to the
# activation dtype (Mamba1's and Mamba2's): they stay float32 in every
# cfg.dtype
F32_PARAMS = frozenset({"conv_w", "conv_b", "dt_bias", "A_log", "D"})


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, cfg.d_model // 16)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv. x [B,T,C], w [C,K], b [C]; init_state
    [B,K-1,C] supplies the left context (decode), zeros otherwise. Sums
    the K taps in f32 in order, then silu, then x's dtype."""
    B, T, C = x.shape
    K = w.shape[1]
    if init_state is None:
        init_state = torch.zeros((B, K - 1, C), dtype=x.dtype,
                                 device=x.device)
    xp = torch.cat([init_state.to(torch.float32), x.to(torch.float32)],
                   dim=1)
    wf = w.to(torch.float32)
    out = xp[:, 0:T] * wf[:, 0]
    for i in range(1, K):
        out = out + xp[:, i:i + T] * wf[:, i]
    return F.silu(out + b.to(torch.float32)).to(x.dtype)


def _scan_into(d: torch.Tensor, i: torch.Tensor, reverse: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of (decay, inp) pairs under the
    reference's combine, (da, ia) . (db, ib) = (da db, db ia + ib), in
    log2(T) Hillis-Steele passes (each step t combines with t - s; with
    ``reverse``, from the last step back, with t + s: the adjoint's), each
    pass written into the other of two buffers (``out=``); the inputs are
    one of them, so they are overwritten. ``d`` may broadcast against
    ``i`` (Mamba2's [B, T, H, 1, 1] decay)."""
    T = i.shape[1]
    d2, i2 = torch.empty_like(d), torch.empty_like(i)
    s = 1
    while s < T:
        if reverse:
            keep, at, by = slice(T - s, None), slice(None, -s), slice(s, None)
        else:
            keep, at, by = slice(None, s), slice(s, None), slice(None, -s)
        d2[:, keep] = d[:, keep]
        i2[:, keep] = i[:, keep]
        torch.mul(d[:, at], d[:, by], out=d2[:, at])
        torch.addcmul(i[:, at], d[:, at], i[:, by], out=i2[:, at])
        d, d2, i, i2 = d2, d, i2, i
        s *= 2
    return d, i


def _chunk_states(xs: Sequence[torch.Tensor], h: torch.Tensor,
                  params: Sequence[torch.Tensor], make_decay_inp: Callable
                  ) -> torch.Tensor:
    """A chunk's state history h_all [B, c, ..., N] from the state h before
    it: the chunk's operands, ``_scan_into``, then the carry."""
    dd, ii = _scan_into(*make_decay_inp(xs, *params))
    return dd * h[:, None] + ii


class _ScanChunk(torch.autograd.Function):
    """One chunk of ``_chunked_ssm_scan_out`` under autograd: (y, h_T) of
    the chunk's inputs ``xs``, the state ``h`` before it and the mixer's
    ``params``. The forward computes what the serving path computes
    (``_chunk_states``, bit for bit) and saves only its inputs, so no pass
    of the scan outlives its chunk. The backward recomputes the chunk's
    states and runs the adjoint of h_t = a_t h_{t-1} + b_t as a reverse
    scan under the same combine: lam_t = g_t + a_{t+1} lam_{t+1}, db_t =
    lam_t, da_t = lam_t h_{t-1}, dh = a_1 lam_1, where g_t is h_t's
    gradient through ``contract`` (recomputed) and, at the chunk's last
    step, h_T's; autograd takes (da, db) through ``make_decay_inp``
    (recomputed) to the inputs and params."""

    @staticmethod
    def forward(ctx, make_decay_inp, contract, n, h, *args):
        xs, params = args[:n], args[n:]
        h_all = _chunk_states(xs, h, params, make_decay_inp)
        ctx.fns, ctx.n = (make_decay_inp, contract), n
        ctx.save_for_backward(h, *args)
        ctx.set_materialize_grads(False)
        return contract(h_all, xs), h_all[:, -1].clone()

    @staticmethod
    def backward(ctx, gy, gh):
        make_decay_inp, contract = ctx.fns
        h, *args = ctx.saved_tensors
        leaves = [a.detach().requires_grad_(r)
                  for a, r in zip(args, ctx.needs_input_grad[4:])]
        xs, params = leaves[:ctx.n], leaves[ctx.n:]
        with torch.no_grad():
            decay, inp = make_decay_inp(xs, *params)
            dshape, a1 = decay.shape, decay[:, 0].clone()
            alpha = torch.zeros_like(decay)              # a_{t+1}; 0 at the end
            alpha[:, :-1] = decay[:, 1:]
            dd, ii = _scan_into(decay, inp)
            del decay, inp
            h_all = dd * h[:, None] + ii
            del dd, ii
        with torch.enable_grad():
            h_all.requires_grad_()
            y = contract(h_all, xs)
            want = [h_all] + [x for x in xs if x.requires_grad]
            gs = torch.autograd.grad(
                y, want, torch.zeros_like(y) if gy is None else gy,
                allow_unused=True)
        grads = dict(zip(map(id, want[1:]), gs[1:]))
        g, h_all = gs[0], h_all.detach()
        with torch.no_grad():
            if gh is not None:
                g[:, -1] += gh
            lam = _scan_into(alpha, g, reverse=True)[1]
            del alpha, g
            da = torch.empty_like(lam)
            torch.mul(lam[:, 1:], h_all[:, :-1], out=da[:, 1:])
            torch.mul(lam[:, :1], h[:, None], out=da[:, :1])
            del h_all
            da = da.sum_to_size(dshape)
            dh = (a1 * lam[:, 0]).sum_to_size(h.shape)
        with torch.enable_grad():
            decay, inp = make_decay_inp(xs, *params)
            outs = [(t, gt) for t, gt in ((decay, da), (inp, lam))
                    if t.requires_grad]
            want = [x for x in leaves if x.requires_grad]
            if outs and want:
                gs = torch.autograd.grad([t for t, _ in outs], want,
                                         [gt for _, gt in outs],
                                         allow_unused=True)
                for x, gx in zip(want, gs):
                    if gx is not None:
                        prev = grads.get(id(x))
                        grads[id(x)] = gx if prev is None else prev + gx
        return (None, None, None, dh if ctx.needs_input_grad[3] else None,
                *(grads.get(id(x)) for x in leaves))


def _check_chunked(T: int, chunk: int) -> int:
    """The chunk a scan of T steps runs at; a ValueError where the
    reference's assert would fail (ROADMAP C10)."""
    c = min(chunk, T)
    if T % c:
        raise ValueError(
            f"{T} steps: the chunked scan takes T at most the chunk ({chunk}) "
            f"or a multiple of it, as the reference's _chunked_ssm_scan_out "
            f"asserts (ROADMAP C10)")
    return c


def _chunked_ssm_scan(decay: torch.Tensor, inp: torch.Tensor,
                      h0: torch.Tensor, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = decay_t h_{t-1} + inp_t along axis 1 with the full state
    history kept: (h_all [B, T, ...], h_T). Short T and no autograd only
    (the reference's own, which no caller there uses; prefill and
    training run ``_chunked_ssm_scan_out``)."""
    c = _check_chunked(inp.shape[1], chunk)
    h, hs = h0, []
    for t0 in range(0, inp.shape[1], c):
        dd, ii = _scan_into(decay[:, t0:t0 + c].clone(),
                            inp[:, t0:t0 + c].clone())
        h_all = dd * h[:, None] + ii
        h = h_all[:, -1]
        hs.append(h_all)
    return torch.cat(hs, dim=1), h


def _chunked_ssm_scan_out(ins: Sequence[torch.Tensor], h0: torch.Tensor,
                          make_decay_inp: Callable, contract: Callable,
                          chunk: int, params: Sequence[torch.Tensor] = ()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = decay_t h_{t-1} + inp_t along axis 1 of the [B, T, ...] tensors
    of ``ins``, chunk by chunk: ``decay, inp = make_decay_inp(ins_chunk,
    *params)`` builds the chunk's [B, chunk, ..., N] operands, the scan runs
    inside the chunk, and ``contract(h_chunk, ins_chunk)`` reduces N away.
    Returns (y [B, T, out...], h_T). Under autograd each chunk is a
    ``_ScanChunk`` (its gradient reaches ``ins``, ``h0`` and ``params``:
    every tensor the two functions read must be among them)."""
    T = ins[0].shape[1]
    c = _check_chunked(T, chunk)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*ins, h0, *params))
    h, ys = h0, []
    for t0 in range(0, T, c):
        xs = tuple(a[:, t0:t0 + c] for a in ins)
        if grad:
            y, h = _ScanChunk.apply(make_decay_inp, contract, len(xs), h,
                                    *xs, *params)
        else:
            h_all = _chunk_states(xs, h, params, make_decay_inp)
            h = h_all[:, -1]
            y = contract(h_all, xs)
            del h_all
        ys.append(y)
    return torch.cat(ys, dim=1), h


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------

class Mamba1State(NamedTuple):
    h: torch.Tensor        # [B, d_in, N] f32
    conv: torch.Tensor     # [B, K-1, d_in] bf16


# logical axes of the mixers' leaves (the reference's ``mamba*_init``)
MAMBA1_AXES = {"in_proj": ("fsdp", "mlp"), "conv_w": ("mlp", None),
               "conv_b": ("mlp",), "x_proj": ("mlp", None),
               "dt_proj": (None, "mlp"), "dt_bias": ("mlp",),
               "A_log": ("mlp", "state"), "D": ("mlp",),
               "out_proj": ("mlp", "fsdp")}
MAMBA2_AXES = {"in_proj": ("fsdp", "mlp"), "conv_w": ("mlp", None),
               "conv_b": ("mlp",), "dt_bias": (None,), "A_log": (None,),
               "D": (None,), "norm_w": ("mlp",), "out_proj": ("mlp", "fsdp")}


def mamba1_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """A Mamba1 mixer's params from ``gen`` (the reference's
    distributions): the projections in ``dtype``, ``F32_PARAMS`` in f32."""
    ssm = cfg.ssm or SSMConfig()
    d = cfg.d_model
    d_in = ssm.expand * d
    r = _dt_rank(cfg)
    f32 = torch.float32

    def full(shape, v):
        return torch.full(shape, v, dtype=f32, device=device)

    return {
        "in_proj": init_dense((d, 2 * d_in), gen, dtype, device),
        "conv_w": init_dense((d_in, ssm.d_conv), gen, f32, device, scale=0.5),
        "conv_b": full((d_in,), 0.0),
        "x_proj": init_dense((d_in, r + 2 * ssm.d_state), gen, dtype, device),
        "dt_proj": init_dense((r, d_in), gen, dtype, device, scale=r ** -0.5),
        "dt_bias": full((d_in,), -4.6),                 # softplus ~ 0.01
        "A_log": torch.log(torch.arange(1, ssm.d_state + 1, dtype=f32,
                                        device=device)).repeat(d_in, 1),
        "D": full((d_in,), 1.0),
        "out_proj": init_dense((d_in, d), gen, dtype, device,
                               scale=d_in ** -0.5)}


def _mamba1_core(p: Params, xconv: torch.Tensor, z: torch.Tensor,
                 h0: torch.Tensor, cfg: ModelConfig, mix=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of the conv output and the gate: (y [B,T,d],
    h_T [B,d_in,N]). ``mix`` (a mesh's): (dt, B, C) of a block of the
    channels are partial sums, summed by it."""
    ssm = cfg.ssm or SSMConfig()
    r, N = _dt_rank(cfg), ssm.d_state
    dt_ = xconv.dtype
    dbc = xconv @ p["x_proj"].to(dt_)
    if mix is not None:
        dbc = mix(dbc)
    dt, Bc, Cc = dbc.split([r, N, N], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"].to(dt_)).to(torch.float32) +
                    p["dt_bias"])                              # [B,T,d_in]
    A = -torch.exp(p["A_log"])                                 # [d_in, N]

    def make_di(xs, A):
        dtc, xc, bc, _ = xs
        decay = torch.exp(dtc[..., None] * A)                  # [B,c,d,N]
        inp = (dtc * xc.to(torch.float32))[..., None] * \
            bc.to(torch.float32)[:, :, None, :]
        return decay, inp

    y, hT = _chunked_ssm_scan_out(
        (dt, xconv, Bc, Cc.to(torch.float32)), h0, make_di,
        lambda h, xs: torch.einsum("btdn,btn->btd", h, xs[3]), ssm.chunk,
        (A,))
    y = y + p["D"] * xconv.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(dt_)
    return y @ p["out_proj"].to(dt_), hT


def _mamba1_in(p: Params, u: torch.Tensor):
    """in_proj, split: (x, z) [B,T,d_in] each."""
    return (u @ p["in_proj"].to(u.dtype)).chunk(2, dim=-1)


def mamba1_prefill(p: Params, u: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Mamba1State]:
    """A full sequence u [B,T,d] from a zero state: (y [B,T,d], the state
    after it: h_T and the bf16 conv tail of the last K-1 inputs)."""
    ssm = cfg.ssm or SSMConfig()
    B = u.shape[0]
    x, z = _mamba1_in(p, u)
    xc = _causal_conv(x, p["conv_w"], p["conv_b"])
    h0 = torch.zeros((B, ssm.expand * cfg.d_model, ssm.d_state),
                     dtype=torch.float32, device=u.device)
    y, hT = _mamba1_core(p, xc, z, h0, cfg)
    return y, Mamba1State(hT, x[:, -(ssm.d_conv - 1):].to(torch.bfloat16))


def _rank_in_proj(w: torch.Tensor, u: torch.Tensor, parts, mesh):
    """u through the columns of the whole ``in_proj`` ``w`` that are the
    rank's: ``parts`` is [(offset, width, split)] of the column blocks
    [x | z | ...] in order, each split over ``model`` or whole; one
    product, then the blocks."""
    cols, sizes = [], []
    for off, n, split in parts:
        b = mesh.block(n) if split else slice(0, n)
        cols.append(w[:, off + b.start:off + b.stop])
        sizes.append(b.stop - b.start)
    return (u @ torch.cat(cols, dim=1).to(u.dtype)).split(sizes, dim=-1)


def mamba1_apply_train(p: Params, u: torch.Tensor, cfg: ModelConfig,
                       mesh=None) -> torch.Tensor:
    """The full-sequence form: u [B,T,d] -> y [B,T,d]. On a mesh with a
    model axis (``mesh``, the trainer's ``MeshModel``): ``in_proj``
    whole, the rest the rank's channels; the input entered, (dt, B, C)
    summed over ``model`` both ways, the output left."""
    if mesh is None or not mesh.tp:
        return mamba1_prefill(p, u, cfg)[0]
    ssm = cfg.ssm or SSMConfig()
    d_in = ssm.expand * cfg.d_model
    x, z = _rank_in_proj(p["in_proj"], mesh.enter(u),
                         [(0, d_in, True), (d_in, d_in, True)], mesh)
    xc = _causal_conv(x, p["conv_w"], p["conv_b"])
    h0 = torch.zeros((u.shape[0], x.shape[-1], ssm.d_state),
                     dtype=torch.float32, device=u.device)
    return mesh.leave(_mamba1_core(p, xc, z, h0, cfg, mesh.mix)[0])


def mamba1_init_state(cfg: ModelConfig, batch: int, device) -> Mamba1State:
    ssm = cfg.ssm or SSMConfig()
    d_in = ssm.expand * cfg.d_model
    return Mamba1State(
        h=torch.zeros((batch, d_in, ssm.d_state), dtype=torch.float32,
                      device=device),
        conv=torch.zeros((batch, ssm.d_conv - 1, d_in), dtype=torch.bfloat16,
                         device=device))


def mamba1_decode(p: Params, u: torch.Tensor, state: Mamba1State,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Mamba1State]:
    """u [B,1,d] one token: (y [B,1,d], the next state; new tensors)."""
    x, z = _mamba1_in(p, u)
    xc = _causal_conv(x, p["conv_w"], p["conv_b"], init_state=state.conv)
    y, hT = _mamba1_core(p, xc, z, state.h, cfg)
    conv = torch.cat([state.conv[:, 1:], x.to(state.conv.dtype)], dim=1)
    return y, Mamba1State(hT, conv)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, scalar decay per head)
# ---------------------------------------------------------------------------

class Mamba2State(NamedTuple):
    h: torch.Tensor        # [B, H, P, N] f32
    conv: torch.Tensor     # [B, K-1, d_in] bf16


def _mamba2_dims(cfg: ModelConfig):
    """(ssm config, d_in, heads)."""
    ssm = cfg.ssm or SSMConfig(kind="mamba2")
    d_in = ssm.expand * cfg.d_model
    return ssm, d_in, d_in // ssm.headdim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, dtype,
                device) -> Params:
    """A Mamba2 mixer's params from ``gen`` (the reference's
    distributions): the projections and the norm in ``dtype``,
    ``F32_PARAMS`` in f32."""
    ssm, d_in, nheads = _mamba2_dims(cfg)
    d, g, n = cfg.d_model, ssm.ngroups, ssm.d_state
    f32 = torch.float32

    def full(shape, v, dt=f32):
        return torch.full(shape, v, dtype=dt, device=device)

    return {
        "in_proj": init_dense((d, 2 * d_in + 2 * g * n + nheads), gen, dtype,
                              device),
        "conv_w": init_dense((d_in, ssm.d_conv), gen, f32, device, scale=0.5),
        "conv_b": full((d_in,), 0.0),
        "dt_bias": full((nheads,), -4.6),
        "A_log": full((nheads,), 0.0),
        "D": full((nheads,), 1.0),
        "norm_w": full((d_in,), 1.0, dtype),
        "out_proj": init_dense((d_in, d), gen, dtype, device,
                               scale=d_in ** -0.5)}


def _mamba2_split(p: Params, u: torch.Tensor, cfg: ModelConfig):
    """in_proj, split: (z, x [B,T,d_in], B, C [B,T,g*N], dt [B,T,H])."""
    ssm, d_in, nheads = _mamba2_dims(cfg)
    gn = ssm.ngroups * ssm.d_state
    return (u @ p["in_proj"].to(u.dtype)).split([d_in, d_in, gn, gn, nheads],
                                                dim=-1)


def _mamba2_core(p: Params, xc, Bc, Cc, dt, z, h0, cfg: ModelConfig,
                 mix=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of the conv output with a scalar decay per head, the
    skip, the gate (rounded to the activation dtype before the gated
    RMSNorm, as the reference does) and out_proj: (y [B,T,d], h_T
    [B,H,P,N]). The heads are those of ``dt``'s last dim; ``mix`` (a
    mesh's, the heads a block of them): the norm's sum of squares over
    the block, summed by it over every channel."""
    ssm = cfg.ssm or SSMConfig(kind="mamba2")
    B_, T, d_in = xc.shape
    H = dt.shape[-1]
    P, N, g = ssm.headdim, ssm.d_state, ssm.ngroups
    f32 = torch.float32
    xh = xc.reshape(B_, T, H, P).to(f32)
    Bh = Bc.reshape(B_, T, g, N).to(f32).repeat_interleave(H // g, dim=2)
    Ch = Cc.reshape(B_, T, g, N).to(f32).repeat_interleave(H // g, dim=2)
    dt = F.softplus(dt.to(f32) + p["dt_bias"])                 # [B,T,H]
    A = -torch.exp(p["A_log"])                                 # [H]

    def make_di(xs, A):
        dtc, xc_, bc, _ = xs
        decay = torch.exp(dtc * A)[..., None, None]            # [B,c,H,1,1]
        inp = (dtc[..., None] * xc_)[..., None] * bc[:, :, :, None, :]
        return decay, inp

    y, hT = _chunked_ssm_scan_out(
        (dt, xh, Bh, Ch), h0, make_di,
        lambda h, xs: torch.einsum("bthpn,bthn->bthp", h, xs[3]), ssm.chunk,
        (A,))
    y = (y + p["D"][:, None] * xh).reshape(B_, T, d_in)
    y = (y * F.silu(z.to(f32))).to(xc.dtype)
    if mix is None:
        y = rms_norm(y, p["norm_w"], cfg.norm_eps)
    else:
        var = mix(y.to(f32).square().sum(dim=-1, keepdim=True)) / \
            (ssm.expand * cfg.d_model)
        y = y * torch.rsqrt(var + cfg.norm_eps).to(y.dtype) * \
            p["norm_w"].to(y.dtype)
    return y @ p["out_proj"].to(xc.dtype), hT


def mamba2_prefill(p: Params, u: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Mamba2State]:
    """A full sequence u [B,T,d] from a zero state: (y [B,T,d], the state
    after it: h_T and the bf16 conv tail of the last K-1 inputs)."""
    ssm, _, H = _mamba2_dims(cfg)
    z, x, Bc, Cc, dt = _mamba2_split(p, u, cfg)
    xc = _causal_conv(x, p["conv_w"], p["conv_b"])
    h0 = torch.zeros((u.shape[0], H, ssm.headdim, ssm.d_state),
                     dtype=torch.float32, device=u.device)
    y, hT = _mamba2_core(p, xc, Bc, Cc, dt, z, h0, cfg)
    return y, Mamba2State(hT, x[:, -(ssm.d_conv - 1):].to(torch.bfloat16))


def mamba2_apply_train(p: Params, u: torch.Tensor, cfg: ModelConfig,
                       mesh=None) -> torch.Tensor:
    """The full-sequence form: u [B,T,d] -> y [B,T,d]. On a mesh with a
    model axis (``mesh``, the trainer's ``MeshModel``): ``in_proj`` whole,
    sliced to the rank's z, x and dt and the whole B and C (one group,
    shared by the heads); the per-head leaves, replicated, at the rank's
    heads; conv, norm and ``out_proj`` the rank's channels; the input
    entered, the gated norm's sum of squares summed both ways, the output
    left."""
    if mesh is None or not mesh.tp:
        return mamba2_prefill(p, u, cfg)[0]
    ssm, d_in, H = _mamba2_dims(cfg)
    gn = ssm.ngroups * ssm.d_state
    z, x, Bc, Cc, dt = _rank_in_proj(
        p["in_proj"], mesh.enter(u),
        [(0, d_in, True), (d_in, d_in, True), (2 * d_in, gn, False),
         (2 * d_in + gn, gn, False), (2 * d_in + 2 * gn, H, True)], mesh)
    heads = mesh.block(H)
    # replicated over model, read at the rank's heads: entered, so every
    # rank's copy takes the whole gradient
    q = dict(p, **{k: mesh.enter(p[k])[heads]
                   for k in ("dt_bias", "A_log", "D")})
    xc = _causal_conv(x, p["conv_w"], p["conv_b"])
    h0 = torch.zeros((u.shape[0], dt.shape[-1], ssm.headdim, ssm.d_state),
                     dtype=torch.float32, device=u.device)
    return mesh.leave(_mamba2_core(q, xc, Bc, Cc, dt, z, h0, cfg,
                                   mesh.mix)[0])


def mamba2_init_state(cfg: ModelConfig, batch: int, device) -> Mamba2State:
    ssm, d_in, H = _mamba2_dims(cfg)
    return Mamba2State(
        h=torch.zeros((batch, H, ssm.headdim, ssm.d_state),
                      dtype=torch.float32, device=device),
        conv=torch.zeros((batch, ssm.d_conv - 1, d_in), dtype=torch.bfloat16,
                         device=device))


def mamba2_decode(p: Params, u: torch.Tensor, state: Mamba2State,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Mamba2State]:
    """u [B,1,d] one token: (y [B,1,d], the next state; new tensors)."""
    z, x, Bc, Cc, dt = _mamba2_split(p, u, cfg)
    xc = _causal_conv(x, p["conv_w"], p["conv_b"], init_state=state.conv)
    y, hT = _mamba2_core(p, xc, Bc, Cc, dt, z, state.h, cfg)
    conv = torch.cat([state.conv[:, 1:], x.to(state.conv.dtype)], dim=1)
    return y, Mamba2State(hT, conv)
