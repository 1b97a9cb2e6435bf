"""A train cell: the step that ``repro_torch.train.trainer.make_train_step``
returns, with the compressed AdamW state, fed rows that all differ.

Set-up builds the step, the params (``harness.weights``) and the state
once, and drives that same object through its first ``checked_steps``
steps by the window's own call and feed: they warm every shape, and the
check reads them (each step's loss; after the first, the gradient as the
optimizer got it, from the 8-bit m it left; after the last, each leaf's
change from the seeded params). The window then dispatches steps until
``--seconds`` have passed, keeping at most ``max_in_flight`` of them queued
on the device (the step makes no host sync), and ends at a synchronize
after the last.
"""
from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from bench.counts import model as CM
from bench.harness import trace as TRC
from bench.harness import weights as W
from bench.harness.traffic import TrainFeed
from bench.reference import quant
from bench.reference import train as RT


def _cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def _sync(device) -> None:
    if _cuda(device):
        torch.cuda.synchronize()


def optimizer_settings(mix: Dict) -> Dict:
    """The AdamW settings of a train mix, the port's defaults elsewhere."""
    from repro_torch.common.types import OptimizerConfig
    d = OptimizerConfig()
    return {"lr": float(mix["lr"]), "b1": d.b1, "b2": d.b2, "eps": d.eps,
            "weight_decay": d.weight_decay, "grad_clip": d.grad_clip,
            "warmup_steps": int(mix["warmup_steps"]),
            "state_block": int(mix["state_block"])}


def _leaf_paths(cfg):
    return [path for path, _, _ in W.leaves(cfg)]


SLICE = 1 << 26          # values a reading handles at a time


def _sq_sum(fn, n: int) -> float:
    """sum of fn(s, e) ** 2 over slices [s, e) of n values, in float64."""
    return sum(float(torch.sum(fn(s, min(s + SLICE, n)).double() ** 2))
               for s in range(0, n, SLICE))


def grad_norms_from_state(opt, cfg, b1: float) -> List[float]:
    """Each leaf's gradient as the optimizer got it in its first step
    (clipped): its 8-bit m after that step over (1 - b1)."""
    out = []
    for path in _leaf_paths(cfg):
        c = W.get(opt.m, path)
        codes, scales, b = quant.unpack8(c["codes"]), c["scales"], c["block"]
        step = max(SLICE // b, 1) * b

        def part(s, e):
            return quant.dequantize(codes[s:e], scales[s // b:e // b], b)
        total = sum(float(torch.sum(part(s, min(s + step, codes.numel()))
                                    .double() ** 2))
                    for s in range(0, codes.numel(), step))
        out.append(total ** 0.5 / (1.0 - b1))
    return out


def change_norms(params, cfg, seed: int, device) -> List[float]:
    """Each leaf's ||p - p0||, p0 made again from the seed."""
    out = []
    for i, path in enumerate(_leaf_paths(cfg)):
        p0 = W.make_leaf(cfg, seed, i, device).reshape(-1)
        p = W.get(params, path).reshape(-1)
        out.append(_sq_sum(lambda s, e: p[s:e].to(torch.float32) -
                           p0[s:e].to(torch.float32), p.numel()) ** 0.5)
        del p0
    return out


def run(ctx) -> Dict:
    from repro_torch.common.types import OptimizerConfig, TrainConfig
    from repro_torch.kernels import qpack
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    dev, cfg, mix = ctx.device, ctx.model, ctx.mix
    o = optimizer_settings(mix)
    ocfg = OptimizerConfig(lr=o["lr"], warmup_steps=o["warmup_steps"],
                           compress_state=bool(mix["compress_state"]),
                           state_block=o["state_block"])
    tcfg = TrainConfig(seq_len=int(mix["seq_len"]),
                       global_batch=int(mix["batch"]),
                       microbatches=int(mix["microbatches"]), optimizer=ocfg)
    params = W.stacked_params(cfg, ctx.seed, dev)
    step_fn, _ = trainer.make_train_step(cfg, tcfg)
    opt = adamw.init(params, ocfg)
    feed = TrainFeed(mix, cfg.vocab_size, ctx.seed, dev)
    n_check = int(mix["checked_steps"])
    prog = {"loss": []}
    for i in range(n_check):
        params, opt, met = step_fn(params, opt, feed.next())
        prog["loss"].append(float(met["loss"]))
        if i == 0:
            prog["grad"] = grad_norms_from_state(opt, cfg, o["b1"])
    prog["change"] = change_norms(params, cfg, ctx.seed, dev)
    _sync(dev)
    ctx.log(f"set-up: {n_check} steps, losses {prog['loss']}")

    update_events = []
    orig_update = adamw.update
    if ctx.trace and _cuda(dev):
        def timed_update(*a, **kw):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = orig_update(*a, **kw)
            e.record()
            update_events.append((s, e))
            return out
        adamw.update = timed_update
    losses, ends = [], []
    depth = int(mix["max_in_flight"])
    ctx.window_started()
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < ctx.seconds:
            params, opt, met = step_fn(params, opt, feed.next())
            losses.append(met["loss"])
            if _cuda(dev):
                e = torch.cuda.Event()
                e.record()
                ends.append(e)
                if len(ends) > depth:
                    ends[-1 - depth].synchronize()
        _sync(dev)
        t1 = time.perf_counter()
    finally:
        adamw.update = orig_update
    steps = len(losses)
    win_s = t1 - t0
    lvals = [float(x) for x in losses]
    failed = sum(1 for x in lvals if not x == x or abs(x) == float("inf"))
    rec = ctx.record(kind="train", window_s=win_s, steps=steps)
    rec.counters.update(tokens=steps * feed.tokens_per_step,
                        model_flops=steps * CM.train_step_flops(
                            cfg, feed.rows, feed.seq))
    rec.extras.update(
        update_ms=[s.elapsed_time(e) for s, e in update_events],
        leaf_numels=[W.get(params, p).numel() for p in _leaf_paths(cfg)],
        state_block=o["state_block"])
    ctx.log(f"window: {steps} steps, {win_s:.3f} s, last loss "
            f"{lvals[-1] if lvals else None}")

    if ctx.trace:
        def one():
            nonlocal params, opt
            params, opt, _ = step_fn(params, opt, feed.next())

        n_prof = int(mix["profile_steps"])
        for attempt in range(1, 4):
            before = qpack.encode_launches + qpack.decode_launches
            tr = TRC.profile(one, n_prof)
            want = (qpack.encode_launches + qpack.decode_launches -
                    before) // (n_prof + 1) * n_prof
            got = len([x for x in tr.ops if "encode_kernel" in x.name or
                       "decode_kernel" in x.name])
            if got == want or not tr.ops:
                break
            ctx.log(f"trace {attempt}: {got} of {want} B3/B4 records; "
                    "taken again")
        rec.trace = tr
    ctx.memory_read()

    out = {"train_tokens_per_s": steps * feed.tokens_per_step / win_s,
           "attempted": steps, "failed": failed, "steps": steps,
           "window_s": win_s}
    del params, opt, step_fn, met, losses
    gc.collect()
    if _cuda(dev):
        torch.cuda.empty_cache()
    out["checks"], out["variants"] = check(cfg, mix, o, ctx, prog)
    return out


def reference_readings(cfg, mix: Dict, o: Dict, seed: int, device,
                       prec: str = "f32", fault: str = "") -> Dict:
    """The reference's readings over the checked steps: each loss, each
    leaf's clipped first gradient, each leaf's change after the steps.
    ``fault`` plants one of the check's faults in the reference put in the
    program's place (``"half_batch"``: half the rows left out)."""
    params = W.stacked_params(cfg, seed, device)
    feed = TrainFeed(mix, cfg.vocab_size, seed, device)
    adam = RT.CompressedAdamW(params, o)
    out = {"loss": []}
    for i in range(int(mix["checked_steps"])):
        batch = feed.next()
        if fault == "half_batch":
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        loss, grads = RT.loss_and_grads(params, batch, cfg, prec)
        clip = adam.update(params, grads)
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = [RT.leaf_norm(W.get(grads, p)) * clip
                           for p in _leaf_paths(cfg)]
        del grads
    out["change"] = change_norms(params, cfg, seed, device)
    del params, adam
    gc.collect()
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers the check holds: the worst step's loss gap over the
    reference's loss; the worst leaf's gap of the first gradient's norm;
    the median leaf's gap of the change's norm; each leaf's gap over the
    larger of the reference's norm of that leaf and of the median leaf.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change. The worst leaf's change gap is
    reported beside, not held: the 8-bit sqrt(v) of an element can round
    to 0 while its m does not, and the update m / eps then moves that
    element by orders more on one side or the other, by rounding alone
    (PERF.md)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                    ref["loss"]))

    def gaps(a, b, keep):
        pairs = [(x, y) for x, y, k in zip(a, b, keep) if k]
        med = sorted(y for _, y in pairs)[len(pairs) // 2]
        return sorted(abs(x - y) / max(y, med) for x, y in pairs)

    gmed = sorted(ref["grad"])[len(ref["grad"]) // 2]
    keep = [g >= 1e-3 * gmed for g in ref["grad"]]
    change = gaps(prog["change"], ref["change"], keep)
    return {"loss_gap": loss,
            "grad_gap": gaps(prog["grad"], ref["grad"], [True] * len(keep))[-1],
            "change_gap": change[len(change) // 2],
            "change_gap_worst_leaf": change[-1]}


def check(cfg, mix: Dict, o: Dict, ctx, prog: Dict):
    """The numbers ``compare`` holds, and, in a control run, the same
    numbers of each planted variant: the control (the reference with float8
    linear layers) and half the batch left out, each put in the program's
    place."""
    t0 = time.perf_counter()
    ref = reference_readings(cfg, mix, o, ctx.seed, ctx.device)
    out = compare(prog, ref)
    ctx.log(f"check: program {prog}")
    ctx.log(f"check: reference {ref}")
    ctx.log(f"check: {out}, reference {time.perf_counter() - t0:.3f} s")
    planted = {}
    if ctx.control:
        low = reference_readings(cfg, mix, o, ctx.seed, ctx.device, "fp8")
        planted["fp8"] = compare(low, ref)
        half = reference_readings(cfg, mix, o, ctx.seed, ctx.device,
                                  fault="half_batch")
        planted["half_batch"] = compare(half, ref)
        ctx.log(f"control: {planted}")
    return out, planted
