"""A serve cell: ``repro_torch.serve.Engine`` under a closed loop of
clients, each sending its next request when its last completes.

Set-up makes the weights, warms the prefill's shapes, joins the clients a
few a step and runs ``warm_steps`` engine steps, so the window starts with
every lane filled and, where there are more clients than lanes, the queue
in steady state. The window runs whole engine steps until ``--seconds``
have passed. The harness times the calls into the engine's layers from
outside (``Engine._admit``, ``_park_lane``, ``_install_parked`` wrapped on
the instance) and counts what a token, a park and a resume carry; it
takes no span inside the program.

A token lands when the call that made it returns to the host: a prompt's
first token when ``_admit`` returns (its prefill fetched it), every other
at the end of ``Engine.step``.
"""
from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.counts import model as CM
from bench.harness import trace as TRC
from bench.harness import weights as W
from bench.harness.traffic import ServeTraffic
from bench.reference import model as REF


def _record(name: str):
    return torch.profiler.record_function(name)


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values())


class Probe:
    """Spans and counts around the engine's layers, taken from outside."""

    def __init__(self, eng):
        self.in_window = False
        self.admit_s = 0.0
        self.copy_bytes = 0
        self.parks: Dict[int, List[int]] = {}
        self.resumed_in_window = set()
        self.fresh: List[int] = []
        self.most_fresh = 0           # prompts a step prefilled, at most
        self.n_fresh = 0              # prompts prefilled in all
        self.t_admit_end = 0.0
        admit, park, install = eng._admit, eng._park_lane, eng._install_parked

        def _admit():
            fresh = [rid for rid in eng.queue
                     if not eng.requests[rid].generated]
            t0 = time.perf_counter()
            with _record("bench.admit"):
                admit()
            self.t_admit_end = t1 = time.perf_counter()
            if self.in_window:
                self.admit_s += t1 - t0
            self.fresh = [rid for rid in fresh if eng.requests[rid].generated]
            self.most_fresh = max(self.most_fresh, len(self.fresh))
            self.n_fresh += len(self.fresh)

        def _park_lane(req, lane):
            self.parks.setdefault(req.rid, []).append(req.pos)
            park(req, lane)
            if self.in_window:
                self.copy_bytes += tree_bytes(req.parked)

        def _install_parked(req, lane):
            if self.in_window:
                self.copy_bytes += tree_bytes(req.parked)
                self.resumed_in_window.add(req.rid)
            install(req, lane)

        eng._admit = _admit
        eng._park_lane = _park_lane
        eng._install_parked = _install_parked


@dataclass
class Log:
    prompt_len: int
    seen: int = 0             # tokens landed
    last_t: float = 0.0
    i0: int = -1              # first token index landed in the window
    i1: int = -1


@dataclass
class Finished:
    rid: int
    prompt: List[int]
    served: List[int]
    parks: List[int]                  # the positions it was parked at
    resumed_in_window: bool


@dataclass
class Window:
    t0: float = 0.0
    t1: float = 0.0
    steps: int = 0
    step_s: float = 0.0
    tokens: int = 0
    gaps: List[float] = field(default_factory=list)
    finished: List[Finished] = field(default_factory=list)
    failed: int = 0
    model_flops: int = 0          # of the requests finished in the window


class ClosedLoop:
    def __init__(self, eng, probe: Probe, traffic: ServeTraffic,
                 clients: int, join_per_step: int):
        self.eng, self.probe, self.traffic = eng, probe, traffic
        self.unjoined = clients
        self.join = join_per_step
        self.next_k = 0
        self.live: Dict[int, Log] = {}
        self.win: Optional[Window] = None
        self.landed = 0               # tokens landed in all

    def _submit(self) -> None:
        prompt, olen = self.traffic.request(self.next_k)
        rid = self.eng.submit(prompt, olen)
        self.live[rid] = Log(len(prompt))
        self.next_k += 1

    def _land(self, log: Log, t: float, n: int) -> None:
        w = self.win
        for _ in range(n):
            if w is not None:
                if log.seen > 0:
                    w.gaps.append(t - log.last_t)
                w.tokens += 1
                if log.i0 < 0:
                    log.i0 = log.seen
                log.i1 = log.seen + 1
            log.seen += 1
            log.last_t = t
            self.landed += 1

    def step(self) -> None:
        for _ in range(min(self.join, self.unjoined)):
            self._submit()
            self.unjoined -= 1
        t0 = time.perf_counter()
        with _record("bench.step"):
            self.eng.step()
        t1 = time.perf_counter()
        reqs = self.eng.requests
        for rid in self.probe.fresh:
            self._land(self.live[rid], self.probe.t_admit_end, 1)
        self.probe.fresh = []
        done = []
        for rid, log in self.live.items():
            req = reqs[rid]
            n = len(req.generated) - log.seen
            if n > 0:
                self._land(log, t1, n)
            if req.state == "done":
                done.append(rid)
        w = self.win
        if w is not None:
            w.steps += 1
            w.step_s += t1 - t0
            w.t1 = t1
        for rid in done:
            log = self.live.pop(rid)
            req = reqs[rid]
            if w is not None:
                if len(req.generated) != req.max_new_tokens:
                    w.failed += 1
                w.finished.append(Finished(
                    rid, req.prompt, list(req.generated),
                    list(self.probe.parks.get(rid, [])),
                    rid in self.probe.resumed_in_window))
                w.model_flops += self.flops_of(log)
            self._submit()

    def flops_of(self, log: Log) -> int:
        """Model FLOPs of the log's tokens landed in the window: its
        prompt's pass if the first token landed there, then one decode a
        token."""
        if log.i0 < 0:
            return 0
        cfg, P = self.eng.cfg, log.prompt_len
        total = CM.tokens_flops(cfg, 0, P) if log.i0 == 0 else 0
        lo = max(log.i0, 1)
        return total + CM.tokens_flops(cfg, P + lo - 1, P + log.i1 - 1)

    def window_flops(self, w: Window) -> int:
        """Model FLOPs of every token landed in the window ``w``."""
        return w.model_flops + sum(self.flops_of(log)
                                   for log in self.live.values())


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def prefill_buckets(mix: Dict, max_len: int) -> List[int]:
    """The engine's prefill buckets (``Engine._bucket``: the next power of
    two, at least 8, at most ``max_len``) of the mix's prompt lengths."""
    from repro_torch.common.utils import next_pow2
    lo, hi = int(mix["prompt"]["min"]), int(mix["prompt"]["max"])
    out, b = [], max(next_pow2(lo), 8)
    while b < next_pow2(hi):
        out.append(min(b, max_len))
        b *= 2
    out.append(min(max(next_pow2(hi), 8), max_len))
    return sorted(set(out))


def warm_prefill(params, cfg, scfg, max_len: int, mix: Dict, device) -> int:
    """The prefill at every (rows, bucket) a step of the mix asks for:
    rows 1, 2, 4 ... ``warm_rows``, each bucket of its prompt lengths."""
    from repro_torch.models import decode as D
    n, rows = 0, 1
    while rows <= int(mix["warm_rows"]):
        for L in prefill_buckets(mix, max_len):
            toks = torch.zeros((rows, L), dtype=torch.int32, device=device)
            lens = torch.full((rows,), L, dtype=torch.int32, device=device)
            logits, cache = D.prefill(params, {"tokens": toks}, cfg, scfg,
                                      max_len, lens=lens)
            del logits, cache
            n += 1
        rows *= 2
    _sync(device)
    return n


def run(ctx) -> Dict:
    """The serve cell of ``ctx`` (``harness.cell.Context``)."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.serve.engine import Engine

    dev, cfg, conf, mix = ctx.device, ctx.model, ctx.conf, ctx.mix
    sc = conf["serve"]
    lanes, max_len = int(sc["lanes"]), int(sc["max_len"])
    clients = int(round(lanes * mix["clients_per_lane"]))
    scfg = ServeConfig(max_running=lanes, hot_window=int(sc["hot_window"]),
                       kv_rate_bits=int(sc["kv_rate_bits"]),
                       fused_dequant_attention=bool(
                           sc["fused_dequant_attention"]))
    stacked = W.stacked_params(cfg, ctx.seed, dev)
    params = W.per_layer(stacked, cfg)
    ctx.log(f"weights: {sum(t.numel() for t in _tensors(stacked))} values")
    n_warm = warm_prefill(params, cfg, scfg, max_len, mix, dev)
    eng = Engine(cfg, scfg, params, max_len=max_len, device=dev)
    probe = Probe(eng)
    loop = ClosedLoop(eng, probe, ServeTraffic(
        mix, cfg.vocab_size, ctx.seed), clients,
        int(mix["join_per_step"]))
    warm = Blocks(loop)
    for _ in range(int(mix["warm_steps"])):
        warm.step()
    _sync(dev)
    ctx.log(f"warm-up by {warm.block} steps ({BLOCK_FIELDS}): "
            f"{warm.done()}")
    ctx.log(f"set-up: {n_warm} prefill shapes warmed, {mix['warm_steps']} "
            f"steps, {clients} clients on {lanes} lanes, queue "
            f"{len(eng.queue)}, counters {eng.counters}")

    # the window
    w = loop.win = Window()
    probe.in_window = True
    ctx.window_started()
    w.t0 = time.perf_counter()
    w.t1 = w.t0
    blocks = Blocks(loop)
    while True:
        blocks.step()
        if w.t1 - w.t0 >= ctx.seconds:
            break
    probe.in_window = False
    loop.win = None
    ctx.log(f"window by {blocks.block} steps ({BLOCK_FIELDS}): "
            f"{blocks.done()}")
    win_s = w.t1 - w.t0
    flops = loop.window_flops(w)

    rec = ctx.record(kind="serve", window_s=win_s, steps=w.steps)
    rec.spans.update(admit=probe.admit_s, step=w.step_s)
    rec.counters.update(copy_bytes=probe.copy_bytes, tokens=w.tokens,
                        model_flops=flops, parks=sum(
                            len(v) for v in probe.parks.values()))
    rec.extras.update(lanes=lanes, bits=scfg.kv_rate_bits,
                      itl_p95_ms=_p95(sorted(w.gaps)) * 1e3 if w.gaps
                      else None)

    if ctx.trace:
        colds = []

        def launches():
            return KA.launches + KA.latent_launches

        for attempt in range(1, 4):
            colds.clear()
            before = launches()
            tr = TRC.profile(loop.step, int(mix["profile_steps"]),
                             after_step=lambda: colds.append(
                                 eng.cache["cold_len"].clone()))
            per_step = (launches() - before) // (int(mix["profile_steps"]) + 1)
            want = per_step * int(mix["profile_steps"])
            got = len(tr.named(*_b5_names()))
            if got == want or not tr.ops:
                break
            ctx.log(f"trace {attempt}: {got} of {want} B5 records; taken "
                    "again")
        tr.extras["cold_lens"] = [c.cpu().tolist() for c in colds]
        rec.trace = tr

    ctx.memory_read()
    out = {"tokens": w.tokens, "window_s": win_s, "gaps": len(w.gaps),
           "itl_p95_ms": rec.extras["itl_p95_ms"],
           "serve_tokens_per_s": w.tokens / win_s,
           "attempted": len(w.finished), "failed": w.failed,
           "finished": len(w.finished), "steps": w.steps,
           "counters": dict(eng.counters)}
    ctx.log(f"window: {w.steps} steps, {w.tokens} tokens, {len(w.gaps)} "
            f"gaps, {len(w.finished)} requests finished, "
            f"{len(probe.resumed_in_window)} resumed, copy "
            f"{probe.copy_bytes} B, {win_s:.3f} s, at most "
            f"{probe.most_fresh} prompts prefilled in a step")

    sample = choose(w.finished, ctx.seed, int(mix["check_requests"]),
                    oversub=clients > lanes)
    del loop, probe, eng
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    out["checks"], out["variants"] = check(params, cfg, scfg, sample, ctx)
    return out


class Blocks:
    """Engine steps read by blocks of ``block`` steps: the milliseconds and
    tokens landed a step, the prompts prefilled, and the queue at the
    block's end (of it, the requests parked). Set-up logs its steps so, to
    show that they have settled before the window; the window logs its
    own, to show that they do not drift."""

    def __init__(self, loop: ClosedLoop, block: int = 16):
        self.loop, self.block = loop, block
        self.rows: List[tuple] = []
        self.i = 0

    def step(self) -> None:
        loop, probe = self.loop, self.loop.probe
        if self.i % self.block == 0:
            self._t0, self._n0, self._f0 = (time.perf_counter(), loop.landed,
                                            probe.n_fresh)
        loop.step()
        self.i += 1
        if self.i % self.block == 0:
            self._close(self.block)

    def done(self) -> List[tuple]:
        if self.i % self.block:
            self._close(self.i % self.block)
        return self.rows

    def _close(self, k: int) -> None:
        loop, eng = self.loop, self.loop.eng
        parked = sum(1 for rid in eng.queue
                     if eng.requests[rid].parked is not None)
        self.rows.append((round((time.perf_counter() - self._t0) * 1e3 / k,
                                1),
                          round((loop.landed - self._n0) / k, 1),
                          loop.probe.n_fresh - self._f0, len(eng.queue),
                          parked))


BLOCK_FIELDS = "ms/step, tokens/step, prefills, queue, parked in queue"


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def _b5_names():
    from bench.counts.kernels import B5_KERNELS
    return B5_KERNELS


def _p95(sorted_vals: List[float]) -> float:
    """The 95th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(sorted_vals), 95))


def choose(finished: List[Finished], seed: int, k: int,
           oversub: bool) -> List[Finished]:
    """Requests the reference checks: the one with the most tokens, one
    resumed in the window where the cell parks, and the rest drawn from the
    seed."""
    if not finished:
        return []
    pool = sorted(finished, key=lambda f: f.rid)
    pick = [max(pool, key=lambda f: len(f.prompt) + len(f.served))]
    if oversub:
        resumed = [f for f in pool if f.resumed_in_window and f.parks
                   and f not in pick]
        if resumed:
            pick.append(max(resumed, key=lambda f: len(f.served)))
    rest = [f for f in pool if f not in pick]
    rng = np.random.default_rng([int(seed), 3])
    for i in rng.permutation(len(rest))[:max(k - len(pick), 0)]:
        pick.append(rest[int(i)])
    return pick


def check(params, cfg, scfg, sample: List[Finished], ctx) -> Dict:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over the sample; and, in a control run, the same
    number of the control (the reference with float8 linear layers) put in
    the program's place."""
    t0 = time.perf_counter()
    worst, n_tok = 0.0, 0
    control = ctx.control
    worst_ctl = 0.0
    parked = 0
    for f in sample:
        precs = ("f32", "fp8") if control else ("f32",)
        lg = REF.served_logits(params, cfg, f.prompt, f.served, f.parks,
                               scfg.hot_window, scfg.kv_rate_bits, precs)
        gaps = REF.served_gaps(lg["f32"], f.served)
        worst = max(worst, float(gaps.max()))
        n_tok += len(f.served)
        parked += int(bool(f.parks))
        if control:
            worst_ctl = max(worst_ctl, float(REF.control_gaps(
                lg["f32"], lg["fp8"]).max()))
        del lg
    ctx.log(f"check: {len(sample)} requests ({parked} parked), {n_tok} "
            f"served tokens, widest gap {worst!r}, reference "
            f"{time.perf_counter() - t0:.3f} s")
    return {"logit_gap": worst, "checked_tokens": n_tok}, \
        ({"fp8": {"logit_gap": worst_ctl}} if control else {})
