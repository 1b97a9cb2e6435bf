"""Continuous-batching serving engine with IBEX-managed KV residency
(PyTorch port of ``repro.serve.engine``: GQA/MHA K and V, MLA's latent
cache, or the SSM family's recurrent state).

  * running requests occupy decode *lanes* (batch slots of ``decode_step``):
    their recent tokens sit uncompressed in the hot ring (promoted region),
    older tokens in the quantized region;
  * a **preempted** request is *demoted*: its live ring tokens are
    quantized into the codes region on the card, in place (the lane flush,
    one launch for every layer's K and V, or for MLA's latent; always a
    clean demotion, KV is append-only) and only the codes + scales are
    parked on the host;
  * **resume** is a promotion: the lane adopts the parked codes (cold_len =
    full length, empty ring) and decode reads them through the fused
    dequantizing attention: no KV byte is dequantized on promotion;
  * **shadowed lanes** (§4.5): the parked copy is kept after resume and its
    prefix stays valid; a re-preempt moves only the suffix generated since
    the last park, an untouched resumed request moves zero bytes;
  * victim selection is the §4.4 second-chance sweep over lanes
    (``SecondChanceLanes.select_mask``).

**Host-sync contract.** Lane bookkeeping (last token, position, reference
bit, active mask, remaining budget) lives in tensors on the card and is
advanced inside the engine step. The host performs exactly ONE sync per
decode step (``counters["step_syncs"]``): one counted fetch of the stacked
int32 (tok, done, ref, pos) rows. Admission syncs (one per prefill bucket,
one per demotion fetch) count in ``counters["admit_syncs"]``. Every fetch
also counts in ``common.contracts.SYNCS``.

**Prefill batching.** Fresh requests admitted in the same step are
prefilled together in power-of-two length buckets (right-padded; the
prefill's ``lens`` keeps padded positions out of the valid range). The
SSM family's recurrent state cannot take right-padding: its requests are
grouped by exact length (rows still padded to a power of two).

**SSM state.** An SSM lane has no compressed form: preemption parks its
raw recurrent state (``ssm.*`` leaves, no quantize, no flush) and resume
installs it back; both move the state in full (``_moved_bytes``).

The cache is updated in place (``models/decode.py``). ``modeled_time``
prices the counters with ``simx.time``. ``obs`` (a
``repro_torch.obs.Recorder``) records each step from the step's one fetch
and each admission, preemption and resume from host bookkeeping: zero
extra syncs. ``serve.serial.SerialEngine`` is the per-lane baseline; both
engines share ``_EngineBase``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common.types import ModelConfig, ServeConfig
from repro_torch.common.utils import next_pow2, resolve_device
from repro_torch.core.compressor import resolve_quantize_impl
from repro_torch.core.engine.policy import SecondChanceLanes
from repro_torch.kernels import qpack
from repro_torch.models import decode as D

WAITING, RUNNING, PREEMPTED, DONE = "waiting", "running", "preempted", "done"

# bf16 hot-ring leaves: quantized into the codes region on demotion, zeroed
# on resume; never parked, never moved
HOT_KEYS = ("k_hot", "v_hot", "lat_hot")


@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    state: str = WAITING
    generated: List[int] = field(default_factory=list)
    lane: int = -1
    pos: int = 0                      # next position to write
    parked: Optional[Dict[str, Any]] = None   # demoted KV on the host
    # tokens [0, shadow_pos) of ``parked`` match the lane's KV bit for bit
    shadow_pos: int = 0
    expander: int = -1


# ---------------------------------------------------------------------------
# Device-side engine ops.
# ---------------------------------------------------------------------------

def _engine_step_impl(params, cache, state, embeds=None, *, cfg: ModelConfig,
                      scfg: ServeConfig, max_len: int):
    """One decode step over all lanes, lane bookkeeping advanced on the
    card. state: {tok,pos,remaining int32[lanes]; active,ref bool[lanes]}.
    Returns (cache, new_state, done[lanes])."""
    logits, cache = D.decode_step(params, cache, state["tok"], state["pos"],
                                  cfg, scfg, embeds)
    active = state["active"]
    step = active.to(torch.int32)
    tok = torch.where(active, logits.argmax(dim=-1).to(torch.int32),
                      state["tok"])
    pos = state["pos"] + step
    remaining = state["remaining"] - step
    done = active & ((remaining <= 0) | (pos >= max_len - 1))
    new_state = {"tok": tok, "pos": pos, "remaining": remaining,
                 "active": active & ~done, "ref": state["ref"] | active}
    return cache, new_state, done


def _prefill_impl(params, batch, lens, *, cfg: ModelConfig, scfg: ServeConfig,
                  max_len: int):
    """Bucketed prefill: (first tokens int32[B], cache); argmax on the card
    so admission costs one fetch of B scalars per bucket."""
    logits, cache = D.prefill(params, batch, cfg, scfg, max_len, lens=lens)
    return logits.argmax(dim=-1).to(torch.int32), cache


def _demote_lane_impl(lane_cache, pos: int, *, scfg: ServeConfig):
    """Clean-demote one lane's cache slice: its live ring tokens are
    quantized into the codes region, in place (the lane flush; the lane's
    slice is parked right after and rewritten whole before it is read
    again), and cold_len advances to ``pos`` (a new tensor). An MLA cache
    flushes its one latent stream (the latent lane flush); an SSM cache
    passes through raw."""
    out = dict(lane_cache)
    if "cold_len" not in out:
        return out
    kernel = resolve_quantize_impl(scfg.quantize_impl,
                                   out["cold_len"].device) == "kernel"
    if "lat_hot" in out:
        flush = qpack.latent_lane_flush if kernel else \
            qpack.latent_lane_flush_plain
        names = ("lat_codes", "lat_scales", "lat_hot", "cold_len")
    else:
        flush = qpack.lane_flush if kernel else qpack.lane_flush_plain
        names = ("k_codes", "k_scales", "k_hot", "v_codes", "v_scales",
                 "v_hot", "cold_len")
    out["cold_len"] = flush(*(out[n] for n in names), pos, scfg.kv_rate_bits)
    return out


# ---------------------------------------------------------------------------
# Lane slice/install (batch axis 1), in place.
# ---------------------------------------------------------------------------

def _lane_slice(cache, lane: int):
    return {k: v[:, lane] for k, v in cache.items()}


def _lane_install(cache, lane: int, lane_cache) -> None:
    for k, v in cache.items():
        v[:, lane] = lane_cache[k].to(device=v.device, dtype=v.dtype)


def _lanes_install(cache, lanes: torch.Tensor, sub_cache) -> None:
    """Install a prefilled sub-batch (rows aligned with ``lanes``)."""
    for k, v in cache.items():
        v[:, lanes] = sub_cache[k].to(v.dtype)


def _moved_bytes(parked: Dict[str, Any], n_tokens: int, max_len: int) -> int:
    """Bytes a park/restore moves: the compressed payload (codes + scales)
    of ``n_tokens`` tokens, plus the SSM family's raw recurrent state in
    full (no compressed form, no append-only prefix): the modeled CXL
    traffic of the motion."""
    total = 0
    for k, v in parked.items():
        nbytes = v.numel() * v.element_size()
        if k.startswith("ssm."):
            total += nbytes
        elif k != "cold_len":
            total += (nbytes // max_len) * min(int(n_tokens), max_len)
    return total


# ---------------------------------------------------------------------------
# Shared engine chassis.
# ---------------------------------------------------------------------------

class _EngineBase:
    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 max_len: int = 2048, seed: int = 0, device=None, obs=None):
        self.cfg, self.scfg = cfg, scfg
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self.lanes = scfg.max_running
        self.cache = D.init_cache(cfg, scfg, self.lanes, max_len, self.device)
        self.lane_req: List[Optional[int]] = [None] * self.lanes
        self.requests: Dict[int, Request] = {}
        self.queue: List[int] = []
        self._next_rid = 0
        self._victim_policy = SecondChanceLanes(self.lanes)
        self._ref = np.zeros((self.lanes,), bool)
        self.counters = {"promotions": 0, "demotions": 0, "preempt_bytes": 0,
                         "resume_bytes": 0, "steps": 0, "tokens": 0,
                         "step_syncs": 0, "admit_syncs": 0,
                         "shadow_repreempts": 0, "prefill_batches": 0,
                         "cross_expander_resumes": 0}
        self.n_expanders = max(int(scfg.n_expanders), 1)
        self.lane_expander = np.arange(self.lanes) % self.n_expanders
        self.expander_stats = {
            "parked": np.zeros((self.n_expanders,), np.int64),
            "preempt_bytes": np.zeros((self.n_expanders,), np.int64),
            "resume_bytes": np.zeros((self.n_expanders,), np.int64),
        }
        self._kw = dict(cfg=cfg, scfg=scfg, max_len=max_len)
        self.obs = obs
        if obs is not None:
            obs.attach_serve(self)

    # -- client API ---------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        if not 1 <= len(prompt) <= self.max_len - 1:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"[1, {self.max_len - 1}]")
        rid = self._next_rid
        self._next_rid += 1
        self.requests[rid] = Request(rid, [int(t) for t in prompt],
                                     max_new_tokens)
        self.queue.append(rid)
        return rid

    def result(self, rid: int) -> List[int]:
        return self.requests[rid].generated

    def run_until_done(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return

    def step(self) -> bool:
        raise NotImplementedError

    # -- host <-> device ----------------------------------------------------

    def _fetch(self, tree, kind: str):
        """The ONLY place device values cross to the host. Each call is one
        blocking sync, counted per path (step vs admission)."""
        self.counters[kind] += 1
        return contracts.fetch(tree)

    def _upload(self, values, dtype) -> torch.Tensor:
        return contracts.upload(values, dtype, self.device)

    # -- delivered-time accounting ------------------------------------------

    def modeled_time(self, devices=None) -> Dict[str, Any]:
        """The engine's preempt/resume bytes and host syncs in modeled
        seconds (``simx.time.serve_modeled_time``): each expander's payload
        motion priced by its own DeviceConfig (the bottleneck across the
        stripe), plus one CXL round trip per host sync."""
        from repro_torch.simx import time as TM
        devs = TM.resolve_fleet(devices, self.n_expanders)
        return TM.serve_modeled_time(self.counters, self.expander_stats,
                                     devs)

    # -- shared mechanics ---------------------------------------------------

    def _free_lane(self) -> Optional[int]:
        for i, r in enumerate(self.lane_req):
            if r is None:
                return i
        return None

    def _drop_park(self, req: Request) -> None:
        if req.parked is not None and req.expander >= 0:
            self.expander_stats["parked"][req.expander] -= 1
        req.parked = None

    def _park_lane(self, req: Request, lane: int) -> None:
        """Demote the lane on the card (quantize ring -> codes) and park
        the compressed payload, charging only the suffix not already
        covered by the request's shadow."""
        covered = req.shadow_pos if req.parked is not None else 0
        exp = int(self.lane_expander[lane])
        if req.parked is None or req.expander != exp:
            if req.parked is not None and req.expander >= 0:
                self.expander_stats["parked"][req.expander] -= 1
            self.expander_stats["parked"][exp] += 1
        demoted = _demote_lane_impl(_lane_slice(self.cache, lane), req.pos,
                                    scfg=self.scfg)
        kept = {k: v for k, v in demoted.items() if k not in HOT_KEYS}
        req.parked = self._fetch(kept, "admit_syncs")
        req.shadow_pos = req.pos
        req.expander = exp
        moved = _moved_bytes(req.parked, req.pos - covered, self.max_len)
        self.counters["preempt_bytes"] += moved
        self.expander_stats["preempt_bytes"][exp] += moved

    def _install_parked(self, req: Request, lane: int) -> None:
        """Promotion: install parked codes into the lane (empty ring, full
        cold_len); nothing is decompressed."""
        lane_tree = {}
        for k, a in self.cache.items():
            if k in HOT_KEYS:
                lane_tree[k] = torch.zeros(a.shape[:1] + a.shape[2:],
                                           dtype=a.dtype, device=a.device)
            else:
                lane_tree[k] = req.parked[k]
        _lane_install(self.cache, lane, lane_tree)
        moved = _moved_bytes(req.parked, req.pos, self.max_len)
        self.counters["resume_bytes"] += moved
        exp = int(self.lane_expander[lane])
        self.expander_stats["resume_bytes"][exp] += moved
        cross = req.expander >= 0 and req.expander != exp
        if cross:
            self.counters["cross_expander_resumes"] += 1
            self.expander_stats["parked"][req.expander] -= 1
            self.expander_stats["parked"][exp] += 1
            req.expander = exp
        self.counters["promotions"] += 1
        if self.obs is not None:
            self.obs.record_resume(lane, req.rid, moved, cross, exp)
        req.lane = lane
        req.state = RUNNING
        self.lane_req[lane] = req.rid


class Engine(_EngineBase):
    """Device-resident batched scheduler (module docstring has the design)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig, params,
                 max_len: int = 2048, seed: int = 0, device=None, obs=None):
        super().__init__(cfg, scfg, params, max_len, seed, device, obs)

        def z(dtype):
            return torch.zeros((self.lanes,), dtype=dtype, device=self.device)

        self.state = {"tok": z(torch.int32), "pos": z(torch.int32),
                      "remaining": z(torch.int32), "active": z(torch.bool),
                      "ref": z(torch.bool)}
        # recurrent state cannot take right-padding: exact-length groups
        self._bucketed = cfg.family not in ("ssm", "hybrid")

    def _set_lane_state(self, lane: int, tok: int, pos: int, remaining: int
                        ) -> None:
        st = self.state
        st["tok"][lane] = tok
        st["pos"][lane] = pos
        st["remaining"][lane] = remaining
        st["active"][lane] = True
        st["ref"][lane] = True
        self._ref[lane] = True

    def _clear_lane_state(self, lane: int) -> None:
        self.state["active"][lane] = False
        self.state["ref"][lane] = False
        self._ref[lane] = False

    # -- scheduling ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        if not self._bucketed:
            return n
        return min(max(next_pow2(n), 8), self.max_len)

    def _admit(self) -> None:
        fresh, resumed = [], []

        def claim(rid: int, lane: int) -> None:
            self.lane_req[lane] = rid
            req = self.requests[rid]
            (resumed if req.parked is not None else fresh).append((rid, lane))

        while self.queue:
            lane = self._free_lane()
            if lane is None:
                break
            claim(self.queue.pop(0), lane)
        # at most ONE preemption per engine step; lanes claimed this step
        # are not eligible victims (their KV is not installed yet)
        if self.queue:
            claimed = {lane for _, lane in fresh + resumed}
            occupied = np.array([r is not None and i not in claimed
                                 for i, r in enumerate(self.lane_req)])
            groups = self.lane_expander if self.n_expanders > 1 else None
            load = (self.expander_stats["parked"]
                    if self.n_expanders > 1 else None)
            victim, new_ref = self._victim_policy.select_mask(
                occupied, self._ref, groups=groups, group_load=load)
            if victim is not None:
                self._ref = new_ref
                self.state["ref"] = self._upload(new_ref.tolist(), torch.bool)
                self._preempt(victim)
                claim(self.queue.pop(0), victim)
        for rid, lane in resumed:
            self._resume(self.requests[rid], lane)
        if fresh:
            self._start_fresh(fresh)

    def _start_fresh(self, items) -> None:
        """Batched prefill of the fresh admissions, grouped into length
        buckets: one prefill and one host sync per bucket."""
        groups: Dict[int, list] = {}
        for rid, lane in items:
            L = self._bucket(len(self.requests[rid].prompt))
            groups.setdefault(L, []).append((rid, lane))
        for L, grp in sorted(groups.items()):
            k = len(grp)
            Bp = next_pow2(k)           # pad rows too: fewer distinct shapes
            tokens = np.zeros((Bp, L), np.int32)
            lens = np.ones((Bp,), np.int32)
            for i, (rid, _) in enumerate(grp):
                p = self.requests[rid].prompt
                tokens[i, :len(p)] = p
                lens[i] = len(p)
            batch = {"tokens": self._upload(tokens, torch.int32)}
            if self.cfg.frontend != "none":
                batch["embeds"] = torch.zeros((Bp, L, self.cfg.d_model),
                                              dtype=torch.bfloat16,
                                              device=self.device)
            toks, sub = _prefill_impl(self.params, batch,
                                      self._upload(lens, torch.int32),
                                      **self._kw)
            lanes_t = self._upload([lane for _, lane in grp], torch.int64)
            _lanes_install(self.cache, lanes_t,
                           {kk: vv[:, :k] for kk, vv in sub.items()})
            del sub
            toks_h = self._fetch(toks[:k], "admit_syncs").tolist()
            self.counters["prefill_batches"] += 1
            if self.obs is not None:
                self.obs.record_admission(k, L)
            for i, (rid, lane) in enumerate(grp):
                req = self.requests[rid]
                req.generated.append(int(toks_h[i]))
                req.pos = int(lens[i])
                req.lane = lane
                req.state = RUNNING
                self.counters["promotions"] += 1
                remaining = req.max_new_tokens - 1
                if remaining <= 0 or req.pos >= self.max_len - 1:
                    req.state = DONE
                    req.lane = -1
                    self.lane_req[lane] = None
                else:
                    self._set_lane_state(lane, int(toks_h[i]), req.pos,
                                         remaining)

    def _preempt(self, lane: int) -> None:
        """Demote the lane. A shadow still covering every token moves zero
        bytes (re-validated, §4.5); a partial shadow pays only the suffix."""
        rid = self.lane_req[lane]
        req = self.requests[rid]
        shadow_hit = req.parked is not None and req.shadow_pos >= req.pos
        if shadow_hit:
            self.counters["shadow_repreempts"] += 1
            moved = 0
        else:
            before = self.counters["preempt_bytes"]
            self._park_lane(req, lane)
            moved = self.counters["preempt_bytes"] - before
        if self.obs is not None:
            self.obs.record_preempt(lane, rid, moved, shadow_hit,
                                    int(self.lane_expander[lane]))
        self.counters["demotions"] += 1
        req.state = PREEMPTED
        req.lane = -1
        self.lane_req[lane] = None
        self._clear_lane_state(lane)
        self.queue.append(rid)

    def _resume(self, req: Request, lane: int) -> None:
        """Promotion; the parked copy stays behind as a shadow."""
        self._install_parked(req, lane)
        self._set_lane_state(lane, req.generated[-1], req.pos,
                             req.max_new_tokens - len(req.generated))

    # -- decode step ---------------------------------------------------------

    @contracts.sync_contract(syncs_per="step", fetches=1)
    def step(self) -> bool:
        """One engine iteration. Returns False when no work remains.
        Exactly one host sync per call once lanes are running
        (``step_syncs == steps``)."""
        self._admit()
        active = [(lane, rid) for lane, rid in enumerate(self.lane_req)
                  if rid is not None]
        if not active:
            return bool(self.queue)
        embeds = None
        if self.cfg.frontend != "none":
            embeds = torch.zeros((self.lanes, self.cfg.d_model),
                                 dtype=torch.bfloat16, device=self.device)
        self.cache, self.state, done = _engine_step_impl(
            self.params, self.cache, self.state, embeds, **self._kw)
        self.counters["steps"] += 1
        quad = torch.stack([self.state["tok"], done.to(torch.int32),
                            self.state["ref"].to(torch.int32),
                            self.state["pos"]])
        tok_h, done_h, ref_h, pos_h = self._fetch(quad, "step_syncs").tolist()
        self._ref = np.array(ref_h, bool)
        if self.obs is not None:
            # telemetry drain: the host rows of this step's one fetch
            self.obs.record_step(self.counters["steps"], tok_h, done_h,
                                 pos_h, [lane for lane, _ in active])
        for lane, rid in active:
            req = self.requests[rid]
            req.pos += 1
            req.generated.append(int(tok_h[lane]))
            self.counters["tokens"] += 1
            if done_h[lane]:
                req.state = DONE
                req.lane = -1
                self._drop_park(req)
                self.lane_req[lane] = None
        return True
