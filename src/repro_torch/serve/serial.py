"""Per-lane reference serving engine, the batched scheduler's baseline
(PyTorch port of ``repro.serve.serial``): one exact-length prefill and one
sync per request, a full-logits fetch every step with a per-lane argmax on
the host, and no lane shadowing (resume drops the parked copy). The tests
hold the batched engine to it token for token.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.engine import (DONE, PREEMPTED, RUNNING, Request,
                                      _EngineBase, _lane_install, _lane_slice,
                                      _prefill_impl)
from repro_torch.models import decode as D


class SerialEngine(_EngineBase):
    """Per-lane host-loop engine (see module docstring)."""

    def _admit(self) -> None:
        started = set()
        while self.queue:
            lane = self._free_lane()
            if lane is None:
                break
            started.add(lane)
            self._start(self.queue.pop(0), lane)
        # at most one preemption per step; lanes started this step are not
        # eligible victims (the batched engine's rule, so both preempt the
        # same schedule)
        if self.queue:
            occupied = np.array([r is not None and i not in started
                                 for i, r in enumerate(self.lane_req)])
            victim, new_ref = self._victim_policy.select_mask(occupied,
                                                              self._ref)
            if victim is not None:
                self._ref = new_ref
                self._preempt(victim)
                self._start(self.queue.pop(0), victim)

    def _start(self, rid: int, lane: int) -> None:
        req = self.requests[rid]
        if req.parked is not None:
            self._resume(req, lane)
            return
        S = len(req.prompt)
        batch = {"tokens": self._upload([req.prompt], torch.int32)}
        if self.cfg.frontend != "none":
            batch["embeds"] = torch.zeros((1, S, self.cfg.d_model),
                                          dtype=torch.bfloat16,
                                          device=self.device)
        toks, sub = _prefill_impl(self.params, batch,
                                  self._upload([S], torch.int32), **self._kw)
        _lane_install(self.cache, lane, _lane_slice(sub, 0))
        self.counters["prefill_batches"] += 1
        tok = int(self._fetch(toks, "admit_syncs")[0])   # a sync per request
        req.generated.append(tok)
        req.pos = S
        req.lane = lane
        req.state = RUNNING
        self._ref[lane] = True
        self.lane_req[lane] = rid
        self.counters["promotions"] += 1
        if req.max_new_tokens <= 1 or req.pos >= self.max_len - 1:
            req.state = DONE
            req.lane = -1
            self.lane_req[lane] = None

    def _preempt(self, lane: int) -> None:
        """Demote and park; no shadow survives in the baseline, so this
        always pays the full compressed payload."""
        rid = self.lane_req[lane]
        req = self.requests[rid]
        self._park_lane(req, lane)
        self.counters["demotions"] += 1
        req.state = PREEMPTED
        req.lane = -1
        self.lane_req[lane] = None
        self._ref[lane] = False
        self.queue.append(rid)

    def _resume(self, req: Request, lane: int) -> None:
        self._install_parked(req, lane)
        self._drop_park(req)
        req.shadow_pos = 0
        self._ref[lane] = True

    def step(self) -> bool:
        """One engine iteration: a full-logits fetch plus a host loop with
        one argmax per lane."""
        self._admit()
        active = [(lane, rid) for lane, rid in enumerate(self.lane_req)
                  if rid is not None]
        if not active:
            return bool(self.queue)
        tokens = np.zeros((self.lanes,), np.int32)
        pos = np.zeros((self.lanes,), np.int32)
        for lane, rid in active:
            req = self.requests[rid]
            tokens[lane] = req.generated[-1] if req.generated else 0
            pos[lane] = req.pos
        embeds = None
        if self.cfg.frontend != "none":
            embeds = torch.zeros((self.lanes, self.cfg.d_model),
                                 dtype=torch.bfloat16, device=self.device)
        logits, self.cache = D.decode_step(
            self.params, self.cache, self._upload(tokens, torch.int32),
            self._upload(pos, torch.int32), self.cfg, self.scfg, embeds)
        self.counters["steps"] += 1
        # full-logits host sync (f32: numpy has no bf16; the order is kept)
        logits = self._fetch(logits.to(torch.float32), "step_syncs").numpy()
        for lane, rid in active:
            req = self.requests[rid]
            req.pos += 1
            self._ref[lane] = True
            req.generated.append(int(np.argmax(logits[lane])))
            self.counters["tokens"] += 1
            if len(req.generated) >= req.max_new_tokens or \
                    req.pos >= self.max_len - 1:
                req.state = DONE
                req.lane = -1
                self.lane_req[lane] = None
        return True
