"""The serve window's arithmetic: the 95th percentile is over every gap
between a request's tokens, the rate over every token and all the
window's time; a synthetic stall moves both."""
from __future__ import annotations

import time
from types import SimpleNamespace

from tiny import REPO  # noqa: F401  (puts the repository on the path)
from bench.harness import serve as S


class FakeEngine:
    """Lanes that each make one token a step; ``stall`` seconds more on
    every step whose number ``stall_every`` divides."""

    def __init__(self, lanes, stall=0.0, stall_every=0):
        self.lanes, self.stall, self.every = lanes, stall, stall_every
        self.requests, self.queue, self.n = {}, [], 0
        self.cfg = None
        self._admit = self._park_lane = self._install_parked = None

    def submit(self, prompt, max_new):
        rid = len(self.requests)
        self.requests[rid] = SimpleNamespace(
            rid=rid, prompt=prompt, generated=[], max_new_tokens=max_new,
            state="waiting", parked=None)
        self.queue.append(rid)
        return rid

    def step(self):
        self.n += 1
        self._admit()
        time.sleep(0.002 + (self.stall if self.every and
                            self.n % self.every == 0 else 0.0))
        for r in self.requests.values():
            if r.state == "running":
                r.generated.append(1)
                if len(r.generated) >= r.max_new_tokens:
                    r.state = "done"
        return True


class Traffic:
    def request(self, k):
        return [1, 2, 3], 10


def _window(stall, every, steps=60):
    eng = FakeEngine(4, stall, every)
    running = []

    def admit():
        while eng.queue and len(running) < 4:
            rid = eng.queue.pop(0)
            eng.requests[rid].state = "running"
            eng.requests[rid].generated.append(0)
            running.append(rid)
        running[:] = [r for r in running
                      if eng.requests[r].state != "done"]

    eng._admit = admit
    eng._park_lane = eng._install_parked = lambda *a: None
    probe = S.Probe(eng)
    loop = S.ClosedLoop(eng, probe, Traffic(), 4, 4)
    loop.flops_of = lambda log: 0
    loop.step()
    w = loop.win = S.Window()
    w.t0 = time.perf_counter()
    for _ in range(steps):
        loop.step()
    return w


def test_p95_over_all_gaps_and_rate_over_window_move_with_a_stall():
    base = _window(0.0, 0)
    slow = _window(0.03, 5)
    for w in (base, slow):
        # every token after a request's first has a gap, in the window
        assert len(w.gaps) > 0.8 * w.tokens
    rate = [w.tokens / (w.t1 - w.t0) for w in (base, slow)]
    p95 = [S._p95(sorted(w.gaps)) for w in (base, slow)]
    assert rate[1] < 0.6 * rate[0]
    assert p95[1] > 5 * p95[0]
    # one long stall in forty steps, under the 95th percentile's reach:
    # the percentile does not move, the rate does
    rare = _window(0.1, 40, steps=80)
    assert S._p95(sorted(rare.gaps)) < 3 * p95[0]
    assert rare.tokens / (rare.t1 - rare.t0) < 0.75 * rate[0]
