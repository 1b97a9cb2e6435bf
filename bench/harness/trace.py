"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a few
steps of the warm program, reduced to the device's busy seconds (the union
of its operations' intervals), the segment's length, the operations by
device time and the idle gaps by what the host was doing.

The host's side is recorded too (``ProfilerActivity.CPU``), only over the
segment, so that each idle gap is named by the harness's span that held it
(``bench.admit``, ``bench.step`` ...) and the host operation under way, or
``python`` where the host was between operations. One step runs in the
profiler's warm-up first, its events discarded: a trace started on the
steps themselves can lose the records of its first launches.
"""
from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

SEGMENT = "bench.segment"
PREFIX = "bench."


@dataclass
class DeviceOp:
    name: str
    start: float      # seconds from the trace's origin
    end: float


@dataclass
class Trace:
    ops: List[DeviceOp]
    busy_s: float
    window_s: float
    steps: int
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    extras: Dict = field(default_factory=dict)

    def named(self, *parts: str) -> List[DeviceOp]:
        """The operations whose name holds any of ``parts``."""
        return [o for o in self.ops if any(p in o.name for p in parts)]


def union_s(spans: List[Tuple[float, float]]) -> float:
    """Seconds in the union of the intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(spans: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The sub-intervals of [lo, hi] that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(spans):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def _label_gaps(host, idle: List[Tuple[float, float]]) -> Dict[str, float]:
    """Idle seconds by (the innermost harness span, the host operation)
    under way at each gap's midpoint."""
    spans = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6,
                    e.name[len(PREFIX):]) for e in host
                   if e.name.startswith(PREFIX) and e.name != SEGMENT)
    ops = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
                 for e in host if not e.name.startswith(PREFIX) and
                 (e.cpu_parent is None or
                  e.cpu_parent.name.startswith(PREFIX)))
    op_starts = [o[0] for o in ops]
    out: Dict[str, float] = {}
    for a, b in idle:
        mid = 0.5 * (a + b)
        span = "outside"
        for s0, s1, name in spans:
            if s0 <= mid <= s1:
                span = name            # later starts are the inner ones
        i = bisect.bisect_right(op_starts, mid) - 1
        op = ops[i][2] if i >= 0 and ops[i][1] >= mid else "python"
        key = f"{span}:{op}"
        out[key] = out.get(key, 0.0) + (b - a)
    return out


def profile(step: Callable[[], None], n: int,
            after_step: Optional[Callable[[], None]] = None) -> Trace:
    """``n`` calls of ``step`` under the profiler, after one in its
    warm-up; ``after_step`` runs after each recorded call (outside the
    segment's device work: it may record what the step left behind)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import record_function, schedule
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tprofile(activities=acts,
                  schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        step()
        _sync()
        prof.step()
        t0 = time.perf_counter()
        with record_function(SEGMENT):
            for _ in range(n):
                step()
                if after_step is not None:
                    after_step()
            _sync()
        wall = time.perf_counter() - t0
    events = prof.events()
    seg = [e for e in events if e.name == SEGMENT]
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not e.name.startswith("ProfilerStep")
           and not e.name.startswith(PREFIX)]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and not e.name.startswith("ProfilerStep")]
    if seg:
        lo, hi = seg[0].time_range.start / 1e6, seg[0].time_range.end / 1e6
    else:
        lo, hi = 0.0, wall
    ops = [DeviceOp(e.name, max(e.time_range.start / 1e6, lo),
                    min(e.time_range.end / 1e6, hi)) for e in dev]
    ops = [o for o in ops if o.end > o.start]
    spans = [(o.start, o.end) for o in ops]
    by_name: Dict[str, float] = {}
    for o in ops:
        key = o.name[:160]
        by_name[key] = by_name.get(key, 0.0) + (o.end - o.start)
    idle = _label_gaps(host, gaps(spans, lo, hi)) if ops else {}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Trace(ops=ops, busy_s=union_s(spans), window_s=hi - lo, steps=n,
                 device_ops=[[k, v] for k, v in top],
                 idle_gaps=[[k, v] for k, v in top_gaps])


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
