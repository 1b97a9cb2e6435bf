"""The Recorder: host-side accumulator for piggybacked telemetry (PyTorch
port of ``repro.obs.recorder``).

Every ``record_*`` method consumes values that are ALREADY on the host:
the deltas, times and flags that fell out of the hot paths' single
contracted fetches (``Fabric._fetch_view``'s per-segment fetch,
``Fabric._commit_epoch``'s per-epoch fetch, ``serve.Engine.step``'s one
``(tok, done, ref, pos)`` fetch) plus host-only scheduling facts
(migration plans, admissions, park/resume bookkeeping). A drain handed a
``torch.Tensor`` raises ``TypeError``: reading it would be a device fetch
outside the contracts' budgets (the reference's lint rule R6 knows only
JAX producers, so the port checks at run time).

Samples land in two places: a :class:`~repro_torch.obs.registry.
MetricsRegistry` (aggregates; counter metrics keyed by
``state.COUNTER_NAMES``, never by position) and ordered per-domain event
lists (``segments`` / ``plans`` / ``epochs`` for the fabric, ``steps`` /
``serve_events`` for serving, ``cells`` for the evaluation path) that
``repro_torch.obs.export`` turns into a Perfetto timeline and
``metrics.json``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.engine import state as S
from repro_torch.obs.registry import MetricsRegistry

# microsecond buckets for delivered-time histograms: 1-2-5 decades from
# 1 us to 50 s (modeled per-segment times live in the ms range)
TIME_US_BOUNDS = tuple(m * 10 ** e for e in range(0, 8) for m in (1, 2, 5))


def _host_only(drain: str, **values) -> None:
    """Refuse device values: every drain reads host values only."""
    for name, v in values.items():
        if isinstance(v, torch.Tensor):
            raise TypeError(f"Recorder.{drain}: {name} is a torch.Tensor "
                            f"on {v.device}; the drains take host values "
                            f"(reading a tensor here would be a fetch "
                            f"outside the sync contracts)")


class Recorder:
    """Accumulates piggybacked samples from one run (one fabric and/or
    one serving engine, and evaluation cells). Opt-in: constructed by the
    caller and passed as ``obs=``; the ``obs=None`` default everywhere is
    the recording-off path, identical in pool, counter and token state."""

    def __init__(self):
        self.metrics = MetricsRegistry()
        # fabric timeline, in record order
        self.segments: List[Dict[str, Any]] = []   # one per replayed segment
        self.plans: List[Dict[str, Any]] = []      # one per non-empty plan
        self.epochs: List[Dict[str, Any]] = []     # one per committed epoch
        # serving timeline
        self.steps: List[Dict[str, Any]] = []      # one per decode step
        self.serve_events: List[Dict[str, Any]] = []   # admissions/motion
        self.cells: List[Dict[str, Any]] = []      # simx workload cells
        self.fabric_info: Optional[Dict[str, Any]] = None
        self.serve_info: Optional[Dict[str, Any]] = None

    # -- attach ---------------------------------------------------------------

    def attach_fabric(self, fabric) -> None:
        """Called by ``Fabric.__init__`` when constructed with ``obs=``.
        Captures the run facts the exporters need (fleet for pricing,
        scheduler mode for labeling), never live device state."""
        self.fabric_info = {
            "n_expanders": fabric.n_expanders,
            "devices": list(fabric.devices),     # DeviceConfig per expander
            "window": fabric.window,
            "spill_interval": fabric.spill_interval,
            "pipeline_depth": fabric.pipeline_depth,
            "sync_migration": fabric.sync_migration,
            "migration": fabric.migration_policy.name,
            "migration_enabled": fabric.migration_enabled,
            # the sharded driver's rank count (None on the vmap drivers)
            "shard_devices": fabric.shard_devices,
        }

    def attach_serve(self, engine) -> None:
        """Called by ``serve._EngineBase.__init__`` when constructed with
        ``obs=``."""
        self.serve_info = {
            "lanes": engine.lanes,
            "n_expanders": engine.n_expanders,
            "max_len": engine.max_len,
            "family": engine.cfg.family,
        }

    # -- fabric drains (host values from the contracted fetches) --------------

    def record_segment(self, seg: int, delta: np.ndarray, times: np.ndarray,
                       free_units: Optional[np.ndarray]) -> None:
        """One replayed segment, from ``_fetch_view``'s single fetch: the
        replay counter delta (int64 [N, C]), the per-expander delivered
        times the segment computed on the device (float32 values as float64
        [N] seconds), and the freelist headroom (int64 [N] chunk units;
        None before the first stats fetch)."""
        _host_only("record_segment", delta=delta, times=times,
                   free_units=free_units)
        delta = np.asarray(delta, np.int64)
        times = np.asarray(times, np.float64)
        self.segments.append({
            "seg": int(seg), "delta": delta, "times": times,
            "free_units": None if free_units is None
            else np.asarray(free_units, np.int64).copy(),
        })
        for name, v in S.counters_delta_dict(delta).items():
            self.metrics.counter(f"fabric.{name}").inc(v)
        th = self.metrics.histogram("fabric.segment_time_us", TIME_US_BOUNDS)
        for t in times:
            th.observe(float(t) * 1e6)
        if free_units is not None:
            self.metrics.gauge("fabric.free_units_min").set(
                float(np.min(free_units)))
            self.metrics.histogram("fabric.free_units").observe(
                float(np.min(free_units)))

    def record_plan(self, seg: int, plan, policy: str) -> None:
        """A migration plan the policy produced at segment ``seg``'s
        boundary (host data: planning never touches the device)."""
        _host_only("record_plan", pages=plan.pages, srcs=plan.srcs,
                   dsts=plan.dsts)
        self.plans.append({
            "seg": int(seg), "policy": policy, "pages": int(len(plan)),
            "urgent": bool(plan.urgent),
            "pairs": plan.pairs(),
        })
        self.metrics.counter("fabric.plans").inc()
        self.metrics.counter("fabric.pages_planned").inc(int(len(plan)))
        if plan.urgent:
            self.metrics.counter("fabric.plans_urgent").inc()

    def record_epoch(self, seg: int, delta: np.ndarray, *, kind: str,
                     overlapped: bool, planned: int, moved: int,
                     urgent: bool, free_units: np.ndarray) -> None:
        """One committed migration epoch, from ``_commit_epoch``'s single
        fetch: the migration counter delta (int64 [N, C]) tagged with the
        segment whose replay it overlapped and how it was scheduled
        (``kind``: overlapped | urgent | sync | drain)."""
        _host_only("record_epoch", delta=delta, planned=planned, moved=moved,
                   free_units=free_units)
        delta = np.asarray(delta, np.int64)
        self.epochs.append({
            "seg": int(seg), "delta": delta, "kind": str(kind),
            "overlapped": bool(overlapped), "planned": int(planned),
            "moved": int(moved), "urgent": bool(urgent),
            "free_units": np.asarray(free_units, np.int64).copy(),
        })
        for name, v in S.counters_delta_dict(delta).items():
            self.metrics.counter(f"fabric.migration.{name}").inc(v)
        self.metrics.counter("fabric.epochs").inc()
        self.metrics.counter(f"fabric.epochs_{kind}").inc()
        self.metrics.counter("fabric.pages_moved").inc(int(moved))
        if planned and not moved:
            self.metrics.counter("fabric.epochs_stalled").inc()

    # -- simx drains ------------------------------------------------------------

    def record_cell(self, scheme: str, workload: str,
                    metrics: Dict[str, Any]) -> None:
        """One finished (scheme x workload) simx cell: the metrics dict
        ``run_workload`` assembled on the host. Delivered time lands in the
        shared time histogram so sweep aggregations merge with fabric
        segment times."""
        _host_only("record_cell", **metrics)
        self.cells.append({"scheme": str(scheme), "workload": str(workload),
                           "time_s": float(metrics["time_s"]),
                           "normalized_perf":
                               float(metrics["normalized_perf"])})
        self.metrics.counter("simx.cells").inc()
        self.metrics.histogram("simx.cell_time_us", TIME_US_BOUNDS).observe(
            float(metrics["time_s"]) * 1e6)
        self.metrics.gauge(
            f"simx.normalized_perf.{scheme}.{workload}").set(
            float(metrics["normalized_perf"]))

    # -- serving drains --------------------------------------------------------

    def record_step(self, step: int, toks: Sequence[int],
                    done: Sequence[int], pos: Sequence[int],
                    active: Sequence[int]) -> None:
        """One decode step, from ``Engine.step``'s single fetch of the
        ``(tok, done, ref, pos)`` rows: emitted tokens, completion flags
        and per-lane positions for the lanes that were active."""
        _host_only("record_step", toks=toks, done=done, pos=pos,
                   active=active)
        active = list(int(a) for a in active)
        self.steps.append({
            "step": int(step), "active": active,
            "done": [int(l) for l in active if bool(np.asarray(done)[l])],
            "max_pos": int(np.max(np.asarray(pos)[active])) if active else 0,
        })
        self.metrics.counter("serve.steps").inc()
        self.metrics.counter("serve.tokens").inc(len(active))
        self.metrics.gauge("serve.active_lanes").set(float(len(active)))
        self.metrics.histogram("serve.active_lanes").observe(len(active))

    def _serve_event(self, kind: str, **fields) -> None:
        ev = {"type": kind, "step": len(self.steps)}
        ev.update(fields)
        self.serve_events.append(ev)

    def record_admission(self, n: int, bucket: int) -> None:
        """One bucketed prefill batch (host scheduling fact)."""
        _host_only("record_admission", n=n, bucket=bucket)
        self._serve_event("admission", n=int(n), bucket=int(bucket))
        self.metrics.counter("serve.admissions").inc(int(n))
        self.metrics.counter("serve.prefill_batches").inc()
        self.metrics.histogram("serve.prefill_bucket").observe(int(bucket))

    def record_preempt(self, lane: int, rid: int, nbytes: int, shadow: bool,
                       expander: int) -> None:
        """One lane preemption: ``nbytes`` parked (0 when the shadow still
        covered every token: the §4.5 zero-byte re-preempt)."""
        _host_only("record_preempt", lane=lane, nbytes=nbytes,
                   expander=expander)
        self._serve_event("preempt", lane=int(lane), rid=int(rid),
                          bytes=int(nbytes), shadow=bool(shadow),
                          expander=int(expander))
        self.metrics.counter("serve.preemptions").inc()
        self.metrics.counter("serve.preempt_bytes").inc(int(nbytes))
        if shadow:
            self.metrics.counter("serve.shadow_repreempts").inc()
        self.metrics.histogram("serve.preempt_bytes").observe(int(nbytes))

    def record_resume(self, lane: int, rid: int, nbytes: int,
                      cross_expander: bool, expander: int) -> None:
        """One parked-request resume (promotion): compressed payload
        installed without dequantizing."""
        _host_only("record_resume", lane=lane, nbytes=nbytes,
                   expander=expander)
        self._serve_event("resume", lane=int(lane), rid=int(rid),
                          bytes=int(nbytes), cross=bool(cross_expander),
                          expander=int(expander))
        self.metrics.counter("serve.resumes").inc()
        self.metrics.counter("serve.resume_bytes").inc(int(nbytes))
        if cross_expander:
            self.metrics.counter("serve.cross_expander_resumes").inc()
        self.metrics.histogram("serve.resume_bytes").observe(int(nbytes))
