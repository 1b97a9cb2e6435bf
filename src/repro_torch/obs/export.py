"""Exporters over a Recorder: Perfetto timeline, metrics.json, tables
(PyTorch port of ``repro.obs.export``).

The fabric trace draws the pipeline pricing model (DESIGN.md §13): each
expander gets a ``replay`` track and a ``migration`` track; an overlapped
epoch's span sits UNDER the segment span it hid behind, and each track's
cursor advances by ``max(replay, migration)`` per row, so a track's total
extent equals ``Fabric.pipeline_times()["overlapped_s"]`` for that
expander (``fabric_track_totals`` calls the same
``pipeline_delivered_time`` on the same row matrices; the launcher asserts
the reconciliation at rtol 1e-9). Urgent/sync/drain epochs get their own
zero-replay rows, charged in full on the critical path, exactly as
``pipeline_times`` prices them.

Every time here is modeled, not measured: priced by ``simx.time``'s
float64 numpy path (``xp=np``), as the reference's exporter prices them,
so a trace is a function of the recorded samples alone. Sharded runs
(``fabric_info["shard_devices"]``) add one track per rank's device, whose
extent ``fabric_device_totals`` gives (``Fabric.device_times`` on the same
rows); on the vmap drivers it returns None.

Events follow the Chrome ``trace_event`` JSON format: ``X`` complete
events (ts/dur in microseconds), ``M`` metadata naming processes and
tracks, ``C`` counter events for freelist headroom, ``i`` instants for
admissions. ``validate_trace`` checks the structural contract: required
keys per phase, per-track monotone timestamps, and proper span nesting
(overlapping spans on one track must nest).
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.engine import state as S
from repro_torch.obs.manifest import manifest
from repro_torch.obs.recorder import Recorder
from repro_torch.simx import time as TM

_FABRIC_PID = 1
_SERVE_PID = 2
_DEVICE_TID = 1000     # per-device shard tracks start here


# ---------------------------------------------------------------------------
# Fabric rows: the SAME (replay, migration) delta matrices pipeline_times
# builds, reconstructed from the Recorder's samples.
# ---------------------------------------------------------------------------

def _fabric_rows(rec: Recorder) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                  List[Dict[str, Any]]]]:
    """(replay [R,N,C], mig [R,N,C], row labels) mirroring
    ``Fabric.pipeline_times``: one row per replayed segment (overlapped
    epochs fold into the row of the segment they hid behind), then one
    zero-replay row per urgent/sync/drain epoch."""
    if not rec.segments:
        return None
    n_seg = len(rec.segments)
    deltas = np.stack([s["delta"] for s in rec.segments])
    n, c = deltas.shape[1], deltas.shape[2]
    sync_epochs = [e for e in rec.epochs if not e["overlapped"]]
    rows = n_seg + len(sync_epochs)
    replay = np.zeros((rows, n, c), np.float64)
    replay[:n_seg] = deltas
    mig = np.zeros_like(replay)
    labels: List[Dict[str, Any]] = [
        {"seg": s["seg"], "kinds": [], "moved": 0, "planned": 0}
        for s in rec.segments]
    labels += [{"seg": e["seg"], "kinds": [e["kind"]], "moved": e["moved"],
                "planned": e["planned"]} for e in sync_epochs]
    for e in rec.epochs:
        if e["overlapped"]:
            r = min(e["seg"], n_seg - 1)
            mig[r] += e["delta"]
            labels[r]["kinds"].append(e["kind"])
            labels[r]["moved"] += e["moved"]
            labels[r]["planned"] += e["planned"]
    for j, e in enumerate(sync_epochs):
        mig[n_seg + j] += e["delta"]
    return replay, mig, labels


def _fabric_lanes(rec: Recorder):
    return TM.stack_devices(rec.fabric_info["devices"], xp=np)


def fabric_track_totals(rec: Recorder) -> Optional[Dict[str, np.ndarray]]:
    """Per-expander delivered seconds of the reconstructed rows, priced
    through the SAME ``pipeline_delivered_time`` call ``pipeline_times``
    uses — the reconciliation anchor: ``overlapped_s[e]`` equals the
    extent of expander ``e``'s tracks in the exported trace."""
    rows = _fabric_rows(rec)
    if rows is None:
        return None
    replay, mig, _ = rows
    lanes = _fabric_lanes(rec)
    return {
        "overlapped_s": TM.pipeline_delivered_time(replay, mig, lanes,
                                                   overlapped=True),
        "sync_s": TM.pipeline_delivered_time(replay, mig, lanes,
                                             overlapped=False),
    }


def _expander_owners(n_expanders: int, n_devices: int) -> np.ndarray:
    """Block expander->device placement (int [N]): the layout of the
    reference's ``fabric.shard.device_of_expander``."""
    return np.arange(n_expanders) // (n_expanders // n_devices)


def fabric_device_totals(rec: Recorder) -> Optional[Dict[str, np.ndarray]]:
    """Per-device delivered seconds on sharded runs: row ``r``'s device
    time is the max over owned expanders of ``max(replay, mig)``, summed
    over rows (the extent of the per-device tracks in the exported
    trace). None without ``shard_devices`` (the vmap drivers) or before
    any segment."""
    info = rec.fabric_info or {}
    n_dev = info.get("shard_devices")
    rows = _fabric_rows(rec)
    if not n_dev or rows is None:
        return None
    replay, mig, _ = rows
    lanes = _fabric_lanes(rec)
    cell = np.maximum(np.atleast_2d(TM.exec_time_vec(replay, lanes, xp=np)),
                      np.atleast_2d(TM.exec_time_vec(mig, lanes, xp=np)))
    owners = _expander_owners(info["n_expanders"], n_dev)
    return {
        "device_s": np.asarray([cell[:, owners == d].max(axis=1).sum()
                                for d in range(n_dev)], np.float64),
        "owners": owners,
    }


def _fabric_events(rec: Recorder) -> List[Dict[str, Any]]:
    rows = _fabric_rows(rec)
    if rows is None:
        return []
    replay, mig, labels = rows
    n_seg = len(rec.segments)
    n = replay.shape[1]
    lanes = _fabric_lanes(rec)
    t_replay = np.atleast_2d(TM.exec_time_vec(replay, lanes, xp=np))
    t_mig = np.atleast_2d(TM.exec_time_vec(mig, lanes, xp=np))
    ev: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _FABRIC_PID, "tid": 0, "name": "process_name",
         "args": {"name": "fabric"}}]
    for e in range(n):
        ev.append({"ph": "M", "pid": _FABRIC_PID, "tid": 2 * e,
                   "name": "thread_name",
                   "args": {"name": f"expander{e}/replay"}})
        ev.append({"ph": "M", "pid": _FABRIC_PID, "tid": 2 * e + 1,
                   "name": "thread_name",
                   "args": {"name": f"expander{e}/migration"}})
    n_dev = (rec.fabric_info or {}).get("shard_devices")
    owners = None
    if n_dev:
        owners = _expander_owners(n, n_dev)
        for d in range(n_dev):
            owned = np.nonzero(owners == d)[0]
            ev.append({"ph": "M", "pid": _FABRIC_PID, "tid": _DEVICE_TID + d,
                       "name": "thread_name",
                       "args": {"name": f"device{d}/shard "
                                f"(e{owned[0]}..e{owned[-1]})"}})
    cursor = np.zeros((n,), np.float64)        # per-expander clock, us
    dev_cursor = np.zeros((n_dev or 0,), np.float64)  # per-device clock, us
    for r in range(len(replay)):
        lab = labels[r]
        internal = S.traffic_vector(replay[r]).sum(axis=-1)
        host = replay[r][..., S.C_HOST_RD] + replay[r][..., S.C_HOST_WR]
        for e in range(n):
            tr_us = float(t_replay[r, e]) * 1e6
            tm_us = float(t_mig[r, e]) * 1e6
            if r < n_seg:
                ev.append({
                    "ph": "X", "pid": _FABRIC_PID, "tid": 2 * e,
                    "ts": float(cursor[e]), "dur": tr_us,
                    "name": f"seg {lab['seg']}",
                    "args": {"internal_64B": int(internal[e]),
                             "host_64B": int(host[e])}})
            if tm_us > 0.0:
                kinds = "+".join(lab["kinds"]) or "overlapped"
                ev.append({
                    "ph": "X", "pid": _FABRIC_PID, "tid": 2 * e + 1,
                    "ts": float(cursor[e]), "dur": tm_us,
                    "name": f"epoch[{kinds}]@seg{lab['seg']}",
                    "args": {"moved": lab["moved"],
                             "planned": lab["planned"]}})
            cursor[e] += max(tr_us, tm_us)
        if owners is not None:
            row_us = np.maximum(t_replay[r], t_mig[r]) * 1e6
            kinds = "+".join(lab["kinds"])
            name = f"seg {lab['seg']}" if r < n_seg else \
                f"epoch[{kinds}]@seg{lab['seg']}"
            for d in range(n_dev):
                dur = float(np.max(row_us[owners == d]))
                ev.append({
                    "ph": "X", "pid": _FABRIC_PID, "tid": _DEVICE_TID + d,
                    "ts": float(dev_cursor[d]), "dur": dur, "name": name,
                    "args": {"moved": lab["moved"],
                             "planned": lab["planned"]}})
                dev_cursor[d] += dur
        if r < n_seg and rec.segments[r]["free_units"] is not None:
            ev.append({
                "ph": "C", "pid": _FABRIC_PID, "tid": 0,
                "ts": float(np.max(cursor)), "name": "free_units",
                "args": {f"e{e}": int(v) for e, v in
                         enumerate(rec.segments[r]["free_units"])}})
    return ev


# ---------------------------------------------------------------------------
# Serving trace: one steps track (span per decode step, duration = the
# step's sync round trip + the motion its admission performed) and one
# motion track per expander (park/resume payload spans priced by
# serve_motion_time on that expander's own DeviceConfig).
# ---------------------------------------------------------------------------

def _serve_events(rec: Recorder) -> List[Dict[str, Any]]:
    if not rec.steps and not rec.serve_events:
        return []
    n_exp = rec.serve_info["n_expanders"] if rec.serve_info else 1
    devs = TM.resolve_fleet(None, n_exp)
    sync_us = max(d.cxl_lat for d in devs) * 1e6
    ev: List[Dict[str, Any]] = [
        {"ph": "M", "pid": _SERVE_PID, "tid": 0, "name": "process_name",
         "args": {"name": "serve"}},
        {"ph": "M", "pid": _SERVE_PID, "tid": 1, "name": "thread_name",
         "args": {"name": "steps"}}]
    for e in range(n_exp):
        ev.append({"ph": "M", "pid": _SERVE_PID, "tid": 10 + e,
                   "name": "thread_name",
                   "args": {"name": f"expander{e}/motion"}})
    by_step: Dict[int, List[Dict[str, Any]]] = {}
    for s_ev in rec.serve_events:
        by_step.setdefault(int(s_ev["step"]), []).append(s_ev)
    cursor = 0.0
    exp_cursor = [0.0] * n_exp
    for i in range(len(rec.steps) + 1):
        start = cursor
        motion_us = 0.0
        for s_ev in by_step.get(i, ()):
            if s_ev["type"] == "admission":
                ev.append({"ph": "i", "pid": _SERVE_PID, "tid": 1,
                           "ts": start, "s": "t",
                           "name": f"admit x{s_ev['n']} "
                                   f"(bucket {s_ev['bucket']})"})
                continue
            e = int(s_ev["expander"]) % n_exp
            pb = s_ev["bytes"] if s_ev["type"] == "preempt" else 0
            rb = s_ev["bytes"] if s_ev["type"] == "resume" else 0
            dur = float(TM.serve_motion_time(float(pb), float(rb),
                                             devs[e], np)) * 1e6
            ts = max(exp_cursor[e], start)
            ev.append({"ph": "X", "pid": _SERVE_PID, "tid": 10 + e,
                       "ts": ts, "dur": dur, "name": s_ev["type"],
                       "args": {k: v for k, v in s_ev.items()
                                if k not in ("type", "step")}})
            exp_cursor[e] = ts + dur
            motion_us += dur
        if i < len(rec.steps):
            st = rec.steps[i]
            dur = sync_us + motion_us
            ev.append({"ph": "X", "pid": _SERVE_PID, "tid": 1,
                       "ts": start, "dur": dur,
                       "name": f"step {st['step']}",
                       "args": {"active": len(st["active"]),
                                "done": len(st["done"]),
                                "max_pos": st["max_pos"]}})
            cursor = start + dur
    return ev


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def build_trace(rec: Recorder) -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` JSON for everything recorded."""
    events = _fabric_events(rec) + _serve_events(rec)
    other: Dict[str, Any] = {"manifest": manifest()}
    totals = fabric_track_totals(rec)
    if totals is not None:
        other["fabric_overlapped_s"] = [float(t)
                                        for t in totals["overlapped_s"]]
        other["fabric_sync_s"] = [float(t) for t in totals["sync_s"]]
    dev_totals = fabric_device_totals(rec)
    if dev_totals is not None:
        other["fabric_device_s"] = [float(t)
                                    for t in dev_totals["device_s"]]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(rec: Recorder, path) -> Dict[str, Any]:
    trace = build_trace(rec)
    errs = validate_trace(trace)
    if errs:
        raise ValueError(f"invalid trace: {errs[:5]}")
    pathlib.Path(path).write_text(json.dumps(trace))
    return trace


def metrics_snapshot(rec: Recorder, **meta: Any) -> Dict[str, Any]:
    """The ``metrics.json`` payload: manifest + registry snapshot + the
    per-domain roll-ups benches fold into BENCH_*.json."""
    out: Dict[str, Any] = {"manifest": manifest(**meta),
                           "metrics": rec.metrics.snapshot()}
    if rec.fabric_info is not None:
        fab: Dict[str, Any] = {
            "n_expanders": rec.fabric_info["n_expanders"],
            "migration": rec.fabric_info["migration"],
            "pipeline_depth": rec.fabric_info["pipeline_depth"],
            "segments": len(rec.segments),
            "epochs": len(rec.epochs),
            "epoch_kinds": sorted({e["kind"] for e in rec.epochs}),
            "pages_moved": sum(e["moved"] for e in rec.epochs),
        }
        totals = fabric_track_totals(rec)
        if totals is not None:
            fab["overlapped_s"] = [float(t) for t in totals["overlapped_s"]]
            fab["sync_s"] = [float(t) for t in totals["sync_s"]]
        if rec.fabric_info.get("shard_devices"):
            fab["shard_devices"] = rec.fabric_info["shard_devices"]
            dev_totals = fabric_device_totals(rec)
            if dev_totals is not None:
                fab["device_s"] = [float(t)
                                   for t in dev_totals["device_s"]]
        out["fabric"] = fab
    if rec.cells:
        out["simx"] = {"cells": rec.cells}
    if rec.serve_info is not None:
        out["serve"] = {
            "lanes": rec.serve_info["lanes"],
            "n_expanders": rec.serve_info["n_expanders"],
            "steps": len(rec.steps),
            "events": len(rec.serve_events),
        }
    return out


def metrics_path(trace_path) -> str:
    """The ``metrics.json`` sibling of a trace path: ``OUT.trace.json`` ->
    ``OUT.metrics.json``; any other name gets ``.metrics.json`` added."""
    trace_path = str(trace_path)
    stem = trace_path[: -len(".trace.json")] \
        if trace_path.endswith(".trace.json") else trace_path
    return stem + ".metrics.json"


def write_metrics(rec: Recorder, path, **meta: Any) -> Dict[str, Any]:
    snap = metrics_snapshot(rec, **meta)
    pathlib.Path(path).write_text(json.dumps(snap, indent=1, sort_keys=True))
    return snap


def fabric_summary_table(rec: Recorder) -> str:
    """Human-readable per-segment summary (the --trace stdout table):
    traffic, migration overlap and pricing per pipeline row."""
    rows = _fabric_rows(rec)
    if rows is None:
        return "(no fabric segments recorded)"
    replay, mig, labels = rows
    n_seg = len(rec.segments)
    lanes = _fabric_lanes(rec)
    t_replay = np.atleast_2d(TM.exec_time_vec(replay, lanes, xp=np))
    t_mig = np.atleast_2d(TM.exec_time_vec(mig, lanes, xp=np))
    lines = [f"{'row':>4} {'seg':>4} {'kind':<12} {'internal64B':>12} "
             f"{'host64B':>10} {'replay_ms':>10} {'mig_ms':>8} "
             f"{'moved':>6}"]
    for r, lab in enumerate(labels):
        internal = int(S.traffic_vector(replay[r]).sum())
        host = int((replay[r][..., S.C_HOST_RD] +
                    replay[r][..., S.C_HOST_WR]).sum())
        kind = "+".join(lab["kinds"]) if lab["kinds"] else \
            ("replay" if r < n_seg else "?")
        lines.append(
            f"{r:>4} {lab['seg']:>4} {kind:<12} {internal:>12} {host:>10} "
            f"{float(t_replay[r].max()) * 1e3:>10.3f} "
            f"{float(t_mig[r].max()) * 1e3:>8.3f} {lab['moved']:>6}")
    totals = fabric_track_totals(rec)
    over = ", ".join(f"e{e}={float(t) * 1e3:.3f}ms"
                     for e, t in enumerate(totals["overlapped_s"]))
    lines.append(f"overlapped totals: {over}")
    return "\n".join(lines)


def validate_trace(trace: Any) -> List[str]:
    """Structural validation of a trace_event JSON dict. Returns error
    strings (empty = valid): known phases, required keys, non-negative
    ts/dur, per-track monotone timestamps, and span nesting (overlapping
    ``X`` spans on one track must be properly contained)."""
    errs: List[str] = []
    if not isinstance(trace, dict) or \
            not isinstance(trace.get("traceEvents"), list):
        return ["traceEvents missing or not a list"]
    eps = 1e-6
    tracks: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(trace["traceEvents"]):
        ph = ev.get("ph")
        if ph not in ("X", "M", "C", "i"):
            errs.append(f"event {i}: unknown phase {ph!r}")
            continue
        if ph != "M" and "ts" not in ev:
            errs.append(f"event {i}: missing ts")
            continue
        if ph == "X":
            missing = [k for k in ("pid", "tid", "ts", "dur", "name")
                       if k not in ev]
            if missing:
                errs.append(f"event {i}: missing {missing}")
                continue
            if ev["ts"] < 0 or ev["dur"] < 0:
                errs.append(f"event {i} ({ev['name']}): negative ts/dur")
            tracks.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["dur"]), str(ev["name"])))
    for key, spans in tracks.items():
        last_ts = -np.inf
        stack: List[float] = []          # open-span end timestamps
        for ts, dur, name in spans:      # emitted order == track order
            if ts < last_ts - eps:
                errs.append(f"track {key}: ts not monotone at {name!r}")
            last_ts = max(last_ts, ts)
            while stack and stack[-1] <= ts + eps:
                stack.pop()
            end = ts + dur
            if stack and end > stack[-1] + eps:
                errs.append(f"track {key}: span {name!r} crosses its "
                            f"enclosing span")
            stack.append(end)
    return errs
