"""One function per paper figure (fig01-fig17) over the port's simx engine,
the PyTorch counterpart of the reference's ``benchmarks/paper_figs.py``.

Each ``figXX(quick, run=...)`` returns rows of dicts ``{"name", "us",
"derived"}``; ``quick`` trims workloads and access counts. ``run`` is the
cell runner, ``simx.engine.run_workload`` on the card by default; pass one
bound to another torch device, or a runner that computes each distinct
cell once.

  PYTHONPATH=src python -m repro_torch.launch.paper_figs [--full] \\
      [--only fig09,fig14] [--device cpu]

prints the ``name,us_per_call,derived`` CSV of the reference's benchmark
runner, an ``ERROR:`` row for each figure that fails, and exits 1 if any
did.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import time
import traceback
from typing import Callable, Dict, List

import numpy as np

from repro_torch import interop
from repro_torch.common.types import replace
from repro_torch.core.engine import batch as B
from repro_torch.core.engine.invariants import first_violation
from repro_torch.simx import device as DEV
from repro_torch.simx import time as TM
from repro_torch.simx.engine import run_cell, run_workload
from repro_torch.simx.trace import WORKLOADS, WorkloadSpec, make_trace

QUICK_WL = ["mcf", "lbm", "omnetpp", "pr", "xsbench"]
FULL_WL = list(WORKLOADS)
N_Q, N_F = 4000, 12000
PROM_Q, PROM_F = 64, 96
FIG09_SCHEMES = ["ibex", "tmcc", "dylect", "mxt", "dmc", "compresso"]

Runner = Callable[..., Dict[str, float]]


def _wl(quick: bool) -> List[str]:
    return QUICK_WL if quick else FULL_WL


def _n(quick: bool) -> int:
    return N_Q if quick else N_F


def _prom(quick: bool) -> int:
    return PROM_Q if quick else PROM_F


def cell_key(scheme: str, spec: WorkloadSpec, n_accesses: int,
             promoted_pages: int, device=None) -> str:
    """A cell's name: the scheme, the workload (with each field that
    differs from the named workload's), the size, and each field of the
    timing model that differs from the default ``DeviceConfig``."""
    base = WORKLOADS[spec.name]
    wl = spec.name + "".join(
        f",{f.name}={getattr(spec, f.name)!r}"
        for f in dataclasses.fields(base)
        if getattr(spec, f.name) != getattr(base, f.name))
    parts = [scheme, wl, f"n={n_accesses}", f"prom={promoted_pages}"]
    if device is not None:
        default = DEV.DeviceConfig()
        parts += [f"{f.name}={getattr(device, f.name)!r}"
                  for f in dataclasses.fields(default)
                  if getattr(device, f.name) != getattr(default, f.name)]
    return "|".join(parts)


class CellCache:
    """A cell runner for the figures that computes each distinct cell once
    (``simx.engine.run_cell`` on ``torch_device``) and keeps, by
    ``cell_key``: the metrics, the pool's I1-I4 status at the cell's end
    (``None`` when they hold or for a line-level scheme, else the first
    violation's message), the cell's wall seconds and its replay stats
    (``batch.new_stats``)."""

    def __init__(self, torch_device=None):
        self.torch_device = torch_device
        self.cells: Dict[str, dict] = {}

    def __call__(self, scheme: str, spec: WorkloadSpec, *, n_accesses: int,
                 promoted_pages: int, device=None) -> Dict[str, float]:
        key = cell_key(scheme, spec, n_accesses, promoted_pages, device)
        if key not in self.cells:
            stats = B.new_stats()
            t0 = time.perf_counter()
            out, pool, cfg = run_cell(
                scheme, spec, n_accesses=n_accesses,
                promoted_pages=promoted_pages, device=device,
                torch_device=self.torch_device, stats=stats)
            seconds = time.perf_counter() - t0   # ends in a counted fetch
            status = None if pool is None else first_violation(
                interop.pool_to_numpy(pool), cfg)
            self.cells[key] = {"scheme": scheme, "metrics": out,
                               "invariants": status, "seconds": seconds,
                               "stats": stats,
                               "accesses": n_accesses + (
                                   0 if pool is None else cfg.n_pages)}
        return self.cells[key]["metrics"]


def _cell(run: Runner, scheme: str, wl: str, quick: bool,
          **kw) -> Dict[str, float]:
    t0 = time.perf_counter()
    r = dict(run(scheme, WORKLOADS[wl], n_accesses=_n(quick),
                 promoted_pages=_prom(quick), **kw))
    r["wall_us"] = (time.perf_counter() - t0) * 1e6
    return r


def fig01_bandwidth(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 1: dual-channel vs ideal internal bandwidth (block compression)."""
    rows = []
    for wl in _wl(quick):
        real = _cell(run, "ibex_base", wl, quick)
        ideal = _cell(run, "ibex_base", wl, quick,
                      device=DEV.ideal_bandwidth(DEV.DeviceConfig()))
        rows.append({"name": f"fig01.{wl}", "us": real["wall_us"],
                     "derived": f"limited/ideal="
                                f"{real['time_s'] / ideal['time_s']:.3f}"})
    return rows


def fig09_speedup(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 9: normalized perf per scheme; headline IBEX-vs-TMCC/DyLeCT."""
    perf: Dict[str, Dict[str, float]] = {s: {} for s in FIG09_SCHEMES}
    rows = []
    for s in FIG09_SCHEMES:
        for wl in _wl(quick):
            r = _cell(run, s, wl, quick)
            perf[s][wl] = r["normalized_perf"]
            rows.append({"name": f"fig09.{s}.{wl}", "us": r["wall_us"],
                         "derived": f"norm_perf={r['normalized_perf']:.3f}"})
    gm = {s: float(np.exp(np.mean(np.log([max(v, 1e-9)
                                          for v in perf[s].values()]))))
          for s in FIG09_SCHEMES}
    for other in ("tmcc", "dylect", "mxt", "dmc"):
        rows.append({"name": f"fig09.speedup_ibex_over_{other}", "us": 0.0,
                     "derived": f"x{gm['ibex'] / gm[other]:.2f}"})
    return rows


def fig10_ratio(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 10: compression ratios (IBEX-1KB, IBEX-4KB, MXT, Compresso)."""
    rows = []
    for name, scheme in (("ibex_1kb", "ibex"), ("ibex_4kb", "ibex_base"),
                         ("mxt", "mxt"), ("compresso", "compresso")):
        ratios = []
        us = 0.0
        for wl in _wl(quick):
            r = _cell(run, scheme, wl, quick)
            ratios.append(max(r["compression_ratio"], 1e-3))
            us += r["wall_us"]
        gm = float(np.exp(np.mean(np.log(ratios))))
        rows.append({"name": f"fig10.{name}", "us": us,
                     "derived": f"ratio={gm:.2f}"})
    return rows


def fig11_breakdown(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 11: per-class traffic, IBEX normalized to TMCC."""
    rows = []
    tot_i = tot_t = 0.0
    for wl in _wl(quick):
        ib = _cell(run, "ibex", wl, quick)
        tm = _cell(run, "tmcc", wl, quick)
        tot_i += ib["internal_accesses"]
        tot_t += tm["internal_accesses"]
        ratio = ib["internal_accesses"] / max(tm["internal_accesses"], 1)
        clean = ib["demotions_clean"] / max(
            ib["demotions_clean"] + ib["demotions_dirty"], 1)
        rows.append({"name": f"fig11.{wl}",
                     "us": ib["wall_us"] + tm["wall_us"],
                     "derived": f"ibex/tmcc={ratio:.3f};clean_frac={clean:.2f}"})
    rows.append({"name": "fig11.total_traffic_reduction", "us": 0.0,
                 "derived": f"{1 - tot_i / max(tot_t, 1):.1%}"})
    return rows


def fig12_background(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 12: practical vs miracle (no activity/scan traffic)."""
    rows = []
    for wl in _wl(quick):
        r = _cell(run, "ibex", wl, quick)
        miracle_traffic = (r["internal_accesses"] - r["activity_rd"]
                           - r["activity_wr"])
        t = {**{k: r[k] for k in ("host_reads", "host_writes", "zero_served",
                                  "promotions", "demotions_dirty",
                                  "recompress_retry")},
             "internal_accesses": miracle_traffic}
        tm = DEV.exec_time(t, DEV.DeviceConfig())
        rows.append({"name": f"fig12.{wl}", "us": r["wall_us"],
                     "derived": f"practical/miracle={r['time_s'] / tm:.3f}"})
    return rows


def fig13_ablation(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 13: traffic as S, C, M are applied incrementally."""
    rows = []
    for wl in (_wl(quick)[:3] if quick else _wl(quick)):
        base = _cell(run, "ibex_base", wl, quick)
        s = _cell(run, "ibex_s", wl, quick)
        sc = _cell(run, "ibex_sc", wl, quick)
        scm = _cell(run, "ibex_scm", wl, quick)
        b = max(base["internal_accesses"], 1)
        rows.append({
            "name": f"fig13.{wl}", "us": base["wall_us"] + s["wall_us"]
            + sc["wall_us"] + scm["wall_us"],
            "derived": (f"S={s['internal_accesses'] / b:.3f};"
                        f"SC={sc['internal_accesses'] / b:.3f};"
                        f"SCM={scm['internal_accesses'] / b:.3f}")})
    return rows


def _device_sweep(r: Dict[str, float], devices) -> np.ndarray:
    """Normalized perf of one cell's traffic under a sweep of device
    models, every point priced in one vectorized call (traffic does not
    depend on the device model)."""
    lanes = TM.stack_devices(devices, xp=np)
    vec = TM.counters_from_dict(r)
    times = TM.exec_time_vec(
        np.broadcast_to(vec, (len(devices),) + vec.shape), lanes)
    host = r["host_reads"] + r["host_writes"]
    base = TM.uncompressed_time(np.full((len(devices),), host), lanes)
    return base / times


def fig14_latency(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 14: sensitivity to CXL round-trip latency."""
    r = _cell(run, "ibex", "pr", quick)
    lats = (70e-9, 150e-9, 250e-9, 400e-9)
    norm = _device_sweep(r, [replace(TM.DeviceConfig(), cxl_lat=lat)
                             for lat in lats])
    return [{"name": f"fig14.cxl_{int(lat * 1e9)}ns",
             "us": r["wall_us"] if i == 0 else 0.0,
             "derived": f"norm_perf={norm[i]:.3f}"}
            for i, lat in enumerate(lats)]


def fig15_decomp(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 15: sensitivity to decompression cycles."""
    r = _cell(run, "ibex", "mcf", quick)
    cycs = (64, 128, 256, 512)
    norm = _device_sweep(r, [replace(TM.DeviceConfig(), decomp_cycles=cyc)
                             for cyc in cycs])
    rows = [{"name": f"fig15.decomp_{cyc}cyc",
             "us": r["wall_us"] if i == 0 else 0.0,
             "derived": f"norm_perf={norm[i]:.3f}"}
            for i, cyc in enumerate(cycs)]
    drop = 1 - norm[-1] / max(norm[0], 1e-9)
    rows.append({"name": "fig15.total_drop", "us": 0.0,
                 "derived": f"{drop:.1%}"})
    return rows


def fig16_write(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 16: write-intensity sweep on the read-only workload (XSBench)."""
    rows = []
    base = None
    for ratio in (0.0, 1 / 6, 1 / 3, 0.5, 2 / 3, 5 / 6):
        spec = WORKLOADS["xsbench"]
        spec = WorkloadSpec(spec.name, ratio, spec.zipf_a, spec.stream_frac,
                            spec.footprint_pages, spec.zero_frac, spec.mix4,
                            spec.mix8)
        r = run("ibex", spec, n_accesses=_n(quick),
                promoted_pages=_prom(quick))
        if base is None:
            base = r["time_s"]
        rows.append({"name": f"fig16.rw_{ratio:.2f}", "us": 0.0,
                     "derived": f"slowdown={r['time_s'] / base:.3f}"})
    return rows


def fig17_fault(quick: bool, run: Runner = run_workload) -> List[Dict]:
    """Fig. 17: page-fault reduction under 50%-of-working-set memory, using
    each workload's measured compression ratio as the capacity multiplier
    (an LRU page cache replayed on the host)."""
    rows = []
    for wl in _wl(quick):
        r = _cell(run, "ibex", wl, quick)
        ratio = max(r["compression_ratio"], 1.0)
        n_pages = 512
        pages, _, _ = make_trace(WORKLOADS[wl], n_accesses=_n(quick),
                                 n_pages=n_pages)
        faults_at = {}
        for label, cap in (("base", n_pages // 2),
                           ("ibex", min(int(n_pages // 2 * ratio), n_pages))):
            resident: dict = {}
            faults = 0
            for t, p in enumerate(pages):
                if p in resident:
                    resident[p] = t
                    continue
                faults += 1
                if len(resident) >= cap:
                    victim = min(resident, key=resident.get)
                    del resident[victim]
                resident[p] = t
            faults_at[label] = faults
        red = 1 - faults_at["ibex"] / max(faults_at["base"], 1)
        rows.append({"name": f"fig17.{wl}", "us": 0.0,
                     "derived": f"fault_reduction={red:.1%}"})
    return rows


ALL_FIGS = [fig01_bandwidth, fig09_speedup, fig10_ratio, fig11_breakdown,
            fig12_background, fig13_ablation, fig14_latency, fig15_decomp,
            fig16_write, fig17_fault]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--device", default=None,
                    help="torch device of the pools (default: the CUDA card)")
    args = ap.parse_args(argv)
    quick = not args.full
    only = [s.strip() for s in args.only.split(",") if s.strip()]
    run = functools.partial(run_workload, torch_device=args.device)

    print("name,us_per_call,derived")
    failed = 0
    for fig in ALL_FIGS:
        name = fig.__name__
        if only and not any(name.startswith(o) or o in name for o in only):
            continue
        try:
            for row in fig(quick, run):
                print(f"{row['name']},{row['us']:.1f},{row['derived']}",
                      flush=True)
        except Exception as e:  # keep going; count failures
            failed += 1
            print(f"{name},0.0,ERROR:{type(e).__name__}:{e}", flush=True)
            traceback.print_exc(file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
