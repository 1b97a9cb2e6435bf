"""One run of one cell: load its files by name, run its runner (``kind`` in
the traffic mix: ``serve`` or ``train``), read its metrics, decide
``correct`` against the cell's limits, and assemble the result line."""
from __future__ import annotations

import importlib.util
import os
import resource
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from bench.harness import spec

GIB = float(1 << 30)


@dataclass
class Record:
    """What a per-layer metric's reader reads."""
    kind: str
    model: Any
    conf: Dict
    mix: Dict
    window_s: float
    steps: int
    spans: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)
    extras: Dict[str, Any] = field(default_factory=dict)
    trace: Any = None


@dataclass
class Context:
    workload: str
    conf: Dict
    mix: Dict
    model: Any
    seed: int
    seconds: float
    trace: bool
    device: Any
    proc_start: float
    control: bool = False
    bench_dir: Path = spec.BENCH_DIR
    log: Callable[[str], None] = print
    t_window: Optional[float] = None
    memory_peak: Optional[int] = None
    rec: Optional[Record] = None

    def window_started(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        self.t_window = time.time()

    def record(self, **kw) -> Record:
        self.rec = Record(model=self.model, conf=self.conf, mix=self.mix,
                          **kw)
        return self.rec

    def memory_read(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def load_reader(name: str, bench_dir: Path = spec.BENCH_DIR):
    """The ``read(record)`` of ``bench/metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def context(workload: str, seed: int, seconds: float, trace: bool, device,
            proc_start: float, bench: Optional[Dict] = None,
            root: Path = spec.ROOT, bench_dir: Path = spec.BENCH_DIR,
            control: bool = False, log=None) -> Context:
    bench = bench if bench is not None else spec.benchmark(root)
    wl = spec.workload(bench, workload)
    conf = spec.load_json(spec.config_file(bench, wl["config"], root))
    mix = spec.traffic(wl["traffic"], bench_dir)
    return Context(workload=workload, conf=conf, mix=mix,
                   model=spec.model_config(conf), seed=int(seed),
                   seconds=float(seconds), trace=bool(trace), device=device,
                   proc_start=proc_start, control=control,
                   bench_dir=bench_dir, log=log or (lambda s: print(s, file=sys.stderr,
                                               flush=True)))


def drive(ctx: Context) -> Dict:
    """The cell's runner: the kernel libraries the mix names built first
    (on the card), then the set-up, the window, the traced segment and the
    check."""
    if torch.device(ctx.device).type == "cuda":
        from repro_torch.kernels import build
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        infos = build.build_all(tuple(ctx.mix["libraries"]))
        ctx.log(f"build: {len(infos)} libraries, "
                f"{time.perf_counter() - t0:.3f} s "
                f"({sum(1 for i in infos if i['seconds'] > 0)} compiled)")
    kind = ctx.mix["kind"]
    if kind == "serve":
        from bench.harness import serve as drv
    elif kind == "train":
        from bench.harness import train as drv
    else:
        raise ValueError(f"unknown traffic kind {kind!r}")
    return drv.run(ctx)


def checks(out: Dict, lim: Optional[Dict]) -> Dict[str, Dict]:
    """Each number compared beside its limit (None where the cell has no
    limits file)."""
    res = {}
    for name, value in out["checks"].items():
        if lim is None or name in lim:
            res[name] = {"value": value,
                         "limit": None if lim is None else lim[name]}
    return res


def is_correct(out: Dict, held: Dict[str, Dict]) -> bool:
    if out.get("failed"):
        return False
    if not held or any(h["limit"] is None for h in held.values()):
        return False
    return all(h["value"] is not None and h["value"] == h["value"] and
               h["value"] <= h["limit"] for h in held.values())


def device_info(ctx: Context) -> Dict:
    if torch.device(ctx.device).type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": ctx.memory_peak}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": None}
    tr = ctx.rec.trace if ctx.rec is not None else None
    if ctx.trace and tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def metrics(ctx: Context, out: Dict, bench: Dict) -> Dict[str, Dict]:
    wl = spec.workload(bench, ctx.workload)
    res = {}
    if not ctx.trace:
        for m in spec.end_to_end_metrics(bench, wl):
            v = end_to_end_value(m["name"], ctx, out)
            if v is not None:
                res[m["name"]] = {"value": v, "unit": m["unit"]}
        return res
    for m in spec.per_layer_metrics(bench, wl):
        v = load_reader(m["name"], ctx.bench_dir)(ctx.rec)
        if v is not None:
            res[m["name"]] = {"value": v, "unit": m["unit"]}
    return res


def end_to_end_value(name: str, ctx: Context, out: Dict):
    if name == "setup_s":
        return ctx.t_window - ctx.proc_start
    if name == "peak_mem_gib":
        return None if ctx.memory_peak is None else ctx.memory_peak / GIB
    return out.get(name)


def host_peak_rss_bytes() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def run(ctx: Context, bench: Optional[Dict] = None) -> Dict:
    """The result line's object (before the import check)."""
    bench = bench if bench is not None else spec.benchmark()
    out = drive(ctx)
    lim = spec.limits(ctx.workload, ctx.bench_dir)
    held = checks(out, lim)
    line = {"correct": is_correct(out, held), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics(ctx, out, bench),
            "device": device_info(ctx)}
    tr = ctx.rec.trace if ctx.rec is not None else None
    if ctx.trace and tr is not None:
        line["breakdown"] = {"device_ops": tr.device_ops,
                             "idle_gaps": tr.idle_gaps}
    ctx.log(f"host peak RSS {host_peak_rss_bytes()} B; window "
            f"{out.get('window_s')!r} s; setup "
            f"{ctx.t_window - ctx.proc_start!r} s")
    if "gaps" in out:
        ctx.log(f"itl samples: {out['gaps']}")
    if ctx.control:
        line["variants"] = variants(out, lim)
        line["readings"] = dict(out["checks"])
    line["checks"] = held
    return line


def variants(out: Dict, lim: Optional[Dict]) -> Dict[str, Dict]:
    """In a control run: each planted variant (the control, a fault) with
    its numbers held against the cell's limits as the program's are, and
    whether it comes out correct (it must not)."""
    res = {}
    for name, nums in out.get("variants", {}).items():
        held = checks({"checks": nums}, lim)
        res[name] = {"correct": is_correct({}, held),
                     "checks": {k: v for k, v in nums.items()}}
    return res


FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (the whole
    name before the first dot: ``repro_torch`` is not ``repro``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def process_start_time() -> float:
    """The epoch time this process started (``/proc/self/stat``, ticks
    since boot, against ``/proc/uptime``); now, where /proc has neither."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time()
