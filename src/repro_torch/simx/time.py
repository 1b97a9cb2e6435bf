"""Delivered-time accounting (PyTorch port of ``repro.simx.time``).

The paper's headline numbers are delivered time, not byte counts:

  * ``DeviceConfig``: one expander's Table-1 parameters, a frozen
    (hashable) dataclass;
  * ``DeviceLanes``: a stacked fleet of expanders, every field an array
    with a leading expander axis (numpy float64, or float32 tensors on a
    named device);
  * ``exec_time_vec``: the model over counter arrays in
    ``engine.state.COUNTER_NAMES`` order, broadcasting over leading axes,
    in numpy float64 on the host (bitwise the reference's) or in float32
    tensors (where the reference runs jnp float32). ``exec_time_dict`` is
    the string-keyed dict API over the same core.

Model (an approximation, not cycle-accurate): execution time is the max of
four saturable resources, the last a latency term moderated by
memory-level parallelism:

  t_mem    = internal 64B accesses x 64 / (channels x DDR bw)
  t_cxl    = host accesses x 64 / CXL bw                (PCIe5 x8 = 32 GB/s)
  t_engine = compressions x 256cyc + decompressions x 64cyc at 2 GHz
  t_lat    = host accesses x avg service latency / MLP

``serve_motion_time``/``serve_modeled_time`` convert a serving engine's
preempt/resume bytes and host syncs into seconds.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass
from typing import Dict, List, Mapping, NamedTuple, Sequence, Union

import numpy as np
import torch

from repro_torch.core.engine import state as S


@dataclass(frozen=True)
class DeviceConfig:
    """One expander's timing parameters (Table 1)."""
    channels: int = 2
    ch_bw: float = 44.8e9          # DDR5-5600 bytes/s per channel
    cxl_bw: float = 32e9           # PCIe Gen5 x8
    cxl_lat: float = 70e-9         # round-trip (Table 1)
    dram_lat: float = 55e-9        # tCL+tRCD-ish
    clock: float = 2.0e9
    comp_cycles: int = 256         # per 1KB block (4B/clk)
    decomp_cycles: int = 64        # per 1KB block (16B/clk)
    mlp: float = 4.0               # outstanding-request parallelism
    block_scale: float = 1.0       # 4KB-block schemes: 4x engine latency


def ideal_bandwidth(dev: DeviceConfig) -> DeviceConfig:
    """Fig. 1's 'unlimited internal bandwidth but same latency' variant."""
    return dataclasses.replace(dev, ch_bw=1e15)


# Named generation profiles for mixed fleets: "gen4" is a previous-
# generation expander (PCIe4 x8 link, DDR4-ish channels, slower engine
# clock); "far" sits behind a CXL switch (latency only).
DEVICE_PROFILES: Dict[str, DeviceConfig] = {
    "default": DeviceConfig(),
    "gen4": DeviceConfig(ch_bw=25.6e9, cxl_bw=16e9, cxl_lat=110e-9,
                         dram_lat=60e-9, clock=1.5e9),
    "far": DeviceConfig(cxl_lat=250e-9),
    "slow_engine": DeviceConfig(clock=1.0e9, comp_cycles=512,
                                decomp_cycles=128),
}

# The port's own kernel-calibration file (repo root). No script writes it
# yet, so by default the engine keeps the paper's constants; the reference
# package's BENCH_kernels.json holds a CPU calibration and is not read.
_BENCH_TORCH = pathlib.Path(__file__).resolve().parents[3] / "BENCH_torch.json"


def calibrated_device(path: "str | pathlib.Path | None" = None,
                      base: "DeviceConfig | None" = None) -> DeviceConfig:
    """DeviceConfig whose compression-engine cycles come from a measured
    kernel throughput (the file's ``calibration`` section:
    ``compress_gbps``, ``decompress_gbps``, ``block_bytes``):
    cycles/block = clock * block_bytes / bytes per second. Falls back to
    ``base`` (the paper's constants) when the file is missing, malformed
    or lacks the section."""
    base = base if base is not None else DeviceConfig()
    p = pathlib.Path(path) if path is not None else _BENCH_TORCH
    try:
        data = json.loads(p.read_text())
    except (OSError, ValueError):
        return base
    cal = data.get("calibration", {})
    comp_gbps = cal.get("compress_gbps")
    decomp_gbps = cal.get("decompress_gbps")
    if not comp_gbps or not decomp_gbps:
        return base
    blk = float(cal.get("block_bytes", 1024))
    comp_cycles = max(1, int(round(base.clock * blk / (comp_gbps * 1e9))))
    decomp_cycles = max(1, int(round(base.clock * blk / (decomp_gbps * 1e9))))
    return dataclasses.replace(base, comp_cycles=comp_cycles,
                               decomp_cycles=decomp_cycles)


class DeviceLanes(NamedTuple):
    """A stacked expander fleet: ``DeviceConfig`` field for field, each an
    array with a leading expander axis. Field names must mirror
    ``DeviceConfig`` (``stack_devices`` checks)."""
    channels: np.ndarray
    ch_bw: np.ndarray
    cxl_bw: np.ndarray
    cxl_lat: np.ndarray
    dram_lat: np.ndarray
    clock: np.ndarray
    comp_cycles: np.ndarray
    decomp_cycles: np.ndarray
    mlp: np.ndarray
    block_scale: np.ndarray


DeviceLike = Union[DeviceConfig, DeviceLanes]


def stack_devices(devs: Sequence[DeviceConfig], xp=torch,
                  device=None) -> DeviceLanes:
    """[DeviceConfig] * N -> DeviceLanes of N-length fields: float32
    tensors on ``device`` (CPU if None) for ``xp=torch``, float64 arrays
    for ``xp=np``. A DeviceConfig field missing from DeviceLanes (or the
    reverse) raises."""
    names = [f.name for f in dataclasses.fields(DeviceConfig)]
    if set(names) != set(DeviceLanes._fields):
        raise TypeError(f"DeviceConfig fields {names} drifted from "
                        f"DeviceLanes fields {list(DeviceLanes._fields)}")
    if xp is np:
        return DeviceLanes(**{n: np.asarray([getattr(d, n) for d in devs],
                                            dtype=np.float64)
                              for n in names})
    return DeviceLanes(**{n: torch.tensor([getattr(d, n) for d in devs],
                                          dtype=torch.float32, device=device)
                          for n in names})


def resolve_fleet(devices, n_expanders: int) -> List[DeviceConfig]:
    """A fleet spec (None: all default; one DeviceConfig: homogeneous; a
    sequence, cycled to length N if shorter) -> N DeviceConfigs."""
    if devices is None:
        devices = DeviceConfig()
    if isinstance(devices, DeviceConfig):
        return [devices] * n_expanders
    devices = list(devices)
    if not devices:
        raise ValueError("empty device fleet")
    if len(devices) < n_expanders:
        devices = [devices[i % len(devices)] for i in range(n_expanders)]
    if len(devices) != n_expanders:
        raise ValueError(f"{len(devices)} device configs for "
                         f"{n_expanders} expanders")
    return devices


def _maximum(xp):
    """Elementwise max for ``xp``: torch.maximum needs two tensors."""
    if xp is torch:
        return lambda a, b: torch.maximum(torch.as_tensor(a),
                                          torch.as_tensor(b))
    return xp.maximum


def _fma_f32(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float32 with one rounding, as a fused multiply-add.
    The reference's float32 model runs jitted, and XLA:CPU contracts its
    one multiply-add with a non-exact product (the latency's first two
    terms) into a fused one; the unfused sum is 1 ulp off in about one
    value of a hundred. The float64 product of two float32 values is
    exact. The float64 sum is then rounded to odd: TwoSum gives its
    rounding error, and an inexact sum whose last bit is even steps one
    float64 ulp toward the exact value. A float64 rounded to odd rounds to
    float32 as the exact value does (53 bits >= 24 + 2), so the result is
    the fused one even where the float64 sum lands on a float32 midpoint,
    which a plain float64 sum would round twice."""
    a = torch.as_tensor(a, dtype=torch.float32)
    f64 = lambda x: torch.as_tensor(x, dtype=torch.float32,  # noqa: E731
                                    device=a.device).double()
    p, c = f64(a) * f64(b), f64(c)
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)                 # TwoSum: s + err exact
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where((err != 0) & even, torch.nextafter(s, toward),
                       s).float()


# ---------------------------------------------------------------------------
# The model core, for python/numpy scalars and arrays (float64) and tensors
# (float32). Its operation order is the reference's, so the float64 path is
# bitwise the reference's, and the float32 path the reference's jitted one.
# ---------------------------------------------------------------------------

def _exec_time_core(host, internal, promotions, demotions_dirty,
                    recompress_retry, zero_served, dev: DeviceLike, xp):
    maximum = _maximum(xp)
    t_mem = internal * 64 / (dev.channels * dev.ch_bw)
    t_cxl = host * 64 / dev.cxl_bw
    n_comp = (demotions_dirty + recompress_retry) * dev.block_scale * 4
    n_decomp = promotions * dev.block_scale          # per block
    t_engine = (n_comp * dev.comp_cycles + n_decomp * dev.decomp_cycles) \
        / dev.clock
    # average service latency per host access
    host1 = maximum(host, 1)
    zero_frac = zero_served / host1
    accesses_per_host = internal / host1
    decomp_lat_frac = promotions / host1
    if xp is torch:
        l_avg = _fma_f32(1 - zero_frac, dev.dram_lat, dev.cxl_lat)
    else:
        l_avg = dev.cxl_lat + (1 - zero_frac) * dev.dram_lat
    l_avg = l_avg \
        + accesses_per_host * dev.dram_lat * 0.25 \
        + decomp_lat_frac * dev.decomp_cycles / dev.clock
    t_lat = host * l_avg / dev.mlp
    return maximum(maximum(t_mem, t_cxl), maximum(t_engine, t_lat))


def exec_time_vec(counters, dev: DeviceLike, xp=None):
    """Delivered seconds ``[...]`` of counter arrays ``[..., NUM_COUNTERS]``
    in ``state.COUNTER_NAMES`` order, under a ``DeviceConfig`` or a
    ``DeviceLanes`` whose fields broadcast against the leading axes.
    Internal traffic is the sum of the ten ``state.TRAFFIC_IDX``
    categories. A numpy input computes in float64 (bitwise the
    reference's), a tensor in float32 on its device."""
    if xp is None:
        xp = np if isinstance(counters, np.ndarray) else torch
    c = (np.asarray(counters, np.float64) if xp is np
         else torch.as_tensor(counters).to(torch.float32))
    internal = S.traffic_vector(c).sum(axis=-1)
    host = c[..., S.C_HOST_RD] + c[..., S.C_HOST_WR]
    return _exec_time_core(host, internal, c[..., S.C_PROMOTIONS],
                           c[..., S.C_DEMO_DIRTY], c[..., S.C_RECOMP_RETRY],
                           c[..., S.C_ZERO_SERVED], dev, xp)


def counters_from_dict(traffic: Mapping[str, float]) -> np.ndarray:
    """String-keyed traffic dict -> float64 ``[NUM_COUNTERS]`` vector in
    ``state.COUNTER_NAMES`` order (missing keys are zero)."""
    return np.asarray([traffic.get(k, 0) for k in S.COUNTER_NAMES],
                      np.float64)


def exec_time_dict(traffic: Mapping[str, float], dev: DeviceConfig) -> float:
    """The dict API over the same core, float64 throughout. An explicit
    ``internal_accesses`` key wins (fig12's miracle variant passes a total
    that is not the category sum); otherwise the ten categories are
    summed."""
    host = traffic["host_reads"] + traffic["host_writes"]
    if "internal_accesses" in traffic:
        internal = traffic["internal_accesses"]
    else:
        internal = sum(traffic.get(k, 0) for k in S.TRAFFIC_NAMES)
    f = np.float64
    return float(_exec_time_core(
        f(host), f(internal), f(traffic.get("promotions", 0)),
        f(traffic.get("demotions_dirty", 0)),
        f(traffic.get("recompress_retry", 0)),
        f(traffic.get("zero_served", 0)), dev, np))


def uncompressed_counters(n_host) -> np.ndarray:
    """Counters of an uncompressed device serving ``n_host`` host reads:
    host reads and one internal data access each, all else zero (scalar or
    array ``n_host``; leading axes broadcast)."""
    n = np.asarray(n_host, np.float64)
    vec = np.zeros(n.shape + (S.NUM_COUNTERS,), np.float64)
    vec[..., S.C_HOST_RD] = n
    vec[..., S.C_DATA_RD] = n          # internal: one 64B access per read
    return vec


def uncompressed_time(n_host, dev: DeviceLike):
    """Fig-9-style baseline: the model's time of the uncompressed traffic.
    Scalar in, float out; array in (or ``DeviceLanes``), array out."""
    t = exec_time_vec(uncompressed_counters(n_host), dev, xp=np)
    return float(t) if np.ndim(t) == 0 else t


def pipeline_delivered_time(replay_deltas, migration_deltas, dev: DeviceLike,
                            overlapped: bool = True):
    """Delivered seconds of a two-stage segment pipeline: per-segment
    counter deltas ``[S, ..., NUM_COUNTERS]`` (the foreground replay's and
    the migration epoch's overlapped with it) priced segment by segment
    and summed over segments. ``overlapped=True`` prices a segment as
    ``max(replay, migration)``, ``False`` as their sum."""
    xp = np if isinstance(replay_deltas, np.ndarray) else torch
    t_replay = exec_time_vec(replay_deltas, dev, xp=xp)
    t_mig = exec_time_vec(migration_deltas, dev, xp=xp)
    per_seg = _maximum(xp)(t_replay, t_mig) if overlapped \
        else t_replay + t_mig
    return per_seg.sum(axis=0)


# ---------------------------------------------------------------------------
# Serving-side model: preempt/resume bytes and host syncs -> seconds.
# ---------------------------------------------------------------------------

def serve_motion_time(preempt_bytes, resume_bytes, dev: DeviceLike, xp=np):
    """Seconds one expander spends moving park/resume payloads: the bytes
    cross the CXL link and the internal channels (pipelined: the max of
    the two), and every parked 1KB block pays the compression engine."""
    maximum = _maximum(xp)
    moved = preempt_bytes + resume_bytes
    t_link = moved / dev.cxl_bw
    t_mem = moved / (dev.channels * dev.ch_bw)
    t_engine = (preempt_bytes / 1024.0) * dev.block_scale * dev.comp_cycles \
        / dev.clock
    return maximum(maximum(t_link, t_mem), t_engine)


def serve_modeled_time(counters: Mapping[str, int],
                       expander_stats: Mapping[str, np.ndarray],
                       devices: Sequence[DeviceConfig]) -> Dict[str, object]:
    """Modeled serving seconds from an engine's motion and sync counters:
    expanders move their own parked payloads in parallel (the bottleneck
    is the max), host syncs are serial round trips at the slowest lane's
    CXL latency."""
    lanes = stack_devices(list(devices), xp=np)
    motion = serve_motion_time(
        np.asarray(expander_stats["preempt_bytes"], np.float64),
        np.asarray(expander_stats["resume_bytes"], np.float64), lanes, np)
    syncs = counters["step_syncs"] + counters["admit_syncs"]
    sync_s = float(syncs * np.max(lanes.cxl_lat))
    modeled_s = sync_s + float(np.max(motion))
    steps = max(int(counters["steps"]), 1)
    return {
        "sync_s": sync_s,
        "motion_s_per_expander": [float(t) for t in motion],
        "modeled_s": modeled_s,
        "modeled_s_per_step": modeled_s / steps,
    }
