#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints its result on its own line and any failure
exits non-zero:

  0 device   the card, its power limit, torch and CUDA versions
  1 build    nvcc builds the fused demote/promote kernels (sm_90a)
  2 kernels  each kernel against its plain PyTorch version on the card,
             byte for byte, over block widths, input types, lossless and
             zero-elision settings and row counts
  3 main     the payload pool at deployment size: population through
             host_write_page, then replay_trace of an mcf trace; launch
             counts, counters, invariants I1-I4 and a bit-exact read-back
  4 whole    the same recipe, small, with the kernels and with the plain
             compressor: every pool leaf identical
  5 times    kernel / plain / bound times (CUDA events) at the main path's
             shapes and at 65,536 blocks

The last three lines are the kernels summary (JSON), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": ...}.
Needs no network; imports torch, numpy and the port, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# f32 operations per value, counted from the kernel source: encode does
# abs/max, then for each of the two rates multiply, round, two clamps, a
# multiply, a bf16 round trip and a compare (or a subtract, abs and max);
# decode does a convert and a multiply.
ENCODE_OPS_PER_VALUE = 18
DECODE_OPS_PER_VALUE = 2
SEED = 0
# the deployment-size pool: 1 GiB of logical pages, a 64 MiB promoted
# region, a 1 GiB compressed region (512 B chunks)
MAIN_POOL = dict(n_pages=262144, n_pchunks=16384, n_cchunks=2097152)
# pages written (2x the promoted region) and accesses replayed there
MAIN_PAGES = 32768
MAIN_ACCESSES = 32768
WHOLE_POOL = dict(n_pages=4096, n_pchunks=512, n_cchunks=32768)


class SmokeFailure(RuntimeError):
    """A phase found the port wrong; the run exits non-zero."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------

def edge_blocks(n: int, v: int, seed: int) -> np.ndarray:
    """float32 [n, v] blocks cycling through nine classes: all zeros, +-0
    mixed, an exact 4-bit grid, an exact 8-bit grid, random finite bf16
    bits, .5 ties, 4-bit saturation at -8, 8-bit saturation at -128, and
    normal values not exact in bf16 (for float32 input)."""
    from repro_torch.simx.trace import make_block_content
    rng = np.random.default_rng(seed)
    cls = np.arange(n) % 9
    rate_of = np.array([0, 0, 1, 2, 3, 0, 0, 0, 0])
    x = make_block_content(rate_of[cls], v, seed)
    pm = cls == 1
    x[pm] = np.where(np.arange(v) % 2 == 1, np.float32(-0.0), np.float32(0.0))
    ties = cls == 5
    x[ties] = rng.integers(-7, 7, size=(int(ties.sum()), v)) + 0.5
    x[ties, 0] = 7.0
    sat4, sat8 = cls == 6, cls == 7
    x[sat4] = -8.0
    x[sat4, 0] = 7.0
    x[sat8] = -128.0
    x[sat8, 0] = 127.0
    nrm = cls == 8
    x[nrm] = rng.standard_normal((int(nrm.sum()), v)) * 0.7
    return x.astype(np.float32)


def mcf_blocks(n: int, seed: int) -> np.ndarray:
    """n blocks of 512 values with mcf's rate mix (the main path's data)."""
    from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                        make_rates_table)
    rates = make_rates_table(WORKLOADS["mcf"], max(1, -(-n // 4)), 4, seed)
    return make_block_content(rates.reshape(-1)[:n], 512, seed)


def decode_bytes_needed(rates: torch.Tensor, v: int) -> int:
    """Bytes the decode of these rows must move: the rates, each row's
    payload at its rate, and the bf16 output."""
    payload = torch.tensor([0, 4 + v // 2, 4 + v, 2 * v],
                           device=rates.device)[rates.long()]
    return int(payload.sum()) + 4 * rates.numel() + 2 * v * rates.numel()


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_device() -> tuple:
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase 0 device: {name} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} | cuda {torch.version.cuda} | cards "
          f"{torch.cuda.device_count()}", flush=True)
    return name, smi


def phase_build(qpack, tag: str) -> None:
    info = qpack.build()
    qpack.load()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase 1 build: {info['seconds']:.3f} s nvcc -> {info['path']} "
          f"[{tag}]", flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}")


def phase_kernels(qpack, comp, dev) -> dict:
    """Each kernel against its plain version, on the card, byte for byte."""
    res = {"encode": {"cases": 0, "mismatches": 0, "err": 0.0},
           "decode": {"cases": 0, "mismatches": 0, "err": 0.0}}
    rates_seen = set()
    for v in (512, 2048):
        x32 = torch.from_numpy(edge_blocks(65536, v, SEED + v)).to(dev)
        inputs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
        for dtype, xall in inputs.items():
            for lossless in (True, False):
                for ze in (True, False):
                    kw = dict(tol4=0.10, tol8=0.01, lossless=lossless,
                              zero_elision=ze,
                              quanta=comp.quanta_per_rate(v))
                    for n in (1, 7, 32, 65536):
                        x = xall[:n]
                        got = qpack.fused_encode(x, **kw)
                        want = qpack.fused_encode_plain(x, **kw)
                        bad = ~(got[0] == want[0]).all(dim=1)
                        bad |= (got[1] != want[1]) | (got[2] != want[2])
                        err = max(
                            float((got[0].int() - want[0].int()).abs().max()),
                            float((got[1] - want[1]).abs().max()),
                            float((got[2] - want[2]).abs().max()))
                        e = res["encode"]
                        e["cases"] += 1
                        e["mismatches"] += int(bad.sum())
                        e["err"] = max(e["err"], err)
                        if lossless and ze:
                            rates_seen |= set(want[1].unique().tolist())
                        out = qpack.fused_decode(want[0], want[1])
                        ref = qpack.fused_decode_plain(want[0], want[1])
                        d = res["decode"]
                        d["cases"] += 1
                        d["mismatches"] += int(
                            (out.view(torch.int16) != ref.view(torch.int16))
                            .any(dim=1).sum())
                        d["err"] = max(d["err"], float(
                            (out.float() - ref.float()).abs().max()))
        torch.cuda.synchronize()
    check(rates_seen == {0, 1, 2, 3},
          f"phase 2 exercised rates {sorted(rates_seen)}, not all four")
    summary = [{"name": k, "launches": getattr(qpack, f"fused_{k}_launches"),
                "cases": r["cases"], "mismatches": r["mismatches"]}
               for k, r in res.items()]
    print(f"phase 2 kernels vs plain: {json.dumps(summary)}", flush=True)
    for k, r in res.items():
        check(r["mismatches"] == 0,
              f"phase 2: fused_{k} disagrees with its plain version in "
              f"{r['mismatches']} rows")
    return res


def _populate_and_replay(cfg, E, pol, content, trace, stats=None):
    """Write every page of ``content`` with host_write_page, then replay
    ``trace``: the port's main path, through its entry points."""
    from repro_torch.core.engine import batch
    pool = E.make_pool(cfg, seed=SEED)          # on the card by default
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(content.shape[0]):
        E.host_write_page(pool, cfg, pol, i, content[i])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch.replay_trace(pool, cfg, pol, *trace, window=32, stats=stats)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return pool, t1 - t0, t2 - t1


def phase_main(qpack, dev, pages: int, accesses: int, tag: str) -> dict:
    from repro_torch import interop
    from repro_torch.common import contracts
    from repro_torch.common.types import PoolConfig
    from repro_torch.core import engine as E
    from repro_torch.core.engine import batch
    from repro_torch.core.engine.invariants import check_pool_invariants
    from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                        make_rates_table, make_trace)

    cfg = PoolConfig(**MAIN_POOL, store_payload=True, lossless=True)
    pol = E.POLICIES["ibex"]
    rates = make_rates_table(WORKLOADS["mcf"], pages, cfg.blocks_per_page, SEED)
    content = torch.from_numpy(
        make_block_content(rates, cfg.vals_per_block, SEED)
        .reshape(pages, cfg.vals_per_page)).to(dev).to(torch.bfloat16)
    trace = make_trace(WORKLOADS["mcf"], n_accesses=accesses, n_pages=pages,
                       seed=SEED)
    stats = batch.new_stats()

    qpack.fused_encode_launches = 0
    qpack.fused_decode_launches = 0
    contracts.SYNCS.reset()
    pool, t_pop, t_rep = _populate_and_replay(cfg, E, pol, content, trace,
                                              stats)
    launches = {"encode": qpack.fused_encode_launches,
                "decode": qpack.fused_decode_launches}
    syncs = contracts.SYNCS.count

    c = E.counters_dict(pool)
    ratio = E.compression_ratio(pool, cfg)
    arrays = interop.pool_to_numpy(pool)
    check_pool_invariants(arrays, cfg)
    del arrays
    w_syncs = stats["window_syncs"] / max(stats["windows"], 1)
    s_syncs = stats["slow_syncs"] / max(stats["slow"], 1)
    print(f"phase 3 main: {pages} pages written over {cfg.n_pchunks} "
          f"P-chunks, {accesses} accesses (window 32) | population "
          f"{pages / t_pop:.3f} pages/s ({t_pop:.3f} s) | replay "
          f"{accesses / t_rep:.3f} accesses/s ({t_rep:.3f} s) | syncs "
          f"{syncs} total, {w_syncs:.3f} per window ({stats['windows']} "
          f"windows), {s_syncs:.3f} per slow access ({stats['slow']} slow) "
          f"| launches encode {launches['encode']} decode "
          f"{launches['decode']} | compression ratio {ratio:.6f} [{tag}]",
          flush=True)
    print(f"phase 3 counters: {json.dumps(c)}", flush=True)
    check(launches["encode"] > 0 and launches["decode"] > 0,
          f"phase 3: a kernel was not launched on the main path: {launches}")
    check(c["demotions_clean"] + c["demotions_dirty"] > 0,
          "phase 3: no demotion")
    check(c["promotions"] > 0, "phase 3: no promotion")

    # read-back (after the metrics). The pool is lossless, so a block of a
    # page the trace never wrote must come back bit-exact. A page the trace
    # wrote is held to nothing here: the reference's block write can type a
    # ZERO block hot without materializing it (ROADMAP queue C1), so such a
    # page may read stale bytes, exactly as the reference does; its blocks
    # are counted against "zeros where written, else the original" only.
    o, w, b = trace
    written = set(zip(o[w].tolist(), b[w].tolist()))
    wpages = set(o[w].tolist())
    rng = np.random.default_rng(SEED + 7)
    clean = np.array(sorted(set(range(pages)) - wpages))
    ps = np.concatenate([rng.choice(clean, 2048),
                         rng.choice(np.array(sorted(wpages)), 256)])
    bs = rng.integers(0, cfg.blocks_per_page, ps.size)
    got, want = [], []
    zero = torch.zeros((cfg.vals_per_block,), dtype=torch.bfloat16, device=dev)
    for p, blk in zip(ps.tolist(), bs.tolist()):
        _, vals = E.host_read_block(pool, cfg, pol, p, blk)
        got.append(vals)
        want.append(zero if (p, blk) in written else
                    content[p, blk * cfg.vals_per_block:
                            (blk + 1) * cfg.vals_per_block])
    differ = (torch.stack(got).view(torch.int16) !=
              torch.stack(want).view(torch.int16)).any(dim=1).tolist()
    bad = sum(differ[:2048])
    print(f"phase 3 read-back: 2048 blocks of pages the trace never wrote, "
          f"{bad} differ | 256 blocks of pages it wrote, "
          f"{sum(differ[2048:])} differ from zeros-where-written "
          f"(reference fault C1, not held) [{tag}]", flush=True)
    check(bad == 0, f"phase 3: {bad} read-back blocks differ")
    return launches


def phase_whole(qpack, dev) -> None:
    """The main path's recipe, small, with the kernels and with the plain
    compressor: every leaf of the pool must match."""
    from repro_torch import interop
    from repro_torch.common.types import PoolConfig
    from repro_torch.core import engine as E
    from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                        make_rates_table, make_trace)

    base = PoolConfig(**WHOLE_POOL, store_payload=True, lossless=True,
                      fused_demote="on")
    pages, accesses = 1024, 4096
    rates = make_rates_table(WORKLOADS["mcf"], pages, base.blocks_per_page,
                             SEED + 1)
    content = torch.from_numpy(
        make_block_content(rates, base.vals_per_block, SEED + 1)
        .reshape(pages, base.vals_per_page)).to(dev).to(torch.bfloat16)
    trace = make_trace(WORKLOADS["mcf"], n_accesses=accesses, n_pages=pages,
                       seed=SEED + 1)
    out = {}
    for impl in ("kernel", "jnp"):
        cfg = dataclasses.replace(base, compress_impl=impl)
        e0, d0 = qpack.fused_encode_launches, qpack.fused_decode_launches
        pool, _, _ = _populate_and_replay(cfg, E, E.POLICIES["ibex"],
                                          content, trace)
        out[impl] = (interop.pool_to_numpy(pool),
                     qpack.fused_encode_launches - e0,
                     qpack.fused_decode_launches - d0)
    (ka, ke, kd), (pa, pe, pd) = out["kernel"], out["jnp"]
    diff = [k for k in ka if not np.array_equal(ka[k], pa[k])]
    print(f"phase 4 whole path kernel vs plain: {len(ka)} leaves, "
          f"{len(diff)} differ {diff} | kernel run launches encode {ke} "
          f"decode {kd}, plain run {pe} {pd}", flush=True)
    check(not diff, f"phase 4: leaves differ: {diff}")
    check(ke > 0 and kd > 0 and pe == 0 and pd == 0,
          "phase 4: the kernel run did not launch the kernels, or the plain "
          "run did")


def time_graph(fn, reps: int, samples: int = 21) -> float:
    """Median ms per call of ``fn`` replayed from a CUDA graph of ``reps``
    calls (device time, free of the host's launch cost)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def time_eager(fn, reps: int, samples: int = 21) -> float:
    """Median ms per call of ``fn`` called back to back from the host (what
    the eager main path pays, launch cost included)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def phase_times(qpack, comp, dev, tag: str) -> dict:
    qt = comp.quanta_per_rate(512)
    out = {}
    for n in (32, 4, 65536):
        x = torch.from_numpy(mcf_blocks(n, SEED + n)).to(dev) \
            .to(torch.bfloat16)
        dense, rates, _ = qpack.fused_encode(x, lossless=True, quanta=qt)
        reps = 200 if n < 1024 else 10
        kinds = {
            "encode": (lambda: qpack.fused_encode(x, lossless=True, quanta=qt),
                       lambda: qpack.fused_encode_plain(x, lossless=True,
                                                        quanta=qt),
                       n * 512 * 2 + n * (2 * 512 + 8),
                       ENCODE_OPS_PER_VALUE * n * 512),
            "decode": (lambda: qpack.fused_decode(dense, rates),
                       lambda: qpack.fused_decode_plain(dense, rates),
                       decode_bytes_needed(rates, 512),
                       DECODE_OPS_PER_VALUE * n * 512),
        }
        for kind, (kern, plain, nbytes, ops) in kinds.items():
            if (kind, n) not in (("encode", 32), ("decode", 4),
                                 ("encode", 65536), ("decode", 65536)):
                continue
            t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
            r = {"ms": time_graph(kern, reps),
                 "eager_ms": time_eager(kern, reps),
                 "plain_ms": time_eager(plain, max(reps // 10, 5)),
                 "bound_ms": max(t_b, t_o) * 1e3,
                 "bound_by": "bytes" if t_b >= t_o else "operations",
                 "bytes": nbytes}
            out[(kind, n)] = r
            print(f"phase 5 {kind} {n}x512 bf16: kernel {r['ms']:.6f} ms "
                  f"(graph replay), {r['eager_ms']:.6f} ms eager | plain "
                  f"{r['plain_ms']:.6f} ms | bound {r['bound_ms']:.6f} ms by "
                  f"{r['bound_by']} ({nbytes} B at 3.35 TB/s) [{tag}]",
                  flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import compressor as comp
        from repro_torch.kernels import qpack
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 3
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name, smi = phase_device()
    tag = smi
    phase_build(qpack, tag)
    errs = phase_kernels(qpack, comp, dev)
    launches = phase_main(qpack, dev, MAIN_PAGES, MAIN_ACCESSES, tag)
    phase_whole(qpack, dev)
    times = phase_times(qpack, comp, dev, tag)

    src = "src/repro_torch/csrc/qpack_fused.cu"
    kernels = []
    for kind, n, line in (("encode", 32, 278), ("decode", 4, 305)):
        t = times[(kind, n)]
        kernels.append({
            "name": f"qpack_fused_{kind}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/qpack.py:{line}",
            "launches": launches[kind], "max_abs_err": errs[kind]["err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "eager_ms": t["eager_ms"],
            "shape": f"{n}x512 bf16", "cases": errs[kind]["cases"],
            "mismatches": errs[kind]["mismatches"]})
    print(f"total {time.perf_counter() - t_start:.3f} s [{tag}]")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
