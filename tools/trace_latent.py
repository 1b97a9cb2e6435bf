"""Where one launch of B5 latent's tensor-core kernel spends its time, by
phase of a CTA's chain, on the card.

The script copies ``csrc/kvc_attn.cu`` with timestamps inserted into
``kvc_latent_tc_kernel`` (thread 0 of each CTA reads ``clock64`` after
each phase and ``%globaltimer`` at its start and end), builds the copy as
its own library beside the shipped one and launches it through the
wrapper. The stamps go to the wrapper's scratch buffer past the merge
records. It prints, at phase 13d's lengths and at phase 13b's profiled
lengths of ``chip_smoke.py`` (minicpm3-4b, 8 lanes, 4-bit latent of 2,048
positions): the working and exiting CTAs, when the working ones start,
when the last one ends, and the median and max cycles of each phase:

    loads       the length, q's copies, the codes' loads and conversion
    QK          Q C^T (the wgmma chain) and its wait
    softmax+PV  the span's softmax, P's split and hi C + lo C
    record      the partial to the output or to its record
    atomic      the counter's add (lanes of more than one span)
    last merge  the last CTA of a (lane, box): the spans' merge

The stamps change the kernel's timing a little; compare phases, not the
total with ``chip_smoke.py``'s times. The insertion points are the
kernel's source lines: a kernel change that moves them makes the script
stop with the line it did not find.

    python3 tools/trace_latent.py      # needs a card and nvcc
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as smoke                                      # noqa: E402
from repro_torch.kernels import build                          # noqa: E402
from repro_torch.kernels import kvc_attn as KA                 # noqa: E402
from repro_torch.kernels import qpack                          # noqa: E402

STAMPS = 16                        # u64 slots a CTA
OFF = 4 << 20                      # floats into the scratch: past the records
PHASES = ((1, 0, "loads"), (2, 1, "QK"), (3, 2, "softmax+PV"),
          (4, 3, "record"), (8, 4, "atomic"), (9, 8, "last merge"))


def traced_source() -> str:
    """csrc/kvc_attn.cu with the stamps in kvc_latent_tc_kernel."""
    src = (build.CSRC / "kvc_attn.cu").read_text()

    def put(anchor: str, add: str, before: bool = False) -> None:
        nonlocal src
        if src.count(anchor) != 1:
            raise SystemExit(f"trace_latent: the kernel no longer has one\n"
                             f"{anchor}")
        src = src.replace(anchor, add + anchor if before else anchor + add)

    def cycles(i: int) -> str:
        return f"  if (tid == 0) trc[{i}] = clock64() - ck0;\n"

    def wall(i: int) -> str:
        return ("  { unsigned long long t; asm volatile(\"mov.u64 %0, "
                f"%globaltimer;\" : \"=l\"(t)); if (tid == 0) trc[{i}] = t; }}\n")

    put("  const int ncol = min(kBox, R - c0);\n",
        "  unsigned long long* trc = reinterpret_cast<unsigned long long*>("
        f"scratch + {OFF}) + ((static_cast<int64_t>(b) * n_span + g) * RB + "
        f"box) * {STAMPS};\n  const long long ck0 = clock64();\n" + wall(0) +
        "  if (tid == 0) trc[15] = 1 + (g < n_act);\n")
    put("  __syncthreads();\n\n  const bool alone = n_act == 1;\n",
        cycles(1), before=False)
    put("    wg_commit();\n    wg_wait<0>();\n    fence_regs(sc);\n", cycles(2))
    put("    fence_frags<kTok / 16>(pl);\n", cycles(3))
    put("  if (alone) return;\n\n  // the last CTA", cycles(4) + wall(12),
        before=True)
    put("  if (!last_s) return;\n  const float* recs", cycles(8), before=True)
    put("  if (tid == 0) *counter = 0;\n}\n\ntemplate <int H, int R, int BITS>"
        "\nint launch(", cycles(9) + wall(13), before=True)
    return src


def use_traced() -> None:
    """Build the traced copy and make the wrapper launch it."""
    out = build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "kvc_attn_trace.cu").write_text(traced_source())
    lib = out / "libkvc_attn_trace.so"
    r = subprocess.run([build._nvcc(), *build.flags("kvc_attn"), "-I",
                        str(build.CSRC), "-o", str(lib),
                        str(out / "kvc_attn_trace.cu")],
                       capture_output=True, text=True, timeout=600)
    if r.returncode:
        raise SystemExit(f"trace_latent: nvcc failed:\n{r.stderr}")
    shipped = KA._lib()                   # its argument types
    traced = ctypes.CDLL(str(lib))
    for fn in ("kvc_attn_partial", "kvc_latent_partial",
               "kvc_latent_partial_tc"):
        getattr(traced, fn).argtypes = getattr(shipped, fn).argtypes
        getattr(traced, fn).restype = ctypes.c_int
    build._libs["kvc_attn"] = traced


def report(label: str, tr: np.ndarray) -> None:
    used = tr[tr[:, 15] != 0]
    work, dead = used[used[:, 15] == 2], used[used[:, 15] == 1]
    t0 = used[:, 0].min()
    ends = np.concatenate([work[:, 12], work[work[:, 13] > 0, 13]])
    print(f"{label}: {len(used)} CTAs, {len(work)} working, {len(dead)} "
          f"exiting at once; working CTAs start within "
          f"{(work[:, 0].max() - t0) / 1e3:.3f} us; the last ends at "
          f"{(ends.max() - t0) / 1e3:.3f} us; "
          f"{int((work[:, 13] > 0).sum())} last merges", flush=True)
    for i, prev, name in PHASES:
        ok = (work[:, i] > 0) & ((work[:, prev] > 0) | (prev == 0))
        d = work[ok, i] - (work[ok, prev] if prev else 0)
        if len(d):
            print(f"  {name:11s} {len(d):4d} CTAs: median {np.median(d):7.0f} "
                  f"cycles, max {d.max():7.0f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_latent: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, smi = smoke.phase_device()
    use_traced()
    B, S, bits = smoke.SERVE_CFG["max_running"], smoke.SERVE_MAX_LEN, \
        smoke.SERVE_CFG["kv_rate_bits"]
    W = smoke.SERVE_CFG["hot_window"]
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 15)
    lc, ls = qpack.encode(torch.randn((B, S, smoke.MLA_R), generator=gen,
                                      device=dev), bits, smoke.MLA_R)
    ls = ls[..., 0].contiguous()
    q = torch.randn((B, smoke.MLA_H, smoke.MLA_R), generator=gen,
                    device=dev).to(torch.bfloat16)
    lens_13d = np.random.default_rng(smoke.SEED).integers(
        *smoke.PROMPT_LENS, size=B) + smoke.SERVE_NEW_TOKENS // 2 - W
    profile = [len(p) - W + 4 for p in smoke._prompts(
        B, smoke._minicpm().vocab_size, smoke.SEED + 4)]
    n_ctas = B * KA.LATENT_TC_BOXES * -(-S // KA.LATENT_TC_TOKENS)
    KA._scratch[dev] = torch.zeros(OFF + 2 * STAMPS * n_ctas,
                                   dtype=torch.float32, device=dev)
    buf = KA._scratch[dev]
    for label, lens_l in (("13d", lens_13d.tolist()), ("13b_profile", profile)):
        lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
        for _ in range(3):                # the last of three calls
            buf[OFF:].zero_()
            KA.kvc_latent_partial(q, lc, ls, lens, bits=bits,
                                  sm_scale=smoke.MLA_SM)
            torch.cuda.synchronize()
        report(f"{label} lengths {lens_l}",
               buf[OFF:].view(torch.int64).cpu().numpy().reshape(-1, STAMPS))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
