"""Tile sweep of the serving path's two attention kernels on the card.

The kernels are built with one tile each (``csrc/flash_attn.cu``'s
``tc::Tile``, ``csrc/kvc_attn.cu``'s ``kChunk``). This script builds each
candidate as its own library, all nvcc processes started together:

  * B6's tensor-core route at D 128 with every (keys per tile, ring stages)
    of ``TILES`` (-DFLASH_TC_BK, -DFLASH_TC_STAGES);
  * B5 with every chunk of ``CHUNKS`` (-DKVC_CHUNK);
  * B5's latent form on the tensor cores (bf16 q, the serving path's
    route) with every span of tokens a CTA of ``LATENT``
    (-DKVC_TC_TOKENS).

It prints each candidate's ptxas lines (registers, spills, serialized
wgmmas), checks it against the plain version (B6 element-wise 2e-2 and
normwise 1e-2, B5 2e-2), and times it at ``chip_smoke.py``'s phase 10
shapes: B6 on 8 x 1,024 causal, 32/8 heads x 128 bf16; B5 on 8 lanes of a
4-bit cache of 2,048 positions at phase 10's lengths; B5 latent on
minicpm3-4b's 8 lanes (40 heads x 288, 4-bit, bf16 q) at phase 13d's
lengths (the same as phase 10's) and at phase 13b's profiled lanes (its
prompts four decode steps in, longer), with each candidate's working CTAs
and the shipped candidate's distance from the best. Times are the median
ms a call of CUDA-graph replays. The last line is one JSON object of the
times, the line before it the card's name and power limit.

    python3 tools/sweep_attn.py                  # needs a card and nvcc
    python3 tools/sweep_attn.py --only latent    # one kernel's candidates
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as smoke                                      # noqa: E402
from repro_torch.kernels import build                          # noqa: E402
from repro_torch.kernels import flash_attn as FA               # noqa: E402
from repro_torch.kernels import kvc_attn as KA                 # noqa: E402
from repro_torch.kernels import qpack                          # noqa: E402

TILES = ((96, 3), (96, 2), (64, 3), (128, 2), (128, 3))
CHUNKS = (64, 128, 256)
LATENT = (64, 96, 128)
ENTRY = {"flash_attn": ("flash_attn_fwd",),
         "kvc_attn": ("kvc_attn_partial", "kvc_latent_partial",
                      "kvc_latent_partial_tc")}


def candidates(only=None) -> list:
    """(source, label, -D macros, chunk) for every candidate of the kernels
    ``only`` names (all when None); a latent candidate's chunk is its
    tokens a CTA."""
    kinds = {
        "b6": [("flash_attn", f"{bk}x{ns}",
                {"FLASH_TC_BK": bk, "FLASH_TC_STAGES": ns}, None)
               for bk, ns in TILES],
        "b5": [("kvc_attn", str(c), {"KVC_CHUNK": c}, c) for c in CHUNKS],
        "latent": [("kvc_attn", f"latent_{t}", {"KVC_TC_TOKENS": t}, t)
                   for t in LATENT]}
    return [c for k, cs in kinds.items() if only in (None, k) for c in cs]


def build_all(cands: list) -> list:
    """One nvcc per candidate, all at once; the library paths."""
    out_dir = build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    started = []
    for name, label, defs, _ in cands:
        out = out_dir / f"lib{name}-{label}.so"
        cmd = [build._nvcc(), *build.flags(name),
               *(f"-D{k}={v}" for k, v in defs.items()), "-o", str(out),
               str(build.CSRC / f"{name}.cu")]
        started.append((out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    paths = []
    for (name, label, _, _), (out, proc) in zip(cands, started):
        _, log = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name} {label}:\n{log}")
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "C7512" in ln:
                print(f"  ptxas {name} {label}: {ln.strip()}")
        paths.append(out)
    return paths


def use(name: str, path: Path) -> None:
    """Make the wrapper of ``name`` launch the library at ``path``."""
    shipped = build.load(name, {})
    lib = ctypes.CDLL(str(path))
    for entry in ENTRY[name]:
        fn = getattr(lib, entry)
        fn.argtypes = getattr(shipped, entry).argtypes
        fn.restype = ctypes.c_int
    build._libs[name] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=("b6", "b5", "latent"),
                    help="sweep one kernel's candidates")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_attn: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    _, smi = smoke.phase_device()
    FA._lib(), KA._lib()                  # the shipped builds, for argtypes
    shipped = dict(build._libs)
    cands = candidates(args.only)
    paths = build_all(cands)

    cfg = smoke._llama()
    B, Hq, Hkv, D = smoke.SERVE_CFG["max_running"], cfg.num_heads, \
        cfg.num_kv_heads, cfg.resolved_head_dim
    bits, W, S = smoke.SERVE_CFG["kv_rate_bits"], \
        smoke.SERVE_CFG["hot_window"], smoke.SERVE_MAX_LEN
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED + 3)
    Sp = 1024
    qf, kf, vf = (torch.randn((B, Sp, h, D), generator=gen, device=dev)
                  .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    want_f = FA.flash_attention_plain(qf, kf, vf, causal=True).float()
    lens_l = np.random.default_rng(smoke.SEED).integers(
        *smoke.PROMPT_LENS, size=B) + smoke.SERVE_NEW_TOKENS // 2 - W
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    (kc, ks), (vc, vs) = [qpack.encode(torch.randn(
        (B, S, Hkv, D), generator=gen, device=dev), bits, D)
        for _ in range(2)]
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    want_k = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits,
                                         1.0 / D ** 0.5)
    # B5 latent: minicpm3-4b's 8 lanes at 13d's lengths and at 13b's
    # profiled lanes (seed + 4 prompts, 4 decode steps in)
    mla = smoke._minicpm()
    lat_lens = {"13d": lens_l.tolist(), "13b_profile": [
        len(p) - W + 4 for p in smoke._prompts(B, mla.vocab_size,
                                               smoke.SEED + 4)]}
    lc, lsc = qpack.encode(torch.randn((B, S, smoke.MLA_R), generator=gen,
                                       device=dev), bits, smoke.MLA_R)
    lsc = lsc[..., 0].contiguous()
    lq = torch.randn((B, smoke.MLA_H, smoke.MLA_R), generator=gen,
                     device=dev).to(torch.bfloat16)
    lat_in = {k: torch.tensor(v, dtype=torch.int32, device=dev)
              for k, v in lat_lens.items()}
    want_l = {k: KA.kvc_latent_partial_plain(lq, lc, lsc, v, bits,
                                             smoke.MLA_SM)
              for k, v in lat_in.items()}

    times = {"flash_attention_8x1024_causal": {}, "kvc_decode_attention": {},
             **{f"kvc_latent_partial_{k}": {} for k in lat_lens}}
    shipped_chunk = KA.CHUNK
    shipped_lat = KA.LATENT_TC_TOKENS
    working = {}
    for (name, label, _, chunk), path in zip(cands, paths):
        use(name, path)
        if name == "flash_attn":
            got = FA.flash_attention(qf, kf, vf, causal=True).float()
            d = got - want_f
            smoke.check(bool((d.abs() <= 2e-2 * (1 + want_f.abs())).all())
                        and float(d.norm()) <= 1e-2 * float(want_f.norm()),
                        f"sweep: B6 tile {label} disagrees with the plain "
                        "version")
            ms = smoke.time_graph(
                lambda: FA.flash_attention(qf, kf, vf, causal=True), 5)
            times["flash_attention_8x1024_causal"][label] = ms
        elif label.startswith("latent"):
            # the scratch follows the candidate
            KA.LATENT_TC_TOKENS = chunk
            working[label] = {k: KA.latent_working_ctas(v)
                              for k, v in lat_lens.items()}
            ms = []
            for k, ln in lat_in.items():
                got = KA.kvc_latent_partial(lq, lc, lsc, ln, bits=bits,
                                            sm_scale=smoke.MLA_SM)
                smoke.check(all(torch.allclose(a, b, atol=2e-2, rtol=2e-2)
                                for a, b in zip(got, want_l[k])),
                            f"sweep: B5 latent {label} disagrees with the "
                            f"plain version at {k}'s lengths")
                t = smoke.time_graph(lambda ln=ln: KA.kvc_latent_partial(
                    lq, lc, lsc, ln, bits=bits, sm_scale=smoke.MLA_SM), 50)
                times[f"kvc_latent_partial_{k}"][label] = t
                ms.append(t)
            ms = ms[0]
            KA.LATENT_TC_TOKENS = shipped_lat
        else:
            KA.CHUNK = chunk              # the scratch follows the chunk
            got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
            smoke.check(all(torch.allclose(a, b, atol=2e-2, rtol=2e-2)
                            for a, b in zip(got, want_k)),
                        f"sweep: B5 chunk {label} disagrees with the plain "
                        "version")
            ms = smoke.time_graph(lambda: KA.kvc_decode_partial(
                q, kc, ks, vc, vs, lens, bits=bits), 50)
            times["kvc_decode_attention"][label] = ms
            KA.CHUNK = shipped_chunk
        build._libs.update(shipped)
        extra = "".join(f", {k} {v[label]:.6f} ms" for k, v in times.items()
                        if k.startswith("kvc_latent") and label in v)
        print(f"sweep {name} {label}: {ms:.6f} ms (graph replay){extra} "
              f"[{smi}]", flush=True)
    print(f"shapes: B6 q {B}x{Sp}x{Hq}x{D} causal; B5 q {B}x{Hq}x{D}, "
          f"{bits}-bit KV {B}x{S}x{Hkv}, lengths {lens_l.tolist()}; shipped "
          f"tiles: B6 {FA.TC_KEYS[D]} keys x 3 stages, B5 chunk "
          f"{shipped_chunk}; B5 latent q {B}x{smoke.MLA_H}x{smoke.MLA_R} "
          f"bf16 (tensor cores), {bits}-bit latent {B}x{S}, lengths "
          f"{lat_lens}, shipped {shipped_lat} tokens a CTA")
    shipped_label = f"latent_{shipped_lat}"
    for k in lat_lens:
        row = times[f"kvc_latent_partial_{k}"]
        if shipped_label in row:
            best = min(row, key=row.get)
            print(f"latent at {k}'s lengths: best {best} {row[best]:.6f} ms, "
                  f"shipped {shipped_label} {row[shipped_label]:.6f} ms = "
                  f"{row[shipped_label] / row[best] - 1:+.4f} off the best; "
                  f"working CTAs {json.dumps({c: w[k] for c, w in working.items()})}")
    print(smi)
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        sys.exit(1)
