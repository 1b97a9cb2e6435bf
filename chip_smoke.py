#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; each prints its result on its own line and any failure
exits non-zero:

  0 device   the card, its power limit, torch and CUDA versions
  1 build    nvcc builds the four kernel sources (sm_90a), all at once;
             ptxas registers and spills, HGMMA/UTMALDG counts in the
             flash library's SASS and HGMMA/UTMALDG/LDGSTS in B5 latent's
             tensor-core kernel
  2 kernels  the fused demote/promote kernels (B1/B2), the demote-and-
             compact kernel (B1's redesign) and the promote step (B2's)
             against their plain PyTorch versions on the card, byte for
             byte, over block widths, input types, lossless and zero-
             elision settings, row counts, victim slots, 8-chunk pages and
             range masks
  3 main     the payload pool at deployment size: population through
             host_write_page, then replay_trace of an mcf trace; launch
             counts (one demote-and-compact launch per demotion batch, one
             promote launch per promotion fill, no fused-decode launch),
             demotion batches and their share of host time, counters,
             invariants I1-I4 and a bit-exact read-back
  4 whole    the same recipe, small, with the kernels and with the plain
             compressor: every pool leaf identical; then its population
             and replay rates with the demote-and-compact kernel and with
             the composition it replaced, and with the promote step and
             the composition it replaced, in turns, at half the pages and
             accesses
  5 times    B1/B2 kernel / plain / bound times (CUDA events) at the main
             path's shapes and at 65,536 blocks; the demote-and-compact
             kernel at a demotion batch of 8 pages and the promote step at
             one page, each beside its eager call, its bound and the
             composition it replaced (device events of one call each,
             torch.profiler)
  6 kernels  the serving kernels against their plain versions: fixed-rate
             encode/decode (B3/B4), the ring step, the prefill fill and
             the lane flush (B3's redesigns) byte for byte, decode
             attention (B5) and prefill attention (B6) within the stated
             tolerance; B5 at the chunk boundaries and bit-identical on a
             second call, B6's bf16 cases on the tensor-core route, B6
             also normwise per case
  7 serve    llama3-8b at its published config (32 layers, bf16, random
             params from a seed) served through Engine: 16 requests over 8
             lanes (preemption and resume), 64 new tokens each; rates,
             counters, launches (the ring step and B5 one a layer a step,
             the prefill fill and B6 one a layer a prefill batch, the lane
             flush one a lane demotion, B3's own encode none, all bf16 B6
             on the tensor cores), B6's device time inside prefill; then
             torch.profiler over 4 decode steps of 8 lanes: device busy
             share, device events a step, B5's time and the top kernels;
             then decode ms a step with the ring step and with the
             composition it replaced, in turns, and the device events a
             step of each; and the device events of one prefill batch and
             of one lane demotion, each step against its composition
  8 paper    the same model in paper mode (promote-then-read): B4 launches
  9 whole    a 2-layer model at llama3-8b's widths, kernels against plain
             versions, in bf16 and float32: prefill and decode logits and
             their argmax, and the same requests served through Engine
             both ways (identical generations in float32)
 10 times    B3-B6 and B3's three steps: kernel / eager / plain / library
             / bound times at the serving path's shapes (B6 also at 4 and
             1 rows; the ring step, the prefill fill and the lane flush
             also beside the compositions they replaced); B5's working
             CTAs against the SMs
 11 simx     the paper's evaluation path (payload-less pools, no kernel):
             one timed full-size cell (ibex x pr), then fig09 at the
             paper's full size over 2 of its 10 workloads (two where
             C5 fires; FIG09_CARD_WL, for the script's time) and
             the other nine figures in quick mode through
             ``launch/paper_figs.py``, each distinct cell once; every cell's
             metrics and every figure row run (fig09's per-cell rows; its
             geomean-speedup rows need the cells not run and are held on
             the CPU) equal to the JAX package's
             (``src/repro_torch/simx/reference_cells.json``), the cells run
             whose pool breaks I1-I4 (fault C5) the reference's with the
             same message, no kernel launched; accesses/s per cell and per
             scheme, windows, slow accesses and syncs a window, the phase's
             wall time
 12 fabric   the multi-expander fabric: (a) 9 of the 12 fabrics of the
             reference fabric bench's full recipe (N = 1, 4, 8; the mixed
             fleets; the skew sweep's 80%; the rebalance pipeline at depth
             2, sync and depth 1) replayed once, payload-less, each equal to
             ``src/repro_torch/fabric/reference_fabric.json`` in every
             field (float32 segment times bit for bit), depth 1 ==
             sync, fetches one a segment plus one an epoch, no kernel
             launched; accesses/s, fetches and the replay's syncs a
             window per fabric; (b) the payload fabric over pool main's
             OSPA space, 4 expanders, 80% of the pages on expander 0, spill
             live at depth 2: I1-I4 on every expander, at least 5 epochs,
             every moved page's compressed bytes equal on its destination,
             B1's and B2's step launches, population pages/s, replay
             accesses/s, pages and bytes moved, the device busy share over
             one segment (torch.profiler); (c) (b)'s recipe on a 4,096-page
             space with the kernels and with the plain versions: every
             leaf of every expander and the override table equal
 13 mla      serving minicpm3-4b (MLA) over the compressed latent cache:
             (a) the MLA kernel forms at its widths against their plain
             versions: the latent ring step, prefill fill and lane flush
             and B4 at block 288 byte for byte, B5's latent form (40 heads
             x 288, K = V) at both routes' tile boundaries within
             tolerance and bit-identical on a second call, bf16 on the
             tensor cores and within its rounding model's tolerance, B6 at
             qk 96 / v 64 (bf16 on the tensor cores, f32); (b) minicpm3-4b at its published
             widths, 16 of its 62 layers (the script's time; bf16,
             random params from a seed) with
             phase 7's recipe: rates, KV cache and peak memory, counters,
             launches against the expectations (the latent ring step and
             B5 one a layer a step, the fill and B6 one a layer a prefill
             batch, the flush one a lane demotion, the GQA steps none,
             every B5 latent launch on the tensor cores), the device busy
             share over 4 decode steps and B5 latent's device time a step
             (found by kernel name); (c) 2 layers at its full widths,
             kernels against plain versions as phase 9, and paper mode (B4
             at block 288) against fused; (d) each MLA form's kernel /
             eager / plain / library / bound times (B5 latent on both
             routes: bf16 q on the tensor cores, the path's, and f32 q on
             the CUDA cores, in the same process), and B5 latent's working
             CTAs at (b)'s lengths above the SM count
 14 moe      serving qwen3-moe-235b-a22b (the MoE family) over the
             compressed KV cache: (a) the kernels at its shapes against
             their plain versions: B3's ring step, prefill fill and lane
             flush at 4 KV heads of 128 byte for byte, B5 at a group of 16
             query heads a KV head (64/4, two head slices) and arctic's 7
             (56/8) at lengths around its chunk within tolerance and
             bit-identical on a second call, B6 at 64/4; (b) qwen3-moe at
             its published widths, 12 of its 94 layers (57.9 GiB of bf16
             params from a seed, peak memory under 72 GiB), with phase 7's
             recipe: rates, KV cache and peak memory, counters, routed
             pairs dropped a decode step, launches against the
             expectations (every B5 launch at a group of 16), the device
             busy share and the top kernels over 4 decode steps; (c) 2
             layers at qwen3-moe's widths and 1 at arctic's, kernels
             against plain versions as phase 9 (float32 generations
             identical; in bf16 the expert choices that differ counted,
             the logits held where none differs), and paper mode (B4)
             against fused; (d) kernel / eager / plain / library / bound
             times of B5 at G 16 and G 7, B6 at 64/4 x 8, 4 and 1 rows and
             B3's steps at 4 KV heads
 15 frontends and ssm
             serving chameleon-34b and musicgen-medium (the frontend
             backbones, fed zero embeddings as the reference's engine
             feeds them) over the compressed KV cache, and falcon-mamba-7b
             (the SSM family, Mamba1), which has no KV cache: (a) the
             kernels at the backbones' shapes against their plain
             versions: B3's ring step, prefill fill and lane flush at 24
             KV heads of 64 byte for byte, B5 at 24/24 x 64 (a group of 1)
             and 64/8 x 128 (8) at lengths around its chunk within
             tolerance and bit-identical on a second call, B6 at both;
             (b) chameleon-34b and (c) musicgen-medium at their published
             widths (musicgen at 24 of its 48 layers, chameleon at 12 of
             its 48, for the script's time: MUSICGEN_SERVE_LAYERS,
             CHAMELEON_SERVE_LAYERS; seeded bf16 params
             made on the card) with phase 7's engine and 16 requests of 32
             new tokens:
             rates, KV cache and peak memory (under 72 GiB), counters,
             launches against the expectations, the device busy share and
             the top kernels over 4 decode steps; (d) falcon-mamba-7b at
             its published widths, 16 of its 64 layers for the script's
             time (SSM_SERVE_LAYERS; bf16), prompts seeded
             multiples of 128 (the reference refuses other lengths past
             its scan chunk): no B3-B6 launch, every park and resume the
             raw state in full (9,175,040 B a lane), exact-length
             prefill groups, rates, peak memory and the busy share; (e) 2
             layers at each model's full widths: chameleon and musicgen
             kernels against plain versions as phase 9, falcon-mamba in
             float32 on the card against the CPU (logits, generations);
             (f) kernel / eager / plain / library / bound times of the
             kernels at (a)'s shapes; each sub-phase's wall
 16 hybrid   serving zamba2-2.7b (the hybrid family: 54 Mamba2 layers in 9
             groups, each followed by one of 2 shared attention blocks,
             32/32 heads of 80) over the compressed KV cache and the raw
             Mamba2 state: (a) the kernels at its shapes against their
             plain versions: B3's ring step, prefill fill and lane flush
             at 32 KV heads of 80 byte for byte, B5 at 32/32 x 80 (a group
             of 1) at lengths around its chunk within tolerance and
             bit-identical on a second call, B6 at 32/32 x 80 (bf16 on
             the tensor cores, f32); (b) zamba2-2.7b at its published
             config (seeded bf16 params made on the card), phase 15d's
             recipe: rates, the cache (1,183,482,144 B) and peak memory,
             counters, launches against the expectations (the ring step
             and B5 one a group a step, the fill and B6 one a group a
             prefill batch, the flush one a lane demotion), every park
             and resume the raw state (72,437,760 B a lane) plus the KV
             suffix, exact-length prefill groups, the busy share and the
             top kernels over 4 decode steps; (c) float32 at full width:
             2 groups, kernels against plain versions (generations
             identical), and 1 group, the card against the CPU; (d)
             kernel / eager / plain / library / bound times at (a)'s
             shapes; each sub-phase's wall
 17 obs      telemetry (``repro_torch.obs``) through the entry points: (a)
             ``launch/serve.py`` on llama3-8b as published (8 lanes, 4-bit
             KV, max_len 2048, 12 requests: preemption and resume) twice,
             without and then with ``--trace``: tokens and
             counters equal, one fetch a step both ways, the recorder's
             steps and bytes equal the engine's, the trace valid, the ring
             step, fill, flush, B5 and B6 launched, the median step wall of
             each kind of run; (b) ``launch/fabric.py`` with payload over
             4,096 pages, 4 expanders, 80% skew, rebalance, with and without
             ``--trace``: every leaf, the overrides and counters equal, one
             fetch a segment and an epoch, every segment and epoch
             recorded, track totals equal to ``pipeline_times()`` at rtol
             1e-9, B1's and B2's steps launched; (c) ``run_workload(obs=)``
             on two quick cells of the reference file; each sub-phase's
             wall
 18 train    training llama3-8b with the IBEX-compressed AdamW state
             (``train/trainer.py``, ``optim/adamw.py``): (a) B3/B4 at 8
             bits, block 512, f32 in, at every size the update hands them,
             byte for byte, and B6's autograd Function at the train shape
             (8 x 512, 32/8 x 128) and at (96, 64), bf16 and f32: its
             forward is B6's launch, dq/dk/dv within ATTN_NORM_TOL of
             autograd through the plain version in f32; their kernel /
             eager / plain / library / bound times and the PyTorch
             attention backward's ms a layer; (b) train main: llama3-8b as
             published (32 layers, bf16, remat, seeded params made on the
             card), seq 512 x batch 8, the compressed state, through
             ``trainer.make_train_step``: a warm-up step and 3 timed ones,
             losses and grad norms finite, step ms (CUDA events), tokens/s,
             the model-FLOP share, peak memory, the state's bytes against
             an f32 state's, launches (B3 and B4 twice a slice of the
             update, B6 twice a layer), no host sync (counted, and
             PyTorch's sync debug mode), the busy share of one profiled
             step and one step split into grads and update; (c) 2 layers
             at llama3-8b's widths in float32, microbatches 2, 3 steps,
             kernels against plain versions: losses within 1e-4, the
             moment codes that differ counted; (d) ``launch/train.py
             --reduced --compress-state`` on the card: checkpoints restore
             byte-equal, a corrupted one is skipped, a resumed run's first
             loss equals the uninterrupted run's

 19 across   the across-device paths on ``torch.distributed`` ranks: the
             sharded fabric at world size 1 (NCCL, this process) and 2
             (two gloo ranks sharing the card) against the vmap driver, the
             data-parallel step with int8 gradient codes (19c-19e)
 20 mesh     the mesh train step (``make_train_step(mesh=)``: FSDP over
             data, tensor parallel over model): (a) mesh (1, 1) on this
             process's NCCL world of one at llama3-8b's published width and
             18b's recipe: one step from 18b's seed and first batch, its
             loss and per-leaf digest equal to 18b's first step's, step ms,
             host syncs 0, B3/B4/B6 launches equal to 18b's a step; (b)
             meshes (1, 2) and (2, 1) on phase 19's two gloo ranks at
             llama3-8b's widths cut to 2 layers, float32, 2 steps: losses
             and params against the single-device step's, B6's launches at
             the rank's head counts (16/4 x 128 at model 2), and B6 at those
             counts held against its plain version and timed; gloo's
             all_reduce and broadcast rates between the two ranks; (c) on
             the same ranks after 20b, the MLA, MoE, SSM and hybrid
             families at 20b's recipe: minicpm3-4b, qwen3-moe and
             falcon-mamba-7b at their published widths and 1 layer,
             zamba2-2.7b at one group (6 Mamba2 layers and its shared
             block), arctic at REDUCED, on (1, 2); qwen3-moe at REDUCED on
             (2, 1) at a global 2 x 512 (grouped, a group a rank) and 4 x
             32 at microbatches 2 (the sorted call re-dealt): losses and
             params against the one-device step from the same seed (the
             ranks train it at once, or in turn where the dry run counts
             its peak past MESH_SHARE of the card, the end blocks then kept
             on the host), each rank's argument bytes against the dry
             run's count, step ms, host syncs, B6's launches by head count;
             B6 at the families' rank heads (20 x 96/64, 32/2 x 128, 16/16 x
             80) held against its plain version and timed
 21 roofline the dry run (``launch/dryrun.py``, ``roofline/``) beside what
             18b, 19c and 20 measured, no new training run: the counted
             argument bytes (params, state, grads; 19c's residuals) within
             1% of the card's allocation, 18b's peak estimate beside its
             peak, 18b's roofline terms beside its step, 20b's counted
             collective bytes at gloo's rates beside its steps, the card's
             memory against the module's, and ``python -m
             repro_torch.launch.dryrun --all --devices 8`` on the host with
             0 failures, after phase 20, beside nothing that is timed
 22 families training the MLA, MoE, SSM and hybrid families through
             ``trainer.make_train_step`` (bf16, remat, seq 512 x batch 8,
             the launcher's optimizer with the compressed state, seeded
             params made on the card): (a) minicpm3-4b as published (62
             layers): a warm-up and 2 timed steps, step ms, tokens/s, the
             model-FLOP share (``roofline.analyze``), peak against the dry
             run's estimate, 0 host syncs (counted and in PyTorch's sync
             debug mode), B3/B4 twice a slice and B6 twice a layer a step;
             (b) zamba2-2.7b and falcon-mamba-7b as published, one step
             each, the peak held to the dry run's estimate (the SSM scan's
             backward keeps one chunk); (c) qwen3-moe at 2 of its 94
             layers; (d) each family cut to 2 layers (zamba2: one group;
             qwen3-moe: 1) in float32, microbatches 2, the kernel route
             against the plain one: losses and params; (e) B6's forward at
             the families' train shapes (40 x 96/64, 64/4 x 128, 32/32 x
             80) against its plain version, and its kernel / eager / plain
             / SDPA / bound times

Every kernel row's bound comes from ``roofline.analyze.kernel_bound`` and
the kernels line carries each row's ``kernel_roofline`` fields.

The last three lines are the kernels summary (JSON), the card's name and
power limit as nvidia-smi gives them, and {"ok": true, "device": ...}.
Needs no network; imports torch, numpy and the port, never JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
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
# phase 4: pages written and accesses replayed for the kernel-vs-plain
# check, and (half of each, for the script's time) for the timed turns
WHOLE_PAGES, WHOLE_ACCESSES = 1024, 4096
WHOLE_AB_PAGES, WHOLE_AB_ACCESSES = 512, 2048
# serving: the main path's engine and workload
SERVE_CFG = dict(max_running=8, hot_window=256, kv_rate_bits=4,
                 attn_chunk=2048)
SERVE_MAX_LEN = 2048
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
PROMPT_LENS = (300, 1001)          # seeded, [300, 1000]: buckets 512, 1024
PAPER_REQUESTS, PAPER_NEW_TOKENS = 4, 16
PROFILE_STEPS = 4
# traces of PROFILE_STEPS steps a profile line may take. The profiler drops
# kernel records now and then, one trace independently of the next
# (tools/trace_loss.py: 5 of 36 traces of musicgen-medium's steps lost B5
# records; PERF.md §6, PR 23), so a trace holding fewer launches of a
# kernel than ran is taken again; the trace kept must hold all of them
PROFILE_TRIES = 4
RING_AB_STEPS = 6      # decode steps a turn of phase 7's ring step A/B
# stated tolerances: the reference's kernel bounds (tests/test_kernels.py,
# atol = rtol), as |kernel - plain| <= tol * (1 + |plain|) for the
# attention kernels, and normwise per row, max|kernel - plain| <= tol *
# max|plain|, for the whole path's logits (phase 9)
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-3}
# and B6 normwise per case, ||kernel - plain||_F <= tol * ||plain||_F: bf16
# rounding of P stays near 2e-3, a skipped or repeated key tile or a wrong
# mask does not
ATTN_NORM_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# the whole path (phase 9): kernels against plain versions asked for
# explicitly, never taken by default
WHOLE_IMPLS = {"kernel": dict(attn_impl="kernel", quantize_impl="kernel"),
               "plain": dict(attn_impl="plain", quantize_impl="jnp")}
WHOLE_STEPS = 16


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


def phase_build(tag: str) -> None:
    """One nvcc per source, all started together; the ptxas lines of each
    kernel, and the tensor-core and TMA instructions in the flash library's
    SASS."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    infos = build.build_all()
    print(f"phase 1 build: {len(infos)} sources in "
          f"{time.perf_counter() - t0:.3f} s [{tag}]", flush=True)
    for info in infos:
        print(f"  {info['name']}: {info['seconds']:.3f} s nvcc -> "
              f"{info['path']}")
        for ln in info["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln or \
                    "C7512" in ln:
                print(f"    ptxas: {ln.strip()}")
    path = {i["name"]: i["path"] for i in infos}
    tool = Path(build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        print(f"phase 1 sass: {tool} absent; HGMMA/UTMALDG not counted",
              flush=True)
        return
    ops = ("HGMMA", "UTMALDG", "LDGSTS")

    def sass(lib: str) -> str:
        return subprocess.run([str(tool), "-sass", path[lib]],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout

    counts = {op: len(re.findall(rf"\b{op}\b", sass("flash_attn")))
              for op in ops[:2]}
    print(f"phase 1 sass of {Path(path['flash_attn']).name}: "
          f"{json.dumps(counts)}", flush=True)
    check(all(counts.values()), f"phase 1: the flash library has no "
          f"tensor-core or TMA instructions: {counts}")
    # B5 latent's tensor-core kernel, one count per instantiation (bits):
    # its copies are cp.async (LDGSTS), not TMA
    lat = {}
    for fn in re.split(r"\n\s*Function : ", sass("kvc_attn"))[1:]:
        name = fn.split("\n", 1)[0].strip()
        if "kvc_latent_tc_kernel" in name:     # keyed by its template args
            key = name[name.index("kvc_latent_tc_kernel"):][:38]
            lat[key] = {op: len(re.findall(rf"\b{op}\b", fn)) for op in ops}
    print(f"phase 1 sass of {Path(path['kvc_attn']).name}, "
          f"kvc_latent_tc_kernel: {json.dumps(lat)}", flush=True)
    check(len(lat) == 2 and all(c["HGMMA"] for c in lat.values()),
          f"phase 1: the latent tensor-core kernel has no HGMMA: {lat}")


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
    res["demote"] = _demote_cases(qpack, comp, dev)
    res["promote"] = _promote_cases(qpack, comp, dev)
    summary = [{"name": k, "launches": getattr(qpack, f"fused_{k}_launches"),
                "cases": r["cases"], "mismatches": r["mismatches"],
                **{f: r[f] for f in ("rates", "groups") if f in r}}
               for k, r in res.items()]
    print(f"phase 2 kernels vs plain: {json.dumps(summary)}", flush=True)
    for k, r in res.items():
        check(r["mismatches"] == 0,
              f"phase 2: fused_{k} disagrees with its plain version in "
              f"{r['mismatches']} rows")
    return res


def _demote_cases(qpack, comp, dev) -> dict:
    """The demote-and-compact kernel against its plain version, byte for
    byte in every output: pages of 4 x 512 and 1 x 2,048 values mixing the
    edge classes (every eighth page all raw, so its quanta fill the page),
    read through seeded victim slots (repeats included) or directly."""
    r = {"cases": 0, "mismatches": 0, "err": 0.0}
    rng = np.random.default_rng(SEED + 5)
    pages = 8192
    for nb, v in ((4, 512), (1, 2048)):
        x32 = torch.from_numpy(edge_blocks(pages * nb, v, SEED + 3 * v)) \
            .to(dev).reshape(pages, nb * v)
        x32[::8] = torch.from_numpy(
            rng.standard_normal((pages // 8, nb * v)).astype(np.float32)
            * 0.7).to(dev)
        for xall in (x32, x32.to(torch.bfloat16)):
            for lossless in (True, False):
                for ze in (True, False):
                    kw = dict(blocks=nb, chunk_bytes=512, lossless=lossless,
                              zero_elision=ze, quanta=comp.quanta_per_rate(v))
                    for k in (1, 8, 4096, None):
                        slots = None if k is None else torch.from_numpy(
                            rng.integers(0, pages, k)).to(dev)
                        x = xall[:8] if k is None else xall
                        got = qpack.fused_demote(x, slots, **kw)
                        want = qpack.fused_demote_plain(x, slots, **kw)
                        r["cases"] += 1
                        rows = want[0].shape[0]
                        bad = torch.zeros(rows, dtype=torch.bool, device=dev)
                        for a, b in zip(got[:4], want[:4]):
                            bad |= (a != b).reshape(rows, -1).any(dim=1)
                        bad_rec = bool((got[4] != want[4]).any())
                        r["mismatches"] += int(bad.sum()) + int(bad_rec)
                        r["err"] = max(r["err"], *(
                            float((a.int() - b.int()).abs().max())
                            for a, b in zip(got, want)))
    torch.cuda.synchronize()
    return r


LOSSY = dict(tol4=0.05, tol8=0.003)   # all four rates occur (tests' setting)


def promote_inputs(qpack, comp, dev, content: np.ndarray, nb: int,
                   lossless: bool, masks, seed: int):
    """Promotions of the pages ``content`` (float32 [K, nb * v]): demoted
    by the demote-and-compact kernel, each page stream written into its own
    chunks of a store of random bytes (an aligned group of 8 for an
    8-chunk page, else its chunks in seeded order), a store of random
    P-chunk rows, and one record a page (its chunk ids, 0 past its chunk
    count as ops._page_chunk_ids gives them, its rates, a distinct seeded
    slot, and ``masks[k % len(masks)]``). Returns (c_store, p_store,
    record, fused_promote's keywords, record rows on the host, compressed
    bytes of the pages, chunk counts)."""
    rng = np.random.default_rng(seed)
    k, v = content.shape[0], content.shape[1] // nb
    page_bytes, cb = 2 * nb * v, 512
    cpp = page_bytes // cb
    quanta = comp.quanta_per_rate(v)
    x = torch.from_numpy(content).to(dev).to(torch.bfloat16)
    bufs, rates, qnt, nch, _ = qpack.fused_demote(
        x, None, blocks=nb, chunk_bytes=cb, lossless=lossless, quanta=quanta,
        **({} if lossless else LOSSY))
    rates_h, nch_h = rates.tolist(), nch.tolist()
    n_rows = 8 * k + 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    c_store = torch.randint(0, 256, (n_rows, cb), generator=gen, device=dev,
                            dtype=torch.uint8)
    p_store = torch.randint(0, 256, (k + 8, page_bytes), generator=gen,
                            device=dev, dtype=torch.uint8)
    groups, slots = rng.permutation(n_rows // 8), rng.permutation(k + 8)
    rows, dst, src = [], [], []
    for p in range(k):
        base = 8 * int(groups[p])
        n = nch_h[p]
        own = list(range(base, base + 8)) if n == 8 else \
            (rng.permutation(8)[:n] + base).tolist()
        ids = [own[i] if i < n else 0 for i in range(cpp)]
        dst += own[:n]
        src += [p * cpp + i for i in range(n)]
        rows.append(ids + rates_h[p] + [int(slots[p]), masks[p % len(masks)]])
    if dst:
        c_store[torch.tensor(dst, device=dev)] = \
            bufs.reshape(k * cpp, cb)[torch.tensor(src, device=dev)]
    record = torch.tensor(rows, dtype=torch.int32, device=dev)
    kw = dict(blocks=nb, chunk_bytes=cb, range_bytes=1024, quanta=quanta)
    return (c_store, p_store, record, kw, rows, int(qnt.sum()) * 128,
            nch_h)


def _promote_cases(qpack, comp, dev) -> dict:
    """The promote kernel against its plain version, byte for byte in
    every P-chunk row: pages of 4 x 512 and 1 x 2,048 values of the edge
    classes (every fourth page all raw: an 8-chunk group whose last block
    starts at page_bytes - 2V, the bound of the slicing's clamp, which no
    quanta table the wrapper accepts can pass), lossless and lossy, 1 to
    64 pages a record, masks of the full page, of single blocks and of
    seeded sets of ranges that are not hot."""
    r = {"cases": 0, "mismatches": 0, "err": 0.0, "rates": set(),
         "groups": 0}
    rng = np.random.default_rng(SEED + 11)
    for nb, v in ((4, 512), (1, 2048)):
        n_ranges = 2 * nb * v // 1024
        full = (1 << n_ranges) - 1
        mask_sets = {"full": [full],
                     "single": [1 << i for i in range(n_ranges)],
                     "not hot": rng.integers(1, full, 64).tolist()}
        for lossless in (True, False):
            for k in (1, 8, 64):
                content = edge_blocks(k * nb, v, SEED + k + v) \
                    .reshape(k, nb * v)
                content[::4] = rng.standard_normal(
                    (len(range(0, k, 4)), nb * v)) * 0.7
                for name, masks in mask_sets.items():
                    c_store, p_store, record, kw, rows, _, nch = \
                        promote_inputs(qpack, comp, dev, content, nb,
                                       lossless, masks, SEED + k)
                    got, want = p_store.clone(), p_store.clone()
                    qpack.fused_promote(c_store, got, record, **kw)
                    qpack.fused_promote_plain(c_store, want, record, **kw)
                    r["cases"] += 1
                    r["mismatches"] += int((got != want).any(dim=1).sum())
                    r["err"] = max(r["err"], float(
                        (got.int() - want.int()).abs().max()))
                    r["rates"] |= {x for row in rows
                                   for x in row[-2 - nb:-2]}
                    r["groups"] += sum(n == 8 for n in nch)
    torch.cuda.synchronize()
    check(r["rates"] == {0, 1, 2, 3} and r["groups"] > 0,
          f"phase 2: the promote cases saw rates {sorted(r['rates'])} and "
          f"{r['groups']} 8-chunk pages")
    r["rates"] = sorted(r["rates"])
    return r


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

    # demotion batches (victim batches and recompressions: every call of
    # the compressor's demote_pages) and the host time inside them, the
    # fetch of their record included
    from repro_torch.core import compressor as comp
    from repro_torch.core.engine import ops
    batches = {"calls": 0, "s": 0.0, "fills": 0}
    orig = (comp.demote_pages, ops._encode_victims, comp.promote_pages)

    def timed_demote(*a, **k):
        batches["calls"] += 1
        return orig[0](*a, **k)

    def counted_promote(*a, **k):      # a promotion fill of a P-chunk row
        batches["fills"] += 1
        return orig[2](*a, **k)

    def timed_victims(*a, **k):
        t0 = time.perf_counter()
        out = orig[1](*a, **k)
        batches["s"] += time.perf_counter() - t0
        return out

    comp.demote_pages, ops._encode_victims, comp.promote_pages = \
        timed_demote, timed_victims, counted_promote
    qpack.fused_encode_launches = 0
    qpack.fused_decode_launches = 0
    qpack.fused_demote_launches = 0
    qpack.fused_promote_launches = 0
    contracts.SYNCS.reset()
    try:
        pool, t_pop, t_rep = _populate_and_replay(cfg, E, pol, content,
                                                  trace, stats)
    finally:
        comp.demote_pages, ops._encode_victims, comp.promote_pages = orig
    launches = {"encode": qpack.fused_encode_launches,
                "decode": qpack.fused_decode_launches,
                "demote": qpack.fused_demote_launches,
                "promote": qpack.fused_promote_launches}
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
          f"| launches demote-and-compact {launches['demote']} promote "
          f"{launches['promote']} decode {launches['decode']} encode "
          f"{launches['encode']} | compression "
          f"ratio {ratio:.6f} [{tag}]", flush=True)
    n_b = batches["calls"]
    print(f"phase 3 demotion: {n_b} batches (victim batches and "
          f"recompressions), {launches['demote'] / max(n_b, 1):.3f} "
          f"demote-and-compact launches a batch, fused-encode launches "
          f"{launches['encode']} | victim batches {batches['s']:.3f} s of "
          f"host time (fetch included) = "
          f"{batches['s'] / (t_pop + t_rep):.4f} of the {t_pop + t_rep:.3f} "
          f"s of population and replay [{tag}]", flush=True)
    n_f = batches["fills"]
    print(f"phase 3 promotion: {n_f} promotion fills (promote and "
          f"update-promote), {launches['promote'] / max(n_f, 1):.3f} promote "
          f"launches a fill, fused-decode launches {launches['decode']} "
          f"[{tag}]", flush=True)
    print(f"phase 3 counters: {json.dumps(c)}", flush=True)
    check(launches["demote"] > 0 and launches["promote"] > 0,
          f"phase 3: a kernel was not launched on the main path: {launches}")
    check(launches["promote"] == n_f and launches["decode"] == 0,
          f"phase 3: {n_f} promotion fills took {launches['promote']} promote "
          f"and {launches['decode']} fused-decode launches (one and none "
          "expected)")
    check(launches["demote"] == n_b and launches["encode"] == 0,
          f"phase 3: {n_b} demotion batches took {launches['demote']} "
          f"demote-and-compact and {launches['encode']} fused-encode "
          "launches (one and none expected)")
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

    def recipe(pages, accesses):
        rates = make_rates_table(WORKLOADS["mcf"], pages,
                                 base.blocks_per_page, SEED + 1)
        content = torch.from_numpy(
            make_block_content(rates, base.vals_per_block, SEED + 1)
            .reshape(pages, base.vals_per_page)).to(dev).to(torch.bfloat16)
        return content, make_trace(WORKLOADS["mcf"], n_accesses=accesses,
                                   n_pages=pages, seed=SEED + 1)

    content, trace = recipe(WHOLE_PAGES, WHOLE_ACCESSES)
    out = {}
    for impl in ("kernel", "jnp"):
        cfg = dataclasses.replace(base, compress_impl=impl)
        e0, d0 = qpack.fused_demote_launches, qpack.fused_promote_launches
        pool, _, _ = _populate_and_replay(cfg, E, E.POLICIES["ibex"],
                                          content, trace)
        out[impl] = (interop.pool_to_numpy(pool),
                     qpack.fused_demote_launches - e0,
                     qpack.fused_promote_launches - d0)
    (ka, ke, kd), (pa, pe, pd) = out["kernel"], out["jnp"]
    diff = [k for k in ka if not np.array_equal(ka[k], pa[k])]
    print(f"phase 4 whole path kernel vs plain: {len(ka)} leaves, "
          f"{len(diff)} differ {diff} | kernel run launches demote {ke} "
          f"promote {kd}, plain run {pe} {pd}", flush=True)
    check(not diff, f"phase 4: leaves differ: {diff}")
    check(ke > 0 and kd > 0 and pe == 0 and pd == 0,
          "phase 4: the kernel run did not launch the kernels, or the plain "
          "run did")

    # the same recipe at half the pages and accesses with the kernels, the
    # demotion done by the demote-and-compact kernel and by the composition
    # it replaced (the gather, the fused-encode kernel, the eager
    # compaction), in turns
    pages, accesses = WHOLE_AB_PAGES, WHOLE_AB_ACCESSES
    content, trace = recipe(pages, accesses)
    fused = qpack.fused_demote

    def composition(x, slots, **kw):
        return qpack.fused_demote_plain(x, slots, encode=qpack.fused_encode,
                                        **kw)

    cfg = dataclasses.replace(base, compress_impl="kernel")
    rates_ab = {"demote-and-compact": [], "composition": []}
    try:
        for name in ("demote-and-compact", "composition", "composition",
                     "demote-and-compact"):
            qpack.fused_demote = fused if name == "demote-and-compact" \
                else composition
            _, t_pop, t_rep = _populate_and_replay(cfg, E, E.POLICIES["ibex"],
                                                   content, trace)
            rates_ab[name].append([pages / t_pop, accesses / t_rep])
    finally:
        qpack.fused_demote = fused
    print(f"phase 4 demote-and-compact vs the composition it replaced, "
          f"{pages} pages over {base.n_pchunks} P-chunks and {accesses} "
          f"accesses, in turns: [population pages/s, replay accesses/s] "
          f"{json.dumps(rates_ab)}", flush=True)

    # and the promotion done by the promote step and by the composition it
    # replaced, in turns (the pool leaves must not differ)
    from repro_torch.core.engine import ops
    step = ops._promote_into
    rates_ab = {"promote step": [], "composition": []}
    leaves = {}
    try:
        for name in ("promote step", "composition", "composition",
                     "promote step"):
            ops._promote_into = step if name == "promote step" else \
                promote_composition()
            pool, t_pop, t_rep = _populate_and_replay(
                cfg, E, E.POLICIES["ibex"], content, trace)
            rates_ab[name].append([pages / t_pop, accesses / t_rep])
            leaves.setdefault(name, interop.pool_to_numpy(pool))
    finally:
        ops._promote_into = step
    a, b = leaves["promote step"], leaves["composition"]
    diff = [k for k in a if not np.array_equal(a[k], b[k])]
    print(f"phase 4 promote step vs the composition it replaced, in turns: "
          f"[population pages/s, replay accesses/s] {json.dumps(rates_ab)} | "
          f"{len(diff)} leaves differ", flush=True)
    check(not diff, f"phase 4: the promote composition's leaves differ: "
          f"{diff}")


def promote_composition():
    """ops._promote_into as it was before the promote step: the chunk ids'
    upload and gather (ops._gather_page_buf), the rates' upload,
    compressor.decode_page (the quanta table's upload, the dense slicing,
    the fused-decode kernel) and a copy into the P-chunk row for each range
    (one for a whole page)."""
    from repro_torch.common import contracts
    from repro_torch.core import compressor as comp
    from repro_torch.core.engine import ops

    def promote_into(pool, cfg, entry, slot, ranges):
        buf = ops._gather_page_buf(pool, cfg, entry)
        rates = contracts.upload(ops._rates_of(entry, cfg), torch.int32,
                                 buf.device)
        page = ops._page_to_bytes(comp.decode_page(buf, rates, cfg))
        if len(ranges) == cfg.page_bytes // cfg.block_bytes:
            pool.p_store[slot] = page
            return
        for r in ranges:
            rng = slice(r * cfg.block_bytes, (r + 1) * cfg.block_bytes)
            pool.p_store[slot, rng] = page[rng]
    return promote_into


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


def _bound(nbytes: int, ops: int, dtype) -> dict:
    """A kernel row's bound (``roofline.analyze.kernel_bound``: bytes at
    the HBM rate or operations at the peak of their type, the larger) and
    its bytes."""
    from repro_torch.roofline import analyze as RA
    ms, by = RA.kernel_bound(nbytes, ops, dtype)
    return {"bound_ms": ms, "bound_by": by, "bytes": nbytes}


def _peak(dtype) -> float:
    from repro_torch.roofline import analyze as RA
    return RA.PEAK_BY_DTYPE[str(dtype).replace("torch.", "")]


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
            r = {"ms": time_graph(kern, reps),
                 "eager_ms": time_eager(kern, reps),
                 "plain_ms": time_eager(plain, max(reps // 10, 5)),
                 **_bound(nbytes, ops, "float32")}
            out[(kind, n)] = r
            print(f"phase 5 {kind} {n}x512 bf16: kernel {r['ms']:.6f} ms "
                  f"(graph replay), {r['eager_ms']:.6f} ms eager | plain "
                  f"{r['plain_ms']:.6f} ms | bound {r['bound_ms']:.6f} ms by "
                  f"{r['bound_by']} ({nbytes} B at 3.35 TB/s) [{tag}]",
                  flush=True)

    # the demote-and-compact kernel at the main path's demotion batch
    # (window 32: 8 pages of 4 x 512 values), read through slots from a
    # store of mcf pages, beside the composition it replaced (the gather,
    # the fused-encode kernel, the plain compaction, the chunk counts and
    # the record's concatenation)
    k, nb, v = 8, 4, 512
    store = torch.from_numpy(mcf_blocks(1024 * nb, SEED + 9)
                             .reshape(1024, nb * v)).to(dev) \
        .to(torch.bfloat16)
    slots = torch.from_numpy(np.random.default_rng(SEED + 9).choice(
        1024, k, replace=False)).to(dev)
    kw = dict(blocks=nb, chunk_bytes=512, lossless=True, quanta=qt)
    kern = lambda: qpack.fused_demote(store, slots, **kw)       # noqa: E731
    old = lambda: qpack.fused_demote_plain(                     # noqa: E731
        store, slots, encode=qpack.fused_encode, **kw)
    page = 2 * nb * v
    # slots and pages read; page streams, quanta and record written
    nbytes = k * (8 + 2 * page + 4 * nb + 4 * (nb + 1))
    r = {"ms": time_graph(kern, 200), "eager_ms": time_eager(kern, 200),
         "plain_ms": time_eager(lambda: qpack.fused_demote_plain(
             store, slots, **kw), 20),
         "composition_ms": time_eager(old, 50),
         "composition_graph_ms": time_graph(old, 50),
         **_bound(nbytes, ENCODE_OPS_PER_VALUE * k * nb * v, "float32"),
         "event_names": device_events(kern),
         "composition_events": sum(device_events(old).values())}
    r["events"] = sum(r["event_names"].values())
    out[("demote", k)] = r
    print(f"phase 5 demote-and-compact {k} pages of {nb}x{v} bf16: kernel "
          f"{r['ms']:.6f} ms (graph replay), {r['eager_ms']:.6f} ms eager, "
          f"{r['events']:.2f} device events a call {r['event_names']} | "
          f"the "
          f"composition it replaced "
          f"{r['composition_ms']:.6f} ms eager, "
          f"{r['composition_graph_ms']:.6f} ms graph replay, "
          f"{r['composition_events']:.2f} device events | plain "
          f"{r['plain_ms']:.6f} ms | bound {r['bound_ms']:.6f} ms by "
          f"{r['bound_by']} ({nbytes} B at 3.35 TB/s) [{tag}]", flush=True)
    out[("promote", 1)] = _promote_times(qpack, comp, dev, tag)
    return out


def _promote_times(qpack, comp, dev, tag: str) -> dict:
    """The promote step at the main path's promotion (one page of 4 x 512
    mcf values, the whole page written), beside the composition it
    replaced: eager with its three uploads; replayed, its device work with
    the uploads made beforehand (a graph cannot capture a copy from
    pageable memory)."""
    from repro_torch.common import contracts
    from repro_torch.common.types import PoolConfig
    nb, v = 4, 512
    qt = comp.quanta_per_rate(v)
    cfg = PoolConfig(lossless=True, compress_impl="kernel")
    c_store, p_store, record, kw, rows, comp_bytes, _ = promote_inputs(
        qpack, comp, dev, mcf_blocks(nb, SEED + 10).reshape(1, nb * v), nb,
        True, [15], SEED + 10)
    cpp = cfg.chunks_per_page
    ids_h, rates_h, slot = rows[0][:cpp], rows[0][cpp:cpp + nb], rows[0][-2]
    kern = lambda: qpack.fused_promote(c_store, p_store, record, **kw)  # noqa: E731

    def old():
        ids = contracts.upload(ids_h, torch.int64, dev)
        buf = c_store.index_select(0, ids).reshape(cfg.page_bytes)
        rates = contracts.upload(rates_h, torch.int32, dev)
        p_store[slot] = comp.decode_page(buf, rates, cfg).contiguous() \
            .view(torch.uint8)

    ids_t = torch.tensor(ids_h, dtype=torch.int64, device=dev)
    rates_t = torch.tensor(rates_h, dtype=torch.int32, device=dev)
    qt_t = torch.tensor(qt, dtype=torch.int64, device=dev)

    def old_device():
        buf = c_store.index_select(0, ids_t).reshape(1, cfg.page_bytes)
        starts = torch.clamp(qpack.offsets(qt_t[rates_t.long()][None]) * 128,
                             max=cfg.page_bytes - 2 * v)
        idx = starts[..., None] + torch.arange(2 * v, device=dev)
        dense = torch.gather(buf, 1, idx.reshape(1, -1)).reshape(nb, 2 * v)
        p_store[slot] = qpack.fused_decode(dense, rates_t).reshape(-1) \
            .view(torch.uint8)

    # record and compressed bytes read, the whole page written
    nbytes = 4 * len(rows[0]) + comp_bytes + cfg.page_bytes
    r = {"ms": time_graph(kern, 200), "eager_ms": time_eager(kern, 200),
         "plain_ms": time_eager(lambda: qpack.fused_promote_plain(
             c_store, p_store, record, **kw), 20),
         "composition_ms": time_eager(old, 50),
         "composition_graph_ms": time_graph(old_device, 50),
         **_bound(nbytes, DECODE_OPS_PER_VALUE * nb * v, "float32"),
         "event_names": device_events(kern),
         "composition_events": sum(device_events(old).values())}
    r["events"] = sum(r["event_names"].values())
    print(f"phase 5 promote step, 1 page of {nb}x{v} bf16 (rates "
          f"{rates_h}, {comp_bytes} compressed B), whole page written: kernel "
          f"{r['ms']:.6f} ms (graph replay), {r['eager_ms']:.6f} ms eager, "
          f"{r['events']:.2f} device events a call {r['event_names']} | the "
          f"composition it replaced {r['composition_ms']:.6f} ms eager, "
          f"{r['composition_events']:.2f} device events; its device work "
          f"{r['composition_graph_ms']:.6f} ms graph replay | plain "
          f"{r['plain_ms']:.6f} ms | bound {r['bound_ms']:.6f} ms by "
          f"{r['bound_by']} ({nbytes} B at 3.35 TB/s) [{tag}]", flush=True)
    return r


# the port's kernels: every one lives in a top-level anonymous namespace
PORT_KERNEL = re.compile(r"^(void )?\(anonymous namespace\)::")


def device_events(fn, calls: int = 4) -> dict:
    """Device events a call of ``fn`` over ``calls`` calls (warmed up
    first), by name: PyTorch's own kernels, copies and fills as
    torch.profiler records them, and the port's kernels as their launch
    counters count them. A short profile can miss a kernel launched
    through ctypes (a lone ring step, prefill fill or lane flush has read
    0 to 0.5 a call after the serving phases, 1 a call in a fresh
    process), so the profiler's records of the port's kernels are dropped
    and the counters stand in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n0 = _port_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n1 = _port_launch_counts()
    names: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not PORT_KERNEL.match(e.name):
            n = e.name[:60]
            names[n] = names.get(n, 0) + 1 / calls
    for k, n in n1.items():
        if n > n0[k]:
            names[k] = (n - n0[k]) / calls
    return names


def _port_launch_counts() -> dict:
    """Every launch counter of the port's kernels (B6's and B5 latent's
    tensor-core counts are parts of their totals, so they are left out)."""
    from repro_torch.kernels import qpack
    counts = {f"qpack_fused_{k}": getattr(qpack, f"fused_{k}_launches")
              for k in ("encode", "decode", "demote", "promote")}
    counts.update(_launch_counts())
    del counts["flash_attention_tc"], counts["kvc_latent_partial_tc"]
    return counts


# ---------------------------------------------------------------------------
# Serving phases (B3-B6, the ring step).
# ---------------------------------------------------------------------------

def _launch_counts() -> dict:
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    return {"qpack_fixed_encode": qpack.encode_launches,
            "qpack_fixed_decode": qpack.decode_launches,
            "qpack_ring_step": qpack.ring_step_launches,
            "qpack_prefill_fill": qpack.prefill_fill_launches,
            "qpack_lane_flush": qpack.lane_flush_launches,
            "kvc_decode_attention": KA.launches,
            "flash_attention": FA.launches,
            "flash_attention_tc": FA.launches_tc,
            "qpack_latent_ring_step": qpack.latent_ring_step_launches,
            "qpack_latent_prefill_fill": qpack.latent_prefill_fill_launches,
            "qpack_latent_lane_flush": qpack.latent_lane_flush_launches,
            "kvc_latent_partial": KA.latent_launches,
            "kvc_latent_partial_tc": KA.latent_launches_tc}


# the decode path's own steps, by attention kind: the other kind's stay at 0
GQA_STEPS = ("qpack_ring_step", "qpack_prefill_fill", "qpack_lane_flush",
             "kvc_decode_attention")
MLA_STEPS = ("qpack_latent_ring_step", "qpack_latent_prefill_fill",
             "qpack_latent_lane_flush", "kvc_latent_partial",
             "kvc_latent_partial_tc")


def _reset_launches() -> None:
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    qpack.encode_launches = qpack.decode_launches = 0
    qpack.ring_step_launches = 0
    qpack.prefill_fill_launches = qpack.lane_flush_launches = 0
    qpack.latent_ring_step_launches = qpack.latent_prefill_fill_launches = 0
    qpack.latent_lane_flush_launches = 0
    KA.launches = FA.launches = FA.launches_tc = KA.latent_launches = 0
    KA.latent_launches_tc = 0
    KA.group_launches.clear()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-row equality of the bit patterns (rows = leading dims)."""
    if a.dtype in (torch.bfloat16, torch.float32):
        iv = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        a, b = a.view(iv), b.view(iv)
    return (a == b).reshape(a.shape[0], -1).all(dim=1)


def phase_serve_kernels(dev) -> dict:
    """B3/B4 and the ring step byte for byte; B5/B6 within ATTN_TOL, max
    abs error kept."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    res = {k: {"cases": 0, "mismatches": 0, "err": 0.0}
           for k in ("qpack_fixed_encode", "qpack_fixed_decode",
                     "qpack_ring_step", "qpack_prefill_fill",
                     "qpack_lane_flush", "kvc_decode_attention",
                     "flash_attention")}
    _ring_cases(res["qpack_ring_step"], qpack, dev)
    _fill_cases(res["qpack_prefill_fill"], qpack, dev)
    _flush_cases(res["qpack_lane_flush"], qpack, dev)
    for block in (128, 512):
        x32 = torch.from_numpy(edge_blocks(131072, block, SEED + block)) \
            .to(dev)
        for xall in (x32, x32.to(torch.bfloat16)):
            for bits in (4, 8):
                for n in (1, 7, 64, 131072):
                    x = xall[:n]
                    got = qpack.encode(x, bits, block)
                    want = qpack.encode_plain(x, bits, block)
                    r = res["qpack_fixed_encode"]
                    r["cases"] += 1
                    r["mismatches"] += int((~(_bits_equal(got[0], want[0]) &
                                              _bits_equal(got[1], want[1])))
                                           .sum())
                    r["err"] = max(r["err"], float(
                        (got[1] - want[1]).abs().max()))
                    for out_dt in (torch.bfloat16, torch.float32):
                        a = qpack.decode(*want, bits, block, out_dt)
                        b = qpack.decode_plain(*want, bits, block, out_dt)
                        r = res["qpack_fixed_decode"]
                        r["cases"] += 1
                        r["mismatches"] += int((~_bits_equal(a, b)).sum())
                        fin = torch.isfinite(b)
                        r["err"] = max(r["err"], float(
                            (a.float() - b.float())[fin].abs().max()))
        del x32, xall
    torch.cuda.synchronize()

    # B5: lengths 0, 1, ragged and full; S 8 to 2048; G 1 and 4; D 64/128
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for S in (8, 100, 2048):
        for G, Hkv, D in ((4, 8, 128), (1, 4, 128), (4, 2, 64)):
            for bits in (4, 8):
                B = 4
                q = torch.randn((B, Hkv * G, D), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                kv = [qpack.encode(torch.randn((B, S, Hkv, D), generator=gen,
                                               device=dev), bits, D)
                      for _ in range(2)]
                (kc, ks), (vc, vs) = [(c, s_[..., 0].contiguous())
                                      for c, s_ in kv]
                lens = torch.tensor([0, 1, max(1, S * 5 // 8), S],
                                    dtype=torch.int32, device=dev)
                sm = 1.0 / D ** 0.5
                got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens,
                                            bits=bits)
                want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens,
                                                   bits, sm)
                gotn = KA.kvc_decode_attention(q, kc, ks, vc, vs, lens,
                                               bits=bits)
                wantn = KA.kvc_decode_attention_plain(q, kc, ks, vc, vs,
                                                      lens, bits, sm)
                r = res["kvc_decode_attention"]
                for a, b in list(zip(got, want)) + [(gotn, wantn)]:
                    a, b = a.float(), b.float()
                    r["cases"] += 1
                    bad = (a - b).abs() > ATTN_TOL[torch.bfloat16] * \
                        (1 + b.abs())
                    r["mismatches"] += int(bad.sum())
                    r["err"] = max(r["err"], float((a - b).abs().max()))

    # B6: causal and full; S 8 to 2048; G 1 and 4; bf16 and f32
    for S, B in ((8, 2), (100, 2), (1024, 1), (2048, 1)):
        for G, Hkv in ((4, 8), (1, 4)):
            for dt in (torch.bfloat16, torch.float32):
                for causal in (True, False):
                    q, k, v = (torch.randn((B, S, h, 128), generator=gen,
                                           device=dev).to(dt)
                               for h in (Hkv * G, Hkv, Hkv))
                    _flash_case(res["flash_attention"], FA, q, k, v, causal)
    # B5 split across the SMs: lengths at the chunk boundaries, S 2048
    # (many splits) and 8 (one), both forms; repeated calls bit-identical
    chunk = KA.CHUNK
    r = res["kvc_decode_attention"]
    repeats = 0
    for S, lens_l in ((2048, [0, 1, chunk - 1, chunk, chunk + 1, 2047, 2048]),
                      (8, [0, 1, 7, 8])):
        for G, Hkv, D in ((4, 8, 128), (8, 2, 128), (1, 4, 64)):
            for bits in (4, 8):
                B = len(lens_l)
                q = torch.randn((B, Hkv * G, D), generator=gen, device=dev) \
                    .to(torch.bfloat16)
                (kc, ks), (vc, vs) = [
                    (c, s_[..., 0].contiguous()) for c, s_ in (
                        qpack.encode(torch.randn((B, S, Hkv, D), generator=gen,
                                                 device=dev), bits, D)
                        for _ in range(2))]
                lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
                sm = 1.0 / D ** 0.5
                got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
                again = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens,
                                              bits=bits)
                repeats += 1
                check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                          for a, b in zip(got, again)),
                      f"phase 6: B5 partials differ between two calls (S {S}, "
                      f"G {G}, D {D}, bits {bits})")
                want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens,
                                                   bits, sm)
                gotn = KA.kvc_decode_attention(q, kc, ks, vc, vs, lens,
                                               bits=bits)
                wantn = KA.kvc_decode_attention_plain(q, kc, ks, vc, vs,
                                                      lens, bits, sm)
                for a, b in list(zip(got, want)) + [(gotn, wantn)]:
                    a, b = a.float(), b.float()
                    r["cases"] += 1
                    r["mismatches"] += int(((a - b).abs() > ATTN_TOL[
                        torch.bfloat16] * (1 + b.abs())).sum())
                    r["err"] = max(r["err"], float((a - b).abs().max()))

    # B6 on the tensor cores (bf16): D 64 and 128, G 1, 4 and 8, S 1 to
    # 2048 causal and full, Sq < Sk; every call counted on launches_tc
    r = res["flash_attention"]
    tc0, tc_cases = FA.launches_tc, 0
    shapes = [(S, S, 2 if S <= 1024 else 1)
              for S in (1, 8, 100, 1000, 1024, 2048)] + \
        [(24, 200, 2), (200, 1000, 2)]
    for Sq, Sk, B in shapes:
        for D in (64, 128):
            for G, Hkv in ((1, 4), (4, 2), (8, 2)):
                for causal in (True, False):
                    q = torch.randn((B, Sq, Hkv * G, D), generator=gen,
                                    device=dev).to(torch.bfloat16)
                    k, v = (torch.randn((B, Sk, Hkv, D), generator=gen,
                                        device=dev).to(torch.bfloat16)
                            for _ in range(2))
                    tc_cases += 1
                    _flash_case(r, FA, q, k, v, causal)
    check(FA.launches_tc - tc0 == tc_cases, f"phase 6: {tc_cases} bf16 "
          f"cases launched the tensor-core route {FA.launches_tc - tc0} times")
    torch.cuda.synchronize()
    print(f"phase 6 redesigned kernels: B5 in {repeats} configurations "
          f"bit-identical on a second call (chunk {chunk}); B6 {tc_cases} bf16 "
          f"cases on the tensor cores (launches_tc +{FA.launches_tc - tc0})",
          flush=True)
    print(f"phase 6 serving kernels vs plain: "
          f"{json.dumps({k: v for k, v in res.items()})} | tolerance "
          f"|kernel - plain| <= tol * (1 + |plain|), tol 2e-2 (bf16) and "
          f"2e-3 (f32); B6 also ||kernel - plain|| <= tol * ||plain|| per "
          f"case, tol 1e-2 (bf16) and 1e-4 (f32); B3/B4, the ring step, the "
          f"prefill fill and the lane flush byte for byte",
          flush=True)
    for k, r in res.items():
        check(r["mismatches"] == 0, f"phase 6: {k} disagrees with its plain "
              f"version in {r['mismatches']} elements/rows")
    r = res["flash_attention"]
    check(r["norm_fails"] == 0, f"phase 6: flash_attention is off its plain "
          f"version normwise in {r['norm_fails']} cases (worst relative "
          f"error {r['norm_err']})")
    return res


# (pos, cold_len) of the ring step's lanes at W 256, S 2048: before the
# window fills, at pos == W, resumed lanes (pos - W < cold_len), evictions
# at 0, in the middle and at S - 1
RING_LANES = ((100, 0), (256, 0), (600, 500), (700, 0), (1500, 1244),
              (2303, 0), (257, 2), (2000, 100))


def ring_inputs(B, H, D, bits, ring, new, gen, dev, W=256, S=2048):
    """A layer's cache slices and new tokens for the ring step: random
    codes and scales, rings of normal values with a zero slot, a +-0 slot
    and a slot of .5 ties; the lanes of RING_LANES."""
    codes = [torch.randint(0, 256, (B, S, H, D * bits // 8), generator=gen,
                           device=dev, dtype=torch.uint8) for _ in range(2)]
    scales = [torch.randn((B, S, H), generator=gen, device=dev)
              for _ in range(2)]
    hot = []
    for _ in range(2):
        h = torch.randn((B, W, H, D), generator=gen, device=dev) * 0.7
        h[:, 1] = 0.0
        h[:, 2, :, 1::2] = -0.0
        h[:, 3] = torch.randint(-7, 7, (B, H, D), generator=gen,
                                device=dev) + 0.5
        hot.append(h.to(ring))
    newv = [(torch.randn((B, H, D), generator=gen, device=dev) * 3).to(new)
            for _ in range(2)]
    lanes = [RING_LANES[i % len(RING_LANES)] for i in range(B)]
    pos = torch.tensor([p for p, _ in lanes], dtype=torch.int32, device=dev)
    cold = torch.tensor([c for _, c in lanes], dtype=torch.int32, device=dev)
    return codes, scales, hot, newv, pos, cold


def _ring_cases(r: dict, qpack, dev,
                shapes=((8, 8, 128), (6, 2, 64), (5, 3, 16))) -> None:
    """The ring step kernel against its plain version, in place, byte for
    byte (codes, scales, both rings) at each (B, H, D) of ``shapes``; a
    mismatch is a lane that differs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf, f32 = torch.bfloat16, torch.float32
    for B, H, D in shapes:
        for bits in (4, 8):
            for ring, new in ((bf, bf), (bf, f32), (f32, f32)):
                codes, scales, hot, newv, pos, cold = ring_inputs(
                    B, H, D, bits, ring, new, gen, dev)
                out = []
                for fn in (qpack.ring_step, qpack.ring_step_plain):
                    c, s_, h = ([t.clone() for t in ts]
                                for ts in (codes, scales, hot))
                    fn(c[0], s_[0], h[0], c[1], s_[1], h[1], newv[0],
                       newv[1], pos, cold, bits)
                    out.append((c, s_, h))
                (kc, ks, kh), (pc, ps, ph) = out
                bad = torch.zeros(B, dtype=torch.bool, device=dev)
                for i in range(2):
                    bad |= ~_bits_equal(kc[i], pc[i])
                    bad |= ~_bits_equal(ks[i], ps[i])
                    bad |= ~_bits_equal(kh[i], ph[i])
                    r["err"] = max(r["err"], float(
                        (kc[i].int() - pc[i].int()).abs().max()), float(
                        (ks[i] - ps[i]).abs().max()), float(
                        (kh[i].float() - ph[i].float()).abs().max()))
                r["cases"] += 1
                r["mismatches"] += int(bad.sum())
    torch.cuda.synchronize()


def fill_inputs(B, S, L, W, H, D, bits, dtype, lens, gen, dev):
    """A prefill layer's k and v [B, S, H, D] (normal values with an
    all-zero token and a +-0 token), its six cache leaves (slices [1] of
    stacked random leaves of 3 layers) and lens."""
    kv = [torch.randn((B, S, H, D), generator=gen, device=dev) * 2
          for _ in range(2)]
    for t in kv:
        t[:, 0] = 0.0
        t[:, 1, :, ::3] = -0.0
    leaves = []
    for _ in range(2):
        leaves += [torch.randint(0, 256, (3, B, L, H, D * bits // 8),
                                 generator=gen, device=dev,
                                 dtype=torch.uint8)[1],
                   torch.randn((3, B, L, H), generator=gen, device=dev)[1],
                   torch.randn((3, B, W, H, D), generator=gen, device=dev)
                   .to(torch.bfloat16)[1]]
    return ([t.to(dtype) for t in kv], leaves,
            torch.tensor(lens, dtype=torch.int32, device=dev))


FILL_SHAPES = [(1, 1024, 2048, 256, 8, 128, [1024]),
               (4, 40, 49, 8, 8, 128, [40, 5, 1, 23])] + \
    [(4, 40, 49, 8, H, D, [40, 5, 1, 23]) for H, D in ((2, 64), (3, 16))] \
    + [(2, 6, 9, 8, 3, 16, [6, 3])]


def _fill_cases(r: dict, qpack, dev, shapes=FILL_SHAPES) -> None:
    """The prefill fill against its plain version, byte for byte in the
    six leaves, at each (B, S, L, W, H, D, lens) of ``shapes``: by default
    the serving path's 1 x 1,024 row and small rows with short prompts
    (ring slots of no real token) and a window wider than the prompt; D
    128/64/16, 4 and 8 bits, bf16 and f32 input."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    for B, S, L, W, H, D, lens in shapes:
        for bits in (4, 8):
            for dtype in (torch.bfloat16, torch.float32):
                kv, leaves, lens_t = fill_inputs(B, S, L, W, H, D, bits,
                                                 dtype, lens, gen, dev)
                out = []
                for fn in (qpack.prefill_fill, qpack.prefill_fill_plain):
                    ls = [t.clone() for t in leaves]
                    fn(kv[0], kv[1], *ls, lens_t, bits)
                    out.append(ls)
                bad = torch.zeros(B, dtype=torch.bool, device=dev)
                for a, b in zip(*out):
                    bad |= ~_bits_equal(a, b)
                    r["err"] = max(r["err"], float(
                        (a.float() - b.float()).abs().max()))
                r["cases"] += 1
                r["mismatches"] += int(bad.sum())
    torch.cuda.synchronize()


# (pos, cold_len of the 3 layers) of the lane flush at W 256, T 2048: a
# steady lane, cold_len above pos - W, a lane shorter than the window, an
# empty ring (cold_len == pos) and pos at the end of the region
FLUSH_LANES = ((1000, (0, 744, 900)), (700, (650, 690, 699)),
               (100, (0, 0, 60)), (500, (500, 500, 500)),
               (2048, (1792, 2000, 0)))


def flush_inputs(Lyr, B, T, W, H, D, bits, gen, dev):
    """The six leaves [Lyr, B, ...] of a batch cache: random codes and
    scales, rings of normal values with a zero slot, a +-0 slot and a slot
    of .5 ties."""
    leaves = []
    for _ in range(2):
        hot = torch.randn((Lyr, B, W, H, D), generator=gen, device=dev) * 0.7
        hot[:, :, 1] = 0.0
        hot[:, :, 2, :, 1::2] = -0.0
        hot[:, :, 3] = torch.randint(-7, 7, (Lyr, B, H, D), generator=gen,
                                     device=dev) + 0.5
        leaves += [torch.randint(0, 256, (Lyr, B, T, H, D * bits // 8),
                                 generator=gen, device=dev,
                                 dtype=torch.uint8),
                   torch.randn((Lyr, B, T, H), generator=gen, device=dev),
                   hot.to(torch.bfloat16)]
    return leaves


def _flush_cases(r: dict, qpack, dev,
                 shapes=((8, 128), (2, 64), (3, 16))) -> None:
    """The lane flush on lane 1's slice of a batch cache against its plain
    version, byte for byte in every leaf of every lane and in the clamped
    cold_len: the lanes of FLUSH_LANES at each (H, D) of ``shapes``, 4 and
    8 bits."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    for H, D in shapes:
        for bits in (4, 8):
            leaves = flush_inputs(3, 3, 2048, 256, H, D, bits, gen, dev)
            for pos, cold in FLUSH_LANES:
                cold_len = torch.zeros((3, 3), dtype=torch.int32, device=dev)
                cold_len[:, 1] = torch.tensor(cold, dtype=torch.int32,
                                              device=dev)
                out = []
                for fn in (qpack.lane_flush, qpack.lane_flush_plain):
                    ls = [t.clone() for t in leaves]
                    new = fn(*(t[:, 1] for t in ls), cold_len[:, 1], pos,
                             bits)
                    out.append((ls, new))
                (ka, kc), (pa, pc) = out
                bad = int(not torch.equal(kc, pc))
                for a, b in zip(ka, pa):
                    bad += int((~_bits_equal(a.transpose(0, 1),
                                             b.transpose(0, 1))).sum())
                    r["err"] = max(r["err"], float(
                        (a.float() - b.float()).abs().max()))
                r["cases"] += 1
                r["mismatches"] += bad
    torch.cuda.synchronize()


def _flash_case(r: dict, FA, q, k, v, causal: bool) -> None:
    """One B6 case against its plain version: elements outside ATTN_TOL
    counted as mismatches, a case outside ATTN_NORM_TOL as a normwise
    failure."""
    a = FA.flash_attention(q, k, v, causal=causal).float()
    b = FA.flash_attention_plain(q, k, v, causal=causal).float()
    d = a - b
    rel = float(d.norm() / b.norm().clamp_min(1e-30))
    r["cases"] += 1
    r["mismatches"] += int((d.abs() > ATTN_TOL[q.dtype] *
                            (1 + b.abs())).sum())
    r["err"] = max(r["err"], float(d.abs().max()))
    r["norm_err"] = max(r.get("norm_err", 0.0), rel)
    r["norm_fails"] = r.get("norm_fails", 0) + int(rel > ATTN_NORM_TOL[
        q.dtype])


def _llama(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("llama3_8b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _prompts(n: int, vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(*PROMPT_LENS, size=n)
    return [rng.integers(1, vocab, size=int(L)).tolist() for L in lens]


class _PhaseTimer:
    """CUDA-event device time around the engine's prefill and decode-step
    functions, and around any extra (module, attribute, kind) hooks (no
    host sync added: events are read after the run)."""

    def __init__(self, engine_mod, hooks=()):
        self.hooks = [(engine_mod, "_prefill_impl", "prefill"),
                      (engine_mod, "_engine_step_impl", "step"), *hooks]
        self.orig = [getattr(m, a) for m, a, _ in self.hooks]
        self.events = {kind: [] for _, _, kind in self.hooks}

    def _wrap(self, fn, kind):
        def timed(*a, **k):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            out = fn(*a, **k)
            e.record()
            self.events[kind].append((s, e))
            return out
        return timed

    def __enter__(self):
        for (m, a, kind), fn in zip(self.hooks, self.orig):
            setattr(m, a, self._wrap(fn, kind))
        return self

    def __exit__(self, *exc):
        for (m, a, _), fn in zip(self.hooks, self.orig):
            setattr(m, a, fn)

    def seconds(self, kind: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[kind]) / 1e3


def _serve(cfg, scfg, params, prompts, new_tokens, dev, hooks=(),
           timed=None):
    """Drive Engine over ``prompts``: (engine, wall s, prefill device s,
    decode-step device s, launches in this run). ``hooks`` are timed too,
    their device seconds put in ``timed`` by kind."""
    from repro_torch.common import contracts
    from repro_torch.serve import Engine
    from repro_torch.serve import engine as engine_mod
    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    rids = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    _reset_launches()
    contracts.SYNCS.reset()
    with _PhaseTimer(engine_mod, hooks) as tm:
        t0 = time.perf_counter()
        eng.run_until_done(max_steps=5000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        t_pre, t_step = tm.seconds("prefill"), tm.seconds("step")
        for _, _, kind in hooks:
            timed[kind] = (tm.seconds(kind), len(tm.events[kind]))
    check(all(eng.requests[r].state == "done" for r in rids),
          "serve: a request did not finish")
    check(eng.counters["step_syncs"] == eng.counters["steps"],
          f"serve: step_syncs {eng.counters['step_syncs']} != steps "
          f"{eng.counters['steps']}")
    check(contracts.SYNCS.count == eng.counters["step_syncs"] +
          eng.counters["admit_syncs"], "serve: an uncounted sync")
    return eng, wall, t_pre, t_step, launches


def phase_serve(dev, tag: str):
    """The serving main path: llama3-8b, all 32 layers, 16 requests."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    cfg = _llama()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    from repro_torch.kernels import flash_attn as FA
    scfg = ServeConfig(**SERVE_CFG)
    prompts = _prompts(SERVE_REQUESTS, cfg.vocab_size, SEED)
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    eng, wall, t_pre, t_step, launches = _serve(
        cfg, scfg, params, prompts, SERVE_NEW_TOKENS, dev,
        hooks=[(FA, "flash_attention", "b6")], timed=timed)
    c = eng.counters
    n_prompt = sum(len(p) for p in prompts)
    print(f"phase 7 serve: {describe(cfg)}, bf16 params from seed {SEED} "
          f"({t_init:.3f} s) | {SERVE_REQUESTS} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{SERVE_NEW_TOKENS} new each, {scfg.max_running} lanes, "
          f"max_len {SERVE_MAX_LEN}, W {scfg.hot_window}, "
          f"{scfg.kv_rate_bits}-bit KV | wall {wall:.3f} s | prefill "
          f"{n_prompt} prompt tokens in {t_pre:.3f} s device = "
          f"{n_prompt / t_pre:.3f} tokens/s | decode {c['tokens']} tokens "
          f"in {c['steps']} steps, {t_step:.3f} s device = "
          f"{c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | KV cache "
          f"{D.cache_bytes(eng.cache) / 2**30:.3f} GiB, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{tag}]",
          flush=True)
    print(f"phase 7 counters: {json.dumps(c)} | step_syncs == steps: "
          f"{c['step_syncs'] == c['steps']}", flush=True)
    t_b6, n_b6 = timed["b6"]
    want_b5 = c["steps"] * cfg.num_layers
    want_b6 = c["prefill_batches"] * cfg.num_layers
    want_flush = c["demotions"] - c["shadow_repreempts"]     # lanes parked
    print(f"phase 7 launches: {json.dumps(launches)} | expected the ring "
          f"step and B5 one a layer a step = {want_b5}, the prefill fill "
          f"and B6 one a layer a prefill batch = {want_b6}, the lane flush "
          f"one a lane demotion = {want_flush}, B3's own encode 0",
          flush=True)
    print(f"phase 7 B6 in prefill: {n_b6} calls, {t_b6:.6f} s device "
          f"(CUDA events around each call) = {t_b6 / t_pre:.4f} of the "
          f"{t_pre:.3f} s of prefill [{tag}]", flush=True)
    check(c["demotions"] > 0 and c["promotions"] > 0,
          "phase 7: no demotion or promotion")
    for k in ("qpack_ring_step", "qpack_prefill_fill", "qpack_lane_flush",
              "kvc_decode_attention", "flash_attention",
              "flash_attention_tc"):
        check(launches[k] > 0, f"phase 7: {k} was not launched")
    check(launches["qpack_ring_step"] == want_b5 and
          launches["qpack_prefill_fill"] == want_b6 and
          launches["qpack_lane_flush"] == want_flush and
          launches["qpack_fixed_encode"] == 0,
          f"phase 7: the ring step launched {launches['qpack_ring_step']} "
          f"times (expected {want_b5}), the prefill fill "
          f"{launches['qpack_prefill_fill']} ({want_b6}), the lane flush "
          f"{launches['qpack_lane_flush']} ({want_flush}), B3 "
          f"{launches['qpack_fixed_encode']} (0)")
    check(launches["kvc_decode_attention"] == want_b5 and
          launches["flash_attention"] == want_b6 == n_b6,
          f"phase 7: B5 launched {launches['kvc_decode_attention']} times "
          f"(expected {want_b5}), B6 {launches['flash_attention']} "
          f"(expected {want_b6})")
    check(launches["flash_attention_tc"] == launches["flash_attention"],
          "phase 7: a bf16 prefill missed the tensor-core route")
    # lengths of the compressed prefix the decode attention saw last
    # (layer 0), for the timing phase's shapes
    return params, launches, {"t_pre": t_pre, "t_step": t_step,
                              "wall": wall, "counters": c}


def _busy_us(events) -> float:
    """Microseconds in the union of the device events' intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _profile_steps(eng, n: int):
    """(device events, host wall s) of ``n`` engine steps under
    torch.profiler, recording the card's activity only: the same device
    events as with the CPU's operators recorded too, without their cost in
    the steps' wall and in the trace's processing (PERF.md §6). One more
    engine step runs first in the profiler's warm-up, its events
    discarded: a trace started on the steps themselves can lose the
    records of its first launches while the tracer comes up. A CPU
    rehearsal records the CPU and finds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    act = ProfilerActivity.CUDA if torch.cuda.is_available() else \
        ProfilerActivity.CPU
    with profile(activities=[act],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        eng.step()
        torch.cuda.synchronize()
        prof.step()                     # the recorded window starts here
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the window's own step annotation is not device work
    return ([e for e in prof.events() if e.device_type == DeviceType.CUDA
             and not e.name.startswith("ProfilerStep")], wall)


def _complete_trace(eng, label: str, tag: str, name: str, want: int):
    """(device events, host wall s, the events of kernels named ``name``,
    traces taken): ``_profile_steps`` over PROFILE_STEPS steps, taken again
    (PROFILE_TRIES traces at most) while the trace holds fewer than the
    ``want`` launches of ``name`` that ran. A trace with no device event (a
    CPU rehearsal) is returned as it is."""
    for attempt in range(1, PROFILE_TRIES + 1):
        kern, wall = _profile_steps(eng, PROFILE_STEPS)
        hits = [e for e in kern if name in e.name]
        if len(hits) == want or not kern:
            break
        print(f"phase {label} profile: trace {attempt} of {PROFILE_TRIES} "
              f"holds {len(hits)} of the {want} {name} launches that ran "
              f"(a lost record); taken again [{tag}]", flush=True)
    return kern, wall, hits, attempt


def _profile_line(eng, label: str, tag: str, b5_per_step: int = 0):
    """torch.profiler over PROFILE_STEPS steps of a warm engine: the
    device busy share, events a step and the top kernels by device time
    (with B5's launches and device time a step where it runs). Returns the
    busy share, or None where the profiler saw no device event."""
    from repro_torch.kernels import kvc_attn as KA
    want_b5 = PROFILE_STEPS * b5_per_step
    t0 = time.perf_counter()
    n0 = KA.launches
    kern, pwall, b5, attempt = _complete_trace(eng, label, tag,
                                               "kvc_split_kernel", want_b5)
    check(KA.launches - n0 == attempt * (want_b5 + b5_per_step),
          f"phase {label}: the warm-up and profiled steps of {attempt} "
          f"trace(s) launched B5 {KA.launches - n0} times, not "
          f"{attempt * (want_b5 + b5_per_step)}")
    t_prof = time.perf_counter() - t0
    if not kern:
        print(f"phase {label} profile: torch.profiler recorded no device "
              f"events; device busy share not measured [{tag}]", flush=True)
        return None
    busy = _busy_us(kern) / (pwall * 1e6)
    b5_us = sum(e.time_range.elapsed_us() for e in b5)
    by_name: dict = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    print(f"phase {label} profile: {PROFILE_STEPS} decode steps, "
          f"{eng.lanes} lanes, {1e3 * pwall / PROFILE_STEPS:.3f} ms per step "
          f"(host wall, profiler on) | device busy "
          f"{_busy_us(kern) / 1e3:.3f} ms = {busy:.4f} of the wall | "
          f"{len(kern)} device events, {len(kern) / PROFILE_STEPS:.1f} per "
          f"step | B5 {len(b5)} launches, "
          f"{b5_us / 1e3 / PROFILE_STEPS:.6f} ms a step | top by device "
          f"time: " + "; ".join(f"{n[:60]} x{k} {us / 1e3:.3f} ms"
                                for n, (k, us) in top) + f" | the profiled "
          f"steps and the trace's processing {t_prof:.3f} s, trace "
          f"{attempt} [{tag}]",
          flush=True)
    check(len(b5) == want_b5, f"phase {label}: the profile found "
          f"{len(b5)} B5 launches, not {want_b5}, in each of {attempt} "
          f"traces")
    return busy


def phase_serve_profile(params, dev, tag: str) -> None:
    """Where a decode step's time goes: torch.profiler over PROFILE_STEPS
    steps of 8 running lanes (no admission, no preemption), the main
    cell's engine and model. Device busy share = the union of the device
    events over the host wall time of the steps. Then the same engine's
    decode steps with the ring step and with the composition it replaced
    (the eager eviction chain around B3's kernel), in turns; and the
    device events of one prefill batch and one lane demotion with the
    prefill fill and the lane flush and with the compositions they
    replaced."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.kernels import qpack
    from repro_torch.serve import Engine
    cfg = _llama()
    eng = Engine(cfg, ServeConfig(**SERVE_CFG), params,
                 max_len=SERVE_MAX_LEN)
    for p in _prompts(SERVE_CFG["max_running"], cfg.vocab_size, SEED + 4):
        eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
    for _ in range(3):                  # admission, prefill, warm steps
        eng.step()
    kern, wall = _profile_steps(eng, PROFILE_STEPS)
    if not kern:
        print(f"phase 7 profile: torch.profiler recorded no device events; "
              f"device busy share not measured [{tag}]", flush=True)
    else:
        busy = _busy_us(kern)
        b5 = [e for e in kern if "kvc_split_kernel" in e.name]
        b5_us = sum(e.time_range.elapsed_us() for e in b5)
        print(f"phase 7 profile B5: {len(b5)} launches, {b5_us / 1e3:.6f} "
              f"ms device, {b5_us / 1e3 / PROFILE_STEPS:.6f} ms a decode "
              f"step, {b5_us / max(len(b5), 1):.3f} us a launch [{tag}]",
              flush=True)
        by_name: dict = {}
        for e in kern:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        print(f"phase 7 profile: {PROFILE_STEPS} decode steps, 8 lanes, "
              f"{1e3 * wall / PROFILE_STEPS:.3f} ms per step (host wall, "
              f"profiler on) | device busy {busy / 1e3:.3f} ms = "
              f"{busy / (wall * 1e6):.4f} of the wall | {len(kern)} device "
              f"events, {len(kern) / PROFILE_STEPS:.1f} per step | top by "
              f"device time: " + "; ".join(
                  f"{n[:60]} x{c} {us / 1e3:.3f} ms" for n, (c, us) in top)
              + f" [{tag}]", flush=True)

    ring_step = qpack.ring_step

    def composition(*a):
        return qpack.ring_step_plain(*a, quantize=qpack.encode)

    ms = {"ring step": [], "composition": []}
    events = {}
    try:
        for name in ("ring step", "composition", "composition", "ring step"):
            qpack.ring_step = ring_step if name == "ring step" else \
                composition
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(RING_AB_STEPS):
                eng.step()
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0) / RING_AB_STEPS)
            if name not in events:
                ev, _ = _profile_steps(eng, 1)
                events[name] = {"all": len(ev), **{
                    k: sum(k in e.name for e in ev)
                    for k in ("ring_step_kernel", "encode_kernel")}}
    finally:
        qpack.ring_step = ring_step
    print(f"phase 7 ring step vs the composition it replaced, the same "
          f"engine, {RING_AB_STEPS} decode steps a turn in turns ring step, "
          f"composition, composition, ring step: ms a step (host wall) "
          f"{json.dumps(ms)} | device events a step (torch.profiler, one "
          f"step) {json.dumps(events)} [{tag}]", flush=True)

    # one prefill batch (a 1,000-token prompt, the 1,024 bucket) and one
    # lane demotion (lane 0 of this engine), each with its step and with
    # the composition it replaced: host wall ms a call in turns, and the
    # device events of a call
    from repro_torch.serve import engine as engine_mod
    prompt = _prompts(1, cfg.vocab_size, SEED + 5)[0]
    prompt = (prompt * 4)[:1000]
    tokens = torch.zeros((1, 1024), dtype=torch.int32, device=dev)
    tokens[0, :len(prompt)] = torch.tensor(prompt, dtype=torch.int32)
    lens = torch.tensor([len(prompt)], dtype=torch.int32, device=dev)
    pos = int(eng.state["pos"][0])
    steps = {
        "prefill batch": (
            lambda: engine_mod._prefill_impl(
                params, {"tokens": tokens}, lens, cfg=cfg, scfg=eng.scfg,
                max_len=SERVE_MAX_LEN),
            "prefill_fill", ("qpack_prefill_fill", "qpack_fixed_encode"), 3),
        "lane demotion": (
            lambda: engine_mod._demote_lane_impl(
                engine_mod._lane_slice(eng.cache, 0), pos, scfg=eng.scfg),
            "lane_flush", ("qpack_lane_flush", "qpack_fixed_encode"), 20),
    }
    demote = engine_mod._demote_lane_impl
    for what, (fn, attr, names, reps) in steps.items():
        step_fn = getattr(qpack, attr)
        ev, ms = {}, {"step": [], "composition": []}
        try:
            for name in ("step", "composition", "composition", "step"):
                if attr == "lane_flush":
                    engine_mod._demote_lane_impl = demote if name == "step" \
                        else lane_demotion_composition(qpack)
                else:
                    qpack.prefill_fill = step_fn if name == "step" else \
                        fill_composition(qpack)
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                ms[name].append(1e3 * (time.perf_counter() - t0) / reps)
                if name not in ev:
                    got = device_events(fn, calls=2)
                    ev[name] = {"all": sum(got.values()),
                                **{k: got.get(k, 0) for k in names}}
        finally:
            setattr(qpack, attr, step_fn)
            engine_mod._demote_lane_impl = demote
        print(f"phase 7 one {what}, the {attr.replace('_', ' ')} vs the "
              f"composition it replaced, in turns step, composition, "
              f"composition, step: ms a call (host wall, {reps} calls a "
              f"turn) {json.dumps(ms)} | device events a call (two calls; "
              f"torch.profiler, the port's kernels by their launch "
              f"counters) {json.dumps(ev)} [{tag}]", flush=True)


def fill_composition(qpack):
    """The prefill's cache writes before the prefill fill: the ring's
    sources computed once a prefill, then for K and V of each layer B3's
    encode kernel, the codes and scales copies, the ring's gather and its
    copy."""
    memo = {}

    def fill(k, v, kc, ks, kh, vc, vs, vh, lens, bits):
        if memo.get("lens") is not lens:
            memo["lens"] = lens
            memo["where"] = (
                torch.arange(k.shape[0], device=k.device)[:, None],
                qpack.ring_sources(lens, k.shape[1], kh.shape[1]))
        for t, c, s_, h in ((k, kc, ks, kh), (v, vc, vs, vh)):
            qpack.fill_plain(t, c, s_, h, memo["where"], bits,
                             quantize=qpack.encode)
    return fill


def lane_demotion_composition(qpack):
    """serve/engine.py::_demote_lane_impl before the lane flush: the
    reference's _ring_to_codes for K and V with B3's encode kernel (new
    tensors), then cold_len's clamp."""
    def demote(lane_cache, pos, *, scfg):
        out = dict(lane_cache)
        for kind in "kv":
            out[f"{kind}_codes"], out[f"{kind}_scales"] = \
                qpack.ring_to_codes_plain(
                    out[f"{kind}_codes"], out[f"{kind}_scales"],
                    out[f"{kind}_hot"], out["cold_len"], pos,
                    scfg.kv_rate_bits, quantize=qpack.encode)
        out["cold_len"] = torch.clamp(out["cold_len"], min=pos)
        return out
    return demote


def phase_paper(params, dev, tag: str) -> dict:
    from repro_torch.common.types import ServeConfig
    cfg = _llama()
    scfg = ServeConfig(**SERVE_CFG, fused_dequant_attention=False)
    prompts = _prompts(PAPER_REQUESTS, cfg.vocab_size, SEED + 1)
    eng, wall, t_pre, t_step, launches = _serve(cfg, scfg, params, prompts,
                                                PAPER_NEW_TOKENS, dev)
    c = eng.counters
    print(f"phase 8 paper mode: {PAPER_REQUESTS} requests, "
          f"{PAPER_NEW_TOKENS} new each | decode {c['tokens']} tokens in "
          f"{c['steps']} steps, {1e3 * t_step / c['steps']:.3f} ms per step "
          f"| launches {json.dumps(launches)} [{tag}]", flush=True)
    check(launches["qpack_fixed_decode"] > 0,
          "phase 8: the fixed-rate decode kernel was not launched")
    return launches


def _whole_run(cfg, params, tokens, lens, impl: str, feed=None,
               paper: bool = False):
    """Prefill, then WHOLE_STEPS decode steps fed ``feed`` (or, when None,
    this run's own greedy tokens); ``paper`` reads the compressed prefix
    promote-then-read. Returns (logits per call, the tokens fed, launches
    in this run)."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.models import decode as D
    scfg = ServeConfig(**SERVE_CFG, **WHOLE_IMPLS[impl],
                       fused_dequant_attention=not paper)
    _reset_launches()
    lg, cache = D.prefill(params, {"tokens": tokens}, cfg, scfg,
                          SERVE_MAX_LEN, lens=lens)
    out = [lg.float()]
    toks = [lg.argmax(-1).to(torch.int32)] if feed is None else feed
    pos = lens.clone()
    for t in range(WHOLE_STEPS):
        lg, _ = D.decode_step(params, cache, toks[t], pos, cfg, scfg)
        out.append(lg.float())
        if feed is None:
            toks.append(lg.argmax(-1).to(torch.int32))
        pos = pos + 1
    return out, toks, _launch_counts()


class _RouteRecorder:
    """Records the expert choices (top_i) of every ``models/moe.route``
    call while it is entered; ``decode`` keeps only the calls of a decode
    step of ``lanes`` lanes (one token a lane, the sorted form)."""

    def __init__(self, lanes=None):
        from repro_torch.models import moe as MOE
        self.mod, self.lanes, self.choices = MOE, lanes, []

    def __enter__(self):
        self.orig = self.mod.route

        def route(router, x, k):
            out = self.orig(router, x, k)
            if self.lanes is None or (x.dim() == 2 and
                                      x.shape[0] == self.lanes):
                self.choices.append(out[2])
            return out
        self.mod.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig

    def differ(self, other) -> int:
        """Choices that differ between two runs of the same calls."""
        check(len(self.choices) == len(other.choices),
              "route calls differ in number between two runs")
        return sum(int((a != b).sum())
                   for a, b in zip(self.choices, other.choices))

    def total(self) -> int:
        return sum(int(a.numel()) for a in self.choices)


def phase_serve_whole(dev, model=None, label: str = "9",
                      layers: int = 2) -> dict:
    """``layers`` layers at the widths of ``model`` (``_llama`` by default;
    phase 13c passes ``_minicpm``, 14c ``_qwen3moe`` and ``_arctic``),
    kernels against plain versions, in bf16 (the main path's type) and in
    float32 (where the argmax has margin): logits of a prefill and
    WHOLE_STEPS decode steps, both runs fed the plain run's greedy tokens,
    then the same prompts served through Engine both ways. For the MoE
    family the expert choices of the two runs are counted where they
    differ; in bf16 a differing choice may move a row's logits past the
    tolerance (the layer is discontinuous in its input there), so the
    logits are held to it only where no choice differs; in float32
    always."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    model = model or _llama
    res = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(model(layers=layers), dtype=dtype)
        # the other attention kind's steps stay at 0
        other = GQA_STEPS if cfg.attn_kind == "mla" else MLA_STEPS
        tol = ATTN_TOL[L.DTYPES[dtype]]
        params = T.init_params(cfg, seed=SEED + 2, device=dev)
        prompts = _prompts(4, cfg.vocab_size, SEED + 2)
        S = 1 << (max(map(len, prompts)) - 1).bit_length()   # the bucket
        tokens = torch.zeros((4, S), dtype=torch.int32, device=dev)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                            device=dev)
        with _RouteRecorder() as rp:
            want, feed, pl = _whole_run(cfg, params, tokens, lens, "plain")
        with _RouteRecorder() as rk:
            got, _, kl = _whole_run(cfg, params, tokens, lens, "kernel", feed)
        groups = dict(KA.group_launches)
        moe = cfg.family == "moe"
        route_diff = rk.differ(rp)
        strict = dtype == "float32" or route_diff == 0
        err, bad, agree = 0.0, 0, 0
        for a, b in zip(got, want):
            # normwise per row: the logits come from a hidden state of unit
            # RMS through one product, so their error scales with the
            # row's magnitude, not with each logit's own
            bound = tol * b.abs().amax(dim=-1)
            err = max(err, float((a - b).abs().max()))
            bad += int(((a - b).abs().amax(dim=-1) > bound).sum())
            # the argmax may differ only where the plain run's top-2
            # margin is within the two runs' joint error bound
            top2 = b.topk(2, dim=-1).values
            close = top2[:, 0] - top2[:, 1] <= 2 * bound
            same = a.argmax(-1) == b.argmax(-1)
            agree += int(same.sum())
            check(not strict or bool((same | close).all()),
                  f"phase {label} {dtype}: an argmax differs at a top-2 "
                  "margin above the tolerance")
        served = {}
        for name, kw in WHOLE_IMPLS.items():
            scfg = ServeConfig(**dict(SERVE_CFG, max_running=2), **kw)
            eng, _, _, _, launches = _serve(cfg, scfg, params, prompts, 8,
                                            dev)
            served[name] = ([eng.result(r) for r in range(len(prompts))],
                            launches)
            if name == "kernel":
                for g, n_ in KA.group_launches.items():
                    groups[g] = groups.get(g, 0) + n_
            del eng                     # it holds params: free them below
        same_gen = sum(x == y for x, y in zip(served["kernel"][0],
                                              served["plain"][0]))
        n = len(got) * got[0].shape[0]
        routing = (f" | expert choices differing kernels vs plain: "
                   f"{route_diff} of {rk.total()}" if moe else "")
        print(f"phase {label} whole path {dtype}, {cfg.name} {layers} "
              f"layers at full width, kernels "
              f"vs plain: prefill + {WHOLE_STEPS} decode steps x 4 rows, "
              f"logits max abs err {err:.6f}, {bad}/{n} rows outside tol "
              f"{tol} * max|plain row| | argmax {agree}/{n} agree, "
              f"{n - agree} differ "
              f"at a top-2 margin within the bound | Engine (4 requests, 2 "
              f"lanes, 8 new): {same_gen}/4 generations identical | "
              f"launches kernel run {json.dumps(kl)}, Engine "
              f"{json.dumps(served['kernel'][1])}; plain runs "
              f"{json.dumps(pl)}, {json.dumps(served['plain'][1])}"
              f"{routing}", flush=True)
        check(not strict or bad == 0, f"phase {label} {dtype}: {bad} rows "
              "of logits outside tolerance")
        if dtype == "float32":
            check(same_gen == 4, f"phase {label} float32: Engine generations "
                  "differ between the kernels and the plain versions")
        for run, counts in (("prefill and decode", kl),
                            ("Engine", served["kernel"][1])):
            for k, v in counts.items():
                # float32 prefill and latent decode take the CUDA-core
                # routes, bf16 the tensor cores; B3 and B4 themselves are
                # off the path, and only the Engine demotes lanes
                idle = k in ("qpack_fixed_encode", "qpack_fixed_decode") or \
                    k in other or \
                    (k in ("flash_attention_tc", "kvc_latent_partial_tc") and
                     dtype == "float32") or \
                    (k in ("qpack_lane_flush", "qpack_latent_lane_flush") and
                     run != "Engine")
                check((v == 0) if idle else (v > 0),
                      f"phase {label} {dtype}: {k} launched {v} times in the "
                      f"kernel run's {run}")
        check(not any(pl.values()) and not any(served["plain"][1].values()),
              f"phase {label} {dtype}: a plain run launched a kernel")
        res[dtype] = {"err": err, "argmax_differ": n - agree,
                      "route_diff": route_diff, "b5_groups": groups}
        if dtype == "bfloat16" and (cfg.attn_kind == "mla" or moe):
            res["paper"] = _whole_paper(cfg, params, tokens, lens, got, feed,
                                        tol, label, rk)
        del params
        torch.cuda.empty_cache()
    return res


def _sdpa(q, k, v, causal, mask=None):
    """One PyTorch call (the yardstick, never called by the port)."""
    F = torch.nn.functional
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=mask, is_causal=causal, enable_gqa=True)


def phase_serve_times(dev, tag: str) -> dict:
    """B3-B6 at the serving path's shapes (llama3-8b, 8 lanes)."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    cfg = _llama()
    B, Hq, Hkv, D = SERVE_CFG["max_running"], cfg.num_heads, \
        cfg.num_kv_heads, cfg.resolved_head_dim
    bits, W, S = SERVE_CFG["kv_rate_bits"], SERVE_CFG["hot_window"], \
        SERVE_MAX_LEN
    Dp = D * bits // 8
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    out = {}

    # B3's own encode (the TPU kernel's contract; off the path since the
    # prefill fill and the lane flush) at the shape it had there: a 1-row
    # prefill batch of the 1,024 bucket, K or V of one layer (bf16)
    kv1 = torch.randn((1, 1024, Hkv, D), generator=gen, device=dev) \
        .to(torch.bfloat16)
    nblk = 1024 * Hkv
    out["qpack_fixed_encode"] = dict(
        shape=f"1x1024x{Hkv}x{D} bf16 (prefill, one row)",
        kern=lambda: qpack.encode(kv1, bits, D),
        plain=lambda: qpack.encode_plain(kv1, bits, D), lib=None,
        nbytes=nblk * (D * 2 + Dp + 4), ops=0, reps=200)
    # the ring step of one layer, 8 lanes in steady state (every lane
    # evicts: cold_len = pos - W), beside the composition it replaced
    rng_pos = np.random.default_rng(SEED).integers(*PROMPT_LENS, size=B) \
        + SERVE_NEW_TOKENS // 2
    ring = ring_inputs(B, Hkv, D, bits, torch.bfloat16, torch.bfloat16, gen,
                       dev, W=W, S=S)[:4]
    pos = torch.tensor(rng_pos, dtype=torch.int32, device=dev)
    cold = pos - W
    ring_args = [ring[0][0], ring[1][0], ring[2][0], ring[0][1], ring[1][1],
                 ring[2][1], ring[3][0], ring[3][1], pos, cold, bits]
    out["qpack_ring_step"] = dict(
        shape=f"{B} lanes x {Hkv} KV heads x {D}, bf16 ring of {W}, "
              f"{bits}-bit codes of {S}, every lane evicting",
        kern=lambda: qpack.ring_step(*ring_args),
        plain=lambda: qpack.ring_step_plain(*ring_args), lib=None,
        composition=lambda: qpack.ring_step_plain(*ring_args,
                                                  quantize=qpack.encode),
        nbytes=2 * B * Hkv * (6 * D + Dp + 4) + 8 * B, ops=0, reps=200)
    # the prefill fill of one layer of a 1-row batch of the 1,024 bucket
    # (a 1,000-token prompt), K and V, beside the composition it replaced
    # (the ring's sources made beforehand, once a prefill as then)
    kvf, leaves, lens1 = fill_inputs(1, 1024, S, W, Hkv, D, bits,
                                     torch.bfloat16, [1000], gen, dev)
    where = (torch.zeros((1, 1), dtype=torch.int64, device=dev),
             qpack.ring_sources(lens1, 1024, W))
    out["qpack_prefill_fill"] = dict(
        shape=f"1x1024x{Hkv}x{D} K and V bf16 -> {bits}-bit codes of {S} "
              f"and a ring of {W} (a prefill layer)",
        kern=lambda: qpack.prefill_fill(kvf[0], kvf[1], *leaves, lens1, bits),
        plain=lambda: qpack.prefill_fill_plain(kvf[0], kvf[1], *leaves,
                                               lens1, bits), lib=None,
        composition=lambda: [qpack.fill_plain(
            t, *leaves[3 * j:3 * j + 3], where, bits, quantize=qpack.encode)
            for j, t in enumerate(kvf)],
        nbytes=2 * (1024 * Hkv * (2 * D + Dp + 4) + W * Hkv * 2 * D) + 4,
        ops=0, reps=200)
    # the lane flush of lane 1 of an 8-lane cache of 32 layers, a live ring
    # of W tokens in every layer, beside the composition it replaced
    from repro_torch.common.types import ServeConfig
    lyr, posf = cfg.num_layers, 1000
    flush_leaves = flush_inputs(lyr, B, S, W, Hkv, D, bits, gen, dev)
    lane = [t[:, 1] for t in flush_leaves]
    cold_f = torch.full((lyr, B), posf - W, dtype=torch.int32, device=dev)
    names = ("k_codes", "k_scales", "k_hot", "v_codes", "v_scales", "v_hot")
    lane_cache = dict(zip(names, lane), cold_len=cold_f[:, 1])
    old_demote = lane_demotion_composition(qpack)
    scfg = ServeConfig(**SERVE_CFG)
    out["qpack_lane_flush"] = dict(
        shape=f"lane 1 of {B}: {lyr} layers, a live ring of {W} x {Hkv} x "
              f"{D} bf16 -> {bits}-bit codes of {S}",
        kern=lambda: qpack.lane_flush(*lane, cold_f[:, 1], posf, bits),
        plain=lambda: qpack.lane_flush_plain(*lane, cold_f[:, 1], posf,
                                             bits), lib=None,
        composition=lambda: old_demote(lane_cache, posf, scfg=scfg),
        nbytes=lyr * (W * Hkv * 2 * (2 * D + Dp + 4) + 8), ops=0, reps=50)
    # B4 at the paper path's shape: the whole compressed region of 8 lanes
    kc, ks = qpack.encode(torch.randn((B, S, Hkv, D), generator=gen,
                                      device=dev), bits, D)
    out["qpack_fixed_decode"] = dict(
        shape=f"{B}x{S}x{Hkv}x{D} -> bf16 (paper-mode prefix)",
        kern=lambda: qpack.decode(kc, ks, bits, D, torch.bfloat16),
        plain=lambda: qpack.decode_plain(kc, ks, bits, D, torch.bfloat16),
        lib=None, nbytes=B * S * Hkv * (Dp + 4 + 2 * D), ops=0, reps=20)
    # B5: the decode step's compressed-prefix read, lengths of this run
    lens_l = np.random.default_rng(SEED).integers(*PROMPT_LENS, size=B) \
        + SERVE_NEW_TOKENS // 2 - W
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    vc, vs = qpack.encode(torch.randn((B, S, Hkv, D), generator=gen,
                                      device=dev), bits, D)
    ks1, vs1 = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    kdq = qpack.decode(kc, ks, bits, D, torch.bfloat16)
    vdq = qpack.decode(vc, vs, bits, D, torch.bfloat16)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    tok = int(lens.sum())
    out["kvc_decode_attention"] = dict(
        shape=f"q {B}x{Hq}x{D} bf16, {bits}-bit KV {B}x{S}x{Hkv}, lengths "
              f"{lens_l.tolist()}",
        kern=lambda: KA.kvc_decode_partial(q, kc, ks1, vc, vs1, lens,
                                           bits=bits),
        plain=lambda: KA.kvc_decode_partial_plain(q, kc, ks1, vc, vs1, lens,
                                                  bits, 1.0 / D ** 0.5),
        lib=lambda: _sdpa(q[:, None], kdq, vdq, False, mask),
        nbytes=tok * Hkv * 2 * (Dp + 4) + B * Hq * D * 2 + B * 4
        + B * Hq * (D + 2) * 4,
        ops=4 * tok * Hq * D, reps=50)
    # B6: the prefill's attention at the 1024 bucket, 8 rows, causal; then
    # the path's own batches (4 rows and 1 row of the 1024 bucket)
    Sp = 1024
    qf, kf, vf = (torch.randn((B, Sp, h, D), generator=gen, device=dev)
                  .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    for rows in (B, 4, 1):
        q_, k_, v_ = qf[:rows], kf[:rows], vf[:rows]
        out["flash_attention" + ("" if rows == B else f"_{rows}x{Sp}")] = dict(
            shape=f"q {rows}x{Sp}x{Hq}x{D}, kv {rows}x{Sp}x{Hkv}x{D} bf16 "
                  f"causal",
            kern=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention(
                q_, k_, v_, causal=True),
            plain=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention_plain(
                q_, k_, v_, causal=True),
            lib=lambda q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, True),
            nbytes=2 * rows * Sp * D * (2 * Hq + 2 * Hkv),
            ops=4 * rows * Hq * D * Sp * (Sp + 1) // 2, reps=5)
    res = _time_rows(out, "10", tag)

    # B5: CTAs that do work at these lengths (one per chunk of a lane's
    # length, per KV head) against the card's SMs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    working = Hkv * sum(len(KA.chunk_plan(int(n))) for n in lens_l)
    grid = B * Hkv * len(KA.chunk_plan(S))
    print(f"phase 10 kvc_decode_attention split: chunk {KA.CHUNK}, grid "
          f"{grid} CTAs of which {working} do work, {sms} SMs [{tag}]",
          flush=True)
    check(working > sms, f"phase 10: only {working} B5 CTAs do work on "
          f"{sms} SMs")
    return res


def _time_rows(out: dict, label: str, tag: str) -> dict:
    """Each row of ``out``: kernel ms (CUDA graph replay), eager ms, plain
    ms, library ms, bound ms, and for a step the composition it replaced;
    one line a row."""
    res = {}
    for name, t in out.items():
        dtype = t.get("ops_dtype", "bfloat16")
        r = {"shape": t["shape"], "ms": time_graph(t["kern"], t["reps"]),
             "eager_ms": time_eager(t["kern"], t["reps"]),
             "plain_ms": time_eager(t["plain"], max(t["reps"] // 10, 2)),
             "library_ms": (time_eager(t["lib"], t["reps"])
                            if t["lib"] else None),
             **_bound(t["nbytes"], t["ops"], dtype)}
        comp_txt = ""
        if "composition" in t:
            r["composition_ms"] = time_eager(t["composition"], 50)
            r["composition_graph_ms"] = time_graph(t["composition"], 50)
            r["event_names"] = device_events(t["kern"])
            r["events"] = sum(r["event_names"].values())
            r["composition_events"] = sum(
                device_events(t["composition"]).values())
            comp_txt = (f" | {r['events']:.2f} device events a call "
                        f"{r['event_names']}; the composition "
                        f"it replaced {r['composition_ms']:.6f} ms eager, "
                        f"{r['composition_graph_ms']:.6f} ms graph replay, "
                        f"{r['composition_events']:.2f} device events")
        res[name] = r
        lib = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.6f} ms"
        print(f"phase {label} {name} [{r['shape']}]: kernel {r['ms']:.6f} ms "
              f"(graph replay), {r['eager_ms']:.6f} ms eager | plain "
              f"{r['plain_ms']:.6f} ms | library {lib} | bound "
              f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({t['nbytes']} B "
              f"at 3.35 TB/s, {t['ops']} flop at "
              f"{_peak(dtype) / 1e12:g} TF/s)"
              f"{comp_txt} "
              f"[{tag}]", flush=True)
    return res


# ---------------------------------------------------------------------------
# The paper's evaluation path (simx): payload-less pools, no kernel.
# ---------------------------------------------------------------------------

# the JAX package's numbers for every cell phase 11 runs, written on the
# CPU by tests/test_torch_simx_reference.py
SIMX_REFERENCE = ROOT / "src" / "repro_torch" / "simx" / "reference_cells.json"
# fig09's full-size grid on the card: two of the four workloads whose pools
# break I1-I4 (C5), 12 of its 60 cells, for the script's time (mcf's six
# went for phase 18's, cc's and xsbench's for phase 20's); its
# geomean-speedup rows need all ten workloads and are held on the CPU only
FIG09_CARD_WL = ("pr", "bfs")


def _zero_port_launches() -> None:
    from repro_torch.kernels import qpack
    _reset_launches()
    for k in ("encode", "decode", "demote", "promote"):
        setattr(qpack, f"fused_{k}_launches", 0)


def _fig09_cut(cache) -> list:
    """fig09's per-cell rows at the paper's full size over FIG09_CARD_WL
    (``paper_figs.fig09_speedup``'s rows, without the geomean rows)."""
    from repro_torch.launch import paper_figs as PF
    from repro_torch.simx.trace import WORKLOADS
    rows = []
    for s in PF.FIG09_SCHEMES:
        for wl in [w for w in PF.FULL_WL if w in FIG09_CARD_WL]:
            r = cache(s, WORKLOADS[wl], n_accesses=PF.N_F,
                      promoted_pages=PF.PROM_F)
            rows.append({"name": f"fig09.{s}.{wl}",
                         "derived": f"norm_perf={r['normalized_perf']:.3f}"})
    return rows


def phase_simx(dev, tag: str) -> dict:
    """fig09 at the paper's full size (6 schemes x FIG09_CARD_WL's 2
    workloads, 12,000 accesses over 96 promoted pages) and the other nine
    figures in quick mode, each distinct cell computed once on the card
    (``CellCache``), after one timed full-size cell. Every cell's metrics
    must equal the reference file's (``==``, floats included), every
    figure row too (fig09's per-cell rows of the workloads run), the set
    of cells whose pool breaks I1-I4 (C5) must be the reference's over the
    cells run, with the same first message, the reference's cells not run
    must be exactly fig09's other workloads, and no kernel may launch."""
    from repro_torch.common import contracts
    from repro_torch.launch import paper_figs as PF
    from repro_torch.simx.trace import WORKLOADS
    ref = json.loads(SIMX_REFERENCE.read_text())
    want = {c["key"]: c for c in ref["cells"]}
    skipped = {PF.cell_key(s, WORKLOADS[wl], PF.N_F, PF.PROM_F)
               for s in PF.FIG09_SCHEMES for wl in PF.FULL_WL
               if wl not in FIG09_CARD_WL}
    _zero_port_launches()
    contracts.SYNCS.reset()
    t0 = time.perf_counter()
    cache = PF.CellCache(dev)
    cache("ibex", WORKLOADS["pr"], n_accesses=PF.N_F,
          promoted_pages=PF.PROM_F)
    first = next(iter(cache.cells.values()))
    rate = first["accesses"] / first["seconds"]
    to_run = [c for c in ref["cells"] if c["key"] not in skipped]
    total = sum(c["n_accesses"] + (0 if c["scheme"] == "compresso" else
                                   4 * c["promoted_pages"])
                for c in to_run)
    print(f"phase 11 first cell: ibex x pr at full size, "
          f"{first['accesses']} accesses in {first['seconds']:.3f} s = "
          f"{rate:.3f} accesses/s; the {len(to_run)} cells' "
          f"{total} accesses predicted at {total / rate:.1f} s (fig09 at "
          f"full size over {', '.join(FIG09_CARD_WL)}: {len(skipped)} of "
          f"the file's {len(ref['cells'])} cells not run) [{tag}]",
          flush=True)
    rows, fig_s = {}, {}
    for fig in PF.ALL_FIGS:
        t = time.perf_counter()
        rows[fig.__name__] = (_fig09_cut(cache)
                              if fig is PF.fig09_speedup else fig(True, cache))
        fig_s[fig.__name__] = round(time.perf_counter() - t, 3)
    wall = time.perf_counter() - t0
    launches = _port_launch_counts()

    cells = cache.cells
    extra = sorted(set(cells) - set(want))
    missing = sorted(set(want) - set(cells))
    differ = {k: [f for f in want[k]["metrics"]
                  if c["metrics"].get(f) != want[k]["metrics"][f]]
              for k, c in cells.items() if k in want and
              c["metrics"] != want[k]["metrics"]}
    names = {x["name"] for x in rows["fig09_speedup"]}
    want_rows = dict(ref["rows"], fig09_speedup=[
        r for r in ref["rows"]["fig09_speedup"] if r[0] in names])
    bad_rows = {n: [r for r, w in zip(
        [[x["name"], x["derived"]] for x in got], want_rows[n]) if r != w]
        for n, got in rows.items()
        if [[x["name"], x["derived"]] for x in got] != want_rows[n]}
    card_c5 = {k: c["invariants"] for k, c in cells.items() if c["invariants"]}
    ref_c5 = {k: want[k]["invariants"] for k in cells
              if k in want and want[k]["invariants"]}

    full = {k: c for k, c in cells.items() if f"|n={PF.N_F}|" in k}
    by_scheme: dict = {}
    for c in full.values():
        by_scheme.setdefault(c["scheme"], []).append(
            c["accesses"] / c["seconds"])
    grid_s = sum(c["seconds"] for c in full.values())
    stats = {k: sum(c["stats"][k] for c in cells.values())
             for k in ("windows", "slow", "window_syncs", "slow_syncs",
                       "serial", "serial_syncs")}
    syncs = sum(stats[k] for k in ("window_syncs", "slow_syncs",
                                   "serial_syncs"))
    print(f"phase 11 cells: {len(cells)} computed ({len(full)} at full "
          f"size), {len(cells) - len(differ) - len(extra)} equal to the "
          f"reference file, {len(missing)} of its cells not run (fig09's "
          f"other workloads: {set(missing) == skipped}); figure "
          f"rows equal: {len(rows) - len(bad_rows)}/{len(rows)}; wall "
          f"{wall:.3f} s, fig09's full grid {grid_s:.3f} s of cell time, "
          f"figures {json.dumps(fig_s)} [{tag}]", flush=True)
    print("phase 11 accesses/s at full size (median, min, max over the "
          "workloads): " + json.dumps({
              s: [round(statistics.median(v), 3), round(min(v), 3),
                  round(max(v), 3)] for s, v in by_scheme.items()}) +
          f" [{tag}]", flush=True)
    print("phase 11 cell accesses/s: " + json.dumps({
        k: round(c["accesses"] / c["seconds"], 3) for k, c in cells.items()}),
        flush=True)
    print(f"phase 11 replay: {stats['windows']} windows, {stats['slow']} "
          f"slow accesses, {stats['serial']} serial accesses, {syncs} syncs "
          f"({(stats['window_syncs'] + stats['slow_syncs']) / max(stats['windows'], 1):.3f} "
          f"a window, {stats['slow_syncs'] / max(stats['slow'], 1):.3f} a "
          f"slow access); counted syncs {contracts.SYNCS.count}", flush=True)
    print(f"phase 11 C5: {len(card_c5)} cells break I1-I4 on the card, "
          f"{len(ref_c5)} in the reference file; the same set: "
          f"{set(card_c5) == set(ref_c5)}", flush=True)
    for k in sorted(card_c5):
        print(f"  {k}: {card_c5[k]}")
    print(f"phase 11 fig09: {len(rows['fig09_speedup'])} per-cell rows "
          f"checked on the card; its geomean-speedup rows need the "
          f"{len(skipped)} cells not run and are held on the CPU only",
          flush=True)
    print(f"phase 11 launches: {json.dumps(launches)}", flush=True)
    check(not extra, f"phase 11: cells not in the reference file: {extra}")
    check(len(names) == len(want_rows["fig09_speedup"]) ==
          len(PF.FIG09_SCHEMES) * len(FIG09_CARD_WL),
          "phase 11: fig09's rows of the workloads run are not the "
          "reference file's")
    check(set(missing) == skipped, f"phase 11: reference cells not run "
          f"beyond fig09's other workloads: {sorted(set(missing) - skipped)}")
    check(not differ, f"phase 11: cells differ from the reference: {differ}")
    check(not bad_rows, f"phase 11: figure rows differ: {bad_rows}")
    check(card_c5 == ref_c5, f"phase 11: I1-I4 status differs from the "
          f"reference: card {card_c5}, reference {ref_c5}")
    check(not any(launches.values()),
          f"phase 11: a kernel launched on the payload-less path: {launches}")
    return {"wall_s": wall, "cells": len(cells), "grid_s": grid_s}


# ---------------------------------------------------------------------------
# Phase 12: the multi-expander fabric.
# ---------------------------------------------------------------------------

FABRIC_N = 4
FABRIC_WEIGHTS = [0.8] + [(1.0 - 0.8) / 3] * 3
# 12b: the payload fabric over pool main's OSPA space. Expander 0 takes 80%
# of the written pages; its compressed region (12,288 chunks) cannot hold
# its share (about 5,500 demoted pages of 3.6 chunks), so the spill
# carries the overflow to expanders 1-3, which keep their headroom. The
# watermark clears a segment's demand (256 writes) plus the 1/8 of the
# region held as 8-chunk groups, which mcf's pages hardly use. The
# metadata cache holds 1/8 of the promoted region, pool main's ratio (a
# cache that covers it marks every page referenced and the clock falls
# back to random victims). Cut (PR 23), for the script's time: every size
# of the 16,384-page recipe (PRs 17-22) over 2.
FABRIC_POOL = dict(n_pages=262144, n_pchunks=1024, n_cchunks=12288,
                   mcache_sets=8)
FABRIC_PAGES = 8192
FABRIC_ACCESSES = 8192
FABRIC_RUN = dict(window=32, spill_interval=256, spill_k=256,
                  spill_low=3072)
FABRIC_MIN_EPOCHS = 5
# 12c: the same recipe on a 4,096-page space (the 8,192-page recipe's sizes
# over 8, its accesses over 4), kernels against plain versions
FABRIC_WHOLE = dict(pool=dict(n_pages=4096, n_pchunks=128, n_cchunks=1536,
                              mcache_sets=1),
                    pages=1024, accesses=2048,
                    run=dict(window=32, spill_interval=32, spill_k=32,
                             spill_low=384))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# 12a's fabrics left out for the script's time (PR 26): N = 2 (between 1
# and 4) and the skew sweep's 25% and 50% (80% runs)
FABRIC_CARD_SKIP = ("scale.2x", "skew.0.25", "skew.0.50")


def _fabric_reference(dev, tag: str) -> dict:
    """12a: the fabrics of the reference bench's full recipe
    (``launch.fabric.BENCH_FABRICS``: scaling N = 1, 4, 8 with migration
    off, the mixed2/mixed4 fleets, the skew sweep's 80% at N = 4 with
    spill live, the rebalance pipeline at depth 2, synchronous and depth
    1; FABRIC_CARD_SKIP left out), each replayed once, against the JAX
    package's record (``fabric/reference_fabric.json``): every field
    equal, the float32 segment times bit for bit."""
    from repro_torch.common import contracts
    from repro_torch.launch import fabric as LF
    ref = json.loads(LF.REFERENCE.read_text())
    check(ref["recipe"] == LF.BENCH_RECIPE and
          [{k: v for k, v in f.items() if k != "result"}
           for f in ref["fabrics"]] == json.loads(json.dumps(
               LF.BENCH_FABRICS)),
          "phase 12a: the reference file is not this recipe's")
    rates, trace = LF.bench_inputs()
    check([LF.digest(np.asarray(a)) for a in trace] == ref["trace_sha256"],
          "phase 12a: the trace differs from the one the reference replayed")
    n_acc = LF.BENCH_RECIPE["n_accesses"]
    _zero_port_launches()
    rows, differ, fabs = {}, {}, {}
    t_all = time.perf_counter()
    for want in ref["fabrics"]:
        name = want["name"]
        if name in FABRIC_CARD_SKIP:
            continue
        contracts.SYNCS.reset()
        _sync(dev)
        t0 = time.perf_counter()
        fab = LF.build(want, rates, device=dev).replay(*trace)
        _sync(dev)
        dt = time.perf_counter() - t0
        syncs = contracts.SYNCS.count
        got = json.loads(json.dumps(LF.record(fab)))
        bad = [k for k in want["result"] if got[k] != want["result"][k]]
        if bad:
            differ[name] = bad
        ss, rs = fab.sync_stats(), fab.replay_stats
        rows[name] = {
            "expanders": fab.n_expanders, "seconds": round(dt, 3),
            "accesses_per_s": round(n_acc / dt, 3),
            "segments": ss["segments"], "segment_fetches":
            ss["segment_syncs"], "epochs": ss["epochs"],
            "epoch_fetches": ss["epoch_syncs"],
            "pages_moved": int(fab.spill_pages_out.sum()),
            "syncs": syncs, "windows": rs["windows"],
            "replay_syncs_a_window": round(
                (rs["window_syncs"] + rs["slow_syncs"]) /
                max(rs["windows"], 1), 3),
            "serial_accesses": rs["serial"], "apply_syncs": fab.apply_syncs}
        if name.startswith("migration."):
            fabs[name] = fab
    wall = time.perf_counter() - t_all
    launches = _port_launch_counts()
    same = fabs["migration.depth1"].state_identical(fabs["migration.sync"])
    pt = fabs["migration.depth2"].pipeline_times()
    over_ok = bool((pt["overlapped_s"] <= pt["sync_s"]).all())
    budget = all(r["segment_fetches"] == r["segments"] and
                 r["epoch_fetches"] == r["epochs"] for r in rows.values())
    print(f"phase 12a reference recipe: {len(rows)} fabrics of {n_acc} "
          f"accesses over {LF.BENCH_RECIPE['n_pages']} pages (window "
          f"{LF.BENCH_RECIPE['window']}; {', '.join(FABRIC_CARD_SKIP)} not "
          f"run), {len(rows) - len(differ)} equal to "
          f"the reference file in every field; depth 1 == sync "
          f"(state_identical): {same}; overlapped <= sync pricing: "
          f"{over_ok} (overlapped {float(np.max(pt['overlapped_s'])):.9e} "
          f"s, sync {float(np.max(pt['sync_s'])):.9e} s); fetches one a "
          f"segment + one an epoch: {budget}; wall {wall:.3f} s [{tag}]",
          flush=True)
    for name, r in rows.items():
        print(f"phase 12a {name}: {json.dumps(r)}", flush=True)
    print(f"phase 12a launches: {json.dumps(launches)}", flush=True)
    check(not differ, f"phase 12a: fabrics differ from the reference: "
          f"{differ}")
    check(same, "phase 12a: the depth-1 pipeline drifted from the "
          "synchronous driver")
    check(over_ok, "phase 12a: overlapped pricing exceeded sync pricing")
    check(budget, "phase 12a: fetches off the one-a-segment, one-an-epoch "
          "budget")
    check(not any(launches.values()),
          f"phase 12a: a kernel launched on the payload-less path: "
          f"{launches}")
    return {"wall_s": wall, "rows": rows}


def _fabric_payload(dev, pool: dict, pages: int, accesses: int, run: dict,
                    impl=None, profile: bool = False) -> dict:
    """The payload fabric: ``pages`` pages of mcf's rate mix written through
    ``Fabric.write_pages``, then an mcf trace of ``accesses`` accesses,
    over FABRIC_N expanders with FABRIC_WEIGHTS, spill live, pipelined at
    depth 2. Before every epoch's apply each planned page's entry and
    compressed bytes are read on its source; after the commit every page
    that moved must read back equal on its destination. That read-back
    check's syncs are taken out of the apply's count and its wall out of
    the ``*_net_s`` times. ``impl`` names ``compress_impl`` (with the
    batched demote step on), else the defaults."""
    from repro_torch.common import contracts
    from repro_torch.common.types import PoolConfig
    from repro_torch.core import metadata as md
    from repro_torch.core.engine import POLICIES
    from repro_torch.core.engine import ops as E
    from repro_torch.core.engine import state as S
    from repro_torch.fabric import Fabric, WeightedInterleave
    from repro_torch.fabric import ops as fops
    from repro_torch.kernels import qpack
    from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                        make_rates_table, make_trace)
    kw = {} if impl is None else dict(compress_impl=impl, fused_demote="on")
    cfg = PoolConfig(**pool, store_payload=True, lossless=True, **kw)
    rates = make_rates_table(WORKLOADS["mcf"], pages, cfg.blocks_per_page,
                             SEED)
    content = torch.from_numpy(
        make_block_content(rates, cfg.vals_per_block, SEED)
        .reshape(pages, cfg.vals_per_page)).to(dev).to(torch.bfloat16)
    trace = make_trace(WORKLOADS["mcf"], n_accesses=accesses, n_pages=pages,
                       seed=SEED)
    before, moved_log = {}, {"pages": 0, "bytes": 0, "bad": [], "epochs": 0}
    check_cost = {"syncs": 0, "s": 0.0}   # the read-back check's own
    apply = fops.apply_migrations

    def snapshot(pools, cfg_, policy, pg, srcs, dsts):
        t, s0 = time.perf_counter(), contracts.SYNCS.count
        for p, s_ in zip(pg.tolist(), srcs.tolist()):
            src = S.pool_slice(pools, s_)
            entry = E._entry(src, p)
            before[p] = (entry, E._gather_page_buf(src, cfg_, entry))
        _sync(dev)
        check_cost["syncs"] += contracts.SYNCS.count - s0
        check_cost["s"] += time.perf_counter() - t
        return apply(pools, cfg_, policy, pg, srcs, dsts)

    def on_epoch(fab, plan, moved):
        t = time.perf_counter()
        try:
            _read_back(fab, plan, moved)
        finally:
            check_cost["s"] += time.perf_counter() - t

    def _read_back(fab, plan, moved):
        moved_log["epochs"] += 1
        dst_of = dict(zip(plan.pages.tolist(), plan.dsts.tolist()))
        for p in moved.tolist():
            entry, buf = before.pop(p)
            dst = fab.pool(dst_of[p])
            got = E._entry(dst, p)
            n = md.get_num_chunks(entry[0])
            same = got[0] == entry[0] and torch.equal(
                E._gather_page_buf(dst, fab.cfg, got)[:n * cfg.chunk_bytes],
                buf[:n * cfg.chunk_bytes])
            if not same:
                moved_log["bad"].append(p)
            moved_log["pages"] += 1
            moved_log["bytes"] += n * cfg.chunk_bytes
        before.clear()

    pl = WeightedInterleave(FABRIC_N, cfg.n_pages, FABRIC_WEIGHTS)
    d0, p0 = qpack.fused_demote_launches, qpack.fused_promote_launches
    fops.apply_migrations = snapshot
    try:
        fab = Fabric(cfg, POLICIES["ibex"], pl, seed=SEED, window=run["window"],
                     spill_interval=run["spill_interval"],
                     spill_k=run["spill_k"], spill_low=run["spill_low"],
                     on_epoch=on_epoch, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        fab.write_pages(np.arange(pages), content)
        _sync(dev)
        t1 = time.perf_counter()
        check_pop_s = check_cost["s"]
        seg0, ep0 = fab.segments_replayed, fab.epochs_applied
        fab.replay(*trace)
        _sync(dev)
        t2 = time.perf_counter()
    finally:
        fops.apply_migrations = apply
    out = {"fab": fab, "cfg": cfg, "pop_s": t1 - t0, "replay_s": t2 - t1,
           "pop_net_s": t1 - t0 - check_pop_s,
           "replay_net_s": t2 - t1 - (check_cost["s"] - check_pop_s),
           "apply_syncs": fab.apply_syncs - check_cost["syncs"],
           "check_syncs": check_cost["syncs"], "check_s": check_cost["s"],
           "pop_segments": seg0, "pop_epochs": ep0,
           "demote": qpack.fused_demote_launches - d0,
           "promote": qpack.fused_promote_launches - p0, **moved_log}
    if profile:
        out["busy"] = _fabric_busy(fab, cfg, pages, run, dev)
    return out


def _fabric_busy(fab, cfg, pages: int, run: dict, dev):
    """Device busy share over one more segment (a trace of spill_interval
    accesses from another seed, so no expander's share exceeds one
    segment; an epoch it commits adds one), from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.simx.trace import WORKLOADS, make_trace
    tr = make_trace(WORKLOADS["mcf"], n_accesses=run["spill_interval"],
                    n_pages=pages, seed=SEED + 5)
    seg0 = fab.segments_replayed
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fab.replay(*tr)
        _sync(dev)
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"segments": fab.segments_replayed - seg0, "wall_s": wall,
            "events": len(kern), "busy_s": _busy_us(kern) / 1e6 if kern
            else None}


def phase_fabric(dev, tag: str) -> dict:
    """Phase 12: 12a the reference bench's recipe against the reference
    file; 12b the payload fabric at pool main's OSPA size (B1's and B2's
    steps on every expander, spill live, pipelined at depth 2); 12c the
    same recipe on a 4,096-page space with the kernels and with the plain
    versions, every leaf of every expander and the override table equal.
    Returns 12b's launches of the demote and promote steps."""
    from repro_torch import interop
    from repro_torch.core.engine.invariants import first_violation
    t_phase = time.perf_counter()
    ref = _fabric_reference(dev, tag)
    torch.cuda.empty_cache()

    r = _fabric_payload(dev, FABRIC_POOL, FABRIC_PAGES, FABRIC_ACCESSES,
                        FABRIC_RUN, profile=True)
    fab, cfg = r["fab"], r["cfg"]
    ss = fab.sync_stats()
    viol = {e: first_violation(interop.pool_to_numpy(fab.pool(e)), cfg)
            for e in range(FABRIC_N)}
    free = fab.park_capacity().tolist()
    busy = r["busy"]
    share = (f"{busy['busy_s'] / busy['wall_s']:.4f}"
             if busy["busy_s"] is not None else "not measured (no device "
             "events recorded)")
    print(f"phase 12b payload fabric: {FABRIC_N} expanders of "
          f"{json.dumps(FABRIC_POOL)}, weights "
          f"{[round(w, 4) for w in FABRIC_WEIGHTS]}, {json.dumps(FABRIC_RUN)} "
          f"| population {FABRIC_PAGES} pages in {r['pop_s']:.3f} s = "
          f"{FABRIC_PAGES / r['pop_s']:.3f} pages/s, "
          f"{FABRIC_PAGES / r['pop_net_s']:.3f} pages/s without the "
          f"read-back check ({r['pop_segments']} segments, "
          f"{r['pop_epochs']} epochs) | replay {FABRIC_ACCESSES} "
          f"accesses in {r['replay_s']:.3f} s = "
          f"{FABRIC_ACCESSES / r['replay_s']:.3f} accesses/s, "
          f"{FABRIC_ACCESSES / r['replay_net_s']:.3f} without the check | "
          f"epochs {ss['epochs']}, pages moved "
          f"{r['pages']} = {r['bytes']} compressed bytes, out "
          f"{fab.spill_pages_out.tolist()} in {fab.spill_pages_in.tolist()}"
          f" | fetches {ss['segment_syncs']} segment + {ss['epoch_syncs']} "
          f"epoch for {ss['segments']} segments and {ss['epochs']} epochs, "
          f"apply syncs {r['apply_syncs']} "
          f"({r['apply_syncs'] / max(r['pages'], 1):.3f} a moved page) | "
          f"launches demote-and-compact {r['demote']} promote "
          f"{r['promote']} | free chunk units {free} | read-back of moved "
          f"pages: {len(r['bad'])} differ; the check took "
          f"{r['check_syncs']} syncs and {r['check_s']:.3f} s, left out "
          f"of the apply syncs and the rates without it [{tag}]",
          flush=True)
    print(f"phase 12b busy: device busy share over {busy['segments']} "
          f"segment(s) of a {FABRIC_RUN['spill_interval']}-access trace, "
          f"{busy['events']} device events, wall {busy['wall_s']:.3f} s, "
          f"busy share {share} [{tag}]", flush=True)
    print(f"phase 12b invariants: {json.dumps(viol)}", flush=True)
    check(not any(viol.values()), f"phase 12b: I1-I4 broken: {viol}")
    check(ss["epochs"] >= FABRIC_MIN_EPOCHS and r["pages"] > 0,
          f"phase 12b: spill committed {ss['epochs']} epochs (at least "
          f"{FABRIC_MIN_EPOCHS} asked)")
    check(not r["bad"], f"phase 12b: moved pages read back wrong: "
          f"{r['bad'][:8]}")
    check(r["demote"] > 0 and r["promote"] > 0,
          f"phase 12b: a kernel was not launched: demote {r['demote']} "
          f"promote {r['promote']}")
    check(ss["segment_syncs"] == ss["segments"] and
          ss["epoch_syncs"] == ss["epochs"],
          f"phase 12b: fetches off budget: {ss}")
    launches = {"demote": r["demote"], "promote": r["promote"]}
    del fab, r
    torch.cuda.empty_cache()

    runs = {}
    for impl in ("kernel", "jnp"):
        w = _fabric_payload(dev, FABRIC_WHOLE["pool"], FABRIC_WHOLE["pages"],
                            FABRIC_WHOLE["accesses"], FABRIC_WHOLE["run"],
                            impl=impl)
        fab = w["fab"]
        bad = [first_violation(interop.pool_to_numpy(fab.pool(e)), fab.cfg)
               for e in range(FABRIC_N)]
        runs[impl] = (interop.pool_stack_to_numpy(fab.pools),
                      fab.placement.overrides.copy(), w["demote"],
                      w["promote"], fab.epochs_applied, w["bad"] +
                      [v for v in bad if v])
        del fab, w
    (ka, ko, kd, kp, ke, kb), (pa, po, pd, pp, pe, pb) = \
        runs["kernel"], runs["jnp"]
    diff = [k for k in ka if not np.array_equal(ka[k], pa[k])]
    print(f"phase 12c whole fabric kernel vs plain: {FABRIC_N} expanders of "
          f"{json.dumps(FABRIC_WHOLE['pool'])}, {FABRIC_WHOLE['pages']} "
          f"pages, {FABRIC_WHOLE['accesses']} accesses, {ke} and {pe} "
          f"epochs | {len(ka)} leaves, {len(diff)} differ {diff} | "
          f"overrides equal {bool((ko == po).all())} | kernel run launches "
          f"demote {kd} promote {kp}, plain run {pd} {pp}", flush=True)
    check(not diff and (ko == po).all(),
          f"phase 12c: leaves or overrides differ: {diff}")
    check(kd > 0 and kp > 0 and pd == 0 and pp == 0 and ke > 0,
          "phase 12c: the kernel run did not launch the kernels or migrate, "
          "or the plain run launched them")
    check(not kb and not pb, f"phase 12c: moved pages read back wrong or "
          f"I1-I4 broken: kernel {kb[:4]}, plain {pb[:4]}")
    print(f"phase 12 wall {time.perf_counter() - t_phase:.3f} s "
          f"(12a {ref['wall_s']:.3f} s) [{tag}]", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 13: serving MLA (minicpm3-4b) over the compressed latent cache.
# ---------------------------------------------------------------------------

MLA_R, MLA_H = 288, 40          # minicpm3-4b's latent row and query heads
MLA_SM = 1.0 / 96 ** 0.5        # 1/sqrt(nope 64 + rope 32)


def _minicpm(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("minicpm3_4b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _whole_paper(cfg, params, tokens, lens, fused, feed, tol, label,
                 fused_routes):
    """13c's and 14c's paper mode: the kernel run again, the compressed
    prefix read promote-then-read (B4 once a layer a decode step for MLA's
    latent at its block of 288, twice for GQA's K and V; B5 never), its
    logits normwise per row within ``tol`` of the fused kernel run's
    (``fused_routes`` its expert choices: for the MoE family the logits
    are held to ``tol`` where no choice differs, else reported)."""
    with _RouteRecorder() as rr:
        got, _, kl = _whole_run(cfg, params, tokens, lens, "kernel", feed,
                                paper=True)
    route_diff = rr.differ(fused_routes)
    bad = sum(int(((a - b).abs().amax(dim=-1) >
                   tol * b.abs().amax(dim=-1)).sum())
              for a, b in zip(got, fused))
    err = max(float((a - b).abs().max()) for a, b in zip(got, fused))
    mla = cfg.attn_kind == "mla"
    b5 = "kvc_latent_partial" if mla else "kvc_decode_attention"
    want_b4 = WHOLE_STEPS * cfg.num_layers * (1 if mla else 2)
    routing = (f" | expert choices differing from the fused run: "
               f"{route_diff} of {rr.total()}" if cfg.family == "moe" else "")
    print(f"phase {label} paper mode bf16: logits vs the fused kernel run "
          f"max abs err {err:.6f}, {bad} rows outside tol {tol} | B4 "
          f"launches {kl['qpack_fixed_decode']} (expected {want_b4}), B5 "
          f"{kl[b5]} (0){routing}", flush=True)
    check((bad == 0 or route_diff > 0) and
          kl["qpack_fixed_decode"] == want_b4 and kl[b5] == 0,
          f"phase {label}: paper mode off the fused run or its launches off")
    return {"err": err, "b4_launches": kl["qpack_fixed_decode"],
            "route_diff": route_diff}


def _latent_cases(res: dict, qpack, dev) -> None:
    """13a, B3's latent steps and B4 at block 288, byte for byte against
    their plain versions: the ring step over RING_LANES (ring bf16, new
    bf16 and f32), the prefill fill at the path's 1 x 1,024 row and at
    small rows of short prompts, the lane flush over FLUSH_LANES; 4 and 8
    bits."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    bf = torch.bfloat16
    for bits in (4, 8):
        B, S, W, R = 8, SERVE_MAX_LEN, SERVE_CFG["hot_window"], MLA_R
        for new in (bf, torch.float32):
            codes, scales, hot, newv, pos, cold = ring_inputs(
                B, 1, R, bits, bf, new, gen, dev)
            out = []
            for fn in (qpack.latent_ring_step, qpack.latent_ring_step_plain):
                c, s_, h = (t[0].clone()[:, :, 0] for t in (codes, scales,
                                                             hot))
                fn(c, s_, h, newv[0][:, 0], pos, cold, bits)
                out.append((c, s_, h))
            _count_equal(res["qpack_latent_ring_step"], *out)
        for Bf, Sf, L_, Wf, lens in ((1, 1024, S, W, [1000]),
                                     (4, 40, 49, 8, [40, 5, 1, 23])):
            for dtype in (bf, torch.float32):
                kv, leaves, lens_t = fill_inputs(Bf, Sf, L_, Wf, 1, R, bits,
                                                 dtype, lens, gen, dev)
                out = []
                for fn in (qpack.latent_prefill_fill,
                           qpack.latent_prefill_fill_plain):
                    ls = [t.clone()[:, :, 0] for t in leaves[:3]]
                    fn(kv[0][:, :, 0], *ls, lens_t, bits)
                    out.append(ls)
                _count_equal(res["qpack_latent_prefill_fill"], *out)
        leaves = flush_inputs(3, 3, S, W, 1, R, bits, gen, dev)[:3]
        for posf, cl in FLUSH_LANES:
            cold_len = torch.zeros((3, 3), dtype=torch.int32, device=dev)
            cold_len[:, 1] = torch.tensor(cl, dtype=torch.int32, device=dev)
            out = []
            for fn in (qpack.latent_lane_flush, qpack.latent_lane_flush_plain):
                ls = [t.clone()[..., 0, :] if t.dim() == 5 else
                      t.clone()[..., 0] for t in leaves]
                new = fn(*(t[:, 1] for t in ls), cold_len[:, 1], posf, bits)
                out.append(ls + [new])
            _count_equal(res["qpack_latent_lane_flush"], *out)
        x = torch.randn((B, S, R), generator=gen, device=dev)
        c, s_ = qpack.encode(x, bits, R)
        for dt in (bf, torch.float32):
            _count_equal(res["qpack_fixed_decode_288"],
                         [qpack.decode(c, s_, bits, R, dt)],
                         [qpack.decode_plain(c, s_, bits, R, dt)])
    torch.cuda.synchronize()


def _count_equal(r: dict, got, want) -> None:
    """One case: every tensor of ``got`` bit for bit ``want``'s; a mismatch
    is a leading row that differs."""
    r["cases"] += 1
    for a, b in zip(got, want):
        r["mismatches"] += int((~_bits_equal(a, b)).sum())
        r["err"] = max(r["err"], float((a.float() - b.float()).abs().max()))


def phase_mla_kernels(dev) -> dict:
    """13a: the MLA forms at minicpm3-4b's widths against their plain
    versions: B3's latent steps and B4 at block 288 byte for byte; B5's
    latent form within ATTN_TOL at lengths straddling both routes' tiles, a
    second call bit-identical, bf16 on the tensor cores and within
    ``LATENT_TC_MODEL_TOL`` of its rounding model, f32 on the CUDA cores;
    B6 at (96, 64) within ATTN_TOL and ATTN_NORM_TOL, bf16 on the tensor
    cores."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    res = {k: {"cases": 0, "mismatches": 0, "err": 0.0}
           for k in ("qpack_latent_ring_step", "qpack_latent_prefill_fill",
                     "qpack_latent_lane_flush", "qpack_fixed_decode_288",
                     "kvc_latent_partial", "kvc_latent_partial_f32",
                     "flash_attention_mla")}
    _latent_cases(res, qpack, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    c, t = KA.LATENT_CHUNK, KA.LATENT_TC_TOKENS
    repeats, lat_tc0, bf_cases = 0, KA.latent_launches_tc, 0
    model = {"ml_err": 0.0, "acc_norm": 0.0, "plain_acc_norm": 0.0}
    for S, lens_l in ((SERVE_MAX_LEN, [0, 1, c - 1, c, c + 1, t - 1, t + 1,
                                       2 * t, 2 * t + 1, 700, 2047, 2048]),
                      (c, [0, 1, c - 1, c])):
        B = len(lens_l)
        for bits in (4, 8):
            codes, scales = qpack.encode(torch.randn(
                (B, S, MLA_R), generator=gen, device=dev), bits, MLA_R)
            scales = scales[..., 0].contiguous()
            lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            for dt in (torch.bfloat16, torch.float32):
                r = res["kvc_latent_partial" if dt == torch.bfloat16 else
                        "kvc_latent_partial_f32"]
                q = torch.randn((B, MLA_H, MLA_R), generator=gen,
                                device=dev).to(dt)
                got = KA.kvc_latent_partial(q, codes, scales, lens, bits=bits,
                                            sm_scale=MLA_SM)
                again = KA.kvc_latent_partial(q, codes, scales, lens,
                                              bits=bits, sm_scale=MLA_SM)
                repeats += 1
                bf_cases += 2 * (dt == torch.bfloat16)
                check(all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(got, again)),
                      f"phase 13a: B5's latent partials differ between two "
                      f"calls (S {S}, bits {bits}, {dt})")
                want = KA.kvc_latent_partial_plain(q, codes, scales, lens,
                                                   bits, MLA_SM)
                for a, b in zip(got, want):
                    r["cases"] += 1
                    r["mismatches"] += int(((a - b).abs() > ATTN_TOL[
                        torch.bfloat16] * (1 + b.abs())).sum())
                    r["err"] = max(r["err"], float((a - b).abs().max()))
                if dt == torch.bfloat16:
                    # the tensor-core route's own rounding, tighter
                    tm = KA.kvc_latent_partial_tc_model(q, codes, scales,
                                                        lens, bits, MLA_SM)
                    model["ml_err"] = max(model["ml_err"], *(
                        float(((a - b).abs() / (1 + b.abs())).max())
                        for a, b in zip(got[:2], tm[:2])))
                    norm = float(tm[2].norm())
                    model["acc_norm"] = max(model["acc_norm"], float(
                        (got[2] - tm[2]).norm()) / norm)
                    model["plain_acc_norm"] = max(
                        model["plain_acc_norm"],
                        float((got[2] - want[2]).norm()) / norm)
    check(KA.latent_launches_tc - lat_tc0 == bf_cases, f"phase 13a: "
          f"{bf_cases} bf16 B5 latent calls launched the tensor-core route "
          f"{KA.latent_launches_tc - lat_tc0} times")
    tol = KA.LATENT_TC_MODEL_TOL
    check(model["ml_err"] <= tol["ml"] and
          model["acc_norm"] <= tol["acc_norm"],
          f"phase 13a: B5 latent's tensor-core route is off its rounding "
          f"model: {model} against {tol}")
    r = res["flash_attention_mla"]
    tc0, tc_cases = FA.launches_tc, 0
    for Sq, Sk, B in ((1, 1, 2), (8, 8, 2), (100, 100, 2), (24, 200, 2),
                      (1000, 1000, 1), (1024, 1024, 2)):
        for dt in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q, k = (torch.randn((B, s, MLA_H, 96), generator=gen,
                                    device=dev).to(dt) for s in (Sq, Sk))
                v = torch.randn((B, Sk, MLA_H, 64), generator=gen,
                                device=dev).to(dt)
                tc_cases += dt == torch.bfloat16
                _flash_case(r, FA, q, k, v, causal)
    torch.cuda.synchronize()
    check(FA.launches_tc - tc0 == tc_cases, f"phase 13a: {tc_cases} bf16 "
          f"cases launched the tensor-core route {FA.launches_tc - tc0} "
          "times")
    print(f"phase 13a MLA kernels vs plain at minicpm3-4b's widths (latent "
          f"{MLA_R}, {MLA_H} heads, B6 qk 96 / v 64): "
          f"{json.dumps(res)} | B5 latent bit-identical on a second call in "
          f"{repeats} configurations, {bf_cases} bf16 calls on the tensor "
          f"cores (spans of {t} tokens, {KA.LATENT_TC_BOXES} column boxes), "
          f"f32 on the CUDA cores (chunk {c}); the tensor-core route against "
          f"its "
          f"rounding model {json.dumps(model)} (tolerance {json.dumps(tol)}: "
          f"m and l |kernel - model| / (1 + |model|), acc normwise; "
          f"plain_acc_norm the same against the plain version); B6 "
          f"{tc_cases} bf16 cases on the tensor cores | tolerance |kernel - "
          f"plain| <= tol * (1 + |plain|), tol 2e-2 (bf16 query or B5) and "
          f"2e-3 (f32 B6); B6 also normwise 1e-2 / 1e-4; B3's steps and B4 "
          f"byte for byte", flush=True)
    for k, v in res.items():
        check(v["mismatches"] == 0, f"phase 13a: {k} disagrees with its "
              f"plain version in {v['mismatches']} elements/rows")
    check(res["flash_attention_mla"]["norm_fails"] == 0,
          "phase 13a: B6 at (96, 64) is off its plain version normwise")
    return res


# 13b's depth: 16 of minicpm3-4b's 62 layers, the script's time (PR 21
# halved it when phase 15 came; PR 23 cut it again, first, for phase 17)
MLA_SERVE_LAYERS = 16


def phase_serve_mla(dev, tag: str) -> tuple:
    """13b: minicpm3-4b at its published widths, MLA_SERVE_LAYERS of its
    62 layers (bf16 params from the seed), served through Engine with
    phase 7's recipe; launches
    against the expectations (the latent ring step and B5's latent form
    one a layer a step, the latent prefill fill and B6 one a layer a
    prefill batch, the latent lane flush one a lane demotion, the GQA
    steps and B3/B4 none); then torch.profiler over PROFILE_STEPS decode
    steps of 8 lanes: the device busy share."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = _minicpm(MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    scfg = ServeConfig(**SERVE_CFG)
    prompts = _prompts(SERVE_REQUESTS, cfg.vocab_size, SEED)
    torch.cuda.reset_peak_memory_stats()
    timed = {}
    eng, wall, t_pre, t_step, launches = _serve(
        cfg, scfg, params, prompts, SERVE_NEW_TOKENS, dev,
        hooks=[(FA, "flash_attention", "b6")], timed=timed)
    c = eng.counters
    n_prompt = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 13b serve mla: {describe(cfg)} ({cfg.param_count()} "
          f"params), bf16 params from seed {SEED} ({t_init:.3f} s) | "
          f"{SERVE_REQUESTS} requests, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {SERVE_NEW_TOKENS} new each, "
          f"{scfg.max_running} lanes, max_len {SERVE_MAX_LEN}, W "
          f"{scfg.hot_window}, {scfg.kv_rate_bits}-bit latent | wall "
          f"{wall:.3f} s | prefill {n_prompt} prompt tokens in {t_pre:.3f} s "
          f"device = {n_prompt / t_pre:.3f} tokens/s | decode {c['tokens']} "
          f"tokens in {c['steps']} steps, {t_step:.3f} s device = "
          f"{c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | KV cache "
          f"{D.cache_bytes(eng.cache) / 2**30:.6f} GiB "
          f"({D.cache_bytes(eng.cache)} B), peak memory {peak:.3f} GiB "
          f"[{tag}]", flush=True)
    print(f"phase 13b counters: {json.dumps(c)}", flush=True)
    t_b6, n_b6 = timed["b6"]
    Lyr = cfg.num_layers
    want = {"qpack_latent_ring_step": c["steps"] * Lyr,
            "kvc_latent_partial": c["steps"] * Lyr,
            "kvc_latent_partial_tc": c["steps"] * Lyr,
            "qpack_latent_prefill_fill": c["prefill_batches"] * Lyr,
            "flash_attention": c["prefill_batches"] * Lyr,
            "flash_attention_tc": c["prefill_batches"] * Lyr,
            "qpack_latent_lane_flush": c["demotions"] -
            c["shadow_repreempts"]}
    want.update({k: 0 for k in launches if k not in want})
    print(f"phase 13b launches: {json.dumps(launches)} | expected "
          f"{json.dumps(want)} (the ring step and B5 one a layer a step, "
          f"every B5 on the tensor cores, the fill and B6 one a layer a "
          f"prefill batch, the flush one a lane demotion) | B6 in prefill: "
          f"{n_b6} calls, {t_b6:.6f} s device = "
          f"{t_b6 / t_pre:.4f} of prefill [{tag}]", flush=True)
    check(c["demotions"] > 0 and c["promotions"] > 0,
          "phase 13b: no demotion or promotion")
    check(launches == want and n_b6 == want["flash_attention"] and
          all(launches[k] > 0 for k in MLA_STEPS),
          f"phase 13b: launches {launches} against {want}")

    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    for p in _prompts(SERVE_CFG["max_running"], cfg.vocab_size, SEED + 4):
        eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
    for _ in range(3):                  # admission, prefill, warm steps
        eng.step()
    kern, pwall, b5, attempt = _complete_trace(
        eng, "13b", tag, "kvc_latent_tc_kernel",
        PROFILE_STEPS * cfg.num_layers)
    busy = None
    if not kern:
        print(f"phase 13b profile: torch.profiler recorded no device events; "
              f"device busy share not measured [{tag}]", flush=True)
    else:
        busy = _busy_us(kern) / (pwall * 1e6)
        b5_us = sum(e.time_range.elapsed_us() for e in b5)
        by_name: dict = {}
        for e in kern:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
        print(f"phase 13b profile: {PROFILE_STEPS} decode steps, 8 lanes, "
              f"{1e3 * pwall / PROFILE_STEPS:.3f} ms per step (host wall, "
              f"profiler on) | device busy {_busy_us(kern) / 1e3:.3f} ms = "
              f"{busy:.4f} of the wall | {len(kern)} device events, "
              f"{len(kern) / PROFILE_STEPS:.1f} per step | B5 latent "
              f"{len(b5)} launches, {b5_us / 1e3 / PROFILE_STEPS:.6f} ms a "
              f"step | top by device time: " + "; ".join(
                  f"{n[:60]} x{k} {us / 1e3:.3f} ms" for n, (k, us) in top)
              + f" | trace {attempt} [{tag}]", flush=True)
        check(len(b5) == PROFILE_STEPS * cfg.num_layers, f"phase 13b: the "
              f"profile found {len(b5)} tensor-core B5 latent launches, not "
              f"{PROFILE_STEPS * cfg.num_layers}, in each of {attempt} "
              f"traces")
    del eng, params
    return launches, {"t_pre": t_pre, "t_step": t_step, "wall": wall,
                      "counters": c, "busy": busy, "peak_gib": peak}


def phase_mla_times(dev, tag: str, lens_l) -> dict:
    """13d: the MLA forms at the main path's shapes (minicpm3-4b, 8 lanes):
    kernel / eager / plain / library / bound ms."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    B, R, H = SERVE_CFG["max_running"], MLA_R, MLA_H
    bits, W, S = SERVE_CFG["kv_rate_bits"], SERVE_CFG["hot_window"], \
        SERVE_MAX_LEN
    Rp, lyr = R * bits // 8, _minicpm().num_layers
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    bf = torch.bfloat16
    out = {}
    # the latent ring step of one layer, 8 lanes, every lane evicting
    ring = ring_inputs(B, 1, R, bits, bf, bf, gen, dev, W=W, S=S)
    pos = torch.tensor(lens_l + W, dtype=torch.int32, device=dev)
    rargs = [ring[0][0][:, :, 0], ring[1][0][:, :, 0], ring[2][0][:, :, 0],
             ring[3][0][:, 0], pos, pos - W, bits]
    out["qpack_latent_ring_step"] = dict(
        shape=f"{B} lanes x latent {R}, bf16 ring of {W}, {bits}-bit codes "
              f"of {S}, every lane evicting",
        kern=lambda: qpack.latent_ring_step(*rargs),
        plain=lambda: qpack.latent_ring_step_plain(*rargs), lib=None,
        nbytes=B * (6 * R + Rp + 4) + 8 * B, ops=0, reps=200)
    # the latent prefill fill of one layer of a 1-row batch of the 1,024
    # bucket (a 1,000-token prompt)
    kvf, leaves, lens1 = fill_inputs(1, 1024, S, W, 1, R, bits, bf, [1000],
                                     gen, dev)
    fargs = [kvf[0][:, :, 0]] + [t[:, :, 0] for t in leaves[:3]] + \
        [lens1, bits]
    out["qpack_latent_prefill_fill"] = dict(
        shape=f"1x1024 latent {R} bf16 -> {bits}-bit codes of {S} and a "
              f"ring of {W} (a prefill layer)",
        kern=lambda: qpack.latent_prefill_fill(*fargs),
        plain=lambda: qpack.latent_prefill_fill_plain(*fargs), lib=None,
        nbytes=1024 * (2 * R + Rp + 4) + W * 2 * R + 4, ops=0, reps=200)
    # the latent lane flush of lane 1 of 8, 62 layers, a live ring of W
    fl = flush_inputs(lyr, B, S, W, 1, R, bits, gen, dev)[:3]
    lane = [t[:, 1, ..., 0, :] if t.dim() == 5 else t[:, 1, ..., 0]
            for t in fl]
    cold_f = torch.full((lyr, B), 1000 - W, dtype=torch.int32, device=dev)
    out["qpack_latent_lane_flush"] = dict(
        shape=f"lane 1 of {B}: {lyr} layers, a live ring of {W} x {R} bf16 "
              f"-> {bits}-bit codes of {S}",
        kern=lambda: qpack.latent_lane_flush(*lane, cold_f[:, 1], 1000, bits),
        plain=lambda: qpack.latent_lane_flush_plain(*lane, cold_f[:, 1], 1000,
                                               bits), lib=None,
        nbytes=lyr * (W * (2 * R + Rp + 4) + 8), ops=0, reps=50)
    # B4 at block 288: the paper path's whole latent prefix of 8 lanes
    lc, ls = qpack.encode(torch.randn((B, S, R), generator=gen, device=dev),
                          bits, R)
    out["qpack_fixed_decode_288"] = dict(
        shape=f"{B}x{S}x{R} -> bf16 (paper-mode latent prefix)",
        kern=lambda: qpack.decode(lc, ls, bits, R, bf),
        plain=lambda: qpack.decode_plain(lc, ls, bits, R, bf), lib=None,
        nbytes=B * S * (Rp + 4 + 2 * R), ops=0, reps=20)
    # B5's latent form: the decode step's compressed-prefix read
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    q = torch.randn((B, H, R), generator=gen, device=dev).to(bf)
    ls1 = ls[..., 0].contiguous()
    ldq = qpack.decode(lc, ls, bits, R, bf)[:, :, None]
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    tok = int(lens.sum())
    out["kvc_latent_partial"] = dict(
        shape=f"q {B}x{H}x{R} bf16 (tensor cores), {bits}-bit latent "
              f"{B}x{S}, lengths {lens_l.tolist()}",
        kern=lambda: KA.kvc_latent_partial(q, lc, ls1, lens, bits=bits,
                                           sm_scale=MLA_SM),
        plain=lambda: KA.kvc_latent_partial_plain(q, lc, ls1, lens, bits,
                                                  MLA_SM),
        lib=lambda: _sdpa(q[:, None], ldq, ldq, False, mask),
        nbytes=tok * (Rp + 4) + B * H * R * 2 + B * 4 + B * H * (R + 2) * 4,
        ops=4 * tok * H * R, reps=50)
    # the CUDA-core route (f32 q) at the same shapes, timed in the same
    # process: its operations are f32 ones
    q32, ldq32 = q.float(), ldq.float()
    out["kvc_latent_partial_f32"] = dict(
        shape=f"q {B}x{H}x{R} f32 (CUDA cores), {bits}-bit latent {B}x{S}, "
              f"lengths {lens_l.tolist()}",
        kern=lambda: KA.kvc_latent_partial(q32, lc, ls1, lens, bits=bits,
                                           sm_scale=MLA_SM),
        plain=lambda: KA.kvc_latent_partial_plain(q32, lc, ls1, lens, bits,
                                                  MLA_SM),
        lib=lambda: _sdpa(q32[:, None], ldq32, ldq32, False, mask),
        nbytes=tok * (Rp + 4) + B * H * R * 4 + B * 4 + B * H * (R + 2) * 4,
        ops=4 * tok * H * R, ops_dtype="float32", reps=50)
    # B6 at (96, 64): the prefill's attention at the 1024 bucket, causal, 8
    # rows, then the path's 4- and 1-row batches
    Sp = 1024
    qf, kf = (torch.randn((B, Sp, H, 96), generator=gen, device=dev).to(bf)
              for _ in range(2))
    vf = torch.randn((B, Sp, H, 64), generator=gen, device=dev).to(bf)
    for rows in (B, 4, 1):
        q_, k_, v_ = qf[:rows], kf[:rows], vf[:rows]
        out["flash_attention_mla" + ("" if rows == B else f"_{rows}x{Sp}")] = \
            dict(shape=f"q {rows}x{Sp}x{H}x96, k {rows}x{Sp}x{H}x96, v "
                       f"{rows}x{Sp}x{H}x64 bf16 causal",
                 kern=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention(
                     q_, k_, v_, causal=True),
                 plain=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention_plain(
                     q_, k_, v_, causal=True),
                 lib=lambda q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, True),
                 nbytes=2 * rows * Sp * H * (96 * 2 + 64 * 2),
                 ops=2 * rows * H * (96 + 64) * Sp * (Sp + 1) // 2, reps=5)
    res = _time_rows(out, "13d", tag)

    # B5's latent form: CTAs that do work at 13b's lengths on the path's
    # route (bf16: a CTA a span of LATENT_TC_TOKENS tokens and a column
    # box) against the card's SMs; the CUDA-core route's beside it
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    working = KA.latent_working_ctas(lens_l)
    grid = B * KA.LATENT_TC_BOXES * -(-S // KA.LATENT_TC_TOKENS)
    print(f"phase 13d kvc_latent_partial split: tensor cores "
          f"{KA.LATENT_TC_TOKENS} tokens and one of {KA.LATENT_TC_BOXES} "
          f"64-wide column boxes a CTA "
          f"(all {H} heads each), grid {grid} CTAs of which {working} do "
          f"work; CUDA cores (f32) chunk {KA.LATENT_CHUNK}, clusters of "
          f"{KA.LATENT_CLUSTER}, "
          f"{KA.latent_working_ctas(lens_l, torch.float32)} working; {sms} "
          f"SMs [{tag}]", flush=True)
    check(working > sms, f"phase 13d: only {working} latent B5 CTAs do work "
          f"on {sms} SMs")
    return res


# ---------------------------------------------------------------------------
# Phase 14: serving the MoE family (qwen3-moe-235b-a22b, arctic-480b) over
# the compressed KV cache.
# ---------------------------------------------------------------------------

# qwen3-moe's depth on one card: 12 of its 94 layers (4.634 GiB of bf16
# params a layer, 2.318 GiB of embedding and lm_head: 57.9 GiB)
MOE_LAYERS = 12
MOE_PEAK_GIB = 72.0
MOE_GROUPS = {16: (64, 4), 7: (56, 8)}    # G: (Hq, Hkv) of qwen3-moe, arctic


def _qwen3moe(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("qwen3_moe_235b_a22b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _arctic(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("arctic_480b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def phase_moe_kernels(dev) -> dict:
    """14a: the kernels at the MoE path's shapes against their plain
    versions: B3's ring step, prefill fill and lane flush at 4 KV heads of
    128 byte for byte; B5 at qwen3-moe's 64/4 (a group of 16: two head
    slices) and arctic's 56/8 (7), 4 and 8 bits, lengths 0, 1, CHUNK - 1,
    CHUNK, CHUNK + 1 and 2,048 of S 2,048, within ATTN_TOL and
    bit-identical on a second call, every launch counted at its group; B6
    at 64/4 heads of 128 (bf16 on the tensor cores, f32), within ATTN_TOL
    and ATTN_NORM_TOL."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    res = {k: {"cases": 0, "mismatches": 0, "err": 0.0}
           for k in ("qpack_ring_step_moe", "qpack_prefill_fill_moe",
                     "qpack_lane_flush_moe", "kvc_decode_attention_g16",
                     "kvc_decode_attention_g7", "flash_attention_moe")}
    W, S = SERVE_CFG["hot_window"], SERVE_MAX_LEN
    _ring_cases(res["qpack_ring_step_moe"], qpack, dev, shapes=((8, 4, 128),))
    _fill_cases(res["qpack_prefill_fill_moe"], qpack, dev, shapes=[
        (1, 1024, S, W, 4, 128, [1000]), (4, 1024, S, W, 4, 128,
                                          [1024, 700, 513, 300]),
        (4, 40, 49, 8, 4, 128, [40, 5, 1, 23])])
    _flush_cases(res["qpack_lane_flush_moe"], qpack, dev, shapes=((4, 128),))
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    c = KA.CHUNK
    lens_l = [0, 1, c - 1, c, c + 1, S]
    B, D, sm = len(lens_l), 128, 1.0 / 128 ** 0.5
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    KA.group_launches.clear()
    calls = 0
    for G, (hq, hkv) in MOE_GROUPS.items():
        r = res[f"kvc_decode_attention_g{G}"]
        for bits in (4, 8):
            q = torch.randn((B, hq, D), generator=gen, device=dev) \
                .to(torch.bfloat16)
            (kc, ks), (vc, vs) = [
                (c_, s_[..., 0].contiguous()) for c_, s_ in (
                    qpack.encode(torch.randn((B, S, hkv, D), generator=gen,
                                             device=dev), bits, D)
                    for _ in range(2))]
            got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
            again = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
            gotn = KA.kvc_decode_attention(q, kc, ks, vc, vs, lens,
                                           bits=bits)
            calls += 3
            check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, again)),
                  f"phase 14a: B5 partials differ between two calls (G {G}, "
                  f"bits {bits})")
            want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits,
                                               sm)
            wantn = KA.kvc_decode_attention_plain(q, kc, ks, vc, vs, lens,
                                                  bits, sm)
            for a, b in list(zip(got, want)) + [(gotn, wantn)]:
                a, b = a.float(), b.float()
                r["cases"] += 1
                r["mismatches"] += int(((a - b).abs() > ATTN_TOL[
                    torch.bfloat16] * (1 + b.abs())).sum())
                r["err"] = max(r["err"], float((a - b).abs().max()))
    groups = dict(KA.group_launches)
    check(groups == {G: calls // 2 for G in MOE_GROUPS}, f"phase 14a: B5 "
          f"launches by group {groups}, {calls // 2} a group expected")
    r = res["flash_attention_moe"]
    tc0, tc_cases = FA.launches_tc, 0
    hq, hkv = MOE_GROUPS[16]
    for Sq, Sk, Bf in ((1, 1, 2), (8, 8, 2), (100, 100, 2), (24, 200, 2),
                       (1000, 1000, 1), (1024, 1024, 2)):
        for dt in (torch.bfloat16, torch.float32):
            for causal in (True, False):
                q = torch.randn((Bf, Sq, hq, D), generator=gen,
                                device=dev).to(dt)
                k, v = (torch.randn((Bf, Sk, hkv, D), generator=gen,
                                    device=dev).to(dt) for _ in range(2))
                tc_cases += dt == torch.bfloat16
                _flash_case(r, FA, q, k, v, causal)
    torch.cuda.synchronize()
    check(FA.launches_tc - tc0 == tc_cases, f"phase 14a: {tc_cases} bf16 "
          f"cases launched the tensor-core route {FA.launches_tc - tc0} "
          "times")
    print(f"phase 14a MoE path kernels vs plain (B3's steps at 4 KV heads x "
          f"128; B5 at 64/4 and 56/8, lengths {lens_l} of {S}, head slices "
          f"of {KA.SLICE_HEADS}: {KA.head_slices(16)} at G 16, "
          f"{KA.head_slices(7)} at G 7; B6 at 64/4): {json.dumps(res)} | "
          f"B5 launches by group {json.dumps(groups)}, bit-identical on a "
          f"second call; B6 {tc_cases} bf16 cases on the tensor cores | "
          f"tolerance |kernel - plain| <= tol * (1 + |plain|), tol 2e-2 "
          f"(bf16 q or B6) and 2e-3 (f32 B6); B6 also normwise 1e-2 / 1e-4; "
          f"B3's steps byte for byte", flush=True)
    for k, v in res.items():
        check(v["mismatches"] == 0, f"phase 14a: {k} disagrees with its "
              f"plain version in {v['mismatches']} elements/rows")
    check(r["norm_fails"] == 0, "phase 14a: B6 at 64/4 is off its plain "
          "version normwise")
    return res


def _tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def phase_serve_moe(dev, tag: str) -> tuple:
    """14b: qwen3-moe at its published widths, MOE_LAYERS of its 94 layers
    (bf16 params from the seed, made on the card), served through Engine
    with phase 7's recipe; peak memory under MOE_PEAK_GIB; routed pairs
    dropped a decode step (capacity ceil(8 x 8 x 1.25 / 128) = 1 at 8
    lanes); launches against the expectations (the ring step and B5 one a
    layer a step, every B5 at a group of 16; the prefill fill and B6 one a
    layer a prefill batch; the lane flush one a lane demotion; the MLA
    forms and B3/B4 none); then torch.profiler over PROFILE_STEPS decode
    steps of 8 lanes: the device busy share and the top kernels."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import decode as D
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = _qwen3moe(MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    p_bytes = _tree_bytes(params)
    scfg = ServeConfig(**SERVE_CFG)
    prompts = _prompts(SERVE_REQUESTS, cfg.vocab_size, SEED)
    timed = {}
    lanes = scfg.max_running
    with _RouteRecorder(lanes) as rec:
        eng, wall, t_pre, t_step, launches = _serve(
            cfg, scfg, params, prompts, SERVE_NEW_TOKENS, dev,
            hooks=[(FA, "flash_attention", "b6")], timed=timed)
    groups = dict(KA.group_launches)
    c = eng.counters
    mo = cfg.moe
    cap = MOE.capacity(mo.top_k, lanes, mo.num_experts)
    check(len(rec.choices) == c["steps"] * cfg.num_layers,
          f"phase 14b: {len(rec.choices)} decode routings recorded, "
          f"{c['steps'] * cfg.num_layers} expected")
    counts = torch.stack([torch.bincount(t.reshape(-1),
                                         minlength=mo.num_experts)
                          for t in rec.choices])
    dropped = int((counts - cap).clamp(min=0).sum())
    n_prompt = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 14b serve moe: {describe(cfg)} ({cfg.param_count()} "
          f"params, {p_bytes} B = {p_bytes / 2**30:.3f} GiB of bf16 params "
          f"from seed {SEED}, {t_init:.3f} s; {MOE_LAYERS} of the published "
          f"94 layers) | {SERVE_REQUESTS} requests, prompts "
          f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens, "
          f"{SERVE_NEW_TOKENS} new each, {lanes} lanes, max_len "
          f"{SERVE_MAX_LEN}, W {scfg.hot_window}, {scfg.kv_rate_bits}-bit KV "
          f"| wall {wall:.3f} s | prefill {n_prompt} prompt tokens in "
          f"{t_pre:.3f} s device = {n_prompt / t_pre:.3f} tokens/s | decode "
          f"{c['tokens']} tokens in {c['steps']} steps, {t_step:.3f} s "
          f"device = {c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | KV cache "
          f"{D.cache_bytes(eng.cache) / 2**30:.6f} GiB "
          f"({D.cache_bytes(eng.cache)} B), peak memory {peak:.3f} GiB "
          f"(limit {MOE_PEAK_GIB}) [{tag}]", flush=True)
    print(f"phase 14b counters: {json.dumps(c)} | preempt "
          f"{c['preempt_bytes']} B, resume {c['resume_bytes']} B | routed "
          f"pairs dropped: {dropped} over {c['steps']} decode steps x "
          f"{cfg.num_layers} layers = {dropped / c['steps']:.3f} a step, "
          f"{dropped / len(rec.choices):.3f} a layer-step of "
          f"{lanes * mo.top_k} pairs (capacity {cap} a expert)", flush=True)
    t_b6, n_b6 = timed["b6"]
    Lyr = cfg.num_layers
    want = {"qpack_ring_step": c["steps"] * Lyr,
            "kvc_decode_attention": c["steps"] * Lyr,
            "qpack_prefill_fill": c["prefill_batches"] * Lyr,
            "flash_attention": c["prefill_batches"] * Lyr,
            "flash_attention_tc": c["prefill_batches"] * Lyr,
            "qpack_lane_flush": c["demotions"] - c["shadow_repreempts"]}
    want.update({k: 0 for k in launches if k not in want})
    print(f"phase 14b launches: {json.dumps(launches)} | expected "
          f"{json.dumps(want)} (the ring step and B5 one a layer a step, the "
          f"fill and B6 one a layer a prefill batch, the flush one a lane "
          f"demotion) | B5 by group {json.dumps(groups)} | B6 in prefill: "
          f"{n_b6} calls, {t_b6:.6f} s device = {t_b6 / t_pre:.4f} of "
          f"prefill [{tag}]", flush=True)
    check(c["demotions"] > 0 and c["promotions"] > 0,
          "phase 14b: no demotion or promotion")
    check(launches == want and n_b6 == want["flash_attention"] and
          all(launches[k] > 0 for k in GQA_STEPS),
          f"phase 14b: launches {launches} against {want}")
    check(groups == {16: want["kvc_decode_attention"]},
          f"phase 14b: B5 launched at groups {groups}, not all at 16")
    check(peak < MOE_PEAK_GIB, f"phase 14b: peak memory {peak:.3f} GiB")
    del rec, counts

    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    for p in _prompts(lanes, cfg.vocab_size, SEED + 4):
        eng.submit(p, max_new_tokens=SERVE_NEW_TOKENS)
    for _ in range(3):                  # admission, prefill, warm steps
        eng.step()
    busy = _profile_line(eng, "14b", tag, b5_per_step=cfg.num_layers)
    del eng, params
    launches["kvc_decode_attention_g16"] = groups.get(16, 0)
    return launches, {"t_pre": t_pre, "t_step": t_step, "wall": wall,
                      "counters": c, "busy": busy, "peak_gib": peak,
                      "dropped": dropped}


def phase_moe_times(dev, tag: str, lens_l) -> dict:
    """14d: the kernels at the MoE path's shapes (8 lanes): B3's three
    steps at 4 KV heads of 128 (the flush over MOE_LAYERS layers), B5 at
    qwen3-moe's 64/4 and arctic's 56/8, B6 at 64/4 x 8, 4 and 1 rows of
    1,024: kernel / eager / plain / library / bound ms."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    B, D = SERVE_CFG["max_running"], 128
    bits, W, S = SERVE_CFG["kv_rate_bits"], SERVE_CFG["hot_window"], \
        SERVE_MAX_LEN
    Dp, bf = D * bits // 8, torch.bfloat16
    Hkv = MOE_GROUPS[16][1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    out = {}
    pos = torch.tensor(lens_l + W, dtype=torch.int32, device=dev)
    ring = ring_inputs(B, Hkv, D, bits, bf, bf, gen, dev, W=W, S=S)[:4]
    ring_args = [ring[0][0], ring[1][0], ring[2][0], ring[0][1], ring[1][1],
                 ring[2][1], ring[3][0], ring[3][1], pos, pos - W, bits]
    out["qpack_ring_step_moe"] = dict(
        shape=f"{B} lanes x {Hkv} KV heads x {D}, bf16 ring of {W}, "
              f"{bits}-bit codes of {S}, every lane evicting",
        kern=lambda: qpack.ring_step(*ring_args),
        plain=lambda: qpack.ring_step_plain(*ring_args), lib=None,
        nbytes=2 * B * Hkv * (6 * D + Dp + 4) + 8 * B, ops=0, reps=200)
    kvf, leaves, lens1 = fill_inputs(1, 1024, S, W, Hkv, D, bits, bf, [1000],
                                     gen, dev)
    out["qpack_prefill_fill_moe"] = dict(
        shape=f"1x1024x{Hkv}x{D} K and V bf16 -> {bits}-bit codes of {S} "
              f"and a ring of {W} (a prefill layer)",
        kern=lambda: qpack.prefill_fill(kvf[0], kvf[1], *leaves, lens1, bits),
        plain=lambda: qpack.prefill_fill_plain(kvf[0], kvf[1], *leaves,
                                               lens1, bits), lib=None,
        nbytes=2 * (1024 * Hkv * (2 * D + Dp + 4) + W * Hkv * 2 * D) + 4,
        ops=0, reps=200)
    lyr, posf = MOE_LAYERS, 1000
    fl = flush_inputs(lyr, B, S, W, Hkv, D, bits, gen, dev)
    lane = [t[:, 1] for t in fl]
    cold_f = torch.full((lyr, B), posf - W, dtype=torch.int32, device=dev)
    out["qpack_lane_flush_moe"] = dict(
        shape=f"lane 1 of {B}: {lyr} layers, a live ring of {W} x {Hkv} x "
              f"{D} bf16 -> {bits}-bit codes of {S}",
        kern=lambda: qpack.lane_flush(*lane, cold_f[:, 1], posf, bits),
        plain=lambda: qpack.lane_flush_plain(*lane, cold_f[:, 1], posf,
                                             bits), lib=None,
        nbytes=lyr * (W * Hkv * 2 * (2 * D + Dp + 4) + 8), ops=0, reps=50)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    tok = int(lens.sum())
    for G, (hq, hkv) in MOE_GROUPS.items():
        q = torch.randn((B, hq, D), generator=gen, device=dev).to(bf)
        (kc, ks), (vc, vs) = (qpack.encode(torch.randn(
            (B, S, hkv, D), generator=gen, device=dev), bits, D)
            for _ in range(2))
        kdq = qpack.decode(kc, ks, bits, D, bf)
        vdq = qpack.decode(vc, vs, bits, D, bf)
        ks1, vs1 = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        out[f"kvc_decode_attention_g{G}"] = dict(
            shape=f"q {B}x{hq}x{D} bf16 (G {G}, {KA.head_slices(G)} head "
                  f"slices), {bits}-bit KV {B}x{S}x{hkv}, lengths "
                  f"{lens_l.tolist()}",
            kern=lambda q=q, a=(kc, ks1, vc, vs1): KA.kvc_decode_partial(
                q, *a, lens, bits=bits),
            plain=lambda q=q, a=(kc, ks1, vc, vs1):
                KA.kvc_decode_partial_plain(q, *a, lens, bits,
                                            1.0 / D ** 0.5),
            lib=lambda q=q, k=kdq, v=vdq: _sdpa(q[:, None], k, v, False,
                                                mask),
            nbytes=tok * hkv * 2 * (Dp + 4) + B * hq * D * 2 + B * 4
            + B * hq * (D + 2) * 4,
            ops=4 * tok * hq * D, reps=50)
    hq, hkv = MOE_GROUPS[16]
    Sp = 1024
    qf, kf, vf = (torch.randn((B, Sp, h, D), generator=gen, device=dev)
                  .to(bf) for h in (hq, hkv, hkv))
    for rows in (B, 4, 1):
        q_, k_, v_ = qf[:rows], kf[:rows], vf[:rows]
        out["flash_attention_moe" + ("" if rows == B else f"_{rows}x{Sp}")] = \
            dict(shape=f"q {rows}x{Sp}x{hq}x{D}, kv {rows}x{Sp}x{hkv}x{D} "
                       f"bf16 causal",
                 kern=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention(
                     q_, k_, v_, causal=True),
                 plain=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention_plain(
                     q_, k_, v_, causal=True),
                 lib=lambda q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, True),
                 nbytes=2 * rows * Sp * D * (2 * hq + 2 * hkv),
                 ops=4 * rows * hq * D * Sp * (Sp + 1) // 2, reps=5)
    res = _time_rows(out, "14d", tag)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for G, (hq, hkv) in MOE_GROUPS.items():
        per = hkv * KA.head_slices(G)
        working = per * sum(len(KA.chunk_plan(int(n))) for n in lens_l)
        print(f"phase 14d kvc_decode_attention_g{G} split: chunk {KA.CHUNK}, "
              f"{hkv} KV heads x {KA.head_slices(G)} head slices, grid "
              f"{B * per * len(KA.chunk_plan(S))} CTAs of which {working} do "
              f"work, {sms} SMs [{tag}]", flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 15: the frontend backbones (chameleon-34b, musicgen-medium) over the
# compressed KV cache, and the SSM family (falcon-mamba-7b, Mamba1), which
# has no KV cache.
# ---------------------------------------------------------------------------

FRONT_PEAK_GIB = MOE_PEAK_GIB
FRONT_NEW_TOKENS = 32
# the frontend backbones' attention shapes (phase_attn_kernels and
# phase_attn_times): B3's steps at musicgen's (name, Hkv, D); B5 and B6 at
# each model's name: ((Hq, Hkv, D), B5's row key): chameleon-34b (a group
# of 8) and musicgen-medium (MHA at D 64, a group of 1)
FRONT_ATTN = {"b3": ("musicgen", 24, 64), "heads": {
    "chameleon": ((64, 8, 128), "g8"), "musicgen": ((24, 24, 64), "g1")}}
# falcon-mamba's prompts: seeded multiples of its scan chunk (128) in
# [384, 1024], since the reference refuses a longer prompt that is not a
# multiple of the chunk (ROADMAP C10); 15e's are 128 or 256
SSM_PROMPT_CHUNKS = (3, 9)
SSM_WHOLE_CHUNKS = (1, 3)
# depths of 15d (of falcon-mamba-7b's 64 layers), 15b (of chameleon-34b's
# 48) and 15c (of musicgen-medium's 48): cut to keep the script near its
# 900 s target once phase 16 came in (PERF.md §4), 15d first as the longest
# serving prefill; 15b again (24 -> 12) for phase 18; 15c (48 -> 24) for
# phase 19
SSM_SERVE_LAYERS = 16
CHAMELEON_SERVE_LAYERS = 12
MUSICGEN_SERVE_LAYERS = 24
# bytes of one parked falcon-mamba lane at 15d's depth: each layer's h
# (8192 x 16 f32) and conv tail (3 x 8192 bf16)
SSM_PARK_BYTES = SSM_SERVE_LAYERS * (8192 * 16 * 4 + 3 * 8192 * 2)
# 15e's falcon-mamba, card against CPU in float32: logits normwise per row
# (test_torch_model.py's float32 bound)
SSM_WHOLE_TOL = 1e-4


def _chameleon(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("chameleon_34b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _musicgen(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("musicgen_medium")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _falcon(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("falcon_mamba_7b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def _ssm_prompts(n: int, vocab: int, seed: int, chunk: int,
                 chunks=SSM_PROMPT_CHUNKS):
    rng = np.random.default_rng(seed)
    lens = rng.integers(*chunks, size=n) * chunk
    return [rng.integers(1, vocab, size=int(L)).tolist() for L in lens]


def phase_attn_kernels(dev, label: str, what: str, attn: dict,
                       seed: int) -> dict:
    """15a / 16a: the kernels at a cell's attention shapes against their
    plain versions (``attn``: FRONT_ATTN or HYBRID_ATTN): B3's ring step,
    prefill fill and lane flush at one model's KV heads byte for byte; B5
    at each model's heads (a group of Hq / Hkv), 4 and 8 bits, lengths 0,
    1, CHUNK - 1, CHUNK, CHUNK + 1 and 2,048 of S 2,048, within ATTN_TOL
    and bit-identical on a second call, every launch counted at its group;
    B6 at each model's heads (bf16 on the tensor cores, f32), causal and
    full, within ATTN_TOL and ATTN_NORM_TOL."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    t0 = time.perf_counter()
    b3, b3_hkv, b3_D = attn["b3"]
    res = {k: {"cases": 0, "mismatches": 0, "err": 0.0} for k in (
        [f"qpack_{s}_{b3}" for s in ("ring_step", "prefill_fill",
                                     "lane_flush")]
        + [f"kvc_decode_attention_{k}" for _, k in attn["heads"].values()]
        + [f"flash_attention_{n}" for n in attn["heads"]])}
    W, S = SERVE_CFG["hot_window"], SERVE_MAX_LEN
    _ring_cases(res[f"qpack_ring_step_{b3}"], qpack, dev,
                shapes=((8, b3_hkv, b3_D),))
    _fill_cases(res[f"qpack_prefill_fill_{b3}"], qpack, dev, shapes=[
        (1, 1024, S, W, b3_hkv, b3_D, [1000]),
        (4, 1024, S, W, b3_hkv, b3_D, [1024, 700, 513, 300]),
        (4, 40, 49, 8, b3_hkv, b3_D, [40, 5, 1, 23])])
    _flush_cases(res[f"qpack_lane_flush_{b3}"], qpack, dev,
                 shapes=((b3_hkv, b3_D),))
    t_b3 = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = KA.CHUNK
    lens_l = [0, 1, c - 1, c, c + 1, S]
    B = len(lens_l)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    KA.group_launches.clear()
    calls = {}
    for (hq, hkv, D), key in attn["heads"].values():
        G, sm = hq // hkv, 1.0 / D ** 0.5
        r = res[f"kvc_decode_attention_{key}"]
        for bits in (4, 8):
            q = torch.randn((B, hq, D), generator=gen, device=dev) \
                .to(torch.bfloat16)
            (kc, ks), (vc, vs) = [
                (c_, s_[..., 0].contiguous()) for c_, s_ in (
                    qpack.encode(torch.randn((B, S, hkv, D), generator=gen,
                                             device=dev), bits, D)
                    for _ in range(2))]
            got = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
            again = KA.kvc_decode_partial(q, kc, ks, vc, vs, lens, bits=bits)
            gotn = KA.kvc_decode_attention(q, kc, ks, vc, vs, lens,
                                           bits=bits)
            calls[G] = calls.get(G, 0) + 3
            check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                      for a, b in zip(got, again)),
                  f"phase {label}: B5 partials differ between two calls "
                  f"({hq}/{hkv} x {D}, bits {bits})")
            want = KA.kvc_decode_partial_plain(q, kc, ks, vc, vs, lens, bits,
                                               sm)
            wantn = KA.kvc_decode_attention_plain(q, kc, ks, vc, vs, lens,
                                                  bits, sm)
            for a, b in list(zip(got, want)) + [(gotn, wantn)]:
                a, b = a.float(), b.float()
                r["cases"] += 1
                r["mismatches"] += int(((a - b).abs() > ATTN_TOL[
                    torch.bfloat16] * (1 + b.abs())).sum())
                r["err"] = max(r["err"], float((a - b).abs().max()))
    groups = dict(KA.group_launches)
    check(groups == calls, f"phase {label}: B5 launches by group {groups}, "
          f"{calls} expected")
    tc0, tc_cases = FA.launches_tc, 0
    for name, ((hq, hkv, D), _) in attn["heads"].items():
        r = res[f"flash_attention_{name}"]
        for Sq, Sk, Bf in ((1, 1, 2), (8, 8, 2), (100, 100, 2), (24, 200, 2),
                           (1000, 1000, 1), (1024, 1024, 2)):
            for dt in (torch.bfloat16, torch.float32):
                for causal in (True, False):
                    q = torch.randn((Bf, Sq, hq, D), generator=gen,
                                    device=dev).to(dt)
                    k, v = (torch.randn((Bf, Sk, hkv, D), generator=gen,
                                        device=dev).to(dt) for _ in range(2))
                    tc_cases += dt == torch.bfloat16
                    _flash_case(r, FA, q, k, v, causal)
    torch.cuda.synchronize()
    check(FA.launches_tc - tc0 == tc_cases, f"phase {label}: {tc_cases} "
          f"bf16 cases launched the tensor-core route "
          f"{FA.launches_tc - tc0} times")
    heads = " and ".join(f"{hq}/{hkv} x {D}"
                         for (hq, hkv, D), _ in attn["heads"].values())
    print(f"phase {label} {what} kernels vs plain (B3's steps at {b3_hkv} KV "
          f"heads x {b3_D}; B5 at {heads}, lengths {lens_l} of {S}; B6 at "
          f"{heads}): {json.dumps(res)} | B5 launches by group "
          f"{json.dumps(groups)}, bit-identical on a second call; B6 "
          f"{tc_cases} bf16 cases on the tensor cores | tolerance |kernel - "
          f"plain| <= tol * (1 + |plain|), tol 2e-2 (bf16 q or B6) and 2e-3 "
          f"(f32 B6); B6 also normwise 1e-2 / 1e-4; B3's steps byte for "
          f"byte | B3 {t_b3:.3f} s, wall {time.perf_counter() - t0:.3f} s",
          flush=True)
    for k, v in res.items():
        check(v["mismatches"] == 0, f"phase {label}: {k} disagrees with its "
              f"plain version in {v['mismatches']} elements/rows")
        check(v.get("norm_fails", 0) == 0, f"phase {label}: {k} is off its "
              "plain version normwise")
    return res


def phase_serve_frontend(dev, model, label: str, tag: str) -> tuple:
    """15b/15c: a frontend backbone at its published widths (15b at
    CHAMELEON_SERVE_LAYERS of its layers; bf16 params from the seed, made
    on the card; the engine feeds the frontend stub
    zero embeddings, as the reference's does) served through Engine with
    phase 7's engine, 16 requests of FRONT_NEW_TOKENS new tokens; peak
    memory under FRONT_PEAK_GIB; launches against the expectations (the
    ring step and B5 one a layer a step, every B5 at the model's group;
    the prefill fill and B6 one a layer a prefill batch, all bf16 B6 on
    the tensor cores; the lane flush one a lane demotion; the MLA forms
    and B3/B4 none); then torch.profiler over PROFILE_STEPS decode steps
    of 8 lanes."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    cfg = model()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    p_bytes = _tree_bytes(params)
    scfg = ServeConfig(**SERVE_CFG)
    prompts = _prompts(SERVE_REQUESTS, cfg.vocab_size, SEED)
    timed = {}
    eng, wall, t_pre, t_step, launches = _serve(
        cfg, scfg, params, prompts, FRONT_NEW_TOKENS, dev,
        hooks=[(FA, "flash_attention", "b6")], timed=timed)
    groups = dict(KA.group_launches)
    c = eng.counters
    n_prompt = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    kv = D.cache_bytes(eng.cache)
    print(f"phase {label} serve {cfg.name}: {describe(cfg)} "
          f"({cfg.param_count()} params, {p_bytes} B = "
          f"{p_bytes / 2**30:.3f} GiB of bf16 params from seed {SEED}, "
          f"{t_init:.3f} s; frontend {cfg.frontend} fed zero embeddings) | "
          f"{SERVE_REQUESTS} requests, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {FRONT_NEW_TOKENS} new each, "
          f"{scfg.max_running} lanes, max_len {SERVE_MAX_LEN}, W "
          f"{scfg.hot_window}, {scfg.kv_rate_bits}-bit KV | wall {wall:.3f} "
          f"s | prefill {n_prompt} prompt tokens in {t_pre:.3f} s device = "
          f"{n_prompt / t_pre:.3f} tokens/s | decode {c['tokens']} tokens in "
          f"{c['steps']} steps, {t_step:.3f} s device = "
          f"{c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | KV cache "
          f"{kv / 2**30:.6f} GiB ({kv} B), peak memory {peak:.3f} GiB "
          f"(limit {FRONT_PEAK_GIB}) [{tag}]", flush=True)
    print(f"phase {label} counters: {json.dumps(c)} | preempt "
          f"{c['preempt_bytes']} B, resume {c['resume_bytes']} B", flush=True)
    t_b6, n_b6 = timed["b6"]
    Lyr = cfg.num_layers
    want = {"qpack_ring_step": c["steps"] * Lyr,
            "kvc_decode_attention": c["steps"] * Lyr,
            "qpack_prefill_fill": c["prefill_batches"] * Lyr,
            "flash_attention": c["prefill_batches"] * Lyr,
            "flash_attention_tc": c["prefill_batches"] * Lyr,
            "qpack_lane_flush": c["demotions"] - c["shadow_repreempts"]}
    want.update({k: 0 for k in launches if k not in want})
    G = cfg.num_heads // cfg.num_kv_heads
    print(f"phase {label} launches: {json.dumps(launches)} | expected "
          f"{json.dumps(want)} (the ring step and B5 one a layer a step, the "
          f"fill and B6 one a layer a prefill batch, the flush one a lane "
          f"demotion) | B5 by group {json.dumps(groups)} | B6 in prefill: "
          f"{n_b6} calls, {t_b6:.6f} s device = {t_b6 / t_pre:.4f} of "
          f"prefill [{tag}]", flush=True)
    check(c["demotions"] > 0 and c["promotions"] > 0,
          f"phase {label}: no demotion or promotion")
    check(launches == want and n_b6 == want["flash_attention"] and
          all(launches[k] > 0 for k in GQA_STEPS),
          f"phase {label}: launches {launches} against {want}")
    check(groups == {G: want["kvc_decode_attention"]},
          f"phase {label}: B5 launched at groups {groups}, not all at {G}")
    check(peak < FRONT_PEAK_GIB, f"phase {label}: peak memory {peak:.3f} "
          "GiB")
    del eng
    torch.cuda.empty_cache()
    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    for p in _prompts(scfg.max_running, cfg.vocab_size, SEED + 4):
        eng.submit(p, max_new_tokens=FRONT_NEW_TOKENS)
    for _ in range(3):                  # admission, prefill, warm steps
        eng.step()
    busy = _profile_line(eng, label, tag, b5_per_step=Lyr)
    del eng, params
    launches[f"kvc_decode_attention_g{G}"] = groups.get(G, 0)
    print(f"phase {label} wall {time.perf_counter() - t0:.3f} s [{tag}]",
          flush=True)
    return launches, {"t_pre": t_pre, "t_step": t_step, "wall": wall,
                      "counters": c, "busy": busy, "peak_gib": peak}


class _PrefillRecorder:
    """Records the (tokens, lens) of every ``serve.engine._prefill_impl``
    call while it is entered (tensors kept on the card, read afterwards:
    no sync added)."""

    def __init__(self):
        from repro_torch.serve import engine as engine_mod
        self.mod, self.calls = engine_mod, []

    def __enter__(self):
        self.orig = self.mod._prefill_impl

        def prefill(params, batch, lens, **kw):
            self.calls.append((batch["tokens"].shape, lens))
            return self.orig(params, batch, lens, **kw)
        self.mod._prefill_impl = prefill
        return self

    def __exit__(self, *exc):
        self.mod._prefill_impl = self.orig


def phase_serve_ssm(dev, tag: str) -> dict:
    """15d: falcon-mamba-7b at its published widths, SSM_SERVE_LAYERS of
    its 64 layers (bf16 params from the seed, made on the card) served
    through Engine with
    phase 7's engine, 16 requests of FRONT_NEW_TOKENS new tokens, prompts
    seeded multiples of 128 (C10): no B3-B6 launch (no KV cache), every
    park and resume moving the raw state in full (SSM_PARK_BYTES a lane),
    every prefill batch an exact-length group; then torch.profiler over
    PROFILE_STEPS decode steps of 8 lanes."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    cfg = _falcon(SSM_SERVE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    p_bytes = _tree_bytes(params)
    scfg = ServeConfig(**SERVE_CFG)
    ssm = cfg.ssm
    d_in = ssm.expand * cfg.d_model
    park = cfg.num_layers * (d_in * ssm.d_state * 4 +
                             (ssm.d_conv - 1) * d_in * 2)
    check(park == SSM_PARK_BYTES, f"phase 15d: a lane's state is {park} B")
    prompts = _ssm_prompts(SERVE_REQUESTS, cfg.vocab_size, SEED, ssm.chunk)
    with _PrefillRecorder() as rec:
        eng, wall, t_pre, t_step, launches = _serve(
            cfg, scfg, params, prompts, FRONT_NEW_TOKENS, dev)
    c = eng.counters
    n_prompt = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    state = D.cache_bytes(eng.cache)
    groups = []
    for shape, lens in rec.calls:
        ln = lens.tolist()
        real = [n for n in ln if n != 1]        # pad rows have length 1
        groups.append((shape[1], len(real), shape[0]))
        check(len(real) >= 1 and all(n == shape[1] for n in real) and
              shape[0] == 1 << (len(ln) - 1).bit_length(),
              f"phase 15d: prefill batch {tuple(shape)} with lengths {ln} "
              "is not an exact-length group of power-of-two rows")
    resumes = c["promotions"] - SERVE_REQUESTS
    print(f"phase 15d serve {cfg.name}: {describe(cfg)} ({cfg.param_count()} "
          f"params, {p_bytes} B = {p_bytes / 2**30:.3f} GiB of bf16 params "
          f"from seed {SEED}, {t_init:.3f} s) | {SERVE_REQUESTS} requests, "
          f"prompts {sorted(set(map(len, prompts)))} tokens (multiples of "
          f"the scan chunk {ssm.chunk}: C10), {FRONT_NEW_TOKENS} new each, "
          f"{scfg.max_running} lanes, max_len {SERVE_MAX_LEN} | wall "
          f"{wall:.3f} s | prefill {n_prompt} prompt tokens in {t_pre:.3f} s "
          f"device = {n_prompt / t_pre:.3f} tokens/s | decode {c['tokens']} "
          f"tokens in {c['steps']} steps, {t_step:.3f} s device = "
          f"{c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | recurrent state "
          f"{state / 2**30:.6f} GiB ({state} B, {park} B a lane), peak "
          f"memory {peak:.3f} GiB [{tag}]", flush=True)
    print(f"phase 15d counters: {json.dumps(c)} | preempt "
          f"{c['preempt_bytes']} B = {c['demotions']} demotions x {park}, "
          f"resume {c['resume_bytes']} B = {resumes} resumes x {park} | "
          f"prefill batches (length, rows, padded rows): {groups} | "
          f"launches {json.dumps(launches)} (none expected: no KV cache)",
          flush=True)
    check(not any(launches.values()), f"phase 15d: a kernel launched on "
          f"the SSM path: {launches}")
    check(c["demotions"] > 0 and resumes > 0 and
          c["shadow_repreempts"] == 0, "phase 15d: no park or resume")
    check(c["preempt_bytes"] == c["demotions"] * park and
          c["resume_bytes"] == resumes * park,
          f"phase 15d: preempt {c['preempt_bytes']} B and resume "
          f"{c['resume_bytes']} B are not whole states")
    check(len(groups) == c["prefill_batches"] and
          sum(g[1] for g in groups) == SERVE_REQUESTS,
          f"phase 15d: {len(groups)} prefill batches recorded")
    del eng
    torch.cuda.empty_cache()
    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    # a decode step's cost does not depend on the prompt's length (an O(1)
    # state): one-chunk prompts keep the warm-up prefill short
    for p in _ssm_prompts(scfg.max_running, cfg.vocab_size, SEED + 4,
                          ssm.chunk, (1, 2)):
        eng.submit(p, max_new_tokens=FRONT_NEW_TOKENS)
    for _ in range(3):
        eng.step()
    busy = _profile_line(eng, "15d", tag)
    del eng, params
    print(f"phase 15d wall {time.perf_counter() - t0:.3f} s [{tag}]",
          flush=True)
    return {"t_pre": t_pre, "t_step": t_step, "wall": wall, "counters": c,
            "busy": busy, "peak_gib": peak}


def _params_to(params, dev):
    """A copy of a params tree on ``dev``."""
    if isinstance(params, dict):
        return {k: _params_to(v, dev) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, dev) for v in params]
    return params.to(dev)


def phase_ssm_whole(dev, layers: int = 2) -> dict:
    """15e falcon-mamba: ``layers`` layers at its full widths in float32
    (TF32 off), the same params on the card and on the CPU: a prefill of
    two 256-token rows, then WHOLE_STEPS decode steps fed the CPU's greedy
    tokens. Each card step is fed the CPU's state before it (the conv
    tail is bf16 in every dtype, as the reference keeps it, so an input
    within rounding of a bf16 boundary may round either way and move
    every later step): the prefill's and these steps' logits normwise per
    row within SSM_WHOLE_TOL. The card's own chained steps are reported
    beside them (logits error, argmax agreement, conv values one bf16
    step apart). Then 4 requests (prompts of 128 or 256 tokens) through
    Engine on each device, 2 lanes, 8 new each: identical generations and
    counters, no kernel launched."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_falcon(layers), dtype="float32")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed=SEED + 2, device=cpu)
    pc = _params_to(params, dev)
    scfg = ServeConfig(**dict(SERVE_CFG, max_running=2))
    tokens = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        1, cfg.vocab_size, (2, 2 * cfg.ssm.chunk)).astype(np.int32))
    _reset_launches()
    pos = torch.full((2,), tokens.shape[1], dtype=torch.int32)

    def run(p, d, feed=None, states=None):
        """Logits of the prefill and each step; each step from
        ``states[t]`` where given, else from the run's own state."""
        lg, cache = D.prefill(p, {"tokens": tokens.to(d)}, cfg, scfg,
                              SERVE_MAX_LEN)
        out, snaps = [lg.float().cpu()], []
        for t in range(WHOLE_STEPS):
            if states is not None:
                for k, v in states[t].items():
                    cache[k].copy_(v)
            snaps.append({k: v.clone() for k, v in cache.items()})
            tok = out[-1].argmax(-1).to(torch.int32) if feed is None \
                else feed[t]
            lg, _ = D.decode_step(p, cache, tok.to(d), (pos + t).to(d), cfg,
                                  scfg)
            out.append(lg.float().cpu())
        return out, snaps, cache

    want, snaps, cpu_cache = run(params, cpu)
    feed = [w.argmax(-1).to(torch.int32) for w in want[:-1]]
    fed, _, _ = run(pc, dev, feed, snaps)
    chained, _, card_cache = run(pc, dev, feed)

    def compare(got):
        err, bad, agree, n = 0.0, 0, 0, 0
        for a, b in zip(got, want):
            bound = SSM_WHOLE_TOL * b.abs().amax(dim=-1)
            diff = (a - b).abs().amax(dim=-1)
            err = max(err, float(diff.max()))
            bad += int((diff > bound).sum())
            agree += int((a.argmax(-1) == b.argmax(-1)).sum())
            n += b.shape[0]
        return err, bad, agree, n

    err, bad, agree, n = compare(fed)
    c_err, c_bad, c_agree, _ = compare(chained)
    conv_c, conv_w = card_cache["ssm.conv"].cpu().float(), \
        cpu_cache["ssm.conv"].float()
    flips = int((conv_c != conv_w).sum())
    h_err = float((card_cache["ssm.h"].cpu() - cpu_cache["ssm.h"])
                  .abs().max())
    prompts = _ssm_prompts(4, cfg.vocab_size, SEED + 2, cfg.ssm.chunk,
                           SSM_WHOLE_CHUNKS)
    served = {}
    for name, p, d in (("cpu", params, cpu), ("card", pc, dev)):
        eng = Engine(cfg, scfg, p, max_len=SERVE_MAX_LEN, device=d)
        rids = [eng.submit(q, max_new_tokens=8) for q in prompts]
        eng.run_until_done(max_steps=400)
        served[name] = ([eng.result(r) for r in rids], dict(eng.counters))
        del eng
    launches = _launch_counts()
    same_gen = sum(x == y for x, y in zip(served["card"][0],
                                          served["cpu"][0]))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"phase 15e whole path float32, {cfg.name} {layers} layers at full "
          f"width, the card vs the CPU (TF32 off): prefill of 2 x "
          f"{tokens.shape[1]} + {WHOLE_STEPS} decode steps each fed the "
          f"CPU's state: logits max abs err {err:.8f}, {bad}/{n} rows "
          f"outside tol {SSM_WHOLE_TOL} * max|CPU row|, argmax {agree}/{n} "
          f"agree | the card's own chained steps: logits max abs err "
          f"{c_err:.8f}, {c_bad}/{n} rows outside, argmax {c_agree}/{n} "
          f"agree, h max abs err {h_err:.8f}, conv values differing "
          f"{flips} of {conv_w.numel()} | Engine (4 requests of "
          f"{[len(q) for q in prompts]} tokens, 2 lanes, 8 new): "
          f"{same_gen}/4 generations identical, counters equal: "
          f"{served['card'][1] == served['cpu'][1]} "
          f"({json.dumps(served['card'][1])}) | launches "
          f"{json.dumps(launches)} | wall {time.perf_counter() - t0:.3f} s",
          flush=True)
    check(bad == 0, f"phase 15e falcon-mamba: {bad} rows of logits outside "
          "tolerance")
    check(same_gen == 4 and served["card"][1] == served["cpu"][1],
          "phase 15e falcon-mamba: Engine on the card differs from the CPU")
    check(not any(launches.values()), "phase 15e falcon-mamba: a kernel "
          "launched on the SSM path")
    del params, pc
    return {"err": err, "chained_err": c_err, "same_gen": same_gen}


def phase_attn_times(dev, label: str, tag: str, attn: dict, seed: int,
                     lens_l, flush_layers: int, unit: str) -> dict:
    """15f / 16d: the kernels at a cell's attention shapes (8 lanes): B3's
    three steps at one model's KV heads (the flush over its
    ``flush_layers`` attention layers or sites), B5 at each model's heads,
    B6 at each x 8, 4 and 1 rows of 1,024: kernel / eager / plain /
    library / bound ms."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.kernels import qpack
    t0 = time.perf_counter()
    B = SERVE_CFG["max_running"]
    bits, W, S = SERVE_CFG["kv_rate_bits"], SERVE_CFG["hot_window"], \
        SERVE_MAX_LEN
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    b3, Hkv, D = attn["b3"]
    Dp = D * bits // 8
    pos = torch.tensor(lens_l + W, dtype=torch.int32, device=dev)
    ring = ring_inputs(B, Hkv, D, bits, bf, bf, gen, dev, W=W, S=S)[:4]
    ring_args = [ring[0][0], ring[1][0], ring[2][0], ring[0][1], ring[1][1],
                 ring[2][1], ring[3][0], ring[3][1], pos, pos - W, bits]
    out[f"qpack_ring_step_{b3}"] = dict(
        shape=f"{B} lanes x {Hkv} KV heads x {D}, bf16 ring of {W}, "
              f"{bits}-bit codes of {S}, every lane evicting",
        kern=lambda: qpack.ring_step(*ring_args),
        plain=lambda: qpack.ring_step_plain(*ring_args), lib=None,
        nbytes=2 * B * Hkv * (6 * D + Dp + 4) + 8 * B, ops=0, reps=200)
    kvf, leaves, lens1 = fill_inputs(1, 1024, S, W, Hkv, D, bits, bf, [1000],
                                     gen, dev)
    out[f"qpack_prefill_fill_{b3}"] = dict(
        shape=f"1x1024x{Hkv}x{D} K and V bf16 -> {bits}-bit codes of {S} "
              f"and a ring of {W} (a prefill {unit})",
        kern=lambda: qpack.prefill_fill(kvf[0], kvf[1], *leaves, lens1, bits),
        plain=lambda: qpack.prefill_fill_plain(kvf[0], kvf[1], *leaves,
                                               lens1, bits), lib=None,
        nbytes=2 * (1024 * Hkv * (2 * D + Dp + 4) + W * Hkv * 2 * D) + 4,
        ops=0, reps=200)
    lyr, posf = flush_layers, 1000
    fl = flush_inputs(lyr, B, S, W, Hkv, D, bits, gen, dev)
    lane = [t[:, 1] for t in fl]
    cold_f = torch.full((lyr, B), posf - W, dtype=torch.int32, device=dev)
    out[f"qpack_lane_flush_{b3}"] = dict(
        shape=f"lane 1 of {B}: {lyr} {unit}s, a live ring of {W} x {Hkv} x "
              f"{D} bf16 -> {bits}-bit codes of {S}",
        kern=lambda: qpack.lane_flush(*lane, cold_f[:, 1], posf, bits),
        plain=lambda: qpack.lane_flush_plain(*lane, cold_f[:, 1], posf,
                                             bits), lib=None,
        nbytes=lyr * (W * Hkv * 2 * (2 * D + Dp + 4) + 8), ops=0, reps=50)
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[
        :, None, None, :]
    tok = int(lens.sum())
    Sp = 1024
    for name, ((hq, hkv, D), key) in attn["heads"].items():
        G, Dp = hq // hkv, D * bits // 8
        q = torch.randn((B, hq, D), generator=gen, device=dev).to(bf)
        (kc, ks), (vc, vs) = (qpack.encode(torch.randn(
            (B, S, hkv, D), generator=gen, device=dev), bits, D)
            for _ in range(2))
        kdq = qpack.decode(kc, ks, bits, D, bf)
        vdq = qpack.decode(vc, vs, bits, D, bf)
        ks1, vs1 = ks[..., 0].contiguous(), vs[..., 0].contiguous()
        out[f"kvc_decode_attention_{key}"] = dict(
            shape=f"q {B}x{hq}x{D} bf16 (G {G}, {name}), {bits}-bit KV "
                  f"{B}x{S}x{hkv}, lengths {lens_l.tolist()}",
            kern=lambda q=q, a=(kc, ks1, vc, vs1): KA.kvc_decode_partial(
                q, *a, lens, bits=bits),
            plain=lambda q=q, a=(kc, ks1, vc, vs1), D=D:
                KA.kvc_decode_partial_plain(q, *a, lens, bits,
                                            1.0 / D ** 0.5),
            lib=lambda q=q, k=kdq, v=vdq: _sdpa(q[:, None], k, v, False,
                                                mask),
            nbytes=tok * hkv * 2 * (Dp + 4) + B * hq * D * 2 + B * 4
            + B * hq * (D + 2) * 4,
            ops=4 * tok * hq * D, reps=50)
        qf, kf, vf = (torch.randn((B, Sp, h, D), generator=gen, device=dev)
                      .to(bf) for h in (hq, hkv, hkv))
        for rows in (B, 4, 1):
            q_, k_, v_ = qf[:rows], kf[:rows], vf[:rows]
            out[f"flash_attention_{name}" +
                ("" if rows == B else f"_{rows}x{Sp}")] = dict(
                shape=f"q {rows}x{Sp}x{hq}x{D}, kv {rows}x{Sp}x{hkv}x{D} "
                      f"bf16 causal",
                kern=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention(
                    q_, k_, v_, causal=True),
                plain=lambda q_=q_, k_=k_, v_=v_: FA.flash_attention_plain(
                    q_, k_, v_, causal=True),
                lib=lambda q_=q_, k_=k_, v_=v_: _sdpa(q_, k_, v_, True),
                nbytes=2 * rows * Sp * D * (2 * hq + 2 * hkv),
                ops=4 * rows * hq * D * Sp * (Sp + 1) // 2, reps=5)
    res = _time_rows(out, label, tag)
    print(f"phase {label} wall {time.perf_counter() - t0:.3f} s [{tag}]",
          flush=True)
    return res


# ---------------------------------------------------------------------------
# Phase 16: the hybrid family (zamba2-2.7b: Mamba2 groups with shared
# attention) over the compressed KV cache, with B5 and B6 at head dim 80.
# ---------------------------------------------------------------------------

# zamba2-2.7b's shared attention, as FRONT_ATTN: MHA at D 80, a group of 1
HYBRID_ATTN = {"b3": ("hybrid", 32, 80),
               "heads": {"hybrid": ((32, 32, 80), "d80")}}
# one parked lane's raw Mamba2 state: 54 layers of h (80 x 64 x 64 f32)
# and the conv tail (3 x 5120 bf16)
HYBRID_STATE_BYTES = 54 * (80 * 64 * 64 * 4 + 3 * 5120 * 2)
# a token's compressed KV in a lane: 9 sites x 32 heads x K and V of 40
# code bytes and a 4-byte scale (4-bit)
HYBRID_TOKEN_BYTES = 9 * 32 * 2 * (80 * 4 // 8 + 4)
# the serving cache at SERVE_CFG: 9 sites' codes, scales, rings and
# cold_len, and 54 layers' state, 8 lanes
HYBRID_CACHE_BYTES = 1_183_482_144
# 16c's card against the CPU in float32: logits normwise per row
# (test_torch_model.py's float32 bound), each step fed the CPU's state
HYBRID_WHOLE_TOL = 1e-4
HYBRID_WHOLE_STEPS = 8


def _zamba2(layers=None):
    from repro_torch.configs import get_config
    cfg = get_config("zamba2_2p7b")
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


class _MovedRecorder:
    """Records every ``serve.engine._moved_bytes`` call while it is
    entered: (the raw-state bytes of the parked tree, n_tokens, the bytes
    charged)."""

    def __init__(self):
        from repro_torch.serve import engine as engine_mod
        self.mod, self.calls = engine_mod, []

    def __enter__(self):
        self.orig = self.mod._moved_bytes

        def moved(parked, n_tokens, max_len):
            out = self.orig(parked, n_tokens, max_len)
            state = sum(v.numel() * v.element_size()
                        for k, v in parked.items() if k.startswith("ssm."))
            self.calls.append((state, min(int(n_tokens), max_len), out))
            return out
        self.mod._moved_bytes = moved
        return self

    def __exit__(self, *exc):
        self.mod._moved_bytes = self.orig


def phase_serve_hybrid(dev, tag: str) -> dict:
    """16b: zamba2-2.7b at its published config (54 Mamba2 layers in 9
    groups, 2 shared attention blocks, 32/32 x 80; bf16 params from the
    seed, made on the card) served through Engine with phase 7's engine, 16
    requests of FRONT_NEW_TOKENS new tokens, prompts seeded multiples of
    128 (C10): launches against the expectations (the ring step and B5 one
    a group a step, all B5 at G 1; the fill and B6 one a group a prefill
    batch, all bf16 B6 on the tensor cores; the flush one a lane
    demotion); every park and resume moving HYBRID_STATE_BYTES of raw
    state plus HYBRID_TOKEN_BYTES a token of KV suffix; exact-length
    prefill groups; then torch.profiler over PROFILE_STEPS decode steps of
    8 lanes."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import describe
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import kvc_attn as KA
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    cfg = _zamba2()
    G, period, nshared = T.hybrid_groups(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    p_bytes = _tree_bytes(params)
    scfg = ServeConfig(**SERVE_CFG)
    prompts = _ssm_prompts(SERVE_REQUESTS, cfg.vocab_size, SEED,
                           cfg.ssm.chunk)
    timed = {}
    with _PrefillRecorder() as rec, _MovedRecorder() as mov:
        eng, wall, t_pre, t_step, launches = _serve(
            cfg, scfg, params, prompts, FRONT_NEW_TOKENS, dev,
            hooks=[(FA, "flash_attention", "b6")], timed=timed)
    groups_b5 = dict(KA.group_launches)
    c = eng.counters
    n_prompt = sum(len(p) for p in prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    cache_b = D.cache_bytes(eng.cache)
    state_b = sum(v.numel() * v.element_size() for k, v in eng.cache.items()
                  if k.startswith("ssm."))
    batches = []
    for shape, lens in rec.calls:
        ln = lens.tolist()
        real = [n for n in ln if n != 1]        # pad rows have length 1
        batches.append((shape[1], len(real), shape[0]))
        check(len(real) >= 1 and all(n == shape[1] for n in real) and
              shape[0] == 1 << (len(ln) - 1).bit_length(),
              f"phase 16b: prefill batch {tuple(shape)} with lengths {ln} "
              "is not an exact-length group of power-of-two rows")
    bad_moves = [m for m in mov.calls if m[0] != HYBRID_STATE_BYTES or
                 m[2] != HYBRID_STATE_BYTES + HYBRID_TOKEN_BYTES * m[1]]
    n_parks = c["demotions"] - c["shadow_repreempts"]
    resumes = c["promotions"] - SERVE_REQUESTS
    print(f"phase 16b serve {cfg.name}: {describe(cfg)} ({cfg.param_count()} "
          f"params, {p_bytes} B = {p_bytes / 2**30:.3f} GiB of bf16 params "
          f"from seed {SEED}, {t_init:.3f} s; {G} groups of {period} Mamba2 "
          f"layers, {nshared} shared blocks) | {SERVE_REQUESTS} requests, "
          f"prompts {sorted(set(map(len, prompts)))} tokens (multiples of the "
          f"scan chunk {cfg.ssm.chunk}: C10), {FRONT_NEW_TOKENS} new each, "
          f"{scfg.max_running} lanes, max_len {SERVE_MAX_LEN}, W "
          f"{scfg.hot_window}, {scfg.kv_rate_bits}-bit KV | wall {wall:.3f} s "
          f"| prefill {n_prompt} prompt tokens in {t_pre:.3f} s device = "
          f"{n_prompt / t_pre:.3f} tokens/s | decode {c['tokens']} tokens in "
          f"{c['steps']} steps, {t_step:.3f} s device = "
          f"{c['tokens'] / t_step:.3f} tokens/s, "
          f"{1e3 * t_step / c['steps']:.3f} ms per step | KV cache plus "
          f"state {cache_b} B ({cache_b - state_b} B KV, {state_b} B state, "
          f"{HYBRID_STATE_BYTES} B a lane), peak memory {peak:.3f} GiB "
          f"[{tag}]", flush=True)
    print(f"phase 16b counters: {json.dumps(c)} | {len(mov.calls)} moves "
          f"(parks and resumes), each {HYBRID_STATE_BYTES} B of state + "
          f"{HYBRID_TOKEN_BYTES} B a KV token: {len(bad_moves)} off | preempt "
          f"{c['preempt_bytes']} B, resume {c['resume_bytes']} B | prefill "
          f"batches (length, rows, padded rows): {batches}", flush=True)
    t_b6, n_b6 = timed["b6"]
    want = {"qpack_ring_step": c["steps"] * G,
            "kvc_decode_attention": c["steps"] * G,
            "qpack_prefill_fill": c["prefill_batches"] * G,
            "flash_attention": c["prefill_batches"] * G,
            "flash_attention_tc": c["prefill_batches"] * G,
            "qpack_lane_flush": n_parks}
    want.update({k: 0 for k in launches if k not in want})
    print(f"phase 16b launches: {json.dumps(launches)} | expected "
          f"{json.dumps(want)} (the ring step and B5 one a group a step, the "
          f"fill and B6 one a group a prefill batch, the flush one a lane "
          f"demotion) | B5 by group {json.dumps(groups_b5)} | B6 in prefill: "
          f"{n_b6} calls, {t_b6:.6f} s device = {t_b6 / t_pre:.4f} of "
          f"prefill [{tag}]", flush=True)
    check(cache_b == HYBRID_CACHE_BYTES, f"phase 16b: cache {cache_b} B, "
          f"not {HYBRID_CACHE_BYTES}")
    check(c["demotions"] > 0 and resumes > 0, "phase 16b: no park or resume")
    check(not bad_moves and len(mov.calls) == n_parks + resumes and
          sum(m[2] for m in mov.calls) == c["preempt_bytes"] +
          c["resume_bytes"], f"phase 16b: moves off the state + KV suffix: "
          f"{bad_moves[:4]}")
    check(launches == want and n_b6 == want["flash_attention"] and
          all(launches[k] > 0 for k in GQA_STEPS),
          f"phase 16b: launches {launches} against {want}")
    check(groups_b5 == {1: want["kvc_decode_attention"]},
          f"phase 16b: B5 launched at groups {groups_b5}, not all at 1")
    check(len(batches) == c["prefill_batches"] and
          sum(b[1] for b in batches) == SERVE_REQUESTS,
          f"phase 16b: {len(batches)} prefill batches recorded")
    del eng
    torch.cuda.empty_cache()
    eng = Engine(cfg, scfg, params, max_len=SERVE_MAX_LEN)
    # one-chunk prompts keep the warm-up prefill short; a decode step reads
    # the KV up to each lane's length, so the lanes decode past 128
    for p in _ssm_prompts(scfg.max_running, cfg.vocab_size, SEED + 4,
                          cfg.ssm.chunk, (1, 2)):
        eng.submit(p, max_new_tokens=FRONT_NEW_TOKENS)
    for _ in range(3):
        eng.step()
    busy = _profile_line(eng, "16b", tag, b5_per_step=G)
    del eng, params
    launches["kvc_decode_attention_d80"] = groups_b5.get(1, 0)
    print(f"phase 16b wall {time.perf_counter() - t0:.3f} s [{tag}]",
          flush=True)
    return launches


def _hybrid_tokens(cfg, rows: int, T_: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (rows, T_)).astype(np.int32))


def phase_hybrid_whole(dev) -> dict:
    """16c: zamba2-2.7b at its full widths in float32 (TF32 off). (1) Two
    groups (12 Mamba2 layers, both shared blocks) on the card, kernels
    against plain versions: a prefill of 4 x 256 tokens and WHOLE_STEPS
    decode steps fed the plain run's greedy tokens, logits normwise per
    row within ATTN_TOL[f32] and the argmax alike where the top-2 margin
    is above it; then 4 requests (128 or 256 tokens) through Engine both
    ways, 2 lanes, 8 new: identical generations. (2) One group on the card
    against the CPU, the same params: a 128-token prefill and
    HYBRID_WHOLE_STEPS decode steps, each card step fed the CPU's state
    before it (as 15e: the bf16 conv tail may round an input at a boundary
    either way), logits within HYBRID_WHOLE_TOL of the row's largest,
    argmax identical; the card's own chained steps reported; 2 requests of
    128 tokens through Engine on each: identical generations and
    counters."""
    from repro_torch.common.types import ServeConfig
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    period = _zamba2().attn_period
    # (1) kernels against plain versions on the card, two groups
    cfg = dataclasses.replace(_zamba2(2 * period), dtype="float32")
    params = T.init_params(cfg, seed=SEED + 2, device=dev)
    tokens = _hybrid_tokens(cfg, 4, 2 * cfg.ssm.chunk, SEED + 2).to(dev)
    lens = torch.full((4,), tokens.shape[1], dtype=torch.int32, device=dev)
    want, feed, pl = _whole_run(cfg, params, tokens, lens, "plain")
    got, _, kl = _whole_run(cfg, params, tokens, lens, "kernel", feed)
    tol = ATTN_TOL[torch.float32]
    err, bad, agree, n = 0.0, 0, 0, 0
    for a, b in zip(got, want):
        bound = tol * b.abs().amax(dim=-1)
        err = max(err, float((a - b).abs().max()))
        bad += int(((a - b).abs().amax(dim=-1) > bound).sum())
        top2 = b.topk(2, dim=-1).values
        same = a.argmax(-1) == b.argmax(-1)
        agree += int(same.sum())
        n += b.shape[0]
        check(bool((same | (top2[:, 0] - top2[:, 1] <= 2 * bound)).all()),
              "phase 16c: an argmax differs at a top-2 margin above the "
              "tolerance")
    prompts = _ssm_prompts(4, cfg.vocab_size, SEED + 2, cfg.ssm.chunk,
                           SSM_WHOLE_CHUNKS)
    served = {}
    for name, kw in WHOLE_IMPLS.items():
        scfg = ServeConfig(**dict(SERVE_CFG, max_running=2), **kw)
        eng, _, _, _, launches = _serve(cfg, scfg, params, prompts, 8, dev)
        served[name] = ([eng.result(r) for r in range(len(prompts))],
                        dict(eng.counters), launches)
        del eng
    same_gen = sum(x == y for x, y in zip(served["kernel"][0],
                                          served["plain"][0]))
    t1 = time.perf_counter() - t0
    print(f"phase 16c whole path float32, {cfg.name} {cfg.num_layers} Mamba2 "
          f"layers (2 groups, both shared blocks) at full width, kernels vs "
          f"plain on the card: prefill 4 x {tokens.shape[1]} + {WHOLE_STEPS} "
          f"decode steps, logits max abs err {err:.8f}, {bad}/{n} rows "
          f"outside tol {tol} * max|plain row|, argmax {agree}/{n} agree | "
          f"Engine (4 requests of {[len(p) for p in prompts]} tokens, 2 "
          f"lanes, 8 new): {same_gen}/4 generations identical, counters "
          f"equal: {served['kernel'][1] == served['plain'][1]} | launches "
          f"kernel run {json.dumps(kl)}, Engine "
          f"{json.dumps(served['kernel'][2])}; plain runs {json.dumps(pl)}, "
          f"{json.dumps(served['plain'][2])} | {t1:.3f} s", flush=True)
    check(bad == 0, f"phase 16c: {bad} rows of logits outside tolerance")
    check(same_gen == 4 and served["kernel"][1] == served["plain"][1],
          "phase 16c: Engine generations differ between the kernels and the "
          "plain versions")
    for run, counts in (("prefill and decode", kl),
                        ("Engine", served["kernel"][2])):
        for k, v in counts.items():
            on = k in GQA_STEPS + ("flash_attention",) and \
                (k != "qpack_lane_flush" or run == "Engine")
            check((v > 0) if on else (v == 0), f"phase 16c: {k} launched "
                  f"{v} times in the kernel run's {run}")
    check(not any(pl.values()) and not any(served["plain"][2].values()),
          "phase 16c: a plain run launched a kernel")
    del params
    torch.cuda.empty_cache()

    # (2) the card against the CPU, one group
    t2 = time.perf_counter()
    cfg = dataclasses.replace(_zamba2(period), dtype="float32")
    cpu = torch.device("cpu")
    params = T.init_params(cfg, seed=SEED + 3, device=cpu)
    pc = _params_to(params, dev)
    scfg = ServeConfig(**dict(SERVE_CFG, max_running=2))
    tokens = _hybrid_tokens(cfg, 1, cfg.ssm.chunk, SEED + 3)
    pos = torch.full((1,), tokens.shape[1], dtype=torch.int32)

    def run(p, d, feed=None, states=None):
        lg, cache = D.prefill(p, {"tokens": tokens.to(d)}, cfg, scfg,
                              SERVE_MAX_LEN)
        out, snaps = [lg.float().cpu()], []
        for t in range(HYBRID_WHOLE_STEPS):
            if states is not None:
                for k, v in states[t].items():
                    cache[k].copy_(v)
            snaps.append({k: v.clone() for k, v in cache.items()})
            tok = out[-1].argmax(-1).to(torch.int32) if feed is None \
                else feed[t]
            lg, _ = D.decode_step(p, cache, tok.to(d), (pos + t).to(d), cfg,
                                  scfg)
            out.append(lg.float().cpu())
        return out, snaps

    cwant, snaps = run(params, cpu)
    cfeed = [w.argmax(-1).to(torch.int32) for w in cwant[:-1]]
    fed, _ = run(pc, dev, cfeed, snaps)
    chained, _ = run(pc, dev, cfeed)

    def compare(rows):
        e, b_, a_ = 0.0, 0, 0
        for a, b in zip(rows, cwant):
            diff = (a - b).abs().amax(dim=-1)
            e = max(e, float(diff.max()))
            b_ += int((diff > HYBRID_WHOLE_TOL * b.abs().amax(dim=-1)).sum())
            a_ += int((a.argmax(-1) == b.argmax(-1)).sum())
        return e, b_, a_

    f_err, f_bad, f_agree = compare(fed)
    c_err, c_bad, c_agree = compare(chained)
    n = len(cwant)
    cprompts = [_hybrid_tokens(cfg, 1, cfg.ssm.chunk, SEED + 5 + i)[0]
                .tolist() for i in range(2)]
    gens = {}
    for name, p, d in (("cpu", params, cpu), ("card", pc, dev)):
        eng = Engine(cfg, scfg, p, max_len=SERVE_MAX_LEN, device=d)
        rids = [eng.submit(q, max_new_tokens=4) for q in cprompts]
        eng.run_until_done(max_steps=100)
        gens[name] = ([eng.result(r) for r in rids], dict(eng.counters))
        del eng
    torch.backends.cuda.matmul.allow_tf32 = tf32
    print(f"phase 16c whole path float32, {cfg.name} {cfg.num_layers} Mamba2 "
          f"layers + 1 shared block at full width, the card vs the CPU (TF32 "
          f"off): prefill of 1 x {tokens.shape[1]} + {HYBRID_WHOLE_STEPS} "
          f"decode steps each fed the CPU's state: logits max abs err "
          f"{f_err:.8f}, {f_bad}/{n} rows outside tol {HYBRID_WHOLE_TOL} * "
          f"max|CPU row|, argmax {f_agree}/{n} agree | the card's own chained "
          f"steps: max abs err {c_err:.8f}, {c_bad}/{n} rows outside, argmax "
          f"{c_agree}/{n} agree | Engine (2 requests of {cfg.ssm.chunk} "
          f"tokens, 2 lanes, 4 new): generations identical "
          f"{gens['card'][0] == gens['cpu'][0]}, counters equal "
          f"{gens['card'][1] == gens['cpu'][1]} | "
          f"{time.perf_counter() - t2:.3f} s; 16c wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    check(f_bad == 0 and f_agree == n, f"phase 16c: card vs CPU, {f_bad} "
          f"rows outside tolerance, argmax {f_agree}/{n}")
    check(gens["card"] == gens["cpu"], "phase 16c: Engine on the card "
          "differs from the CPU")
    del params, pc
    return {"err": err, "cpu_err": f_err, "chained_err": c_err}


# ---------------------------------------------------------------------------
# Phase 17: telemetry (repro_torch.obs) on serving, the fabric and the
# evaluation path, through the entry points a user calls.
# ---------------------------------------------------------------------------

# 17a: the serve launcher on llama3-8b as published, 8 lanes, 4-bit KV,
# max_len 2048; 12 requests over 8 lanes preempt and resume
OBS_SERVE_ARGV = ["--arch", "llama3_8b", "--requests", "12", "--new-tokens",
                  "16", "--lanes", "8", "--kv-bits", "4", "--max-len", "2048"]
# 17b: the fabric launcher over phase 12c's page space, promoted region,
# window, accesses, expanders and skew, with payload (B1's and B2's steps).
# The launcher sizes the compressed region itself (8 chunks a page) and has
# no flags for the spill's interval, batch and watermark, so the spill would
# not fire: migration is the rebalance policy, which does
# 17b's page space: half of 12c's 4,096 pages, for the script's time (the
# population of every page took most of 17b's wall at 4,096)
OBS_FABRIC_ARGV = ["--workload", "mcf", "--expanders", "4", "--skew", "0.8",
                   "--payload", "--pages", "2048", "--prom", "128",
                   "--window", "32", "--accesses", "2048", "--migration",
                   "rebalance"]
# 17c: two quick cells of the reference file, one pool-level, one line-level
OBS_CELLS = ("ibex|mcf|n=4000|prom=64", "compresso|pr|n=4000|prom=64")


class _StepClock:
    """Host wall of every ``Engine.step`` while installed, each marked
    pure decode (no prefill, preemption or resume in it) or not. Each step
    ends in its one fetch, so its wall is the step's whole time."""

    def __init__(self):
        from repro_torch.serve import Engine
        self.cls, self.orig = Engine, Engine.step
        self.walls: list = []

    def __enter__(self):
        orig, walls = self.orig, self.walls

        def step(eng):
            c = eng.counters
            before = (c["steps"], c["prefill_batches"], c["promotions"],
                      c["demotions"])
            t0 = time.perf_counter()
            out = orig(eng)
            dt = time.perf_counter() - t0
            after = (c["steps"], c["prefill_batches"], c["promotions"],
                     c["demotions"])
            if after[0] > before[0]:
                walls.append((dt, after[1:] == before[1:]))
            return out

        self.cls.step = step
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def _median_ms(walls, pure_only: bool):
    v = [w for w, pure in walls if pure or not pure_only]
    return round(1e3 * statistics.median(v), 3) if v else None


def phase_obs_serve(dev, tag: str, argv=OBS_SERVE_ARGV) -> dict:
    """17a: ``launch/serve.py``'s ``main`` twice in turns, without and
    with ``--trace`` (off, on), the same seed: tokens and every
    engine counter equal, one fetch a step both ways, the recorder's steps
    and byte counters equal the engine's, the written trace valid; the
    step walls of each kind of run (all steps, and pure decode steps)."""
    import tempfile
    from repro_torch.launch import serve as LS
    from repro_torch.obs import export as OBX
    t0 = time.perf_counter()
    runs, walls = [], {False: [], True: []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, on in enumerate((False, True)):
            path = Path(tmp) / f"serve{i}.trace.json"
            _reset_launches()
            with _StepClock() as clock:
                eng = LS.main(argv + (["--trace", str(path)] if on else []))
            launches = _launch_counts()
            walls[on] += clock.walls
            rec = eng.obs
            run = {"on": on, "counters": dict(eng.counters),
                   "tokens": [eng.result(r) for r in sorted(eng.requests)],
                   "launches": launches, "walls": clock.walls}
            if on:
                trace = json.loads(path.read_text())
                snap = json.loads(Path(OBX.metrics_path(path)).read_text())
                run.update(steps=len(rec.steps),
                           events=len(rec.serve_events),
                           kinds=sorted({e["type"]
                                         for e in rec.serve_events}),
                           errs=OBX.validate_trace(trace),
                           n_events=len(trace["traceEvents"]),
                           snap=snap["metrics"]["counters"],
                           manifest=snap["manifest"])
            runs.append(run)
            del eng, rec
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    c = runs[0]["counters"]
    same = all(r["counters"] == c and r["tokens"] == runs[0]["tokens"]
               for r in runs)
    ms = {k: (_median_ms(walls[on], False), _median_ms(walls[on], True),
              sum(p for _, p in walls[on]))
          for k, on in (("off", False), ("on", True))}
    turns = [(_median_ms(r["walls"], False), _median_ms(r["walls"], True))
             for r in runs]
    print(f"phase 17a serve --trace: {' '.join(argv)} | 2 launcher runs "
          f"(off, on) | tokens and counters equal in all: {same} "
          f"| counters {json.dumps(c)} | step_syncs == steps in each: "
          f"{all(r['counters']['step_syncs'] == r['counters']['steps'] for r in runs)}"
          f" | launches {json.dumps(runs[1]['launches'])} [{tag}]",
          flush=True)
    for r in runs[1:]:
        print(f"phase 17a recorder: {r['steps']} steps recorded of "
              f"{r['counters']['steps']}, {r['events']} serve events "
              f"{r['kinds']}, trace {r['n_events']} events, validator "
              f"{r['errs']} | serve.preempt_bytes "
              f"{r['snap']['serve.preempt_bytes']} resume_bytes "
              f"{r['snap']['serve.resume_bytes']} (engine "
              f"{r['counters']['preempt_bytes']} / "
              f"{r['counters']['resume_bytes']}) | manifest "
              f"{json.dumps({k: r['manifest'][k] for k in ('torch', 'cuda', 'device', 'device_count', 'gpu_name', 'gpu_driver', 'gpu_power_limit')})}",
              flush=True)
    print(f"phase 17a step ms (median host wall a step; all steps / pure "
          f"decode steps, their count): without the recorder {ms['off'][0]}"
          f" / {ms['off'][1]} ({ms['off'][2]}), with it {ms['on'][0]} / "
          f"{ms['on'][1]} ({ms['on'][2]}); by run in turn (off, on): "
          f"{json.dumps(turns)}; wall {wall:.3f} s [{tag}]",
          flush=True)
    check(same, "phase 17a: tokens or counters differ with the recorder")
    check(c["demotions"] > 0 and c["promotions"] > c["prefill_batches"],
          f"phase 17a: no preemption or resume: {c}")
    for r in runs:
        check(r["counters"]["step_syncs"] == r["counters"]["steps"],
              f"phase 17a: step_syncs off budget: {r['counters']}")
        if dev.type == "cuda":
            check(all(r["launches"][k] > 0 for k in (
                "qpack_ring_step", "qpack_prefill_fill", "qpack_lane_flush",
                "kvc_decode_attention", "flash_attention")),
                f"phase 17a: a kernel was not launched: {r['launches']}")
        if r["on"]:
            check(r["steps"] == r["counters"]["steps"],
                  "phase 17a: the recorder missed a step")
            check({"admission", "preempt", "resume"} <= set(r["kinds"]),
                  f"phase 17a: serve events {r['kinds']}")
            check(r["snap"]["serve.preempt_bytes"] ==
                  r["counters"]["preempt_bytes"] and
                  r["snap"]["serve.resume_bytes"] ==
                  r["counters"]["resume_bytes"],
                  "phase 17a: the recorder's bytes differ from the engine's")
            check(r["errs"] == [], f"phase 17a: invalid trace {r['errs']}")
    return {"wall_s": wall, "ms": ms}


def phase_obs_fabric(dev, tag: str, argv=OBS_FABRIC_ARGV) -> dict:
    """17b: ``launch/fabric.py``'s ``main`` with ``--trace`` and without:
    every leaf of every expander, the override table and the counters
    equal, the fetch budgets held, every segment and epoch recorded, the
    track totals equal to ``pipeline_times()`` at rtol 1e-9, the trace
    valid, B1's and B2's steps launched."""
    import tempfile
    from repro_torch.kernels import qpack
    from repro_torch.launch import fabric as LF
    from repro_torch.obs import export as OBX
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fabric.trace.json"
        _zero_port_launches()
        t = time.perf_counter()
        on = LF.main(argv + ["--trace", str(path)])
        t_on = time.perf_counter() - t
        demote, promote = qpack.fused_demote_launches, \
            qpack.fused_promote_launches
        trace = json.loads(path.read_text())
        snap = json.loads(Path(OBX.metrics_path(path)).read_text())
    t = time.perf_counter()
    off = LF.main(argv)
    t_off = time.perf_counter() - t
    rec = on.obs
    ss, ss_off = on.sync_stats(), off.sync_stats()
    same = on.state_identical(off) and on.counters() == off.counters() \
        and ss == ss_off
    pt, totals = on.pipeline_times(), OBX.fabric_track_totals(rec)
    rel = {k: float(np.max(np.abs(totals[k] - pt[k]) / pt[k]))
           for k in ("overlapped_s", "sync_s")}
    errs = OBX.validate_trace(trace)
    wall = time.perf_counter() - t0
    print(f"phase 17b fabric --trace: {' '.join(argv)} | with the recorder "
          f"{t_on:.3f} s, without {t_off:.3f} s | leaves, overrides, "
          f"counters and sync stats equal: {same} | {json.dumps(ss)} | "
          f"recorded {len(rec.segments)} segments, {len(rec.plans)} plans, "
          f"{len(rec.epochs)} epochs ({sorted({e['kind'] for e in rec.epochs})}"
          f", {sum(e['moved'] for e in rec.epochs)} pages moved) | track "
          f"totals vs pipeline_times, max relative difference "
          f"{json.dumps(rel)} | trace {len(trace['traceEvents'])} events, "
          f"validator {errs}, metrics.json fabric "
          f"{json.dumps({k: snap['fabric'][k] for k in ('segments', 'epochs', 'pages_moved')})}"
          f" | launches demote-and-compact {demote} promote {promote} | "
          f"wall {wall:.3f} s [{tag}]", flush=True)
    check(same, "phase 17b: the recorder changed the fabric's state")
    check(ss["segment_syncs"] == ss["segments"] == len(rec.segments) and
          ss["epoch_syncs"] == ss["epochs"] == len(rec.epochs),
          f"phase 17b: budgets or records off: {ss}, {len(rec.segments)} "
          f"segments and {len(rec.epochs)} epochs recorded")
    check(ss["epochs"] > 0 and len(rec.plans) > 0,
          "phase 17b: no plan or epoch recorded")
    check(all(v <= 1e-9 for v in rel.values()),
          f"phase 17b: track totals off pipeline_times: {rel}")
    check(errs == [], f"phase 17b: invalid trace {errs}")
    if dev.type == "cuda":
        check(demote > 0 and promote > 0, f"phase 17b: B1's or B2's step "
              f"not launched: demote {demote} promote {promote}")
    return {"wall_s": wall}


def phase_obs_cells(dev, tag: str, keys=OBS_CELLS) -> dict:
    """17c: ``run_workload(obs=rec)`` on quick cells of the reference file:
    each cell's metrics still ``==`` the file's, and ``rec.cells`` and the
    ``simx.*`` metrics carry them."""
    from repro_torch.obs import Recorder
    from repro_torch.simx import engine as SE
    from repro_torch.simx.trace import WORKLOADS
    ref = {c["key"]: c for c in json.loads(
        SIMX_REFERENCE.read_text())["cells"]}
    t0 = time.perf_counter()
    rec, bad = Recorder(), []
    for key in keys:
        cell = ref[key]
        spec = dataclasses.replace(WORKLOADS[cell["spec"]["name"]],
                                   **cell["spec"])
        got = SE.run_workload(cell["scheme"], spec,
                              n_accesses=cell["n_accesses"],
                              promoted_pages=cell["promoted_pages"],
                              torch_device=dev, obs=rec)
        if got != cell["metrics"]:
            bad.append(key)
    wall = time.perf_counter() - t0
    want = [{"scheme": ref[k]["scheme"], "workload": ref[k]["spec"]["name"],
             "time_s": ref[k]["metrics"]["time_s"],
             "normalized_perf": ref[k]["metrics"]["normalized_perf"]}
            for k in keys]
    snap = rec.metrics.snapshot()
    gauges_ok = all(snap["gauges"][f"simx.normalized_perf.{w['scheme']}."
                                   f"{w['workload']}"] ==
                    w["normalized_perf"] for w in want)
    hist = snap["histograms"]["simx.cell_time_us"]
    print(f"phase 17c run_workload(obs=): {len(keys)} cells {list(keys)}, "
          f"{len(keys) - len(bad)} equal to the reference file | recorded "
          f"{json.dumps(rec.cells)} | simx.cells {snap['counters']['simx.cells']}"
          f", gauges equal: {gauges_ok}, cell_time_us count {hist['count']} "
          f"| wall {wall:.3f} s [{tag}]", flush=True)
    check(not bad, f"phase 17c: cells differ from the reference: {bad}")
    check(rec.cells == want and snap["counters"]["simx.cells"] == len(keys)
          and gauges_ok and hist["count"] == len(keys),
          "phase 17c: the recorder's cells or simx metrics differ")
    return {"wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 18: training, llama3-8b with the IBEX-compressed AdamW state.
# ---------------------------------------------------------------------------

# 18b's peak memory limit; llama3-8b trains at all 32 layers under it
# (a deeper cut would be listed in PERF.md §4, as 14b's is)
TRAIN_PEAK_GIB = 72.0
TRAIN_STEPS = 3           # timed steps after one warm-up step
# the warning of torch.cuda.set_sync_debug_mode("warn") at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"
# an f32 AdamW state of llama3-8b: 2 moments x 4 B x 8,029,995,008 params
F32_STATE_BYTES = 8 * 8_029_995_008
# 18a's B3/B4 sizes: a norm (final_norm), a stacked norm ([32, 4096]), the
# embedding's last slice, and a whole slice of a stacked leaf (wq, the
# MLP's and the embedding's other slices): every size the update hands B3
TRAIN_CODEC_SIZES = (4096, 131072, 525_336_576 % (1 << 26), 1 << 26)
# B6's Function: the train shape (8 x 512, 32/8 x 128) and MLA's pair
TRAIN_ATTN = ((8, 512, 32, 8, 128, 128), (8, 512, 40, 40, 96, 64))
# 18c: llama3-8b's widths at 2 layers, float32, microbatches 2, 3 steps,
# the losses of the two routes within this relative distance (float32
# sums in another order through 2 layers, 3 updates)
TRAIN_WHOLE_LAYERS = 2
TRAIN_WHOLE_RTOL = 1e-4
# 18d: the launcher on REDUCED llama3 with the compressed state
TRAIN_LAUNCHER_ARGV = ["--arch", "llama3_8b", "--reduced", "--steps", "4",
                       "--seq-len", "64", "--global-batch", "4",
                       "--compress-state", "--ckpt-every", "2"]


def _train_configs(layers=None, dtype=None, microbatches=1):
    """(model config, TrainConfig): llama3-8b as published (or cut to
    ``layers``), TrainConfig's defaults (seq 512, global batch 8), the
    launcher's optimizer (lr 3e-4, warm-up 20) with the compressed state."""
    from repro_torch.common.types import OptimizerConfig, TrainConfig
    cfg = _llama(layers)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg, TrainConfig(microbatches=microbatches,
                            optimizer=OptimizerConfig(
                                lr=3e-4, warmup_steps=20,
                                compress_state=True))


def _train_slices(params, block: int) -> int:
    """Slices ``adamw.update`` cuts the leaves into (B3 and B4 launch twice
    a slice: m and sqrt(v))."""
    from repro_torch.common import tree as TR
    from repro_torch.optim import adamw
    return sum(len(adamw._slices(p.numel(), adamw._blk(p.numel(), block)))
               for _, p in TR.leaves_with_paths(params))


def phase_train_kernels(dev, tag: str) -> tuple:
    """18a: B3/B4 at 8 bits, block 512, f32 in, at every size the update
    hands them, byte for byte; B6's autograd Function at the train shape
    and at (96, 64), bf16 and f32, causal: its forward is B6's launch, its
    grads against autograd through the plain version in f32 on the card,
    normwise within ATTN_NORM_TOL; then the kernel / eager / plain /
    library / bound times of the three at the train path's shapes, and the
    attention backward's ms a layer."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import qpack
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    errs = {k: {"err": 0.0, "cases": 0, "mismatches": 0} for k in (
        "qpack_fixed_encode_train", "qpack_fixed_decode_train",
        "flash_attention_train")}
    for n in TRAIN_CODEC_SIZES:
        x = torch.randn((n,), generator=gen, device=dev) * 1e-3
        x[: n // 8] = 0.0                      # whole zero blocks too
        got, want = qpack.encode(x, 8, 512), qpack.encode_plain(x, 8, 512)
        r = errs["qpack_fixed_encode_train"]
        r["cases"] += 1
        r["mismatches"] += int((got[0] != want[0]).sum()) + \
            int((~_bits_equal(got[1][:, None], want[1][:, None])).sum())
        a = qpack.decode(*want, 8, 512, torch.float32)
        b = qpack.decode_plain(*want, 8, 512, torch.float32)
        r = errs["qpack_fixed_decode_train"]
        r["cases"] += 1
        r["mismatches"] += int((a.view(torch.int32) !=
                                b.view(torch.int32)).sum())
        r["err"] = max(r["err"], float((a - b).abs().max()))
        errs["qpack_fixed_encode_train"]["err"] = max(
            errs["qpack_fixed_encode_train"]["err"],
            float((qpack.decode_plain(*got, 8, 512, torch.float32) -
                   b).abs().max()))
        del x, got, want, a, b
    grad_errs = {}
    r = errs["flash_attention_train"]
    for B, S, Hq, Hkv, D, Dv in TRAIN_ATTN:
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
        v = torch.randn((B, S, Hkv, Dv), generator=gen, device=dev)
        do = torch.randn((B, S, Hq, Dv), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            ins = [t.to(dt).requires_grad_() for t in (q, k, v)]
            n0 = FA.launches
            o = FA.flash_attention_trainable(*ins, causal=True)
            check(FA.launches == n0 + 1 and o.grad_fn is not None,
                  "phase 18a: B6's Function did not launch B6 once")
            o.backward(do.to(dt))
            ref = [t.to(dt).float().requires_grad_() for t in (q, k, v)]
            o_ref = FA.flash_attention_plain(*ref, causal=True)
            o_ref.backward(do.to(dt).float())
            d = o.detach().float() - o_ref.detach()
            r["cases"] += 1
            r["mismatches"] += int((d.abs() > ATTN_TOL[dt] *
                                    (1 + o_ref.detach().abs())).sum())
            r["err"] = max(r["err"], float(d.abs().max()))
            name = f"{B}x{S} {Hq}/{Hkv} x {D}/{Dv} {str(dt)[6:]}"
            grad_errs[name] = [round(float((a.grad.float() - b.grad).norm()
                                           / b.grad.norm()), 8)
                               for a, b in zip(ins, ref)]
            check(max(grad_errs[name]) <= ATTN_NORM_TOL[dt],
                  f"phase 18a: B6's gradients off at {name}: "
                  f"{grad_errs[name]}")
            del ins, ref, o, o_ref, d
    print(f"phase 18a kernels: B3 at 8 bits / block 512 / f32 over "
          f"{list(TRAIN_CODEC_SIZES)} values: "
          f"{errs['qpack_fixed_encode_train']['mismatches']} codes and "
          f"scales differ; B4 to f32: "
          f"{errs['qpack_fixed_decode_train']['mismatches']} values differ"
          f" | B6's Function: forward max abs err {r['err']:.3e}, "
          f"{r['mismatches']} outside ATTN_TOL; dq/dk/dv normwise against "
          f"autograd through the plain version in f32: "
          f"{json.dumps(grad_errs)} [{tag}]", flush=True)
    check(errs["qpack_fixed_encode_train"]["mismatches"] == 0 and
          errs["qpack_fixed_decode_train"]["mismatches"] == 0,
          "phase 18a: B3/B4 differ from their plain versions")
    check(r["mismatches"] == 0, "phase 18a: B6's forward off tolerance")

    n = TRAIN_CODEC_SIZES[-1]
    x = torch.randn((n,), generator=gen, device=dev) * 1e-3
    c, sc = qpack.encode(x, 8, 512)
    B, S, Hq, Hkv, D, _ = TRAIN_ATTN[0]
    qa, ka, va = (torch.randn((B, S, h, D), generator=gen, device=dev)
                  .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    out = {
        "qpack_fixed_encode_train": dict(
            shape=f"{n} f32 values (a slice of a stacked leaf) -> 8-bit "
                  f"codes, block 512",
            kern=lambda: qpack.encode(x, 8, 512),
            plain=lambda: qpack.encode_plain(x, 8, 512), lib=None,
            nbytes=n * 4 + n + n // 512 * 4,
            ops=ENCODE_OPS_PER_VALUE * n, ops_dtype="float32", reps=20),
        "qpack_fixed_decode_train": dict(
            shape=f"{n} 8-bit codes, block 512 -> f32",
            kern=lambda: qpack.decode(c, sc, 8, 512, torch.float32),
            plain=lambda: qpack.decode_plain(c, sc, 8, 512, torch.float32),
            lib=None, nbytes=n + n // 512 * 4 + n * 4,
            ops=DECODE_OPS_PER_VALUE * n, ops_dtype="float32", reps=20),
        "flash_attention_train": dict(
            shape=f"q {B}x{S}x{Hq}x{D}, kv {B}x{S}x{Hkv}x{D} bf16 causal "
                  f"(a layer's training forward)",
            kern=lambda: FA.flash_attention(qa, ka, va, causal=True),
            plain=lambda: FA.flash_attention_plain(qa, ka, va, causal=True),
            lib=lambda: _sdpa(qa, ka, va, True),
            nbytes=2 * B * S * D * (2 * Hq + 2 * Hkv),
            ops=4 * B * Hq * D * S * (S + 1) // 2, reps=20)}
    times = _time_rows(out, "18a", tag)
    oa = FA.flash_attention(qa, ka, va, causal=True)
    bwd_ms = time_eager(lambda: FA.flash_attention_backward(
        qa, ka, va, oa, oa, causal=True, sm_scale=1.0 / D ** 0.5), 5)
    print(f"phase 18a attention backward (PyTorch, FlashAttention-2's "
          f"formulas) at the train shape: {bwd_ms:.6f} ms a layer (eager) "
          f"[{tag}]", flush=True)
    times["attention_backward_ms"] = bwd_ms
    return errs, times


def _train_digest(params, opt) -> dict:
    """Per leaf, in slices: every param's float64 sum, and each compressed
    moment's code sum (int64) and scale sum (float64); one fetch."""
    from repro_torch.common import contracts
    from repro_torch.common import tree as TR
    from repro_torch.optim import adamw

    def total(x, dt):
        flat = x.reshape(-1)
        return torch.stack([flat[s:e].to(dt).sum() for s, e in
                            adamw._slices(flat.numel(), 1)]).sum()

    out = {"p:" + "/".join(p): total(x, torch.float64)
           for p, x in TR.leaves_with_paths(params)}
    for pre, tree in (("m:", opt.m), ("v:", opt.v)):
        for p, x in TR.leaves_with_paths(tree):
            if p[-1] in ("codes", "scales"):
                out[pre + "/".join(p)] = total(
                    x, torch.int64 if p[-1] == "codes" else torch.float64)
    return {k: v.item() for k, v in contracts.fetch(out).items()}


def _timed_steps(step_fn, params, opt, batches):
    """Each step between two CUDA events; (params, opt, metrics list, ms
    list)."""
    evs, metrics = [], []
    for b in batches:
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt, m = step_fn(params, opt, b)
        e.record()
        evs.append((a, e))
        metrics.append(m)
    torch.cuda.synchronize()
    return params, opt, metrics, [a.elapsed_time(e) for a, e in evs]


def phase_train_main(dev, tag: str) -> dict:
    """18b: llama3-8b as published (32 layers, bf16, remat; seeded params
    made on the card) trained through ``trainer.make_train_step`` with the
    compressed AdamW state: one warm-up step, then TRAIN_STEPS timed
    steps with every launch count set to 0 before them and read after
    (B3 and B4 twice a slice of the update, B6 twice a layer: the forward
    and the remat forward), no host sync (the port's counter, and
    PyTorch's sync debug mode); then one step under torch.profiler (busy
    share) and one split into grads and update (CUDA events)."""
    import warnings
    from repro_torch.common import contracts
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import qpack
    from repro_torch.optim import adamw
    from repro_torch.roofline import analyze as RA
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    cfg, tcfg = _train_configs()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    params = trainer.init_params(cfg, SEED, dev)
    opt = adamw.init(params, tcfg.optimizer)
    mem = {"args": torch.cuda.memory_allocated(dev) - base}
    step_fn, _ = trainer.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batches = [make_batch(cfg, i, global_batch=tcfg.global_batch,
                          seq_len=tcfg.seq_len, device=dev)
               for i in range(TRAIN_STEPS + 3)]
    params, opt, warm = step_fn(params, opt, batches[0])
    torch.cuda.synchronize()
    digest = _train_digest(params, opt)      # 20a holds its step to these
    _reset_launches()
    contracts.SYNCS.reset()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt, metrics, ms = _timed_steps(
                step_fn, params, opt, batches[1:TRAIN_STEPS + 1])
            n_caught = len(caught)
            warm["loss"].item()        # the instrument's own check: caught
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = contracts.SYNCS.count
    sync_msgs = [i for i, w in enumerate(caught)
                 if SYNC_WARNING in str(w.message)]
    debug_syncs = [str(caught[i].message)[:120] for i in sync_msgs
                   if i < n_caught]
    instrument_ok = any(i >= n_caught for i in sync_msgs)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    host = contracts.fetch({f"{k}{i}": m[k] for i, m in enumerate(
        [warm] + metrics) for k in ("loss", "grad_norm", "lr")})
    losses = [float(host[f"loss{i}"]) for i in range(TRAIN_STEPS + 1)]
    gnorms = [float(host[f"grad_norm{i}"]) for i in range(TRAIN_STEPS + 1)]
    slices = _train_slices(params, tcfg.optimizer.state_block)
    want = {"qpack_fixed_encode": 2 * slices * TRAIN_STEPS,
            "qpack_fixed_decode": 2 * slices * TRAIN_STEPS,
            "flash_attention": 2 * cfg.num_layers * TRAIN_STEPS,
            "flash_attention_tc": 2 * cfg.num_layers * TRAIN_STEPS}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    step_ms = statistics.median(ms)
    tokens = tcfg.global_batch * tcfg.seq_len
    n_params = cfg.param_count()
    mfu = RA.model_flops(n_params, n_params, tokens, "train") / (
        step_ms / 1e3 * RA.PEAK_FLOPS)
    state = adamw.state_bytes(opt)

    # one step under the profiler (the card's activity), one split
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if torch.cuda.is_available() else \
        ProfilerActivity.CPU
    with profile(activities=[act]) as prof:
        tp = time.perf_counter()
        params, opt, _ = step_fn(params, opt, batches[TRAIN_STEPS + 1])
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - tp
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = _busy_us(evs) / 1e6 / prof_wall
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e[0].record()
    grads, loss = trainer.grads_and_loss(params, batches[TRAIN_STEPS + 2],
                                         cfg, tcfg.microbatches)
    # params, state, grads, the batches and the loss: all that is alive
    mem["with_grads"] = torch.cuda.memory_allocated(dev) - base
    e[1].record()
    params, opt, _ = adamw.update(grads, opt, params, tcfg.optimizer)
    e[2].record()
    torch.cuda.synchronize()
    del grads
    split = {"grads_ms": e[0].elapsed_time(e[1]),
             "update_ms": e[1].elapsed_time(e[2])}
    wall = time.perf_counter() - t0
    print(f"phase 18b train main: {cfg.name} as published ({cfg.num_layers} "
          f"layers, d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} x "
          f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.dtype}, remat {cfg.remat}; "
          f"{n_params} params) | seq {tcfg.seq_len} x batch "
          f"{tcfg.global_batch}, microbatches {tcfg.microbatches}, "
          f"compressed AdamW (lr {tcfg.optimizer.lr}, warm-up "
          f"{tcfg.optimizer.warmup_steps}) | losses (warm-up, then timed) "
          f"{losses} | grad norms {gnorms} [{tag}]", flush=True)
    print(f"phase 18b step: {step_ms:.3f} ms median of {[round(x, 3) for x in ms]}"
          f" (CUDA events) | {tokens / step_ms * 1e3:.1f} tokens/s | "
          f"model-FLOP share {mfu:.4f} (6 N tokens / (step s x 989 TF/s)) "
          f"| peak {peak:.3f} GiB | compressed state {state} B against "
          f"{F32_STATE_BYTES} B in f32 ({state / F32_STATE_BYTES:.4f}) | "
          f"init {t_init:.3f} s [{tag}]", flush=True)
    print(f"phase 18b launches over {TRAIN_STEPS} steps: {json.dumps(got)}"
          f" (expected {json.dumps(want)}: {slices} update slices, "
          f"{cfg.num_layers} layers); a step: B3 "
          f"{got['qpack_fixed_encode'] / TRAIN_STEPS:.1f}, B4 "
          f"{got['qpack_fixed_decode'] / TRAIN_STEPS:.1f}, B6 "
          f"{got['flash_attention'] / TRAIN_STEPS:.1f}; others "
          f"{json.dumps(others)} | host syncs a step "
          f"{syncs / TRAIN_STEPS:.1f} (counted), {len(debug_syncs)} in "
          f"PyTorch's sync debug mode {debug_syncs[:3]} (a deliberate "
          f".item() after the steps caught: {instrument_ok}) [{tag}]",
          flush=True)
    print(f"phase 18b profile: one step {prof_wall * 1e3:.3f} ms wall, "
          f"{len(evs)} device events, busy {busy:.4f} | split step: grads "
          f"(forward, remat and backward) {split['grads_ms']:.3f} ms, "
          f"update {split['update_ms']:.3f} ms | phase 18b wall "
          f"{wall:.3f} s [{tag}]", flush=True)
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"phase 18b: a loss or grad norm is not finite: {losses} {gnorms}")
    check(got == want, f"phase 18b: launches {got}, expected {want}")
    check(not others, f"phase 18b: other kernels launched: {others}")
    check(syncs == 0 and not debug_syncs and instrument_ok,
          f"phase 18b: the train step synced: {syncs} counted, "
          f"{debug_syncs[:3]} (sync debug mode working: {instrument_ok})")
    check(peak <= TRAIN_PEAK_GIB, f"phase 18b: peak {peak:.3f} GiB past "
          f"{TRAIN_PEAK_GIB} GiB")
    del params, opt, batches, metrics, warm
    return {"launches": got, "step_ms": step_ms, "wall_s": wall,
            "peak_gib": peak, "busy": busy, "mfu": mfu, "mem": mem,
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "first": {"loss": losses[0], "digest": digest}, **split}


def _train_route(dev, impl: str) -> dict:
    """18c's run on one route: TRAIN_WHOLE_LAYERS layers at llama3-8b's
    widths in float32, microbatches 2, 3 steps from the seeded params."""
    from repro_torch.common import contracts
    from repro_torch.common import tree as TR
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg, tcfg = _train_configs(TRAIN_WHOLE_LAYERS, "float32", 2)
    kw = WHOLE_IMPLS[impl]
    params = trainer.init_params(cfg, SEED + 1, dev)
    opt = adamw.init(params, tcfg.optimizer, kw["quantize_impl"])
    step_fn, _ = trainer.make_train_step(cfg, tcfg, **kw)
    _reset_launches()
    ms = []
    for i in range(3):
        params, opt, m = step_fn(params, opt, make_batch(
            cfg, i, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            device=dev))
        ms.append(m)
    torch.cuda.synchronize()
    launches = _launch_counts()
    host = contracts.fetch({f"loss{i}": m["loss"] for i, m in enumerate(ms)})
    codes = torch.cat([x.reshape(-1) for p, x in
                       TR.leaves_with_paths((opt.m, opt.v))
                       if p[-1] == "codes"])
    return {"losses": [float(host[f"loss{i}"]) for i in range(3)],
            "codes": codes, "launches": launches}


def phase_train_whole(dev, tag: str) -> dict:
    """18c: the whole training path both ways at llama3-8b's widths and
    TRAIN_WHOLE_LAYERS layers, float32, microbatches 2, 3 steps: the
    kernel route (B3/B4/B6) against the plain route (``quantize_impl``
    "jnp", ``attn_impl`` "plain"): losses within TRAIN_WHOLE_RTOL; the
    share of moment codes that differ and the largest difference reported
    (a value at a rounding boundary may move a code)."""
    t0 = time.perf_counter()
    k = _train_route(dev, "kernel")
    torch.cuda.empty_cache()
    p = _train_route(dev, "plain")
    d = (k["codes"].view(torch.int8).int() - p["codes"].view(
        torch.int8).int()).abs()
    share, worst = float((d > 0).float().mean()), int(d.max())
    rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
    b6 = {r: x["launches"]["flash_attention"] for r, x in
          (("kernel", k), ("plain", p))}
    b3 = {r: x["launches"]["qpack_fixed_encode"] for r, x in
          (("kernel", k), ("plain", p))}
    wall = time.perf_counter() - t0
    print(f"phase 18c train whole ({TRAIN_WHOLE_LAYERS} layers at "
          f"llama3-8b's widths, float32, microbatches 2, 3 steps): losses "
          f"kernel {k['losses']} / plain {p['losses']} (relative "
          f"{[f'{x:.2e}' for x in rel]}) | moment codes differing "
          f"{share:.6f} of {d.numel()}, largest difference {worst} | B6 "
          f"launches {b6}, B3 {b3} | wall {wall:.3f} s [{tag}]", flush=True)
    check(max(rel) <= TRAIN_WHOLE_RTOL, f"phase 18c: losses differ: {rel}")
    check(b6["kernel"] > 0 and b3["kernel"] > 0 and b6["plain"] == 0 and
          b3["plain"] == 0, f"phase 18c: routes crossed: B6 {b6}, B3 {b3}")
    del k, p, d
    return {"wall_s": wall, "code_share": share, "code_max": worst}


def _tree_bytes_equal(a, b) -> bool:
    from repro_torch.common import tree as TR
    for (pa, x), (pb, y) in zip(TR.leaves_with_paths(a),
                                TR.leaves_with_paths(b)):
        if pa != pb:
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                    x.reshape(-1).view(torch.uint8),
                    y.reshape(-1).view(torch.uint8)):
                return False
        elif x != y:
            return False
    return True


def phase_train_launcher(dev, tag: str) -> dict:
    """18d: ``launch/train.py`` on the card with ``--reduced
    --compress-state``: 4 steps, a checkpoint every 2; the newest
    checkpoint restores byte-equal to the run's params and state; with its
    ``arrays.npz`` corrupted ``latest()`` skips it; a second run resumes
    from step 2 and its first step's loss equals the first run's."""
    import contextlib
    import io
    import os
    import tempfile
    from repro_torch.launch import train as LT
    from repro_torch.train import checkpoint as ckpt
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        argv = TRAIN_LAUNCHER_ARGV + ["--ckpt-dir", tmp, "--device",
                                      str(dev)]
        _reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as out1:
            first = LT.main(argv)
        launches = _launch_counts()
        steps = ckpt.list_steps(tmp)
        back, _ = ckpt.restore(tmp, steps[-1], {"params": first["params"],
                                                "opt": first["opt"]})
        restored = _tree_bytes_equal(back, {"params": first["params"],
                                            "opt": first["opt"]})
        npz = os.path.join(tmp, f"step_{steps[-1]:08d}", "arrays.npz")
        with open(npz, "r+b") as f:
            f.seek(120)
            f.write(b"\xde\xad\xbe\xef")
        skipped = ckpt.latest(tmp)
        with contextlib.redirect_stdout(io.StringIO()) as out2:
            again = LT.main(argv)
        s0 = again["start"]
        l1 = float(first["metrics"][s0]["loss"])
        l2 = float(again["metrics"][s0]["loss"])
        same_end = _tree_bytes_equal(
            {"params": again["params"], "opt": again["opt"]},
            {"params": first["params"], "opt": first["opt"]})
    wall = time.perf_counter() - t0
    lines = [x for x in out1.getvalue().splitlines() if x.startswith("step")]
    print(f"phase 18d train launcher: {' '.join(TRAIN_LAUNCHER_ARGV)} | "
          f"{lines} | checkpoints {steps}; step {steps[-1]} restores "
          f"byte-equal: {restored}; corrupted, latest() -> {skipped} | "
          f"resumed at step {s0}: loss {l2} against {l1} uninterrupted; "
          f"the resumed run ends byte-equal: {same_end} | launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})} | wall "
          f"{wall:.3f} s [{tag}]", flush=True)
    check("training complete" in out1.getvalue() and
          "training complete" in out2.getvalue(),
          "phase 18d: the launcher did not complete")
    check(steps == [2, 4], f"phase 18d: checkpoints {steps}")
    check(restored, "phase 18d: the checkpoint does not restore byte-equal")
    check(skipped == 2, f"phase 18d: latest() gave {skipped} past a "
          "corrupted checkpoint")
    check(s0 == 2 and l1 == l2, f"phase 18d: resumed at {s0}, loss {l2} "
          f"against {l1}")
    check(all(launches[k] > 0 for k in ("qpack_fixed_encode",
                                        "qpack_fixed_decode",
                                        "flash_attention")),
          f"phase 18d: a kernel was not launched: {launches}")
    return {"wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 19: the across-device paths (the sharded fabric, the DP train step).
# ---------------------------------------------------------------------------

SHARD_RANKS = 2           # 19b: gloo ranks sharing the one card
RANK_TIMEOUT = 300.0
# 19c: llama3-8b's widths at 8 of its 32 layers (the replicated f32
# residual costs 4 B a parameter: 11.2 GB at 8 layers, 32 GB at 32), bf16,
# compressed state; one warm-up step, DP_STEPS timed, one checked
DP_LAYERS = 8
DP_STEPS = 2
DP_WHOLE_RTOL = 1e-4      # 19d: 2 layers, float32, the two routes' losses


def _shard_spec(impl: str) -> dict:
    """12c's recipe (4,096 pages, 4 expanders, 80% skew, spill firing) as
    a ``fabric.shard.replay_specs`` spec: the pages written first, then
    mcf's trace; ``impl`` names ``compress_impl`` (the batched demote step
    on)."""
    from repro_torch.common.types import PoolConfig
    from repro_torch.simx.trace import (WORKLOADS, make_block_content,
                                        make_rates_table, make_trace)
    w = FABRIC_WHOLE
    cfg = PoolConfig(**w["pool"], store_payload=True, lossless=True,
                     compress_impl=impl, fused_demote="on")
    rates = make_rates_table(WORKLOADS["mcf"], w["pages"],
                             cfg.blocks_per_page, SEED)
    vals = make_block_content(rates, cfg.vals_per_block, SEED).reshape(
        w["pages"], cfg.vals_per_page).astype(np.float32)
    run = w["run"]
    return dict(cfg=dataclasses.asdict(cfg), policy="ibex",
                placement=("WeightedInterleave", (FABRIC_N, cfg.n_pages,
                                                  FABRIC_WEIGHTS)),
                fabric=dict(seed=SEED, window=run["window"],
                            spill_interval=run["spill_interval"],
                            spill_k=run["spill_k"],
                            spill_low=run["spill_low"]),
                write=(np.arange(w["pages"]), vals),
                trace=make_trace(WORKLOADS["mcf"], n_accesses=w["accesses"],
                                 n_pages=w["pages"], seed=SEED))


def _vmap_sync(spec: dict, dev):
    """The spec's fabric on the vmap synchronous driver on ``dev``."""
    from repro_torch.common.types import PoolConfig
    from repro_torch.core.engine import POLICIES
    from repro_torch.fabric import Fabric, placement as PL
    name, args = spec["placement"]
    fab = Fabric(PoolConfig(**spec["cfg"]), POLICIES[spec["policy"]],
                 getattr(PL, name)(*args), sync_migration=True, device=dev,
                 **spec["fabric"])
    ospns, vals = spec["write"]
    fab.write_pages(ospns, torch.from_numpy(vals).to(dev).to(torch.bfloat16))
    return fab.replay(*spec["trace"])


def _leaves_differ(a: dict, b: dict) -> list:
    return [k for k in b if a[k].dtype != b[k].dtype or
            not np.array_equal(a[k], b[k])]


def shard_ranks_start(dev, gate: str, gate20: str):
    """The SHARD_RANKS gloo ranks of 19b and 20b on ``dev`` (both blocks of
    the stack on the one card), started now on a thread: they start up and
    wait for the file ``gate``, run 19b, then wait for ``gate20`` and run
    20b (``_across_ranks``). Returns the future of (rank 0's 19b record,
    the time its replay ended, every rank's 20b record)."""
    import concurrent.futures as cf
    import tempfile
    from repro_torch.common import sharding as SH
    spec = _shard_spec("kernel")
    tmp = tempfile.mkdtemp(prefix="shard")

    def ranks():
        outs = SH.spawn_ranks(_across_ranks, SHARD_RANKS, backend="gloo",
                              args=(spec, gate20), device=str(dev),
                              workdir=tmp, timeout=RANK_TIMEOUT, gate=gate)
        return outs[0][0], outs[0][1], [o[2] for o in outs]

    pool = cf.ThreadPoolExecutor(1)
    fut = pool.submit(ranks)
    pool.shutdown(wait=False)
    return fut


def _across_ranks(group, spec: dict, gate20: str) -> tuple:
    """One of the ranks of ``shard_ranks_start`` (a spawn target, so it is
    a module-level function): 19b's replay, then, once ``gate20`` exists,
    20b (``_mesh_ranks``) and 20c (``_mesh_family_ranks``); in between,
    ``_train_warm``. Returns (its 19b record, the time its replay ended,
    its 20b record with 20c's under "families"); the 19b record is rank
    0's alone."""
    from repro_torch.fabric import shard as FS
    recs = FS.replay_specs(group, [spec])
    t_end = time.perf_counter()
    _train_warm(group.device)
    while not os.path.exists(gate20):
        time.sleep(0.01)
    mesh = _mesh_ranks(group)
    mesh["families"] = _mesh_family_ranks(group)
    return None if recs is None else recs[0], t_end, mesh


def phase_shard(dev, group, fut, gate: str, tag: str, during=None) -> dict:
    """19a/19b: 12c's payload fabric on the sharded driver, at D = 1 (this
    process, NCCL on cuda:0) and at D = SHARD_RANKS (the gloo ranks of
    ``shard_ranks_start``, released here through ``gate`` to run beside
    19a), B1's and B2's steps live; each against the vmap synchronous
    driver on the card with the PLAIN compression (every leaf of every
    expander and the override table equal: the sharded driver equals the
    vmap one, and the kernels their plain versions). Counts: boundary and
    drain fetches, apply syncs, B1's and B2's launches. ``during()`` runs
    here while the ranks finish."""
    from repro_torch import interop
    from repro_torch.common.types import PoolConfig
    from repro_torch.core.engine.invariants import first_violation
    from repro_torch.fabric import shard as FS
    t0 = time.perf_counter()
    spec = _shard_spec("kernel")
    Path(gate).touch()
    _sync(dev)
    t1 = time.perf_counter()
    d1 = FS.replay_specs(group, [spec])[0]
    _sync(dev)
    t_d1 = time.perf_counter() - t1
    t2 = time.perf_counter()
    ref = _vmap_sync(_shard_spec("jnp"), dev)
    _sync(dev)
    t_ref = time.perf_counter() - t2
    want = interop.pool_stack_to_numpy(ref.pools)
    extra = during() if during is not None else None
    d2, t_end, mesh_ranks = fut.result()
    t_d2 = t_end - t0
    cfg = PoolConfig(**spec["cfg"])
    res = {"during": extra, "mesh_ranks": mesh_ranks}
    for label, rec, wall in (("19a", d1, t_d1), ("19b", d2, t_d2)):
        diff = _leaves_differ(rec["leaves"], want)
        over = bool((rec["overrides"] == ref.placement.overrides).all())
        viol = [first_violation({k: v[e] for k, v in rec["leaves"].items()},
                                cfg) for e in range(FABRIC_N)]
        ss = rec["sync_stats"]
        res[label] = dict(rec["launches"], wall_s=wall, run_s=rec["run_s"])
        ranks_ = 1 if label == "19a" else SHARD_RANKS
        print(f"phase {label} sharded fabric, {ranks_} rank(s) "
              f"({'NCCL' if ranks_ == 1 else 'gloo'} on {dev}), 12c's "
              f"recipe ({FABRIC_N} expanders of "
              f"{json.dumps(FABRIC_WHOLE['pool'])}, "
              f"{FABRIC_WHOLE['pages']} pages written, "
              f"{FABRIC_WHOLE['accesses']} accesses) | rank 0's write and "
              f"replay {rec['run_s']:.3f} s, wall {wall:.3f} s"
              f"{' from the gate (beside 19a, the reference and 19d)' if ranks_ > 1 else ''}"
              f" | fetches: {ss['boundary_syncs']} boundary for "
              f"{ss['boundaries']} boundaries, {ss['drain_syncs']} drain, "
              f"{ss['segment_syncs']} segment, {ss['epoch_syncs']} epoch | "
              f"apply syncs {rec['apply_syncs']} | epochs {ss['epochs']}, "
              f"pages out {rec['spill_stats']['pages_out']} | launches "
              f"demote-and-compact {rec['launches']['demote']} promote "
              f"{rec['launches']['promote']} | against the vmap synchronous "
              f"driver with the plain compression ({ref.epochs_applied} "
              f"epochs, {t_ref:.3f} s): {len(want)} leaves, {len(diff)} "
              f"differ {diff}; overrides equal {over} | I1-I4 "
              f"{sum(v is not None for v in viol)} expanders broken "
              f"[{tag}]", flush=True)
        check(not diff and over, f"phase {label}: the sharded run differs "
              f"from the vmap driver: {diff}, overrides equal {over}")
        check(ss["boundary_syncs"] == ss["boundaries"] and
              ss["segment_syncs"] == ss["epoch_syncs"] == 0,
              f"phase {label}: fetches off budget: {ss}")
        check(ss["epochs"] > 0 and rec["launches"]["demote"] > 0 and
              rec["launches"]["promote"] > 0,
              f"phase {label}: no epoch or a kernel not launched: "
              f"{ss['epochs']} epochs, {rec['launches']}")
        check(not any(viol), f"phase {label}: I1-I4 broken: {viol}")
    res["wall_s"] = time.perf_counter() - t0
    return res


def _dp_step_run(dev, group, cfg, tcfg, impl: dict, steps: int,
                 check_codes: bool = False, mem: dict = None) -> dict:
    """``steps`` DP steps of ``cfg`` at world size ``group.world`` from the
    seeded params (the first a warm-up): losses, the timed steps' ms and
    launches, syncs, and with ``check_codes`` one more step in which every
    gradient leaf's B3 codes and scales and every B4 decode are held
    against the plain versions on the same inputs. ``mem``: gets the bytes
    allocated by the params, the state and the residuals ("args")."""
    import warnings
    from repro_torch.common import contracts
    from repro_torch.data.pipeline import make_batch
    from repro_torch.common import tree as TR
    from repro_torch.optim import adamw, gradcomp
    from repro_torch.train import trainer
    base = torch.cuda.memory_allocated(dev)
    params = trainer.init_params(cfg, SEED, dev)
    opt = adamw.init(params, tcfg.optimizer, impl["quantize_impl"])
    res = trainer.init_residual_flat(params, 1)
    if mem is not None:
        mem["args"] = torch.cuda.memory_allocated(dev) - base
    step = trainer.make_dp_compressed_step(cfg, tcfg, group, **impl)
    batches = [make_batch(cfg, i, global_batch=tcfg.global_batch,
                          seq_len=tcfg.seq_len, device=dev)
               for i in range(steps + 1)]
    params, opt, res, warm = step(params, opt, res, batches[0])
    torch.cuda.synchronize()
    _reset_launches()
    contracts.SYNCS.reset()
    evs, metrics = [], [warm]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for b in batches[1:steps]:
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                params, opt, res, m = step(params, opt, res, b)
                e.record()
                evs.append((a, e))
                metrics.append(m)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    debug_syncs = sum(SYNC_WARNING in str(w.message) for w in caught)
    out = {"ms": [a.elapsed_time(e) for a, e in evs],
           "launches": _launch_counts(), "syncs": contracts.SYNCS.count,
           "debug_syncs": debug_syncs, "slices": _train_slices(
               params, tcfg.optimizer.state_block),
           "leaves": sum(1 for _ in TR.leaves_with_paths(params))}
    if check_codes:
        bad = {"codes": 0, "scales": 0, "decoded": 0, "values": 0,
               "calls": 0}
        comp, decomp = gradcomp.compress_leaf, gradcomp.decompress_leaf

        def compress(g, block, impl_="auto"):
            c, p = comp(g, block, "kernel"), comp(g, block, "jnp")
            bad["codes"] += int((c["codes"] != p["codes"]).sum())
            bad["scales"] += int((~_bits_equal(c["scales"][:, None],
                                               p["scales"][:, None])).sum())
            bad["values"] += g.numel()
            bad["calls"] += 1
            return c

        def decompress(c, shape, block, impl_="auto"):
            a, p = decomp(c, shape, block, "kernel"), decomp(c, shape, block,
                                                            "jnp")
            bad["decoded"] += int((a.view(torch.int32) !=
                                   p.view(torch.int32)).sum())
            return a

        gradcomp.compress_leaf, gradcomp.decompress_leaf = compress, \
            decompress
        try:
            params, opt, res, m = step(params, opt, res, batches[steps])
            metrics.append(m)
        finally:
            gradcomp.compress_leaf, gradcomp.decompress_leaf = comp, decomp
        out["codes"] = bad
    host = contracts.fetch({f"loss{i}": m["loss"] for i, m in
                            enumerate(metrics)})
    out["losses"] = [float(host[f"loss{i}"]) for i in range(len(metrics))]
    del params, opt, res, batches
    return out


def phase_dp(dev, group, tag: str) -> dict:
    """19c: ``trainer.make_dp_compressed_step`` at world size 1 under NCCL
    on llama3-8b's widths cut to DP_LAYERS layers (bf16, compressed AdamW
    state, seq 512 x batch 8): one warm-up step, DP_STEPS timed (CUDA
    events), one more with every gradient leaf's B3 codes and B4 decodes
    held against the plain versions; launches a step (B3 once a leaf and
    twice a moment slice, B4 twice a leaf and twice a slice, B6 twice a
    layer), host syncs, peak memory."""
    t0 = time.perf_counter()
    cfg, tcfg = _train_configs(DP_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    mem: dict = {}
    r = _dp_step_run(dev, group, cfg, tcfg, WHOLE_IMPLS["kernel"],
                     DP_STEPS + 1, check_codes=True, mem=mem)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n = DP_STEPS
    got = {k: r["launches"][k] for k in ("qpack_fixed_encode",
                                         "qpack_fixed_decode",
                                         "flash_attention")}
    want = {"qpack_fixed_encode": (r["leaves"] + 2 * r["slices"]) * n,
            "qpack_fixed_decode": (2 * r["leaves"] + 2 * r["slices"]) * n,
            "flash_attention": 2 * cfg.num_layers * n}
    others = {k: v for k, v in r["launches"].items()
              if k not in want and k != "flash_attention_tc" and v}
    step_ms = statistics.median(r["ms"])
    c = r["codes"]
    print(f"phase 19c DP step: {cfg.name} at its widths, {cfg.num_layers} "
          f"of 32 layers ({cfg.param_count()} params), {cfg.dtype}, world "
          f"size {group.world} (NCCL), seq {tcfg.seq_len} x batch "
          f"{tcfg.global_batch}, compressed AdamW | losses (warm-up, timed, "
          f"checked) {r['losses']} | step {step_ms:.3f} ms median of "
          f"{[round(x, 3) for x in r['ms']]} (CUDA events) | peak "
          f"{peak:.3f} GiB | host syncs a step "
          f"{r['syncs'] / n:.1f} counted, {r['debug_syncs']} in PyTorch's "
          f"sync debug mode | launches over {n} steps {json.dumps(got)} "
          f"(expected {json.dumps(want)}: {r['leaves']} leaves, "
          f"{r['slices']} update slices); others {json.dumps(others)} | "
          f"checked step: {c['calls']} leaves, {c['values']} values: B3 "
          f"codes differing {c['codes']}, scales {c['scales']}; B4 decoded "
          f"values differing {c['decoded']} | wall "
          f"{time.perf_counter() - t0:.3f} s [{tag}]", flush=True)
    check(all(np.isfinite(r["losses"])), f"phase 19c: losses {r['losses']}")
    check(got == want, f"phase 19c: launches {got}, expected {want}")
    check(not others, f"phase 19c: other kernels launched: {others}")
    check(r["syncs"] == 0, f"phase 19c: {r['syncs']} counted host syncs")
    check(c["calls"] == r["leaves"] and c["codes"] == c["scales"] ==
          c["decoded"] == 0, f"phase 19c: B3/B4 differ from the plain "
          f"route: {c}")
    return {"launches": got, "step_ms": step_ms, "peak_gib": peak,
            "codes": c, "wall_s": time.perf_counter() - t0, "cfg": cfg,
            "tcfg": tcfg, "mem": mem}


def phase_dp_whole(dev, group, tag: str) -> float:
    """19d: the DP step at TRAIN_WHOLE_LAYERS layers in float32 (microbatches
    2, a warm-up and 2 more steps) on the kernel route and on the plain
    route: losses within DP_WHOLE_RTOL, and each route's launches."""
    t1 = time.perf_counter()
    cfg2, tcfg2 = _train_configs(TRAIN_WHOLE_LAYERS, "float32", 2)
    k = _dp_step_run(dev, group, cfg2, tcfg2, WHOLE_IMPLS["kernel"], 3)
    p = _dp_step_run(dev, group, cfg2, tcfg2, WHOLE_IMPLS["plain"], 3)
    rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
    routes = {name: {x: run["launches"][x] for x in (
        "qpack_fixed_encode", "qpack_fixed_decode", "flash_attention")}
        for name, run in (("kernel", k), ("plain", p))}
    wall = time.perf_counter() - t1
    print(f"phase 19d DP whole ({TRAIN_WHOLE_LAYERS} layers at llama3-8b's "
          f"widths, float32, microbatches 2, 3 steps): losses kernel "
          f"{k['losses']} / plain {p['losses']} (relative "
          f"{[f'{x:.2e}' for x in rel]}) | launches of the last 2 steps "
          f"{json.dumps(routes)} | wall {wall:.3f} s (beside 19b's ranks) "
          f"[{tag}]", flush=True)
    check(max(rel) <= DP_WHOLE_RTOL, f"phase 19d: losses differ: {rel}")
    check(all(routes["kernel"].values()) and
          not any(routes["plain"].values()),
          f"phase 19d: routes crossed: {routes}")
    return wall


def _dp_times(dev, cfg, tag: str) -> dict:
    """19e: the DP path's kernels at its shapes: B3/B4 on a whole gradient
    leaf (wq at DP_LAYERS layers), B6 at the train shape."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels import qpack
    t0 = time.perf_counter()
    n = cfg.num_layers * cfg.d_model * cfg.num_heads * cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    x = torch.randn((n,), generator=gen, device=dev) * 1e-3
    cs, sc = qpack.encode(x, 8, 512)
    B, S, Hq, Hkv, D, _ = TRAIN_ATTN[0]
    qa, ka, va = (torch.randn((B, S, h, D), generator=gen, device=dev)
                  .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    rows = _time_rows({
        "qpack_fixed_encode_dp": dict(
            shape=f"a gradient leaf of {n} f32 values (wq at "
                  f"{cfg.num_layers} layers) -> 8-bit codes, block 512",
            kern=lambda: qpack.encode(x, 8, 512),
            plain=lambda: qpack.encode_plain(x, 8, 512), lib=None,
            nbytes=n * 4 + n + n // 512 * 4,
            ops=ENCODE_OPS_PER_VALUE * n, ops_dtype="float32", reps=10),
        "qpack_fixed_decode_dp": dict(
            shape=f"{n} 8-bit codes, block 512 -> f32 (the gathered leaf)",
            kern=lambda: qpack.decode(cs, sc, 8, 512, torch.float32),
            plain=lambda: qpack.decode_plain(cs, sc, 8, 512, torch.float32),
            lib=None, nbytes=n + n // 512 * 4 + n * 4,
            ops=DECODE_OPS_PER_VALUE * n, ops_dtype="float32", reps=10),
        "flash_attention_dp": dict(
            shape=f"q {B}x{S}x{Hq}x{D}, kv {B}x{S}x{Hkv}x{D} bf16 causal "
                  f"(a layer's forward in the DP step)",
            kern=lambda: FA.flash_attention(qa, ka, va, causal=True),
            plain=lambda: FA.flash_attention_plain(qa, ka, va, causal=True),
            lib=lambda: _sdpa(qa, ka, va, True),
            nbytes=2 * B * S * D * (2 * Hq + 2 * Hkv),
            ops=4 * B * Hq * D * S * (S + 1) // 2, reps=10)}, "19e", tag)
    del x, cs, sc, qa, ka, va
    rows["wall_s"] = time.perf_counter() - t0
    return rows


# ---------------------------------------------------------------------------
# Phase 20: the mesh train step (FSDP over data, tensor parallel over model).
# ---------------------------------------------------------------------------

# 20b: llama3-8b's widths cut to 2 layers, float32 (the CPU test's dtype),
# the raw AdamW state, 2 steps of 4 x 256 tokens on each mesh, held to the
# single-device step with the CPU test's tolerances
# (tests/test_torch_train_mesh.py)
MESH_LAYERS = 2
MESH_SHAPES = ((1, 2), (2, 1))
MESH_STEPS = 2
MESH_BATCH, MESH_SEQ = 4, 256
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_TOL = 1e-4
# B6 at a rank's heads on a model axis of 2, at 18b's recipe (8 x 512,
# bf16: a four-card (x, 2) mesh's shape) and 20b's (4 x 256, float32):
# llama3-8b's 32/8 -> 16/4 x 128 (20b); minicpm3-4b's 40 x 96/64 -> 20,
# qwen3-moe's 64/4 x 128 -> 32/2, zamba2-2.7b's 32/32 x 80 -> 16/16 (20c).
# (row, query heads, KV heads, qk dim, v dim)
MESH_ATTN = (("flash_attention_mesh", 16, 4, 128, 128),
             ("flash_attention_mesh_mla", 20, 20, 96, 64),
             ("flash_attention_mesh_moe", 32, 2, 128, 128),
             ("flash_attention_mesh_hybrid", 16, 16, 80, 80))
MESH_ATTN_ROWS = ((8, 512, torch.bfloat16, ""),
                  (MESH_BATCH, MESH_SEQ, torch.float32, "_f32"))


def _mesh_configs():
    """20b's (model config, TrainConfig): the raw state, the launcher's
    optimizer."""
    from repro_torch.common.types import OptimizerConfig, TrainConfig
    cfg = dataclasses.replace(_llama(MESH_LAYERS), dtype="float32")
    return cfg, TrainConfig(seq_len=MESH_SEQ, global_batch=MESH_BATCH,
                            optimizer=OptimizerConfig(lr=3e-4,
                                                      warmup_steps=20))


def phase_mesh_one(dev, group, first: dict, tag: str) -> dict:
    """20a: ``trainer.make_train_step(mesh=)`` on a (1, 1) mesh over this
    process's NCCL world of one, at 18b's recipe (llama3-8b as published,
    bf16, the compressed state): one step from 18b's seed and first
    batch, with every launch count set to 0 before it and read after; its
    loss and ``_train_digest`` equal to 18b's first step's (``first``);
    step ms (CUDA events), host syncs (counted, and PyTorch's sync debug
    mode), peak memory."""
    import warnings
    from repro_torch.common import contracts
    from repro_torch.common.types import MeshConfig
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    cfg, tcfg = _train_configs()
    torch.cuda.reset_peak_memory_stats(dev)
    mesh = make_mesh(MeshConfig((1, 1), ("data", "model")), group)
    step_fn, sh = trainer.make_train_step(cfg, tcfg, mesh)
    base = torch.cuda.memory_allocated(dev)
    params = sh["params"].shard(trainer.init_params(cfg, SEED, dev))
    opt = adamw.init(params, tcfg.optimizer, sharding=sh["params"])
    mem = {"args": torch.cuda.memory_allocated(dev) - base}
    batch = sh["batch"].shard(make_batch(cfg, 0, global_batch=tcfg.global_batch,
                                         seq_len=tcfg.seq_len, device=dev))
    torch.cuda.synchronize()
    _reset_launches()
    contracts.SYNCS.reset()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            a.record()
            params, opt, m = step_fn(params, opt, batch)
            e.record()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = contracts.SYNCS.count
    debug = [str(w.message)[:120] for w in caught
             if SYNC_WARNING in str(w.message)]
    launches = _launch_counts()
    ms = a.elapsed_time(e)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    loss = float(contracts.fetch(m["loss"]))
    digest = _train_digest(params, opt)
    slices = _train_slices(params, tcfg.optimizer.state_block)
    want = {"qpack_fixed_encode": 2 * slices, "qpack_fixed_decode": 2 * slices,
            "flash_attention": 2 * cfg.num_layers,
            "flash_attention_tc": 2 * cfg.num_layers}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items() if k not in want and v}
    differ = sorted(k for k in first["digest"]
                    if digest.get(k) != first["digest"][k])
    del params, opt, batch, m
    wall = time.perf_counter() - t0
    print(f"phase 20a mesh (1, 1): {cfg.name} as published ({cfg.num_layers} "
          f"layers, {cfg.dtype}), 18b's recipe (seq {tcfg.seq_len} x batch "
          f"{tcfg.global_batch}, compressed AdamW), NCCL world of "
          f"{group.world} | loss {loss!r} (18b's first step {first['loss']!r})"
          f" | digest: {len(digest)} leaves (params' float64 sums, the "
          f"moments' code and scale sums), {len(differ)} differ from 18b's "
          f"first step {differ[:4]} | step {ms:.3f} ms (CUDA events, one "
          f"step) | peak {peak:.3f} GiB | host syncs {syncs} counted, "
          f"{len(debug)} in PyTorch's sync debug mode | launches "
          f"{json.dumps(got)} (expected 18b's a step {json.dumps(want)}); "
          f"others {json.dumps(others)} | wall {wall:.3f} s [{tag}]",
          flush=True)
    check(loss == first["loss"] and not differ and
          set(digest) == set(first["digest"]),
          f"phase 20a: the (1, 1) mesh step differs from 18b's first step: "
          f"loss {loss!r} vs {first['loss']!r}, leaves {differ[:8]}")
    check(got == want, f"phase 20a: launches {got}, expected {want}")
    check(not others, f"phase 20a: other kernels launched: {others}")
    check(syncs == 0 and not debug,
          f"phase 20a: the step synced: {syncs} counted, {debug[:3]}")
    return {"launches": got, "step_ms": ms, "peak_gib": peak,
            "wall_s": wall, "mem": mem}


def _train_warm(dev) -> None:
    """One train step of a small float32 model (2 layers, d 256, 2/1 heads
    of 128) on ``dev``: a fresh process pays its first training step's
    one-time costs here (about 10 s on the chip's host, whatever the
    model's size: the libraries' kernels loaded), not inside a collective
    step where the other rank would wait for it."""
    from repro_torch.common.types import TrainConfig
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32",
                              num_heads=2, num_kv_heads=1, head_dim=128)
    tcfg = TrainConfig(seq_len=64, global_batch=2)
    p = trainer.init_params(cfg, SEED, dev)
    opt = adamw.init(p, tcfg.optimizer)
    trainer.make_train_step(cfg, tcfg)[0](
        p, opt, make_batch(cfg, 0, global_batch=2, seq_len=64, device=dev))
    torch.cuda.synchronize()


def _mesh_ranks(group) -> dict:
    """20b on one of ``shard_ranks_start``'s ranks: rank 0 first trains
    the single-device step (its end params kept); then both ranks train
    each mesh of MESH_SHAPES from the seeded params over the same
    batches, every launch of B6 tallied by its (query heads / KV heads x
    head dim); rank 0 holds each mesh's losses and gathered params to the
    single-device step's."""
    from repro_torch.common.types import MeshConfig
    from repro_torch.common import tree as TR
    from repro_torch.data.pipeline import make_batch
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    dev = group.device
    cfg, tcfg = _mesh_configs()
    batches = [make_batch(cfg, i, global_batch=MESH_BATCH, seq_len=MESH_SEQ,
                          device=dev) for i in range(MESH_STEPS)]
    out = {"rank": group.rank, "meshes": {}}
    ref = None
    if group.rank == 0:
        p = trainer.init_params(cfg, SEED, dev)
        opt = adamw.init(p, tcfg.optimizer)
        step = trainer.make_train_step(cfg, tcfg)[0]
        losses = []
        for b in batches:
            p, opt, m = step(p, opt, b)
            losses.append(m["loss"])
        out["single"] = [float(x) for x in torch.stack(losses).cpu()]
        ref = p
        del opt
    heads: dict = {}
    launch = FA._launch

    def tallied(q, k, v, causal, sm_scale):
        key = f"{q.shape[2]}/{k.shape[2]} x {q.shape[3]}"
        heads[key] = heads.get(key, 0) + 1
        return launch(q, k, v, causal, sm_scale)

    FA._launch = tallied
    try:
        for shape in MESH_SHAPES:
            heads.clear()
            mesh = make_mesh(MeshConfig(shape, ("data", "model")), group)
            step, sh = trainer.make_train_step(cfg, tcfg, mesh)
            p = sh["params"].shard(trainer.init_params(cfg, SEED, dev))
            opt = adamw.init(p, tcfg.optimizer, sharding=sh["params"])
            losses, evs = [], []
            for b in batches:
                a = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                a.record()
                p, opt, m = step(p, opt, sh["batch"].shard(b))
                e.record()
                evs.append((a, e))
                losses.append(m["loss"])
            torch.cuda.synchronize()
            rec = {"losses": [float(x) for x in torch.stack(losses).cpu()],
                   "ms": [a.elapsed_time(e) for a, e in evs],
                   "heads": dict(heads)}
            del opt
            whole = sh["params"].gather(p)
            del p
            if ref is not None:
                rec["param_err"] = max(
                    float((x.float() - TR.get(ref, path).float()).norm() /
                          TR.get(ref, path).float().norm())
                    for path, x in TR.leaves_with_paths(whole))
            del whole
            torch.cuda.empty_cache()
            out["meshes"]["%dx%d" % shape] = rec
    finally:
        FA._launch = launch
    out["gloo"] = _gloo_rates(group)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _gloo_rates(group) -> dict:
    """GiB/s of gloo's all_reduce and broadcast of one of ``Mesh``'s 64 MiB
    pieces between the ranks sharing the card (the median of 3 calls each,
    CUDA tensors, the ranks lined up by a barrier before each)."""
    import torch.distributed as dist
    from repro_torch.common import sharding as SH
    x = torch.zeros(SH.COLLECTIVE_BYTES, dtype=torch.uint8,
                    device=group.device)
    out = {}
    for op in ("all_reduce", "broadcast"):
        secs = []
        for _ in range(3):
            torch.cuda.synchronize(group.device)
            dist.barrier()
            t = time.perf_counter()
            if op == "all_reduce":
                dist.all_reduce(x)
            else:
                dist.broadcast(x, src=0)
            torch.cuda.synchronize(group.device)
            secs.append(time.perf_counter() - t)
        out[op] = SH.COLLECTIVE_BYTES / 2 ** 30 / statistics.median(secs)
    return out


# 20c: the MLA, MoE, SSM and hybrid families on the mesh, on 20b's ranks
# after 20b, at 20b's recipe (float32, the raw state, 2 steps): (name,
# config, mesh, global batch, seq, microbatches). Published widths at 1
# layer on (1, 2) (zamba2: one group, its 6 Mamba2 layers and its shared
# block); arctic at REDUCED (a published layer's experts are 53.6 GB in
# float32); qwen3-moe at REDUCED on (2, 1): a global 2 x 512 (one grouped
# call, one group a rank) and 4 x 32 at microbatches 2 (the sorted call,
# its rows re-dealt). The REDUCED configs take head dim 64, B6's least
# (theirs is 32)
def _reduced(arch):
    from repro_torch.configs import get_reduced
    return dataclasses.replace(get_reduced(arch), head_dim=64)


MESH_FAMILY_RUNS = (
    ("minicpm3-4b", lambda: _minicpm(1), (1, 2), MESH_BATCH, MESH_SEQ, 1),
    ("qwen3-moe", lambda: _qwen3moe(1), (1, 2), MESH_BATCH, MESH_SEQ, 1),
    ("falcon-mamba-7b", lambda: _falcon(1), (1, 2), MESH_BATCH, MESH_SEQ,
     1),
    ("zamba2-2.7b", lambda: _zamba2(6), (1, 2), MESH_BATCH, MESH_SEQ, 1),
    ("arctic REDUCED", lambda: _reduced("arctic_480b"), (1, 2),
     MESH_BATCH, MESH_SEQ, 1),
    ("qwen3-moe REDUCED grouped", lambda: _reduced("qwen3_moe_235b_a22b"),
     (2, 1), 2, 512, 1),
    ("qwen3-moe REDUCED microbatches 2",
     lambda: _reduced("qwen3_moe_235b_a22b"), (2, 1), 4, 32, 2))
MESH_ARGS_RTOL = 0.01     # counted argument bytes against the allocation
# a one-device step the dry run counts past this share of the card is
# trained by one rank at a time (two at once would not fit)
MESH_SHARE = 0.45


def _mesh_family_one(group, name, cfg, shape, gb, seq, k, heads) -> dict:
    """One run of 20c on this rank: the one-device step from the seed (2
    steps; both ranks at once, or in turn where the dry run counts its
    peak past MESH_SHARE of the card), its end blocks of this rank kept
    on the host; then the mesh step from the same seed, the argument
    bytes (params, state, a batch) against the dry run's count, 2 steps
    timed (CUDA events), host syncs counted, B6's launches tallied by
    head count (``heads``); then each leaf against the kept one on the
    card, the squared differences summed over the ranks (a leaf the mesh
    replicates counted once): the params' normwise error over the whole
    tree, which 20c holds, and each leaf's, reported. A leaf the seed
    makes zeros (Mamba2's conv_b and A_log) holds after 2 steps only
    AdamW's updates, lr m / (sqrt(v) + eps), whose value moves with the
    order of float32 sums wherever a gradient is near eps: normwise to
    itself it is no measure of the step."""
    import torch.distributed as dist
    from repro_torch.common import contracts
    from repro_torch.common import tree as TR
    from repro_torch.common.types import (MeshConfig, OptimizerConfig,
                                          ShapeConfig, TrainConfig)
    from repro_torch.data.pipeline import make_batch
    from repro_torch.launch import dryrun as DRY
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    t0 = time.perf_counter()
    dev = group.device
    cfg = dataclasses.replace(cfg, dtype="float32")
    tcfg = TrainConfig(seq_len=seq, global_batch=gb, microbatches=k,
                       optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))
    mc = MeshConfig(shape, ("data", "model"))
    one = DRY.count_cell(cfg, ShapeConfig("20c", seq, gb, "train"),
                         MeshConfig((1, 1), mc.axes), tcfg)["peak_bytes"]
    counted = DRY.count_cell(cfg, ShapeConfig("20c", seq, gb, "train"), mc,
                             tcfg)["memory"]["argument_bytes"]
    turns = one > MESH_SHARE * torch.cuda.get_device_properties(
        dev).total_memory
    mesh = make_mesh(mc, group)
    step, sh = trainer.make_train_step(cfg, tcfg, mesh)
    batches = [make_batch(cfg, i, global_batch=gb, seq_len=seq, device=dev)
               for i in range(MESH_STEPS)]
    single, kept = None, None
    home = "cpu" if turns else dev       # where the kept end blocks wait
    for turn in range(group.world if turns else 1):
        if turns:
            dist.barrier()
        if not turns or turn == group.rank:
            p = trainer.init_params(cfg, SEED, dev)
            opt = adamw.init(p, tcfg.optimizer)
            one_step = trainer.make_train_step(cfg, tcfg)[0]
            losses = []
            for b in batches:
                p, opt, m = one_step(p, opt, b)
                losses.append(m["loss"])
            single = [float(x) for x in torch.stack(losses).cpu()]
            del opt, m
            kept = TR.map_tree(lambda t: t.to(home, copy=True),
                               sh["params"].shard(p))
            del p
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
    if turns:
        dist.barrier()
    base = torch.cuda.memory_allocated(dev)
    p = sh["params"].shard(trainer.init_params(cfg, SEED, dev))
    opt = adamw.init(p, tcfg.optimizer, sharding=sh["params"])
    torch.cuda.synchronize(dev)
    rows = [sh["batch"].shard(b) for b in batches]
    del batches
    args = torch.cuda.memory_allocated(dev) - base + \
        sum(v.numel() * v.element_size() for v in rows[0].values())
    heads.clear()
    contracts.SYNCS.reset()
    losses, evs = [], []
    for b in rows:
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        p, opt, m = step(p, opt, b)
        e.record()
        evs.append((a, e))
        losses.append(m["loss"])
    torch.cuda.synchronize(dev)
    syncs = contracts.SYNCS.count
    tally = dict(heads)
    heads.clear()
    del opt, m, rows
    torch.cuda.empty_cache()
    sums = []
    for path, x in TR.leaves_with_paths(p):
        r = TR.get(kept, path).to(dev)
        own = float(mesh.owns(sh["params"].spec(path)))
        sums.append(torch.stack([(x - r).float().norm() ** 2,
                                 r.float().norm() ** 2]) * own)
        del r
    sums = mesh.psum(torch.stack(sums).double(), None).cpu()
    err = (sums[:, 0] / sums[:, 1].clamp(min=1e-300)).sqrt()
    tree = float((sums[:, 0].sum() / sums[:, 1].sum()).sqrt())
    paths = ["/".join(map(str, path)) for path, _ in TR.leaves_with_paths(p)]
    worst = {paths[i]: [float(err[i]), float(sums[i, 1].sqrt())]
             for i in err.argsort(descending=True)[:3].tolist()}
    del p, kept
    torch.cuda.empty_cache()
    return {"name": name, "arch": cfg.name, "layers": cfg.num_layers,
            "shape": list(shape), "batch": [gb, seq, k],
            "params": cfg.param_count(), "turns": bool(turns),
            "losses": [float(x) for x in torch.stack(losses).cpu()],
            "single": single, "param_err": tree,
            "leaf_err": float(err.max()), "worst": worst,
            "ms": [a.elapsed_time(e) for a, e in evs], "heads": tally,
            "syncs": syncs, "args": args, "args_counted": counted,
            "wall_s": time.perf_counter() - t0}


def _mesh_family_ranks(group) -> dict:
    """20c on one of ``shard_ranks_start``'s ranks, after 20b: each run of
    MESH_FAMILY_RUNS (``_mesh_family_one``), B6's launches tallied by its
    (query heads / KV heads x head dim) while the mesh steps run."""
    from repro_torch.kernels import flash_attn as FA
    t0 = time.perf_counter()
    heads: dict = {}
    launch = FA._launch

    def tallied(q, k, v, causal, sm_scale):
        key = f"{q.shape[2]}/{k.shape[2]} x {q.shape[3]}"
        heads[key] = heads.get(key, 0) + 1
        return launch(q, k, v, causal, sm_scale)

    FA._launch = tallied
    runs = []
    try:
        for name, make, shape, gb, seq, k in MESH_FAMILY_RUNS:
            runs.append(_mesh_family_one(group, name, make(), shape, gb,
                                         seq, k, heads))
            if group.rank == 0:         # progress, should a later run fail
                print(f"phase 20c rank 0 {name}: losses "
                      f"{runs[-1]['losses']}, params "
                      f"{runs[-1]['param_err']:.3e}, wall "
                      f"{runs[-1]['wall_s']:.3f} s", flush=True)
    finally:
        FA._launch = launch
    return {"runs": runs, "wall_s": time.perf_counter() - t0}


def _mesh_family_heads(cfg, shape) -> dict:
    """B6's launches a rank of 20c expects: forward and remat a layer (the
    hybrid: a group's shared block), a microbatch, a step, at the rank's
    heads (MLA: query heads x qk dim; K heads as many)."""
    m = shape[1]
    if cfg.attn_kind == "none":
        return {}
    if cfg.attn_kind == "mla":
        key = (f"{cfg.num_heads // m}/{cfg.num_heads // m} x "
               f"{cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim}")
    else:
        key = (f"{cfg.num_heads // m}/{cfg.num_kv_heads // m} x "
               f"{cfg.resolved_head_dim}")
    from repro_torch.models import transformer as T
    sites = T.hybrid_groups(cfg)[0] if cfg.family == "hybrid" else \
        cfg.num_layers
    return {key: 2 * sites * MESH_STEPS}


def phase_mesh_family(ranks: list, gloo: dict, tag: str) -> dict:
    """20c's report from the ranks' records: each run's losses and params
    against the one-device step's, its argument bytes against the count
    on every rank, step ms beside gloo's rates, host syncs, B6's launches
    by head count. Returns B6's launches of each run (both ranks) and the
    phase's wall on the ranks."""
    launches = {}
    makers = {n: mk for n, mk, *_ in MESH_FAMILY_RUNS}
    for i, r0 in enumerate(ranks[0]["families"]["runs"]):
        per = [r["families"]["runs"][i] for r in ranks]
        rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                   r0["single"])]
        name = r0["name"]
        cfg = makers[name]()
        want = _mesh_family_heads(cfg, r0["shape"])
        want = {h: n * r0["batch"][2] for h, n in want.items()}
        args = [abs(r["args"] - r["args_counted"]) / r["args_counted"]
                for r in per]
        print(f"phase 20c mesh {tuple(r0['shape'])} {name}: {r0['arch']} "
              f"{r0['layers']} layer(s), {r0['params']} params, float32, raw "
              f"AdamW, {MESH_STEPS} steps of {r0['batch'][0]} x "
              f"{r0['batch'][1]} at microbatches {r0['batch'][2]} | losses "
              f"{r0['losses']} against the one-device step's {r0['single']}"
              f"{' (trained by each rank in turn)' if r0['turns'] else ''} "
              f"(relative {[f'{x:.2e}' for x in rel]}) | params normwise "
              f"{r0['param_err']:.3e} over the tree, {r0['leaf_err']:.3e} "
              f"the worst leaf (the 3 worst leaves' [normwise error, "
              f"norm]: {json.dumps(r0['worst'])}) | argument bytes a rank "
              f"{[r['args'] for r in per]} against the count "
              f"{r0['args_counted']} (relative "
              f"{[f'{x:.2e}' for x in args]}) | step ms on rank 0 "
              f"{[round(x, 3) for x in r0['ms']]} (CUDA events; gloo "
              f"all_reduce {gloo['all_reduce']:.3f}, broadcast "
              f"{gloo['broadcast']:.3f} GiB/s) | host syncs "
              f"{[r['syncs'] for r in per]} | B6 launches by heads, rank by "
              f"rank {json.dumps([r['heads'] for r in per])} | wall "
              f"{r0['wall_s']:.3f} s [{tag}]", flush=True)
        check(max(rel) <= MESH_LOSS_RTOL and
              r0["param_err"] <= MESH_PARAM_TOL,
              f"phase 20c {name}: losses {rel}, params {r0['param_err']}")
        check(max(args) <= MESH_ARGS_RTOL, f"phase 20c {name}: argument "
              f"bytes {[r['args'] for r in per]} against "
              f"{r0['args_counted']}")
        check(all(r["heads"] == want for r in per),
              f"phase 20c {name}: B6 launches {[r['heads'] for r in per]}, "
              f"expected {want} a rank")
        launches[name] = sum(sum(r["heads"].values()) for r in per)
    wall = max(r["families"]["wall_s"] for r in ranks)
    print(f"phase 20c wall {wall:.3f} s on the ranks [{tag}]", flush=True)
    return {"launches": launches, "wall_s": wall}


def phase_mesh_kernels(dev, tag: str) -> tuple:
    """20b's and 20c's kernel side, in this process beside the ranks: B6 at
    a rank's head counts on a model axis of 2 (MESH_ATTN at each of
    MESH_ATTN_ROWS) against its plain version (ATTN_TOL elementwise,
    ATTN_NORM_TOL normwise), and its kernel / eager / plain / library /
    bound times."""
    from repro_torch.kernels import flash_attn as FA
    gen = torch.Generator(device=dev).manual_seed(SEED + 70)
    errs, rows = {}, {}
    for name, Hq, Hkv, D, Dv in MESH_ATTN:
        err = errs[name] = {"err": 0.0, "cases": 0, "mismatches": 0,
                            "norm_fails": 0}
        for B, S, dt, suffix in MESH_ATTN_ROWS:
            q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev)
                       .to(dt) for h, d in ((Hq, D), (Hkv, D), (Hkv, Dv)))
            n0 = FA.launches
            o = FA.flash_attention(q, k, v, causal=True)
            check(FA.launches == n0 + 1, f"phase 20: B6 did not launch at "
                  f"{Hq}/{Hkv} x {D}/{Dv}")
            want = FA.flash_attention_plain(q, k, v, causal=True).float()
            d = (o.float() - want).abs()
            err["cases"] += 1
            err["mismatches"] += int((d > ATTN_TOL[dt] *
                                      (1 + want.abs())).sum())
            err["norm_fails"] += int(float((o.float() - want).norm() /
                                           want.norm()) > ATTN_NORM_TOL[dt])
            err["err"] = max(err["err"], float(d.max()))
            rows[name + suffix] = dict(
                shape=f"q {B}x{S}x{Hq}x{D}, k {B}x{S}x{Hkv}x{D}, v "
                      f"{B}x{S}x{Hkv}x{Dv} {str(dt)[6:]} causal (a rank's "
                      f"heads at model 2)",
                kern=lambda q=q, k=k, v=v: FA.flash_attention(q, k, v,
                                                              causal=True),
                plain=lambda q=q, k=k, v=v: FA.flash_attention_plain(
                    q, k, v, causal=True),
                lib=lambda q=q, k=k, v=v: _sdpa(q, k, v, True),
                nbytes=B * S * (Hq + Hkv) * (D + Dv) * q.element_size(),
                ops=2 * B * Hq * (S * (S + 1) // 2) * (D + Dv),
                ops_dtype=dt, reps=10)
            del o, want, d
    print(f"phase 20 kernels: B6 at a rank's heads on a model axis of 2 "
          f"(bf16 8 x 512 and f32 4 x 256): {json.dumps(errs)} [{tag}]",
          flush=True)
    check(all(e["mismatches"] == 0 and e["norm_fails"] == 0
              for e in errs.values()), f"phase 20: B6 at a rank's heads off "
          f"tolerance: {errs}")
    return errs, _time_rows(rows, "20", tag)


def phase_mesh_ranks(ranks: list, wall: float, tag: str) -> dict:
    """20b's report from the ranks' records: each mesh's losses and params
    against the single-device step's, B6's launches by head count, step
    ms. Returns B6's launches at 16/4 x 128 (the (1, 2) mesh's)."""
    r0 = ranks[0]
    single = r0["single"]
    cfg = _mesh_configs()[0]
    launches = 0
    for name, rec in r0["meshes"].items():
        rel = [abs(a - b) / abs(b) for a, b in zip(rec["losses"], single)]
        per_rank = [r["meshes"][name]["heads"] for r in ranks]
        n = sum(sum(h.values()) for h in per_rank)
        model = int(name.split("x")[1])
        want_heads = (f"{cfg.num_heads // model}/"
                      f"{cfg.num_kv_heads // model} x "
                      f"{cfg.resolved_head_dim}")
        print(f"phase 20b mesh ({name.replace('x', ', ')}) on "
              f"{len(ranks)} gloo ranks sharing the card: llama3-8b's "
              f"widths, {MESH_LAYERS} layers, float32, raw AdamW, "
              f"{MESH_STEPS} steps of {MESH_BATCH} x {MESH_SEQ} | losses "
              f"{rec['losses']} against the single-device step's {single} "
              f"(relative {[f'{x:.2e}' for x in rel]}) | params normwise "
              f"{rec['param_err']:.3e} at most | B6 launches by heads, rank "
              f"by rank {json.dumps(per_rank)} | step ms on rank 0 "
              f"{[round(x, 3) for x in rec['ms']]} (CUDA events) [{tag}]",
              flush=True)
        check(max(rel) <= MESH_LOSS_RTOL and
              rec["param_err"] <= MESH_PARAM_TOL,
              f"phase 20b {name}: losses {rel}, params {rec['param_err']}")
        check(all(list(h) == [want_heads] and
                  h[want_heads] == 2 * MESH_LAYERS * MESH_STEPS
                  for h in per_rank),
              f"phase 20b {name}: B6 launches {per_rank}, expected "
              f"{2 * MESH_LAYERS * MESH_STEPS} a rank at {want_heads}")
        if model == 2:
            launches += n
    print(f"phase 20b gloo between the ranks, a 64 MiB piece on the card: "
          f"all_reduce {r0['gloo']['all_reduce']:.3f} GiB/s, broadcast "
          f"{r0['gloo']['broadcast']:.3f} GiB/s (median of 3) [{tag}]",
          flush=True)
    print(f"phase 20b wall {max(r['wall_s'] for r in ranks):.3f} s on the "
          f"ranks, {wall:.3f} s from the gate [{tag}]", flush=True)
    return {"launches": launches, "gloo": r0["gloo"],
            "ms": {name: rec["ms"] for name, rec in r0["meshes"].items()}}



def phase_across(dev, tag: str, times: dict, errs: dict, train: dict,
                 train_times: dict, train_errs: dict, fut, gate: str,
                 gate20: str) -> list:
    """Phases 19 and 20 on one NCCL rank group of world size 1 on cuda:0
    here: the DP train step (19c), its kernels' times (19e) and the (1, 1)
    mesh step (20a) with the card to themselves; then the sharded fabric
    (19a in this process, 19b on the gloo ranks, released through
    ``gate``) with the DP step's two routes (19d) beside them; then 20b on
    the same ranks (released through ``gate20`` once 19d is done); then
    B6 at a rank's head counts, checked and timed with the card to itself.
    Returns the kernels line's entries for both phases. ``fut``: the
    ranks (``shard_ranks_start``)."""
    import tempfile
    from repro_torch.common import sharding as SH
    t0 = time.perf_counter()
    pg = tempfile.mkdtemp(prefix="pg")
    group = SH.init_expander_ranks(1, 0, "nccl", f"file://{pg}/pg", dev)
    beside = {}

    def during():
        beside["19d"] = phase_dp_whole(dev, group, tag)
        torch.cuda.empty_cache()
        Path(gate20).touch()
        beside["t20"] = time.perf_counter()

    try:
        dp = phase_dp(dev, group, tag)
        torch.cuda.empty_cache()
        rows = _dp_times(dev, dp["cfg"], tag)
        mesh_one = phase_mesh_one(dev, group, train["first"], tag)
        torch.cuda.empty_cache()
        t_ab = time.perf_counter()
        shard = phase_shard(dev, group, fut, gate, tag, during=during)
        t_ab = time.perf_counter() - t_ab
    finally:
        SH.leave_expander_ranks()
        Path(gate20).touch()    # a failed phase lets the ranks finish
    torch.cuda.empty_cache()
    mesh_ranks = phase_mesh_ranks(shard["mesh_ranks"],
                                  time.perf_counter() - beside["t20"], tag)
    family = phase_mesh_family(shard["mesh_ranks"], mesh_ranks["gloo"], tag)
    mesh_errs, mesh_times = phase_mesh_kernels(dev, tag)   # the card alone
    wall = time.perf_counter() - t0
    print(f"phase 19 wall {wall:.3f} s ({json.dumps({'19c': round(dp['wall_s'], 3), '19e': round(rows['wall_s'], 3), '19abd': round(t_ab, 3)})}) "
          f"[{tag}]", flush=True)
    print(f"phase 20 wall {mesh_one['wall_s'] + time.perf_counter() - beside['t20']:.3f} s (20a "
          f"{mesh_one['wall_s']:.3f} s, then 20b and 20c from the gate to "
          f"their reports, beside 19b's end, and B6's rows; 20c "
          f"{family['wall_s']:.3f} s on the ranks) [{tag}]", flush=True)
    kernels = []
    for kind, line in (("demote", 278), ("promote", 305)):
        t = times[(kind, 8 if kind == "demote" else 1)]
        kernels.append({
            "name": f"qpack_fused_{kind}_sharded", "route": "cuda",
            "source": "src/repro_torch/csrc/qpack_fused.cu",
            "replaces": f"src/repro/kernels/qpack.py:{line}",
            "launches": shard["19a"][kind] + shard["19b"][kind],
            "max_abs_err": errs[kind]["err"], "ms": t["ms"],
            "bytes": t["bytes"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "eager_ms": t["eager_ms"],
            "path": "the sharded payload fabric (phases 19a and 19b); "
                    "times at phase 5's shape",
            "shape": f"{8 if kind == 'demote' else 1} pages of 4x512 bf16",
            "cases": errs[kind]["cases"],
            "mismatches": errs[kind]["mismatches"]})
    c = dp["codes"]
    for name_, src, rep, key in (
            ("qpack_fixed_encode_dp", "qpack_fixed.cu", "qpack.py:122",
             "qpack_fixed_encode"),
            ("qpack_fixed_decode_dp", "qpack_fixed.cu", "qpack.py:148",
             "qpack_fixed_decode"),
            ("flash_attention_dp", "flash_attn.cu", "flash_attn.py:72",
             "flash_attention")):
        t = rows[name_]
        e = train_errs["flash_attention_train"] if key == "flash_attention" \
            else {"err": 0.0, "cases": c["calls"],
                  "mismatches": c["codes"] + c["scales"]
                  if key == "qpack_fixed_encode" else c["decoded"]}
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": dp["launches"][key], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": "the data-parallel train step (phase 19c): "
                    + ("the forward and the remat forward"
                       if key == "flash_attention" else
                       "the gradient codes and the AdamW moments"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    # the mesh step (phase 20): 20a's launches at 18a's shapes and times;
    # B6 at a rank's heads on 20b's (1, 2) mesh, timed in 20b
    for name_, src, rep, key, row in (
            ("qpack_fixed_encode_mesh", "qpack_fixed.cu", "qpack.py:122",
             "qpack_fixed_encode", "qpack_fixed_encode_train"),
            ("qpack_fixed_decode_mesh", "qpack_fixed.cu", "qpack.py:148",
             "qpack_fixed_decode", "qpack_fixed_decode_train"),
            ("flash_attention_mesh_one", "flash_attn.cu", "flash_attn.py:72",
             "flash_attention", "flash_attention_train"),
            ("flash_attention_mesh", "flash_attn.cu", "flash_attn.py:72",
             None, "flash_attention_mesh_f32")):
        t = mesh_times[row] if key is None else train_times[row]
        e = mesh_errs["flash_attention_mesh"] if key is None \
            else train_errs[row]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{rep}",
            "launches": mesh_ranks["launches"] if key is None
            else mesh_one["launches"][key], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": "the mesh step at (1, 2) on two ranks (phase 20b): a "
                    "rank's 16/4 heads, forward and remat forward"
                    if key is None else "the mesh step at (1, 1) (phase "
                    "20a); times at 18a's shape",
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    kernels[-1]["path_shapes"] = {"bf16 8x512": {
        f: mesh_times["flash_attention_mesh"][f]
        for f in ("ms", "eager_ms", "library_ms", "bound_ms")}}
    # B6 at the families' rank heads on 20c's (1, 2) meshes, f32 4 x 256
    # (the path's), bf16 8 x 512 beside it
    for row, run in (("flash_attention_mesh_mla", "minicpm3-4b"),
                     ("flash_attention_mesh_moe", "qwen3-moe"),
                     ("flash_attention_mesh_hybrid", "zamba2-2.7b")):
        t, e = mesh_times[row + "_f32"], mesh_errs[row]
        kernels.append({
            "name": row, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:72",
            "launches": family["launches"][run], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": f"the mesh step at (1, 2) on two ranks (phase 20c): "
                    f"{run}'s rank heads, forward and remat forward",
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"],
            "path_shapes": {"bf16 8x512": {
                f: mesh_times[row][f]
                for f in ("ms", "eager_ms", "library_ms", "bound_ms")}}})
    return kernels, {"dp": dp, "mesh_one": mesh_one,
                     "mesh_ranks": mesh_ranks, "mesh_family": family}


# ---------------------------------------------------------------------------
# Phase 21: the dry run's counts against what phases 18-20 measured.
# ---------------------------------------------------------------------------

DRYRUN_ARGV = ["--all", "--devices", "8"]
DRYRUN_MEM_RTOL = 0.01      # a count of allocated bytes against the card's


def dryrun_start() -> dict:
    """``python -m repro_torch.launch.dryrun`` with DRYRUN_ARGV started on
    the host, its output piped, its records in a temporary directory;
    phase 21 starts it and collects it (it runs beside phase 21's own
    counts, after every phase that times something)."""
    import tempfile
    out_dir = tempfile.mkdtemp(prefix="dryrun")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGV,
         "--out", out_dir], cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return {"proc": proc, "dir": out_dir, "t0": time.perf_counter()}


def dryrun_stop(dry: dict) -> None:
    import shutil
    if dry["proc"].poll() is None:
        dry["proc"].kill()
        dry["proc"].wait()
    shutil.rmtree(dry["dir"], ignore_errors=True)


def phase_roofline(dev, tag: str, train: dict, info: dict) -> dict:
    """21: ``launch/dryrun.py``'s per-rank counts beside phases 18-20's
    measurements, no new training run: the argument bytes (params, state,
    grads; 19c's residuals) of 18b, 19c and 20a within DRYRUN_MEM_RTOL of
    ``torch.cuda.memory_allocated`` taken where those tensors and nothing
    else were alive; 18b's peak estimate beside its measured peak; 18b's
    roofline terms beside its step, and its model-FLOP share from
    ``roofline.analyze``; 20b's collective bytes at (1, 2) and (2, 1) timed
    at gloo's rates measured between 20b's ranks, beside 20b's steps; the
    card's memory against ``analyze.HBM_BYTES``; and
    ``python -m repro_torch.launch.dryrun --all --devices 8`` on the host
    (started here, beside the rest of this phase), its own time, with 0
    failures."""
    from repro_torch.common.types import MeshConfig, ShapeConfig
    from repro_torch.launch import dryrun as DRY
    from repro_torch.roofline import analyze as RA
    t0 = time.perf_counter()
    dry = dryrun_start()
    proc = dry["proc"]
    try:
        one = MeshConfig((1, 1), ("data", "model"))
        cfg, tcfg = _train_configs()
        rec = DRY.count_cell(cfg, DRY.TRAIN_512, one, tcfg)
        pr = rec["per_rank"]
        dp = info["dp"]
        dcfg, dtcfg = dp["cfg"], dp["tcfg"]
        r19 = DRY.count_cell(dcfg, ShapeConfig(
            "train_19c", dtcfg.seq_len, dtcfg.global_batch, "train"), one,
            dtcfg)["per_rank"]
        held = {
            "18b params + state": (pr["params"] + pr["state"],
                                   train["mem"]["args"]),
            "18b params + state + grads + batch": (
                pr["params"] + pr["state"] + pr["grads"] + pr["batch"],
                train["mem"]["with_grads"]),
            # the DP step's error-feedback rows: float32, a value a param
            "19c params + state + residuals": (
                r19["params"] + r19["state"] + 4 * r19["values"],
                dp["mem"]["args"]),
            "20a params + state": (pr["params"] + pr["state"],
                                   info["mesh_one"]["mem"]["args"])}
        errs = {k: abs(got - want) / want for k, (want, got) in held.items()}
        print(f"phase 21 argument bytes, dry run against the card's "
              f"allocation: " + "; ".join(
                  f"{k} {want} B counted, {got} B allocated (relative "
                  f"{errs[k]:.2e})" for k, (want, got) in held.items()) +
              f" [{tag}]", flush=True)
        peak = train["peak_bytes"]
        print(f"phase 21 18b peak: estimated {rec['peak_bytes'] / 2 ** 30:.3f}"
              f" GiB (arguments {rec['memory']['argument_bytes']} B, grads "
              f"{pr['grads']} B, working set {pr['temp']} B), measured "
              f"{peak / 2 ** 30:.3f} GiB (relative "
              f"{(rec['peak_bytes'] - peak) / peak:+.4f}); fits "
              f"{RA.HBM_BYTES / 2 ** 30:.3f} GiB: {rec['fits']} [{tag}]",
              flush=True)
        rl = RA.analyze_record(dict(rec, status="ok"), rec["tokens"],
                               "train")
        step_s = train["step_ms"] / 1e3
        share = rl.model_flops / (step_s * RA.PEAK_FLOPS)
        # the share as 18b computed it before roofline/ existed
        old_share = 6 * rec["params"] * rec["tokens"] / (step_s * 989e12)
        print(f"phase 21 18b roofline: compute {rl.compute_s * 1e3:.3f} ms "
              f"({rec['flops']:.6g} executed matmul FLOPs, "
              f"{rec['flops'] - rec['flops_f32']:.6g} bf16 at 989 TF/s and "
              f"{rec['flops_f32']:.6g} float32 at 67 TF/s; "
              f"{rec['other_flops']:.6g} others), memory "
              f"{rl.memory_s * 1e3:.3f} ms (a floor of "
              f"{rec['bytes_accessed']} B at 3.35 TB/s), collective "
              f"{rl.collective_s * 1e3:.3f} ms, {rl.dominant}; model FLOPs "
              f"{rl.model_flops:.6g}, useful ratio {rl.useful_ratio:.4f} | "
              f"measured step {train['step_ms']:.3f} ms: "
              f"{rl.compute_s / step_s:.4f} of it the compute term, "
              f"model-FLOP share {share:.4f} (18b's {train['mfu']:.4f}, "
              f"6 N D / (step x 989 TF/s) {old_share:.4f}) [{tag}]",
              flush=True)
        mr = info["mesh_ranks"]
        mcfg, mtcfg = _mesh_configs()
        coll = {}
        for shape in MESH_SHAPES:
            name = "%dx%d" % shape
            c = DRY.count_cell(mcfg, ShapeConfig(
                "mesh_20b", MESH_SEQ, MESH_BATCH, "train"),
                MeshConfig(shape, ("data", "model")), mtcfg)[
                    "collective_bytes"]
            secs = c["all-reduce"] / (mr["gloo"]["all_reduce"] * 2 ** 30) + \
                c["all-gather"] / (mr["gloo"]["broadcast"] * 2 ** 30)
            coll[name] = {"all_reduce": c["all-reduce"],
                          "broadcast": c["all-gather"], "s": secs,
                          "step_ms": mr["ms"][name]}
            print(f"phase 21 20b mesh ({shape[0]}, {shape[1]}) collectives "
                  f"counted a rank a step: all_reduce {c['all-reduce']:.0f} "
                  f"B, broadcast {c['all-gather']:.0f} B "
                  f"({json.dumps({k: round(v) for k, v in c['by_use'].items()})}"
                  f") | at gloo's measured rates {secs * 1e3:.3f} ms | "
                  f"20b's steps on rank 0 "
                  f"{[round(x, 3) for x in mr['ms'][name]]} ms [{tag}]",
                  flush=True)
        total = torch.cuda.get_device_properties(dev).total_memory
        print(f"phase 21 card memory: total_memory {total} B "
              f"({total / 2 ** 30:.3f} GiB) against analyze.HBM_BYTES "
              f"{RA.HBM_BYTES} B ({total / RA.HBM_BYTES:.4f}) [{tag}]",
              flush=True)
        done = proc.poll() is not None
        text, _ = proc.communicate(timeout=300)
        dry_s = time.perf_counter() - dry["t0"]
    finally:
        dryrun_stop(dry)
    m = re.search(r"dryrun: (\d+) failures, (\d+) cells in ([0-9.]+) s",
                  text)
    failures, cells, secs = (int(m.group(1)), int(m.group(2)),
                             float(m.group(3))) if m else (-1, 0, -1.0)
    ok = text.count("[ok     ]")
    skipped = text.count("[skipped]")
    wall = time.perf_counter() - t0
    print(f"phase 21 dry run {' '.join(DRYRUN_ARGV)}: exit "
          f"{proc.returncode}, {ok} cells counted, {skipped} skipped, "
          f"{failures} failures; {secs:.3f} s counting after its imports, "
          f"done {'before' if done else 'after'} the phase's own counts, "
          f"{dry_s:.3f} s from its start to its end | phase 21 wall "
          f"{wall:.3f} s [{tag}]", flush=True)
    check(all(e <= DRYRUN_MEM_RTOL for e in errs.values()),
          f"phase 21: argument bytes off the allocation: {errs}")
    check(abs(train["mfu"] - old_share) <= 1e-12 * old_share and
          abs(share - old_share) <= 1e-12 * old_share,
          f"phase 21: model-FLOP shares {share} (roofline) and "
          f"{train['mfu']} (18b) against 6 N D's {old_share}")
    check(abs(total - RA.HBM_BYTES) <= 0.01 * RA.HBM_BYTES,
          f"phase 21: total_memory {total} against analyze.HBM_BYTES "
          f"{RA.HBM_BYTES}")
    check(proc.returncode == 0 and failures == 0 and ok + skipped == cells
          and ok > 0,
          f"phase 21: the dry run exited {proc.returncode} with {failures} "
          f"failures: {text[-2000:]}")
    return {"wall_s": wall, "coll": coll, "errs": errs}


# ---------------------------------------------------------------------------
# Phase 22: training the MLA, MoE, SSM and hybrid families.
# ---------------------------------------------------------------------------

FAMILY_STEPS = 2          # 22a's timed steps after one warm-up step
MOE_TRAIN_LAYERS = 2      # 22c: qwen3-moe's widths at 2 of its 94 layers
# 22d: 2 layers (zamba2: one group of 6 Mamba2 layers and a shared block;
# qwen3-moe: 1, whose float32 params, grads, their float32 sum and state
# at 2 layers, 87 GB, pass the card's 80) in float32, microbatches 2, one
# step (two took phase 22 to 67 s on an H100, past its 60), the kernel
# route against the plain one: the loss within TRAIN_WHOLE_RTOL, every
# param leaf after the update normwise within FAMILY_PARAM_TOL
FAMILY_WHOLE = ((_minicpm, 2), (_qwen3moe, 1), (_falcon, 2), (_zamba2, 6))
FAMILY_WHOLE_STEPS = 1
FAMILY_PARAM_TOL = 1e-4
# 22e: B6's forward at the families' train shapes, 8 x 512, causal:
# name -> (Hq, Hkv, qk dim, v dim)
FAMILY_ATTN_ROWS = (8, 512)
FAMILY_ATTN = {"flash_attention_train_mla": (40, 40, 96, 64),
               "flash_attention_train_moe": (64, 4, 128, 128),
               "flash_attention_train_hybrid": (32, 32, 80, 80)}


def _family_train(dev, cfg, tcfg, steps: int, warm: bool,
                  sync_check: bool = False) -> dict:
    """``cfg`` trained through ``trainer.make_train_step`` from seeded
    params made on the card: a warm-up step when ``warm``, then ``steps``
    steps between CUDA events with every launch count set to 0 before them
    and read after (with ``sync_check`` in PyTorch's sync debug mode and
    the port's counter, as 18b); the peak from before the params."""
    import warnings
    from repro_torch.common import contracts
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = trainer.init_params(cfg, SEED, dev)
    opt = adamw.init(params, tcfg.optimizer)
    step_fn, _ = trainer.make_train_step(cfg, tcfg)
    batches = [make_batch(cfg, i, global_batch=tcfg.global_batch,
                          seq_len=tcfg.seq_len, device=dev)
               for i in range(steps + int(warm))]
    warm_m = []
    if warm:
        params, opt, m = step_fn(params, opt, batches.pop(0))
        warm_m.append(m)
    torch.cuda.synchronize()
    _reset_launches()
    contracts.SYNCS.reset()
    debug_syncs, instrument_ok = [], None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if sync_check:
            torch.cuda.set_sync_debug_mode("warn")
        try:
            params, opt, metrics, ms = _timed_steps(step_fn, params, opt,
                                                    batches)
            n_caught = len(caught)
            if sync_check:
                metrics[0]["loss"].item()     # the instrument's own check
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = contracts.SYNCS.count
    if sync_check:
        hits = [i for i, w in enumerate(caught)
                if SYNC_WARNING in str(w.message)]
        debug_syncs = [str(caught[i].message)[:120] for i in hits
                       if i < n_caught]
        instrument_ok = any(i >= n_caught for i in hits)
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) - base
    all_m = warm_m + metrics
    host = contracts.fetch({f"{k}{i}": m[k] for i, m in enumerate(all_m)
                            for k in ("loss", "grad_norm")})
    slices = _train_slices(params, tcfg.optimizer.state_block)
    codec = _whole_leaf_codec(opt, tcfg.optimizer.state_block)
    sites = _attn_sites(cfg)
    want = {"qpack_fixed_encode": 2 * slices * steps,
            "qpack_fixed_decode": 2 * slices * steps,
            "flash_attention": 2 * sites * steps}
    got = {k: launches[k] for k in want}
    others = {k: v for k, v in launches.items()
              if k not in want and k != "flash_attention_tc" and v}
    del params, opt, batches, metrics, warm_m, all_m
    return {"losses": [float(host[f"loss{i}"]) for i in range(
                steps + int(warm))],
            "gnorms": [float(host[f"grad_norm{i}"]) for i in range(
                steps + int(warm))],
            "ms": ms, "launches": got, "want": want, "others": others,
            "tc": launches["flash_attention_tc"], "slices": slices,
            "syncs": syncs, "debug_syncs": debug_syncs,
            "instrument_ok": instrument_ok, "peak_bytes": peak,
            "codec": codec, "wall_s": time.perf_counter() - t0}


def _whole_leaf_codec(opt, block: int) -> dict:
    """The compressed moments a step left on the card at every leaf whose
    block is not ``block`` (one block of the whole leaf: zamba2's per-head
    dt_bias, A_log and D, 6 x 80 values a group): B4 against its plain
    version bit for bit on their codes and scales, and B3 against its
    plain version byte for byte on the values B4 gave, at the block the
    update hands them. Read after the path's launch counts."""
    from repro_torch.common import tree as TR
    from repro_torch.kernels import qpack
    from repro_torch.optim import adamw
    leaves = {}
    for name, tree in (("m", opt.m), ("v", opt.v)):
        for path, x in TR.leaves_with_paths(tree):
            leaves.setdefault((name,) + tuple(path[:-1]), {})[path[-1]] = x
    blocks, bad = [], 0
    for c in leaves.values():
        b = c["block"]
        if b == block:
            continue
        blocks.append(b)
        for s, e in adamw._slices(c["codes"].numel(), b):
            codes, scales = c["codes"][s:e], c["scales"][s // b:e // b]
            a = qpack.decode(codes, scales, 8, b, torch.float32)
            w = qpack.decode_plain(codes, scales, 8, b, torch.float32)
            got, want = qpack.encode(w, 8, b), qpack.encode_plain(w, 8, b)
            bad = bad + (a.view(torch.int32) != w.view(torch.int32)).sum() \
                + (got[0] != want[0]).sum() + \
                (~_bits_equal(got[1][:, None], want[1][:, None])).sum()
    return {"leaves": len(blocks), "blocks": sorted(set(blocks)),
            "mismatches": int(bad)}


def _attn_sites(cfg) -> int:
    """B6's call sites in one forward: the attention layers, the hybrid's
    groups (each ends in a shared block), none for the SSM family."""
    from repro_torch.models import transformer as T
    if cfg.family == "ssm":
        return 0
    return T.hybrid_groups(cfg)[0] if cfg.family == "hybrid" else \
        cfg.num_layers


def _family_estimate(cfg, tcfg) -> dict:
    """The dry run's count of ``cfg``'s train step on one device."""
    from repro_torch.common.types import MeshConfig, ShapeConfig
    from repro_torch.launch import dryrun as DRY
    return DRY.count_cell(cfg, ShapeConfig(
        "family", tcfg.seq_len, tcfg.global_batch, "train"),
        MeshConfig((1, 1), ("data", "model")), tcfg)


def _family_line(label: str, cfg, tcfg, r: dict, est: dict, tag: str,
                 timed: str) -> dict:
    """One phase-22 line (step ms, tokens/s, the model-FLOP share from
    ``roofline.analyze``, peak against the dry run's estimate, launches a
    step, host syncs) and the checks every family run shares."""
    from repro_torch.launch import train as TL
    from repro_torch.roofline import analyze as RA
    steps = len(r["ms"])
    step_ms = statistics.median(r["ms"])
    tokens = tcfg.global_batch * tcfg.seq_len
    share = RA.model_flops(cfg.param_count(), cfg.active_param_count(),
                           tokens, "train") / (step_ms / 1e3 * RA.PEAK_FLOPS)
    gap = (est["peak_bytes"] - r["peak_bytes"]) / r["peak_bytes"]
    per_step = {k: v / steps for k, v in r["launches"].items()}
    print(f"phase {label} train {cfg.name} ({cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.dtype}, remat {cfg.remat}; "
          f"{cfg.param_count()} params, {cfg.active_param_count()} active) | "
          f"seq {tcfg.seq_len} x batch {tcfg.global_batch}, microbatches "
          f"{tcfg.microbatches}, compressed AdamW | losses {r['losses']} | "
          f"grad norms {r['gnorms']} | {timed}: {step_ms:.3f} ms median of "
          f"{[round(x, 3) for x in r['ms']]} (CUDA events) | "
          f"{tokens / step_ms * 1e3:.1f} tokens/s | model-FLOP share "
          f"{share:.4f} (roofline.analyze.model_flops at "
          f"{RA.PEAK_FLOPS / 1e12:g} TF/s) | peak {r['peak_bytes']} B "
          f"({r['peak_bytes'] / 2 ** 30:.3f} GiB) against the dry run's "
          f"{est['peak_bytes']} B ({est['peak_bytes'] / 2 ** 30:.3f} GiB; "
          f"gap {gap:+.4f}; working set {est['per_rank']['temp']} B) | "
          f"launches a step {json.dumps(per_step)} (expected "
          f"{json.dumps({k: v / steps for k, v in r['want'].items()})}: "
          f"{r['slices']} update slices, {_attn_sites(cfg)} B6 sites; B6 on "
          f"the tensor cores {r['tc']}); others {json.dumps(r['others'])} | "
          f"host syncs a step {r['syncs'] / steps:.1f} (counted) | the "
          f"state after the step at its whole-leaf blocks {r['codec']['blocks']}"
          f" ({r['codec']['leaves']} moments): B4 and B3 against their plain "
          f"versions, {r['codec']['mismatches']} values, codes or scales "
          f"differ | wall {r['wall_s']:.3f} s [{tag}]", flush=True)
    check(all(np.isfinite(r["losses"])) and all(np.isfinite(r["gnorms"])),
          f"phase {label}: {cfg.name}'s losses or grad norms not finite")
    check(r["launches"] == r["want"], f"phase {label}: {cfg.name} launches "
          f"{r['launches']}, expected {r['want']}")
    check(not r["others"], f"phase {label}: other kernels launched: "
          f"{r['others']}")
    check(r["tc"] == r["launches"]["flash_attention"],
          f"phase {label}: a bf16 B6 launch left the tensor cores")
    check(r["syncs"] == 0, f"phase {label}: {r['syncs']} host syncs counted")
    check(est["fits"], f"phase {label}: the dry run says {cfg.name} does not "
          f"fit ({est['peak_bytes']} B)")
    check(r["codec"]["mismatches"] == 0, f"phase {label}: B3/B4 differ from "
          f"their plain versions on the state at blocks "
          f"{r['codec']['blocks']}")
    margin = 1 + TL.COUNT_MARGIN
    check(r["peak_bytes"] <= est["peak_bytes"] * margin and
          est["peak_bytes"] <= r["peak_bytes"] * margin,
          f"phase {label}: {cfg.name}'s peak {r['peak_bytes']} B against the "
          f"dry run's {est['peak_bytes']} B (gap {gap:+.4f}) is past the "
          f"launcher's margin {TL.COUNT_MARGIN}")
    return {"step_ms": step_ms, "share": share, "gap": gap,
            "launches": r["launches"], "peak_bytes": r["peak_bytes"],
            "estimate": est["peak_bytes"], "wall_s": r["wall_s"]}


def _family_configs(cfg, dtype=None, microbatches=1):
    """(``cfg`` in ``dtype``, TrainConfig's defaults: seq 512 x batch 8,
    the launcher's optimizer with the compressed state)."""
    _, tcfg = _train_configs(microbatches=microbatches)
    return (cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype),
            tcfg)


def phase_family_main(dev, tag: str) -> dict:
    """22a: minicpm3-4b at its published width, all 62 layers, bf16, remat,
    8 x 512, the compressed state: a warm-up and FAMILY_STEPS timed steps,
    as 18b (no host sync, counted and in sync debug mode; B3/B4 twice a
    slice, B6 twice a layer a step)."""
    cfg, tcfg = _family_configs(_minicpm())
    est = _family_estimate(cfg, tcfg)
    r = _family_train(dev, cfg, tcfg, FAMILY_STEPS, warm=True,
                      sync_check=True)
    out = _family_line("22a", cfg, tcfg, r, est, tag,
                       f"{FAMILY_STEPS} timed steps after a warm-up")
    print(f"phase 22a syncs: {len(r['debug_syncs'])} in PyTorch's sync debug "
          f"mode {r['debug_syncs'][:3]} (a deliberate .item() after the "
          f"steps caught: {r['instrument_ok']}) [{tag}]", flush=True)
    check(not r["debug_syncs"] and r["instrument_ok"],
          f"phase 22a: the train step synced: {r['debug_syncs'][:3]} (sync "
          f"debug mode working: {r['instrument_ok']})")
    return out


def phase_family_ssm(dev, tag: str) -> dict:
    """22b: zamba2-2.7b and falcon-mamba-7b as published (every layer),
    bf16, remat, 8 x 512, the compressed state: one step each, no warm-up;
    each peak held to the dry run's estimate within the launcher's
    ``COUNT_MARGIN`` (``_family_line``)."""
    out = {}
    for name, model in (("zamba2-2.7b", _zamba2),
                        ("falcon-mamba-7b", _falcon)):
        cfg, tcfg = _family_configs(model())
        est = _family_estimate(cfg, tcfg)
        r = _family_train(dev, cfg, tcfg, 1, warm=False)
        out[name] = _family_line("22b", cfg, tcfg, r, est, tag,
                                 "one step, no warm-up")
        torch.cuda.empty_cache()
    return out


def phase_family_moe(dev, tag: str) -> dict:
    """22c: qwen3-moe at its published widths, MOE_TRAIN_LAYERS of 94 layers
    (128 experts top-8, the grouped dispatch at 4,096 tokens), bf16,
    remat, 8 x 512, the compressed state: a warm-up and one timed step."""
    cfg, tcfg = _family_configs(_qwen3moe(MOE_TRAIN_LAYERS))
    est = _family_estimate(cfg, tcfg)
    r = _family_train(dev, cfg, tcfg, 1, warm=True)
    return _family_line("22c", cfg, tcfg, r, est, tag,
                        "one timed step after a warm-up")


def _family_route(dev, cfg, tcfg, impl: str) -> dict:
    """22d's run of ``cfg`` on one route: FAMILY_WHOLE_STEPS steps from the
    seeded params; the losses, the params (on the card) and, on the kernel
    route, ``_whole_leaf_codec`` of the state (then dropped)."""
    from repro_torch.common import contracts
    from repro_torch.data.pipeline import make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    kw = WHOLE_IMPLS[impl]
    params = trainer.init_params(cfg, SEED + 2, dev)
    opt = adamw.init(params, tcfg.optimizer, kw["quantize_impl"])
    step_fn, _ = trainer.make_train_step(cfg, tcfg, **kw)
    _reset_launches()
    ms = []
    for i in range(FAMILY_WHOLE_STEPS):
        params, opt, m = step_fn(params, opt, make_batch(
            cfg, i, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            device=dev))
        ms.append(m)
    torch.cuda.synchronize()
    launches = _launch_counts()
    host = contracts.fetch({f"loss{i}": m["loss"] for i, m in enumerate(ms)})
    codec = _whole_leaf_codec(opt, tcfg.optimizer.state_block) \
        if impl == "kernel" else None
    del opt
    return {"losses": [float(host[f"loss{i}"]) for i in range(len(ms))],
            "params": params, "launches": launches, "codec": codec}


def _leaf_errors(got, want) -> dict:
    """Per leaf, ||got - want|| / ||want|| in float64 on the card, in
    slices of whole leaves (``adamw._slices``); one fetch."""
    from repro_torch.common import contracts
    from repro_torch.common import tree as TR
    from repro_torch.optim import adamw
    wants = dict(TR.leaves_with_paths(want))
    out = {}
    for path, g in TR.leaves_with_paths(got):
        a, b = g.reshape(-1), wants[path].reshape(-1)
        num = den = 0
        for s, e in adamw._slices(a.numel(), 1):
            wb = b[s:e].double()
            num = num + (a[s:e].double() - wb).square().sum()
            den = den + wb.square().sum()
        out["/".join(path)] = (num / torch.clamp(den, min=1e-300)).sqrt()
    return {k: float(v) for k, v in contracts.fetch(out).items()}


def phase_family_whole(dev, tag: str) -> dict:
    """22d: each family at 2 layers of its published widths (zamba2: one
    group, 6 Mamba2 layers and a shared block; qwen3-moe: 1) in float32,
    microbatches 2, the compressed state, FAMILY_WHOLE_STEPS steps on the
    kernel route (B3/B4/B6) and on the plain route: losses within
    TRAIN_WHOLE_RTOL, every param leaf normwise within FAMILY_PARAM_TOL
    (compared on the card), B6 and B3 launched on the kernel route only;
    the kernel route's state at its whole-leaf blocks held to the plain
    versions of B3 and B4 (``_whole_leaf_codec``)."""
    t0 = time.perf_counter()
    out = {}
    for model, layers in FAMILY_WHOLE:
        t1 = time.perf_counter()
        cfg, tcfg = _family_configs(model(layers), "float32", 2)
        k = _family_route(dev, cfg, tcfg, "kernel")
        torch.cuda.empty_cache()
        p = _family_route(dev, cfg, tcfg, "plain")
        errs = _leaf_errors(k["params"], p["params"])
        del k["params"], p["params"]
        torch.cuda.empty_cache()
        rel = [abs(a - b) / abs(b) for a, b in zip(k["losses"], p["losses"])]
        perr = max(errs.values())
        b6 = {r: x["launches"]["flash_attention"] for r, x in
              (("kernel", k), ("plain", p))}
        b3 = {r: x["launches"]["qpack_fixed_encode"] for r, x in
              (("kernel", k), ("plain", p))}
        out[cfg.name] = {"rel": rel, "param_err": perr,
                         "wall_s": time.perf_counter() - t1}
        print(f"phase 22d train whole {cfg.name} ({cfg.num_layers} layers at "
              f"its widths, float32, microbatches 2, {FAMILY_WHOLE_STEPS} "
              f"steps): losses kernel {k['losses']} / plain {p['losses']} "
              f"(relative {[f'{x:.2e}' for x in rel]}) | params normwise, "
              f"largest over {len(errs)} leaves {perr:.3e} "
              f"({max(errs, key=errs.get)}) | B6 launches {b6}, B3 {b3} | "
              f"the kernel route's state at its whole-leaf blocks "
              f"{k['codec']['blocks']} ({k['codec']['leaves']} moments): "
              f"{k['codec']['mismatches']} values, codes or scales differ "
              f"from the plain B4/B3 | wall {out[cfg.name]['wall_s']:.3f} s "
              f"[{tag}]", flush=True)
        check(max(rel) <= TRAIN_WHOLE_RTOL,
              f"phase 22d: {cfg.name}'s losses differ: {rel}")
        check(perr <= FAMILY_PARAM_TOL,
              f"phase 22d: {cfg.name}'s params differ: {perr}")
        check(k["codec"]["mismatches"] == 0, f"phase 22d: {cfg.name}: B3/B4 "
              f"differ from their plain versions on the state at blocks "
              f"{k['codec']['blocks']}")
        want_b6 = 2 * _attn_sites(cfg) * FAMILY_WHOLE_STEPS * 2
        check(b6["kernel"] == want_b6 and b3["kernel"] > 0 and
              b6["plain"] == 0 and b3["plain"] == 0,
              f"phase 22d: {cfg.name}: routes crossed or B6 launched "
              f"{b6['kernel']} times, expected {want_b6}; B3 {b3}")
        del k, p
    out["wall_s"] = time.perf_counter() - t0
    return out


def _family_codec(dev, gen) -> dict:
    """22e: B3 and B4 at every whole-leaf block (a leaf whose length the
    state block does not divide is one block) that phase 22's updates hand
    them, on random moments and on a zero leaf (``adamw.init``'s), byte for
    byte against their plain versions."""
    from repro_torch.common import tree as TR
    from repro_torch.kernels import qpack
    from repro_torch.optim import adamw
    from repro_torch.train import trainer
    block = _family_configs(_minicpm())[1].optimizer.state_block
    cfgs = [_minicpm(), _zamba2(), _falcon(), _qwen3moe(MOE_TRAIN_LAYERS)] + \
        [model(layers) for model, layers in FAMILY_WHOLE]
    sizes = sorted({p.numel() for cfg in cfgs for _, p in TR.leaves_with_paths(
        trainer.init_params(cfg, SEED, "meta"))
        if adamw._blk(p.numel(), block) != block})
    bad = 0
    for n in sizes:
        for x in (torch.randn((n,), generator=gen, device=dev) * 1e-3,
                  torch.zeros((n,), device=dev)):
            got, want = qpack.encode(x, 8, n), qpack.encode_plain(x, 8, n)
            a = qpack.decode(*want, 8, n, torch.float32)
            b = qpack.decode_plain(*want, 8, n, torch.float32)
            bad = bad + (got[0] != want[0]).sum() + \
                (~_bits_equal(got[1][:, None], want[1][:, None])).sum() + \
                (a.view(torch.int32) != b.view(torch.int32)).sum()
    check(bool(sizes), "phase 22e: no whole-leaf block found in phase 22's "
          "configs")
    return {"blocks": sizes, "mismatches": int(bad)}


def phase_family_attn(dev, tag: str) -> tuple:
    """22e: B3/B4 at the families' whole-leaf blocks (``_family_codec``);
    B6's forward at the families' train shapes (8 x 512, causal):
    minicpm3-4b's 40 heads at 96/64, qwen3-moe's 64/4 x 128, zamba2's
    32/32 x 80; bf16 (the tensor cores) and f32, each against its plain
    version within ATTN_TOL (and normwise ATTN_NORM_TOL); then kernel /
    eager / plain / SDPA / bound times in bf16."""
    from repro_torch.kernels import flash_attn as FA
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    codec = _family_codec(dev, torch.Generator(device=dev).manual_seed(
        SEED + 61))
    print(f"phase 22e kernels: B3/B4 at 8 bits, f32, at the whole-leaf "
          f"blocks of phase 22's configs {codec['blocks']}, random and zero "
          f"moments, against their plain versions: {codec['mismatches']} "
          f"codes, scales or values differ [{tag}]", flush=True)
    check(codec["mismatches"] == 0, f"phase 22e: B3/B4 differ from their "
          f"plain versions at blocks {codec['blocks']}")
    B, S = FAMILY_ATTN_ROWS
    errs, out = {}, {}
    for name, (Hq, Hkv, D, Dv) in FAMILY_ATTN.items():
        r = errs[name] = {"err": 0.0, "cases": 0, "mismatches": 0}
        q = torch.randn((B, S, Hq, D), generator=gen, device=dev)
        k = torch.randn((B, S, Hkv, D), generator=gen, device=dev)
        v = torch.randn((B, S, Hkv, Dv), generator=gen, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            qd, kd, vd = (t.to(dt) for t in (q, k, v))
            n0, tc0 = FA.launches, FA.launches_tc
            got = FA.flash_attention(qd, kd, vd, causal=True)
            check(FA.launches == n0 + 1 and FA.launches_tc == tc0 + int(
                dt == torch.bfloat16), f"phase 22e: {name} {dt} did not "
                "launch B6 once on its route")
            want = FA.flash_attention_plain(qd, kd, vd, causal=True).float()
            d = (got.float() - want).abs()
            r["cases"] += 1
            r["mismatches"] += int((d > ATTN_TOL[dt] * (1 + want.abs())).sum())
            r["err"] = max(r["err"], float(d.max()))
            nerr = float((got.float() - want).norm() / want.norm())
            check(nerr <= ATTN_NORM_TOL[dt], f"phase 22e: {name} {dt} "
                  f"normwise {nerr}")
            del qd, kd, vd, got, want, d
        qa, ka, va = (t.to(torch.bfloat16) for t in (q, k, v))
        out[name] = dict(
            shape=f"q {B}x{S}x{Hq}x{D}, k {B}x{S}x{Hkv}x{D}, v "
                  f"{B}x{S}x{Hkv}x{Dv} bf16 causal (a layer's training "
                  f"forward)",
            kern=lambda qa=qa, ka=ka, va=va: FA.flash_attention(
                qa, ka, va, causal=True),
            plain=lambda qa=qa, ka=ka, va=va: FA.flash_attention_plain(
                qa, ka, va, causal=True),
            lib=lambda qa=qa, ka=ka, va=va: _sdpa(qa, ka, va, True),
            nbytes=2 * B * S * (Hq * D + Hkv * D + Hkv * Dv + Hq * Dv),
            ops=2 * B * Hq * (S * (S + 1) // 2) * (D + Dv), reps=20)
    print(f"phase 22e kernels: B6 at the families' train shapes, bf16 and "
          f"f32 against the plain version: "
          f"{json.dumps({k: v for k, v in errs.items()})} [{tag}]",
          flush=True)
    check(all(r["mismatches"] == 0 for r in errs.values()),
          f"phase 22e: B6 off tolerance: {errs}")
    times = _time_rows(out, "22e", tag)
    return errs, times


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
    phase_build(tag)
    errs = phase_kernels(qpack, comp, dev)
    launches = phase_main(qpack, dev, MAIN_PAGES, MAIN_ACCESSES, tag)
    phase_whole(qpack, dev)
    times = phase_times(qpack, comp, dev, tag)
    torch.cuda.empty_cache()             # the pool is gone: free its memory
    serve_errs = phase_serve_kernels(dev)
    params, serve_launches, _ = phase_serve(dev, tag)
    phase_serve_profile(params, dev, tag)
    paper_launches = phase_paper(params, dev, tag)
    del params
    torch.cuda.empty_cache()
    phase_serve_whole(dev)
    torch.cuda.empty_cache()
    serve_times = phase_serve_times(dev, tag)
    torch.cuda.empty_cache()
    phase_simx(dev, tag)
    torch.cuda.empty_cache()
    fabric_launches = phase_fabric(dev, tag)
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    mla_errs = phase_mla_kernels(dev)
    mla_launches, _ = phase_serve_mla(dev, tag)
    torch.cuda.empty_cache()
    mla_whole = phase_serve_whole(dev, _minicpm, "13c")
    torch.cuda.empty_cache()
    lens_l = np.random.default_rng(SEED).integers(
        *PROMPT_LENS, size=SERVE_CFG["max_running"]) + \
        SERVE_NEW_TOKENS // 2 - SERVE_CFG["hot_window"]
    mla_times = phase_mla_times(dev, tag, lens_l)
    print(f"phase 13 wall {time.perf_counter() - t13:.3f} s [{tag}]",
          flush=True)
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    moe_errs = phase_moe_kernels(dev)
    torch.cuda.empty_cache()
    moe_launches, _ = phase_serve_moe(dev, tag)
    torch.cuda.empty_cache()
    phase_serve_whole(dev, _qwen3moe, "14c")
    torch.cuda.empty_cache()
    arctic_whole = phase_serve_whole(dev, _arctic, "14c arctic", layers=1)
    torch.cuda.empty_cache()
    moe_times = phase_moe_times(dev, tag, lens_l)
    print(f"phase 14 wall {time.perf_counter() - t14:.3f} s [{tag}]",
          flush=True)
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    front_errs = phase_attn_kernels(dev, "15a", "frontend", FRONT_ATTN,
                                    SEED + 30)
    torch.cuda.empty_cache()
    cham_launches, _ = phase_serve_frontend(
        dev, lambda: _chameleon(CHAMELEON_SERVE_LAYERS), "15b", tag)
    torch.cuda.empty_cache()
    music_launches, _ = phase_serve_frontend(
        dev, lambda: _musicgen(MUSICGEN_SERVE_LAYERS), "15c", tag)
    torch.cuda.empty_cache()
    phase_serve_ssm(dev, tag)
    torch.cuda.empty_cache()
    t15e = time.perf_counter()
    phase_serve_whole(dev, _chameleon, "15e chameleon")
    torch.cuda.empty_cache()
    phase_serve_whole(dev, _musicgen, "15e musicgen")
    torch.cuda.empty_cache()
    phase_ssm_whole(dev)
    torch.cuda.empty_cache()
    print(f"phase 15e wall {time.perf_counter() - t15e:.3f} s [{tag}]",
          flush=True)
    front_lens = np.random.default_rng(SEED).integers(
        *PROMPT_LENS, size=SERVE_CFG["max_running"]) + \
        FRONT_NEW_TOKENS // 2 - SERVE_CFG["hot_window"]
    front_times = phase_attn_times(dev, "15f", tag, FRONT_ATTN, SEED + 31,
                                   front_lens, _musicgen().num_layers,
                                   "layer")
    print(f"phase 15 wall {time.perf_counter() - t15:.3f} s [{tag}]",
          flush=True)
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    hybrid_errs = phase_attn_kernels(dev, "16a", "hybrid", HYBRID_ATTN,
                                     SEED + 40)
    torch.cuda.empty_cache()
    hybrid_launches = phase_serve_hybrid(dev, tag)
    torch.cuda.empty_cache()
    phase_hybrid_whole(dev)
    torch.cuda.empty_cache()
    from repro_torch.models import transformer as T
    hybrid_times = phase_attn_times(
        dev, "16d", tag, HYBRID_ATTN, SEED + 41, front_lens,
        T.hybrid_groups(_zamba2())[0], "site")
    print(f"phase 16 wall {time.perf_counter() - t16:.3f} s [{tag}]",
          flush=True)
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    walls17 = {"17a": phase_obs_serve(dev, tag)["wall_s"]}
    torch.cuda.empty_cache()
    walls17["17b"] = phase_obs_fabric(dev, tag)["wall_s"]
    torch.cuda.empty_cache()
    walls17["17c"] = phase_obs_cells(dev, tag)["wall_s"]
    print(f"phase 17 wall {time.perf_counter() - t17:.3f} s "
          f"({json.dumps({k: round(v, 3) for k, v in walls17.items()})}) "
          f"[{tag}]", flush=True)
    torch.cuda.empty_cache()
    # phase 19b's gloo ranks start up now (10-18 s a spawn on the chip's
    # host), beside phase 18: CPU work and an idle context each; they wait
    # for the gate that phase 19 opens
    import tempfile
    gates = Path(tempfile.mkdtemp(prefix="gate"))
    gate, gate20 = str(gates / "go"), str(gates / "go20")
    shard_fut = shard_ranks_start(dev, gate, gate20)
    try:
        t18 = time.perf_counter()
        train_errs, train_times = phase_train_kernels(dev, tag)
        walls18 = {"18a": time.perf_counter() - t18}
        torch.cuda.empty_cache()
        train = phase_train_main(dev, tag)
        walls18["18b"] = train["wall_s"]
        torch.cuda.empty_cache()
        walls18["18c"] = phase_train_whole(dev, tag)["wall_s"]
        torch.cuda.empty_cache()
        walls18["18d"] = phase_train_launcher(dev, tag)["wall_s"]
        print(f"phase 18 wall {time.perf_counter() - t18:.3f} s "
              f"({json.dumps({k: round(v, 3) for k, v in walls18.items()})}) "
              f"[{tag}]", flush=True)
        torch.cuda.empty_cache()
        across, info = phase_across(dev, tag, times, errs, train,
                                    train_times, train_errs, shard_fut,
                                    gate, gate20)
        torch.cuda.empty_cache()
        phase_roofline(dev, tag, train, info)
    finally:
        Path(gate).touch()    # a failed phase lets the ranks finish
        Path(gate20).touch()
    torch.cuda.empty_cache()
    t22 = time.perf_counter()
    family = {"22a": phase_family_main(dev, tag)}
    torch.cuda.empty_cache()
    family["22b"] = phase_family_ssm(dev, tag)
    torch.cuda.empty_cache()
    family["22c"] = phase_family_moe(dev, tag)
    torch.cuda.empty_cache()
    family["22d"] = phase_family_whole(dev, tag)
    torch.cuda.empty_cache()
    family_errs, family_times = phase_family_attn(dev, tag)
    walls22 = {"22a": family["22a"]["wall_s"],
               "22b": sum(r["wall_s"] for r in family["22b"].values()),
               "22c": family["22c"]["wall_s"],
               "22d": family["22d"]["wall_s"]}
    print(f"phase 22 wall {time.perf_counter() - t22:.3f} s "
          f"({json.dumps({k: round(v, 3) for k, v in walls22.items()})}) "
          f"[{tag}]", flush=True)

    src = "src/repro_torch/csrc/qpack_fused.cu"
    extra = ("composition_ms", "composition_graph_ms", "events",
             "composition_events")
    kernels = []
    for kind, n, line, path in (
            ("encode", 32, 278, "none since the demote-and-compact kernel "
             "took the pool's demotion: the TPU kernel's contract, held in "
             "phase 2"),
            ("decode", 4, 305, "none since the promote step took the "
             "pool's promotion: the TPU kernel's contract, held in phase 2"),
            ("demote", 8, 278, "pool main (phase 3) and the payload "
             "fabric (phase 12b)"),
            ("promote", 1, 305, "pool main (phase 3) and the payload "
             "fabric (phase 12b)")):
        t = times[(kind, n)]
        kernels.append({
            "name": f"qpack_fused_{kind}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/qpack.py:{line}",
            "launches": launches[kind] + fabric_launches.get(kind, 0),
            "max_abs_err": errs[kind]["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "eager_ms": t["eager_ms"], "path": path,
            "shape": (f"{n} pages of 4x512 bf16" if kind in ("demote",
                                                            "promote")
                      else f"{n}x512 bf16"), "cases": errs[kind]["cases"],
            "mismatches": errs[kind]["mismatches"],
            **{f: t[f] for f in extra if f in t}})
    # B4 runs on the paper path of serving: its launches are that path's;
    # B3's own encode runs on the train path (phase 18b)
    path_launches = dict(serve_launches,
                         qpack_fixed_decode=paper_launches[
                             "qpack_fixed_decode"],
                         qpack_fixed_encode=train["launches"][
                             "qpack_fixed_encode"])
    for name_, source, replaces in (
            ("qpack_fixed_encode", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_ring_step", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_prefill_fill", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_lane_flush", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_fixed_decode", "qpack_fixed.cu", "qpack.py:148"),
            ("kvc_decode_attention", "kvc_attn.cu", "kvc_attn.py:96"),
            ("flash_attention", "flash_attn.cu", "flash_attn.py:72")):
        t, e = serve_times[name_], serve_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": path_launches[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": ("serve paper (phase 8)" if name_ == "qpack_fixed_decode"
                     else "train main (phase 18b), the AdamW moments at "
                     "qpack_fixed_encode_train's shape; none on serve main "
                     "since the prefill fill and the lane flush (its shape "
                     "here, held in phase 6)"
                     if name_ == "qpack_fixed_encode"
                     else "serve main (phase 7)"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"],
            **{f: t[f] for f in extra if f in t}})
    # B6 also at the path's own batches (4 rows and 1 row of 1024)
    kernels[-1]["path_shapes"] = {
        k.split("_")[-1]: {f: t[f] for f in ("ms", "eager_ms", "library_ms",
                                              "bound_ms")}
        for k, t in serve_times.items() if k.startswith("flash_attention_")}
    # the MLA forms (phase 13): launches on serve mla (13b), B4 at block
    # 288 on 13c's paper-mode run
    mla_path = dict(mla_launches, flash_attention_mla=mla_launches[
        "flash_attention"], qpack_fixed_decode_288=mla_whole["paper"][
            "b4_launches"], kvc_latent_partial_f32=mla_launches[
                "kvc_latent_partial"] - mla_launches["kvc_latent_partial_tc"])
    for name_, source, replaces in (
            ("qpack_latent_ring_step", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_latent_prefill_fill", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_latent_lane_flush", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_fixed_decode_288", "qpack_fixed.cu", "qpack.py:148"),
            ("kvc_latent_partial", "kvc_attn.cu", "kvc_attn.py:96"),
            ("kvc_latent_partial_f32", "kvc_attn.cu", "kvc_attn.py:96"),
            ("flash_attention_mla", "flash_attn.cu", "flash_attn.py:72")):
        t, e = mla_times[name_], mla_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": mla_path[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": ("serve mla paper mode (phase 13c)"
                     if name_ == "qpack_fixed_decode_288"
                     else "none on serve mla's bf16 path: f32 queries (13a, "
                     "13c's float32 run)"
                     if name_ == "kvc_latent_partial_f32"
                     else "serve mla (phase 13b), the tensor cores"
                     if name_ == "kvc_latent_partial"
                     else "serve mla (phase 13b)"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    kernels[-1]["path_shapes"] = {
        k.split("_")[-1]: {f: t[f] for f in ("ms", "eager_ms", "library_ms",
                                              "bound_ms")}
        for k, t in mla_times.items() if k.startswith("flash_attention_mla_")}
    # the MoE path (phase 14): launches on serve moe (14b); B5 at G 7 on
    # 14c's arctic runs (the kernel runs' whole path and Engine, bf16 and
    # float32)
    moe_path = {"qpack_ring_step_moe": moe_launches["qpack_ring_step"],
                "qpack_prefill_fill_moe": moe_launches["qpack_prefill_fill"],
                "qpack_lane_flush_moe": moe_launches["qpack_lane_flush"],
                "kvc_decode_attention_g16":
                    moe_launches["kvc_decode_attention_g16"],
                "kvc_decode_attention_g7": sum(
                    arctic_whole[dt]["b5_groups"].get(7, 0)
                    for dt in ("bfloat16", "float32")),
                "flash_attention_moe": moe_launches["flash_attention"]}
    for name_, source, replaces in (
            ("qpack_ring_step_moe", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_prefill_fill_moe", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_lane_flush_moe", "qpack_fixed.cu", "qpack.py:122"),
            ("kvc_decode_attention_g16", "kvc_attn.cu", "kvc_attn.py:96"),
            ("kvc_decode_attention_g7", "kvc_attn.cu", "kvc_attn.py:96"),
            ("flash_attention_moe", "flash_attn.cu", "flash_attn.py:72")):
        t, e = moe_times[name_], moe_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": moe_path[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": ("arctic-480b's whole path, 1 layer (phase 14c)"
                     if name_ == "kvc_decode_attention_g7"
                     else "serve moe (phase 14b)"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    kernels[-1]["path_shapes"] = {
        k.split("_")[-1]: {f: t[f] for f in ("ms", "eager_ms", "library_ms",
                                              "bound_ms")}
        for k, t in moe_times.items() if k.startswith("flash_attention_moe_")}
    # the frontend backbones (phase 15): launches on serve chameleon (15b)
    # and serve musicgen (15c); falcon-mamba's path (15d) launches none
    front_path = {"qpack_ring_step_musicgen": music_launches["qpack_ring_step"],
                  "qpack_prefill_fill_musicgen":
                      music_launches["qpack_prefill_fill"],
                  "qpack_lane_flush_musicgen":
                      music_launches["qpack_lane_flush"],
                  "kvc_decode_attention_g1":
                      music_launches["kvc_decode_attention_g1"],
                  "kvc_decode_attention_g8":
                      cham_launches["kvc_decode_attention_g8"],
                  "flash_attention_musicgen": music_launches["flash_attention"],
                  "flash_attention_chameleon":
                      cham_launches["flash_attention"]}
    for name_, source, replaces in (
            ("qpack_ring_step_musicgen", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_prefill_fill_musicgen", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_lane_flush_musicgen", "qpack_fixed.cu", "qpack.py:122"),
            ("kvc_decode_attention_g1", "kvc_attn.cu", "kvc_attn.py:96"),
            ("kvc_decode_attention_g8", "kvc_attn.cu", "kvc_attn.py:96"),
            ("flash_attention_musicgen", "flash_attn.cu", "flash_attn.py:72"),
            ("flash_attention_chameleon", "flash_attn.cu",
             "flash_attn.py:72")):
        t, e = front_times[name_], front_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": front_path[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": ("serve chameleon (phase 15b)" if name_.endswith(
                ("_g8", "_chameleon")) else "serve musicgen (phase 15c)"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
        if name_.startswith("flash_attention_"):
            kernels[-1]["path_shapes"] = {
                k.split("_")[-1]: {f: tt[f] for f in (
                    "ms", "eager_ms", "library_ms", "bound_ms")}
                for k, tt in front_times.items()
                if k.startswith(name_ + "_")}
    # the hybrid (phase 16): launches on serve zamba2-2.7b (16b)
    hybrid_path = {"qpack_ring_step_hybrid": hybrid_launches["qpack_ring_step"],
                   "qpack_prefill_fill_hybrid":
                       hybrid_launches["qpack_prefill_fill"],
                   "qpack_lane_flush_hybrid":
                       hybrid_launches["qpack_lane_flush"],
                   "kvc_decode_attention_d80":
                       hybrid_launches["kvc_decode_attention_d80"],
                   "flash_attention_hybrid": hybrid_launches["flash_attention"]}
    for name_, source, replaces in (
            ("qpack_ring_step_hybrid", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_prefill_fill_hybrid", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_lane_flush_hybrid", "qpack_fixed.cu", "qpack.py:122"),
            ("kvc_decode_attention_d80", "kvc_attn.cu", "kvc_attn.py:96"),
            ("flash_attention_hybrid", "flash_attn.cu", "flash_attn.py:72")):
        t, e = hybrid_times[name_], hybrid_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": hybrid_path[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": "serve zamba2-2.7b (phase 16b)",
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    kernels[-1]["path_shapes"] = {
        k.split("_")[-1]: {f: tt[f] for f in ("ms", "eager_ms", "library_ms",
                                               "bound_ms")}
        for k, tt in hybrid_times.items()
        if k.startswith("flash_attention_hybrid_")}
    # the training path (phase 18): launches on train main (18b)
    train_path = {"qpack_fixed_encode_train":
                  train["launches"]["qpack_fixed_encode"],
                  "qpack_fixed_decode_train":
                  train["launches"]["qpack_fixed_decode"],
                  "flash_attention_train": train["launches"][
                      "flash_attention"]}
    for name_, source, replaces in (
            ("qpack_fixed_encode_train", "qpack_fixed.cu", "qpack.py:122"),
            ("qpack_fixed_decode_train", "qpack_fixed.cu", "qpack.py:148"),
            ("flash_attention_train", "flash_attn.cu", "flash_attn.py:72")):
        t, e = train_times[name_], train_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": train_path[name_], "max_abs_err": e["err"],
            "ms": t["ms"], "bytes": t["bytes"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "eager_ms": t["eager_ms"],
            "path": ("train main (phase 18b): the forward and the remat "
                     "forward, under autograd" if name_.startswith("flash")
                     else "train main (phase 18b): the AdamW moments"),
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    kernels += across
    # the families' training (phase 22): B6's forward at each family's
    # shape, launched on 22a (minicpm3-4b), 22c (qwen3-moe) and 22b
    # (zamba2-2.7b)
    family_path = {
        "flash_attention_train_mla": ("22a", family["22a"]),
        "flash_attention_train_moe": ("22c", family["22c"]),
        "flash_attention_train_hybrid": ("22b", family["22b"]["zamba2-2.7b"])}
    for name_, (ph, run) in family_path.items():
        t, e = family_times[name_], family_errs[name_]
        kernels.append({
            "name": name_, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn.py:72",
            "launches": run["launches"]["flash_attention"],
            "max_abs_err": e["err"], "ms": t["ms"], "bytes": t["bytes"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "eager_ms": t["eager_ms"],
            "path": f"train (phase {ph}): the forward and the remat "
                    f"forward, under autograd",
            "shape": t["shape"], "cases": e["cases"],
            "mismatches": e["mismatches"]})
    from repro_torch.roofline import analyze as RA
    for k in kernels:
        rl = RA.kernel_roofline([{"name": k["name"], "bytes": k["bytes"],
                                  "us": k["ms"] * 1e3}])[0]
        k.update({f: rl[f] for f in ("gbps", "frac_of_hbm_roof", "bound")})
    print(f"total {time.perf_counter() - t_start:.3f} s [{tag}]")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
