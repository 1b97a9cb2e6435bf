"""A benchmark in miniature for the CPU tests: the repository's
``BENCHMARK.json``, configurations and mixes with every size cut down (two
layers, widths in the hundreds, prompts of tens of tokens, four lanes), in
a directory of its own. The harness's code is the repository's."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for _p in (str(REPO / "src"), str(REPO)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

SEED = 2 ** 31 + 12345          # past 32 signed bits: such seeds must work

GQA_SIZES = dict(hidden_size=256, intermediate_size=512,
                 num_attention_heads=4, num_key_value_heads=4,
                 num_hidden_layers=2, vocab_size=512)
MLA_SIZES = dict(GQA_SIZES, vocab_size=500, q_lora_rank=64, kv_lora_rank=32,
                 qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
# the miniature's own limits, set as the cells' are, from its readings on
# this seed: serve, sound 0.026-0.041 and the fp8 control 0.19-0.23; train,
# sound (loss 9.3e-5, gradient 6.3e-4, median change 2.3e-4), control
# (7.7e-4, 6.7e-3, 1.05e-3), half the batch (5.9e-3, 3.1e-2, 1.9e-3)
LIMITS = {"serve": {"logit_gap": 0.1},
          "train": {"loss_gap": 3e-4, "grad_gap": 2.5e-3,
                    "change_gap": 6e-4}}


def make(root: Path, dtype: str = "bfloat16") -> Path:
    """The miniature under ``root``: ``BENCHMARK.json`` with the entries of
    ``cells.json`` it lacks (every cell the harness runs, those that wait
    for a chip among them: PERF.md section 7), every size cut down.
    ``dtype`` sets every configuration's model dtype. Its cells get the
    miniature's limits (``LIMITS``)."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    extra = json.loads((Path(__file__).parent / "cells.json").read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        have = {x["name"]: x for x in bench[key]}
        for x in extra[key]:
            if x["name"] not in have:
                bench[key].append(x)
            elif "workloads" in x:
                have[x["name"]]["workloads"] = sorted(
                    set(have[x["name"]].get("workloads", [])) |
                    set(x["workloads"]))
    (root / "bench").mkdir(parents=True, exist_ok=True)
    for sub in ("configs", "traffic", "metrics", "limits"):
        (root / "bench" / sub).mkdir(exist_ok=True)
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf.update(MLA_SIZES if conf["port"]["attn_kind"] == "mla"
                    else GQA_SIZES)
        conf["port"]["dtype"] = dtype
        conf["serve"].update(lanes=4, max_len=128, hot_window=16)
        (root / c["file"]).write_text(json.dumps(conf))
    for w in bench["workloads"]:
        src = REPO / "bench" / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(src.read_text())
        if mix["kind"] == "serve":
            mix["prompt"].update(median=32, min=12, max=60)
            mix["output"].update(median=8, min=3, max=20)
            mix.update(stratum=8, join_per_step=2, warm_steps=6, warm_rows=2,
                       profile_steps=2, check_requests=3)
        else:
            mix.update(batch=2, seq_len=32, profile_steps=1)
        (root / "bench" / "traffic" / src.name).write_text(json.dumps(mix))
        (root / "bench" / "limits" / f"{w['name']}.json").write_text(
            json.dumps(LIMITS[mix["kind"]]))
    for f in (REPO / "bench" / "metrics").glob("*.py"):
        shutil.copy(f, root / "bench" / "metrics" / f.name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def context(root: Path, workload: str, seed: int = SEED, seconds=0.5,
            trace: bool = False, control: bool = False):
    import torch
    from bench.harness import cell, spec
    bench = spec.load_json(root / "BENCHMARK.json")
    return cell.context(workload, seed, seconds, trace, torch.device("cpu"),
                        time.time(), bench=bench, root=root,
                        bench_dir=root / "bench", control=control,
                        log=lambda s: None), bench


def run(root: Path, workload: str, **kw):
    """The result line of one run of ``workload`` on the CPU."""
    from bench.harness import cell
    ctx, bench = context(root, workload, **kw)
    return cell.run(ctx, bench)
