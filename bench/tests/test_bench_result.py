"""The result line, the refusal without a card, and cells, mixes and
per-layer metrics found by their names alone."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import tiny
from tiny import REPO

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload,trace", [
    ("deepseek-7b.serve.oversub", False), ("deepseek-7b.serve.oversub", True),
    ("minicpm3-4b.serve.oversub", False), ("deepseek-7b.train.s2k", False),
    ("deepseek-7b.train.s2k", True)])
def test_result_line_keys(tmp_path, workload, trace):
    root = tiny.make(tmp_path)
    line = tiny.run(root, workload, trace=trace)
    assert list(line)[:5] == KEYS
    assert list(line)[-1] == "checks"          # the numbers compared, last
    assert line["failed"] == 0 and line["attempted"] > 0
    for h in line["checks"].values():
        assert set(h) == {"value", "limit"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    from bench.harness import spec
    wl = spec.workload(bench, workload)
    if trace:
        want = {m["name"] for m in spec.per_layer_metrics(bench, wl)}
        assert "breakdown" in line
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the host-side readers read on the CPU too; device ones need a card
        assert set(line["metrics"]) <= want and line["metrics"]
    else:
        want = {m["name"] for m in spec.end_to_end_metrics(bench, wl)}
        # peak_mem_gib reads the card's allocator only
        assert set(line["metrics"]) == want - {"peak_mem_gib"}
    json.dumps(line)


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "deepseek-7b.serve.oversub", "--seed",
                        str(tiny.SEED), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_metric_mix_and_cell_found_by_name(tmp_path):
    """A later PR adds a per-layer metric, a mix and a cell by new files and
    new entries only."""
    root = tiny.make(tmp_path)
    (root / "bench" / "metrics" / "tokens_per_step.serve.py").write_text(
        "def read(rec):\n"
        "    return rec.counters['tokens'] / rec.steps\n")
    mix = json.loads((root / "bench" / "traffic" / "serve.fit.json")
                     .read_text())
    mix["clients_per_lane"] = 0.5
    (root / "bench" / "traffic" / "serve.half.json").write_text(
        json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "deepseek-7b.serve.half",
                               "config": "deepseek-7b",
                               "traffic": "serve.half", "chips": 1,
                               "why": "half the lanes busy"})
    bench["per_layer"].append({
        "name": "tokens_per_step.serve", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "serving engine",
        "moves": "serve_tokens_per_s",
        "workloads": ["deepseek-7b.serve.half"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "deepseek-7b.serve.fit" in m["workloads"]:
            m["workloads"].append("deepseek-7b.serve.half")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = tiny.run(root, "deepseek-7b.serve.half", trace=True)
    v = line["metrics"]["tokens_per_step.serve"]["value"]
    # two clients on four lanes: a token each a step, two in the step that
    # prefills a prompt (its first token, then its first decode)
    assert 0 < v <= 4
    assert "tokens_per_step.serve" not in tiny.run(
        root, "deepseek-7b.serve.fit", trace=True)["metrics"]


def test_a_reader_that_finds_nothing_is_left_out(tmp_path):
    """The fit cell parks nothing: its copy metric is not in the line, and
    the device readers find no device on the CPU."""
    root = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "lane_copy_mib_per_step.serve":
            m["workloads"].append("deepseek-7b.serve.fit")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = tiny.run(root, "deepseek-7b.serve.fit", trace=True)
    assert "lane_copy_mib_per_step.serve" not in line["metrics"]
    assert "kvc_attn_roofline.serve" not in line["metrics"]
    assert "admit_ms_per_step.serve" in line["metrics"]
