"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names
and units, every file it names found by name under ``bench/``, each cell
reporting set-up, another end-to-end metric and a per-layer metric, each
per-layer metric's cells reporting the metric it moves, and the run
length inside the check's time with 24 cells."""
from __future__ import annotations

import json
import re

from tiny import REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_keys_names_and_units():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["bench"] and B["command"][1] == "bench/run.py"
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len({m["name"] for m in B["end_to_end"] + B["per_layer"]}) == \
        len(B["end_to_end"]) + len(B["per_layer"])


def test_every_file_found_by_name():
    for c in B["configs"]:
        assert (REPO / c["file"]).exists()
    for w in B["workloads"]:
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (REPO / "bench" / "limits" / f"{w['name']}.json").exists()
    for m in B["per_layer"]:
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").exists()


def test_each_cell_reports_what_its_metrics_move():
    from bench.harness import spec
    for w in B["workloads"]:
        e2e = {m["name"] for m in spec.end_to_end_metrics(B, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = spec.per_layer_metrics(B, w)
        assert per
        assert all(m["moves"] in e2e for m in per)
    for m in B["per_layer"]:
        for name in m.get("workloads", []):
            w = spec.workload(B, name)
            assert m["moves"] in {x["name"] for x in
                                  spec.end_to_end_metrics(B, w)}


def test_run_length_fits_the_check_with_24_cells():
    rs = B["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
