"""Loading a cell by name: its entry in ``BENCHMARK.json``, its
configuration file (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<traffic>.json``) and its limits
(``bench/limits/<workload>.json``). Nothing here names a cell: a later cell
is found by its files alone."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config_file(bench: Dict[str, Any], name: str, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def limits(workload_name: str, bench_dir: Path = BENCH_DIR
           ) -> Optional[Dict[str, Any]]:
    """The cell's limits file, or None where the cell has none yet (then
    every number is printed against no limit and ``correct`` is false)."""
    path = bench_dir / "limits" / f"{workload_name}.json"
    return load_json(path) if path.exists() else None


def model_config(conf: Dict[str, Any]):
    """The port's ``ModelConfig`` from a configuration file: the published
    keys as run (``hidden_size`` ...) and the port's own (``port``)."""
    from repro_torch.common.types import MLAConfig, ModelConfig
    port = conf["port"]
    heads = conf["num_attention_heads"]
    mla = None
    if port["attn_kind"] == "mla":
        mla = MLAConfig(q_lora_rank=conf["q_lora_rank"],
                        kv_lora_rank=conf["kv_lora_rank"],
                        qk_nope_head_dim=conf["qk_nope_head_dim"],
                        qk_rope_head_dim=conf["qk_rope_head_dim"],
                        v_head_dim=conf["v_head_dim"])
    return ModelConfig(
        name=conf["name"], family=port["family"],
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=heads, num_kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim") or 0, d_ff=conf["intermediate_size"],
        vocab_size=conf["vocab_size"],
        max_seq_len=conf["max_position_embeddings"],
        rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]),
        attn_kind=port["attn_kind"], mla=mla, dtype=port["dtype"],
        remat=bool(port["remat"]))


def per_layer_metrics(bench: Dict[str, Any], wl: Dict[str, Any]):
    """The per-layer metrics this cell reports: those that list it, and
    those with no list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cells is not None and wl["name"] in cells) or \
                (cells is None and m["moves"] in e2e):
            out.append(m)
    return out


def end_to_end_metrics(bench: Dict[str, Any], wl: Dict[str, Any]):
    return [m for m in bench["end_to_end"]
            if wl["name"] in m.get("workloads", [wl["name"]])]
