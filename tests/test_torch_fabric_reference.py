"""The committed reference of the fabric bench
(``src/repro_torch/fabric/reference_fabric.json``): what the JAX package's
``Fabric`` gives for every fabric of ``benchmarks/fabric_bench.py``'s full
recipe (``repro_torch.launch.fabric.BENCH_FABRICS``), and the generator
that writes it.

For each fabric the file holds ``launch.fabric.record``'s fields:
per-expander counters, the override table's digest, spill and sync stats,
segment and migration deltas, float64 delivered times, every segment's
float32 times as bit patterns, the pipeline pricing and every pool leaf's
digest. ``chip_smoke.py`` phase 12 holds every fabric on the card to it;
the tests here hold two of them on the CPU (``==`` on every field).

Regenerate it on the CPU with JAX (about ten minutes, mostly compiles):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_fabric_reference.py
"""
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine.policy import POLICIES as JPOLICIES  # noqa: E402
from repro.fabric import replay as JR  # noqa: E402
from repro.fabric.placement import make_placement as jmake_placement  # noqa: E402,E501
from repro.simx import time as JTM  # noqa: E402
from repro.simx.engine import pool_cfg_for as jpool_cfg_for  # noqa: E402
from repro.simx.trace import make_rates_table as jmake_rates  # noqa: E402
from repro.simx.trace import make_trace as jmake_trace  # noqa: E402
from repro.simx.trace import WORKLOADS as JWORKLOADS  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import fabric as LF  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _jax_fabric(fabric: dict, recipe: dict, rates) -> "JR.Fabric":
    policy = JPOLICIES[recipe["scheme"]]
    cfg = jpool_cfg_for(policy, n_pages=recipe["n_pages"],
                        n_pchunks=recipe["n_pchunks"],
                        n_cchunks=fabric["n_cchunks"])
    n = fabric["n"]
    placement = (jmake_placement("interleave", n, recipe["n_pages"])
                 if fabric["weights"] is None else
                 jmake_placement("weighted", n, recipe["n_pages"],
                                 weights=fabric["weights"]))
    return JR.Fabric(cfg, policy, placement, seed=recipe["seed"],
                     rates_table=jnp.asarray(rates), window=recipe["window"],
                     devices=[JTM.DEVICE_PROFILES[p]
                              for p in fabric["profiles"]],
                     **fabric["kwargs"])


def _jax_record(fab, seg_times) -> dict:
    """``launch.fabric.record`` of a JAX fabric."""
    pt = fab.pipeline_times()
    leaves = {k: np.asarray(v) for k, v in interop.leaves(fab.pools)}
    return {
        "counters": fab.counters_by_expander(),
        "overrides_sha256": LF.digest(fab.placement.overrides),
        "overrides_set": int((fab.placement.overrides >= 0).sum()),
        "spill_stats": fab.spill_stats(),
        "sync_stats": fab.sync_stats(),
        "segment_deltas": [d.tolist() for d in fab.segment_deltas],
        "migration_deltas": [[int(i), d.tolist(), bool(o)]
                             for i, d, o in fab.migration_deltas],
        "delivered_exact": [float(t) for t in fab.delivered_time()],
        "segment_times_f32": [np.asarray(t, np.float32).view(np.uint32)
                              .tolist() for t in seg_times],
        "pipeline": None if pt is None else {
            "mode": pt["mode"],
            "overlapped_s": [float(t) for t in pt["overlapped_s"]],
            "sync_s": [float(t) for t in pt["sync_s"]]},
        "leaves_sha256": {k: LF.digest(a) for k, a in leaves.items()},
    }


def generate() -> dict:
    recipe = LF.BENCH_RECIPE
    spec = JWORKLOADS[recipe["workload"]]
    rates = jmake_rates(spec, recipe["n_pages"], seed=recipe["seed"])
    trace = jmake_trace(spec, n_accesses=recipe["n_accesses"],
                        n_pages=recipe["n_pages"], seed=recipe["seed"])
    # the float32 times each segment's fetch carries (the reference keeps
    # only the last), recorded by wrapping the fetch
    seg_times = []
    fetch = JR.Fabric._fetch_view

    def recording(self, times, stats, counters, recent):
        seg_times.append(np.asarray(jax.device_get(times)))
        return fetch(self, times, stats, counters, recent)

    JR.Fabric._fetch_view = recording
    out = []
    try:
        for fabric in LF.BENCH_FABRICS:
            seg_times.clear()
            fab = _jax_fabric(fabric, recipe, rates)
            fab.replay(*trace)
            out.append(dict(fabric, result=_jax_record(fab, seg_times)))
            print(f"{fabric['name']}: {fab.sync_stats()}", flush=True)
    finally:
        JR.Fabric._fetch_view = fetch
    return {"recipe": recipe,
            "trace_sha256": [LF.digest(np.asarray(a)) for a in trace],
            "fabrics": out}


@pytest.fixture(scope="module")
def reference():
    return json.loads(LF.REFERENCE.read_text())


def test_reference_file_is_this_recipe(reference):
    """The file was written for the recipe and the fabrics the port runs,
    and the port's trace is the one the JAX package replayed."""
    assert reference["recipe"] == LF.BENCH_RECIPE
    assert [{k: v for k, v in f.items() if k != "result"}
            for f in reference["fabrics"]] == \
        json.loads(json.dumps(LF.BENCH_FABRICS))
    _, trace = LF.bench_inputs()
    assert [LF.digest(np.asarray(a)) for a in trace] == \
        reference["trace_sha256"]


@pytest.mark.parametrize("name", ["migration.depth2", "fleet.mixed4"])
def test_port_fabric_equals_reference_file(reference, name):
    """Two of the recipe's fabrics on the CPU against the JAX package's
    record: the rebalance pipeline at depth 2 (its trigger reads the
    float32 segment times) and the mixed fleet with spill live; every
    field ``==``, the float32 times bit for bit."""
    want = next(f for f in reference["fabrics"] if f["name"] == name)
    rates, trace = LF.bench_inputs()
    fab = LF.build(want, rates, device="cpu").replay(*trace)
    got = json.loads(json.dumps(LF.record(fab)))
    assert got["sync_stats"]["epochs"] > 0
    bad = [k for k in want["result"] if got[k] != want["result"][k]]
    assert not bad, bad


if __name__ == "__main__":
    content = generate()
    LF.REFERENCE.write_text(json.dumps(content, indent=None) + "\n")
    print(f"wrote {LF.REFERENCE.relative_to(ROOT)}: "
          f"{len(content['fabrics'])} fabrics")
