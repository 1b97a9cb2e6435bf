"""The committed reference of the figure cells
(``src/repro_torch/simx/reference_cells.json``) against a fresh run of the
JAX package, and the generator that writes it.

The file holds every cell that the port's figures ask for when fig09 runs
at the paper's full size and the other nine figures in quick mode (the
cells ``chip_smoke.py`` runs on the card): the reference's
``run_workload`` metrics, the first I1-I4 violation of the reference's pool
at the cell's end (``tests/helpers.py::check_pool_invariants``; null when
they hold or for a line-level scheme), and the reference's figure rows.

Regenerate it on the CPU with JAX (about three minutes):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_simx_reference.py
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import batch as JB  # noqa: E402
from repro.core.engine import state as JS  # noqa: E402
from repro.simx import engine as JSE  # noqa: E402
from repro.simx import trace as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.launch import paper_figs as PF  # noqa: E402
from repro_torch.simx import engine as SE  # noqa: E402
from repro_torch.simx import trace as TT  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from helpers import check_pool_invariants  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "src" / "repro_torch" / "simx" / "reference_cells.json"


def reference_cell(scheme, spec, *, n_accesses, promoted_pages, device=None,
                   seed=0, window=JSE.DEFAULT_WINDOW):
    """The reference's ``run_workload`` metrics for one cell, and its
    pool's leaves and I1-I4 status at the cell's end (``run_workload``'s
    recipe through the reference's own pieces; None, None for line-level
    schemes)."""
    metrics = JSE.run_workload(scheme, spec, n_accesses=n_accesses,
                               promoted_pages=promoted_pages, seed=seed,
                               device=device, window=window)
    policy = JSE.SCHEMES[scheme]
    if policy.line_level:
        return metrics, None, None
    n_pages = 4 * promoted_pages
    n_used = min(max(int(promoted_pages * spec.footprint_pages), 32), n_pages)
    rates = JT.make_rates_table(spec, n_pages, seed=seed)
    ospn, is_write, block = JT.make_trace(spec, n_accesses=n_accesses,
                                          n_pages=n_used, seed=seed)
    cfg = JSE.pool_cfg_for(policy, n_pages=n_pages, n_pchunks=promoted_pages,
                           n_cchunks=2 * n_pages * 8)
    pool = JS.make_pool(cfg, seed=seed, rates_table=jnp.asarray(rates))
    pool = JSE.first_touch_populate(pool, cfg, policy, n_used=n_used,
                                    seed=seed, window=window)
    pool = JB.replay_trace(pool, cfg, policy, ospn, is_write, block,
                           window=window)
    assert JS.counters_dict(pool)["host_reads"] == metrics["host_reads"]
    try:
        check_pool_invariants(pool, cfg)
        status = None
    except AssertionError as e:
        status = str(e)
    arrays = {k: np.asarray(v) for k, v in interop.leaves(pool)}
    return metrics, arrays, status


def _spec_of(entry):
    return TT.WorkloadSpec(**entry["spec"])


def load_reference() -> dict:
    return json.loads(REFERENCE.read_text())


def generate() -> dict:
    """Run the reference's figures (fig09 full, the rest quick), recording
    each distinct cell they ask for; returns the file's content."""
    import dataclasses

    sys.path.insert(0, str(ROOT))
    from benchmarks import paper_figs as JPF

    cells = {}

    def recorder(scheme, spec, *, n_accesses, promoted_pages, device=None):
        key = PF.cell_key(scheme, spec, n_accesses, promoted_pages, device)
        if key not in cells:
            metrics, _, status = reference_cell(
                scheme, spec, n_accesses=n_accesses,
                promoted_pages=promoted_pages, device=device)
            cells[key] = {
                "key": key, "scheme": scheme,
                "spec": dataclasses.asdict(spec), "n_accesses": n_accesses,
                "promoted_pages": promoted_pages,
                "device": None if device is None else
                dataclasses.asdict(device),
                "metrics": metrics, "invariants": status}
            print(f"{len(cells)} {key} {status}", flush=True)
        return dict(cells[key]["metrics"])

    JPF.run_workload = recorder
    rows = {}
    for fig in JPF.ALL_FIGS:
        quick = fig.__name__ != "fig09_speedup"
        rows[fig.__name__] = [[r["name"], r["derived"]] for r in fig(quick)]
    return {"meta": {"generator": "tests/test_torch_simx_reference.py",
                     "jax": jax.__version__, "seed": 0,
                     "window": JSE.DEFAULT_WINDOW,
                     "fig09": "full", "others": "quick"},
            "cells": list(cells.values()), "rows": rows}


@pytest.mark.parametrize("scheme,wl", [("ibex", "pr"), ("tmcc", "mcf")])
def test_reference_file_is_current(scheme, wl):
    """Two of the file's full-size cells, recomputed with JAX: the same
    metrics and invariant status; and the port on the CPU gives them too."""
    ref = load_reference()
    spec = JT.WORKLOADS[wl]
    key = PF.cell_key(scheme, spec, PF.N_F, PF.PROM_F)
    entry = {c["key"]: c for c in ref["cells"]}[key]
    metrics, arrays, status = reference_cell(
        scheme, spec, n_accesses=PF.N_F, promoted_pages=PF.PROM_F)
    assert metrics == entry["metrics"]
    assert status == entry["invariants"]
    out, pool, cfg = SE.run_cell(scheme, TT.WORKLOADS[wl], n_accesses=PF.N_F,
                                 promoted_pages=PF.PROM_F, torch_device="cpu")
    assert out == entry["metrics"]
    got = interop.pool_to_numpy(pool)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_reference_file_covers_the_figures():
    """The file's cells are exactly those the port's figures ask for
    (fig09 full, the rest quick), its rows name the same figures, and its
    I1-I4 failures are the cells that C5 hits (ROADMAP queue C)."""
    ref = load_reference()
    asked = []

    def recorder(scheme, spec, *, n_accesses, promoted_pages, device=None):
        asked.append(PF.cell_key(scheme, spec, n_accesses, promoted_pages,
                                 device))
        return {k: 1.0 for k in ref["cells"][0]["metrics"]}

    for fig in PF.ALL_FIGS:
        fig(fig.__name__ != "fig09_speedup", recorder)
    keys = [c["key"] for c in ref["cells"]]
    assert len(set(keys)) == len(keys)
    assert sorted(set(asked)) == sorted(keys)
    assert list(ref["rows"]) == [f.__name__ for f in PF.ALL_FIGS]
    for c in ref["cells"]:
        assert PF.cell_key(c["scheme"], _spec_of(c), c["n_accesses"],
                           c["promoted_pages"], c["device"] and
                           PF.DEV.DeviceConfig(**c["device"])) == c["key"]
    # C5: some baselines break I1-I4; ibex, its S+C rungs and the
    # line-level scheme never do
    failing = {c["scheme"] for c in ref["cells"] if c["invariants"]}
    assert failing and not failing & {"ibex", "ibex_sc", "ibex_scm",
                                      "compresso"}


if __name__ == "__main__":
    content = generate()
    REFERENCE.write_text(json.dumps(content, indent=1) + "\n")
    n_bad = sum(1 for c in content["cells"] if c["invariants"])
    print(f"wrote {REFERENCE.relative_to(ROOT)}: {len(content['cells'])} "
          f"cells, {n_bad} break I1-I4")
