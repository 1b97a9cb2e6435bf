"""The port's figure runner (``repro_torch.launch.paper_figs``) against the
reference's ``benchmarks/paper_figs.py``: every figure function gives the
same rows (names and derived values; the ``us`` wall times aside) at a
small size set in both modules with monkeypatch (128 accesses over 32
promoted pages, three workloads). This file holds the figures over ibex
and the baselines; test_torch_paper_figs_ablation.py holds fig01 and
fig13, whose IBEX rungs compile apart (one file per test worker). The CLI
prints the reference runner's CSV and reports a failing figure as an
``ERROR:`` row with exit code 1."""
import functools
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import paper_figs as JPF  # noqa: E402
from repro_torch.launch import paper_figs as PF  # noqa: E402
from repro_torch.simx import engine as SE  # noqa: E402

SMALL = dict(N_Q=128, PROM_Q=32, QUICK_WL=["pr", "mcf", "xsbench"])


@pytest.fixture
def small(monkeypatch):
    for mod in (JPF, PF):
        for k, v in SMALL.items():
            monkeypatch.setattr(mod, k, v)


def _rows(rows):
    return [(r["name"], r["derived"]) for r in rows]


ABLATION_FIGS = ["fig01_bandwidth", "fig13_ablation"]


def check_figure(name):
    port = functools.partial(SE.run_workload, torch_device="cpu")
    want = _rows(getattr(JPF, name)(True))
    assert _rows(getattr(PF, name)(True, port)) == want
    # the same rows through the cache that computes each cell once
    assert _rows(getattr(PF, name)(True, PF.CellCache("cpu"))) == want


@pytest.mark.parametrize("name", [f.__name__ for f in JPF.ALL_FIGS
                                  if f.__name__ not in ABLATION_FIGS])
def test_figure_rows_match_reference(small, name):
    check_figure(name)


def test_figure_list_matches_reference():
    assert [f.__name__ for f in PF.ALL_FIGS] == \
        [f.__name__ for f in JPF.ALL_FIGS]
    for k in ("QUICK_WL", "FULL_WL", "N_Q", "N_F", "PROM_Q", "PROM_F"):
        assert getattr(PF, k) == getattr(JPF, k), k


def test_cell_cache_runs_each_cell_once(small):
    cache = PF.CellCache("cpu")
    PF.fig12_background(True, cache)
    PF.fig17_fault(True, cache)         # the same ibex cells again
    assert len(cache.cells) == len(SMALL["QUICK_WL"])
    for c in cache.cells.values():
        assert c["invariants"] is None and c["seconds"] > 0
        assert c["stats"]["windows"] > 0
        assert c["accesses"] == SMALL["N_Q"] + 4 * SMALL["PROM_Q"]


def test_cli_prints_the_csv_and_flags_errors(small, monkeypatch, capsys):
    assert PF.main(["--only", "fig14", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in out[1:]] == \
        [f"fig14.cxl_{n}ns" for n in (70, 150, 250, 400)]

    def broken(quick, run=None):
        raise ValueError("boom")
    broken.__name__ = "fig15_decomp"
    monkeypatch.setattr(PF, "ALL_FIGS", [PF.fig14_latency, broken])
    assert PF.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "fig15_decomp,0.0,ERROR:ValueError:boom"
    assert PF.main(["--only", "nothing", "--device", "cpu"]) == 0
