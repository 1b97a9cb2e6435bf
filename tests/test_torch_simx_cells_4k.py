"""``run_workload`` cell parity (see test_torch_simx_cells.py) for the
4 KB-engine baselines mxt and dmc and the IBEX ablation's base rung."""
import pytest

pytest.importorskip("jax")

from test_torch_simx_cells import WORKLOADS, check_cell  # noqa: E402


@pytest.mark.parametrize("wl", WORKLOADS)
@pytest.mark.parametrize("scheme", ["mxt", "dmc", "ibex_base"])
def test_cell_matches_reference(scheme, wl):
    check_cell(scheme, wl)
