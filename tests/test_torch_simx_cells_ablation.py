"""``run_workload`` cell parity (see test_torch_simx_cells.py) for the
IBEX ablation rungs S, SC and SCM (fig13)."""
import pytest

pytest.importorskip("jax")

from test_torch_simx_cells import WORKLOADS, check_cell  # noqa: E402


@pytest.mark.parametrize("wl", WORKLOADS)
@pytest.mark.parametrize("scheme", ["ibex_s", "ibex_sc", "ibex_scm"])
def test_cell_matches_reference(scheme, wl):
    check_cell(scheme, wl)
