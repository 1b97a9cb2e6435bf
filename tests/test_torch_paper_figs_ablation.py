"""Figure-row parity (see test_torch_paper_figs.py) for fig01 and fig13,
the figures over IBEX's ablation rungs (ibex_base, ibex_s, ibex_sc,
ibex_scm)."""
import pytest

pytest.importorskip("jax")

from test_torch_paper_figs import ABLATION_FIGS, check_figure, small  # noqa: E402,F401


@pytest.mark.parametrize("name", ABLATION_FIGS)
def test_figure_rows_match_reference(small, name):  # noqa: F811
    check_figure(name)
