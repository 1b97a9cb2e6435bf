"""The payload pool against the reference (test_torch_pool.py's recipe:
48 pages, seed 5, a 256-access mcf trace, every leaf after population and
after replay, I1-I4 in both packages) for the baselines without a parity
test elsewhere: dmc, dylect, mxt and compresso, each with its own
settings. test_torch_pool_schemes_ablation.py holds IBEX's ablation
rungs."""
import pytest

pytest.importorskip("jax")

from test_torch_pool import CONFIGS, _base, _for_policy, check_slice  # noqa: E402

SCHEMES = ["dmc", "dylect", "mxt", "compresso"]
for _name in SCHEMES:
    CONFIGS[f"payload_{_name}"] = (_name, _for_policy(_base(), _name))


@pytest.mark.parametrize("name", SCHEMES)
def test_slice_bit_identical(name):
    check_slice(f"payload_{name}")
