"""The payload pool against the reference (test_torch_pool.py's recipe,
as in test_torch_pool_schemes_4k.py) for IBEX's ablation rungs: ibex_base,
ibex_s, ibex_sc and ibex_scm, each with its own settings."""
import pytest

pytest.importorskip("jax")

from test_torch_pool import CONFIGS, _base, _for_policy, check_slice  # noqa: E402

SCHEMES = ["ibex_base", "ibex_s", "ibex_sc", "ibex_scm"]
for _name in SCHEMES:
    CONFIGS[f"payload_{_name}"] = (_name, _for_policy(_base(), _name))


@pytest.mark.parametrize("name", SCHEMES)
def test_slice_bit_identical(name):
    check_slice(f"payload_{name}")
