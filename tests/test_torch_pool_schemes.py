"""The port's payload pool against the reference for the configs beyond
ibex's (see test_torch_pool.py, whose recipe and checks these reuse): one
4 KB-block scheme (tmcc, lossy tolerances) and a payload-less pool sized
by a content model, with batched demotion at the serial engine's cadence."""
import pytest

pytest.importorskip("jax")

from test_torch_pool import check_interop_mid_run, check_slice  # noqa: E402

SCHEMES = ["tmcc", "ibex_access_cadence_no_payload"]


@pytest.mark.parametrize("key", SCHEMES)
def test_slice_bit_identical(key):
    check_slice(key)


def test_interop_round_trip_mid_run():
    check_interop_mid_run("tmcc")
