"""The port's ``simx/engine.run_workload`` against the reference's, cell
by cell, on the CPU: for each scheme x {pr, mcf} at ``n_accesses=768,
promoted_pages=32`` the metrics dicts compare equal with ``==``, floats
included (key order too), and the pools at the cell's end are identical
leaf for leaf with the same I1-I4 status. This file holds ibex, tmcc,
dylect and compresso, and ibex at ``window=1``;
``test_torch_simx_cells_4k.py`` and ``test_torch_simx_cells_ablation.py``
hold the other six schemes (one file per test worker)."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.simx import trace as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.engine.invariants import first_violation  # noqa: E402
from repro_torch.simx import engine as SE  # noqa: E402
from repro_torch.simx import trace as TT  # noqa: E402
from test_torch_simx_reference import reference_cell  # noqa: E402

SIZE = dict(n_accesses=768, promoted_pages=32)
WORKLOADS = ["pr", "mcf"]


def check_cell(scheme: str, wl: str, **kw) -> dict:
    """One cell through both packages: equal metrics, pool leaves and
    I1-I4 status. Returns the port's metrics."""
    kw = dict(SIZE, **kw)
    want, arrays, status = reference_cell(scheme, JT.WORKLOADS[wl], **kw)
    got, pool, cfg = SE.run_cell(scheme, TT.WORKLOADS[wl],
                                 torch_device="cpu", **kw)
    assert list(got) == list(want)
    assert got == want, {k: (got[k], want[k]) for k in want
                         if got[k] != want[k]}
    if arrays is None:
        assert pool is None
        return got
    leaves = interop.pool_to_numpy(pool)
    assert list(leaves) == list(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    assert first_violation(leaves, cfg) == status
    return got


@pytest.mark.parametrize("wl", WORKLOADS)
@pytest.mark.parametrize("scheme", ["ibex", "tmcc", "dylect", "compresso"])
def test_cell_matches_reference(scheme, wl):
    check_cell(scheme, wl)


def test_serial_window_matches_reference():
    """``window=1``: every access through the serial path."""
    got = check_cell("ibex", "pr", window=1)
    assert got != SE.run_workload("ibex", TT.WORKLOADS["pr"],
                                  torch_device="cpu", **SIZE)


def test_run_workload_is_run_cells_metrics():
    spec = TT.WORKLOADS["mcf"]
    for scheme in ("ibex", "compresso"):
        assert SE.run_workload(scheme, spec, torch_device="cpu", **SIZE) == \
            SE.run_cell(scheme, spec, torch_device="cpu", **SIZE)[0]


def test_run_workload_refuses_obs_and_needs_a_device(monkeypatch):
    """``run_workload(obs=)`` records the cell (the telemetry is ported:
    it no longer refuses a recorder) and still needs a device."""
    from repro_torch.obs import Recorder
    spec = TT.WORKLOADS["mcf"]
    rec = Recorder()
    got = SE.run_workload("ibex", spec, obs=rec, torch_device="cpu", **SIZE)
    assert rec.cells == [{"scheme": "ibex", "workload": "mcf",
                          "time_s": got["time_s"],
                          "normalized_perf": got["normalized_perf"]}]
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SE.run_workload("ibex", spec, **SIZE)


# numpy 2.0.2's Generator.zipf (the numpy the reference's numbers were made
# with): the first six of 5,000 draws and a digest of all of them
ZIPF_2_0 = {
    (1.01 + 1e-9, 0): ([65, 2967038773440042, 17, 155204556462,
                        617799279106606208, 243872737160], "7838ed4529ca04a4"),
    (1.1 + 1e-9, 7): ([3100488, 1, 8443551, 36, 18, 1121], "09aea33e765dacd3"),
    (1.5, 0): ([7, 1, 29, 49, 13, 53], "e2718351a2a7a868"),
    (2.0, 7): ([4, 1, 1, 4, 1, 1], "8ccf2cc140ab29f9"),
}


@pytest.mark.parametrize("a,seed", list(ZIPF_2_0))
def test_zipf_is_numpy_2_0s_sampler(a, seed):
    """The port's traces draw Zipf ranks with numpy 2.0's sampler whatever
    numpy is installed (later versions changed the draws for a < ~1.8, and
    with them every trace): the draws, and the stream state after them."""
    import hashlib
    rng = np.random.default_rng(seed)
    d = TT.zipf(rng, a, size=5000)
    head, digest = ZIPF_2_0[(a, seed)]
    assert d.dtype == np.int64 and d[:6].tolist() == head
    assert hashlib.sha1(d.tobytes()).hexdigest()[:16] == digest
    after = np.random.default_rng(seed)
    if np.__version__.startswith("2.0."):
        np.testing.assert_array_equal(after.zipf(a, size=5000), d)
        assert after.random() == rng.random()
    assert TT.zipf(np.random.default_rng(seed), a) == head[0]
