"""ROADMAP queue C5, a fault of the reference that the port keeps: in a
payload-less pool whose schemes price a page at its worst block (coloc
off), pages with one raw block need an 8-chunk group, the group freelist
(1/8 of the compressed region) runs dry, and the callers store the -1 that
``freelist.pop`` returns as a chunk pointer. Both packages end with the
same pool and the same I1 failure: the reference's own checker
(``tests/helpers.py``) and the port's ``invariants.py`` give one message.
Nothing is resized to hide it."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import engine as JE  # noqa: E402
from repro.core.engine import batch as JB  # noqa: E402
from repro.simx import trace as JT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.engine.invariants import (  # noqa: E402
    check_pool_invariants, first_violation)
from repro_torch.simx import engine as SE  # noqa: E402
from repro_torch.simx import trace as TT  # noqa: E402
from test_torch_pool import (CONFIGS, N_ACCESSES, SEED, _assert_same,  # noqa: E402
                             _base, _content_model, _for_policy, _inputs,
                             _jax_arrays, _jax_write, _port_run)
from test_torch_simx_reference import reference_cell  # noqa: E402

from helpers import check_pool_invariants as jax_invariants  # noqa: E402

C5_MESSAGE = "I1 violated: page 17 references free chunk 0"
# test_torch_pool.py's recipe (48 pages, 384 C-chunks: 6 groups, seed 5,
# a 256-access mcf trace) with ibex_s's settings, payload-less
CONFIGS["c5_ibex_s"] = ("ibex_s", _for_policy(
    dataclasses.replace(_base(), store_payload=False), "ibex_s"))


def _message(check, *args):
    with pytest.raises(AssertionError) as e:
        check(*args)
    return str(e.value)


def test_c5_group_freelist_runs_dry_alike():
    name, cfg = CONFIGS["c5_ibex_s"]
    pol = JE.POLICIES[name]
    pages, (o, w, b) = _inputs(cfg)
    jpool = _jax_write(JE.make_pool(cfg, seed=SEED,
                                   rates_table=_content_model(cfg)),
                       cfg, pol, pages)
    half = N_ACCESSES // 2
    jpool = JB.replay_trace(jpool, cfg, pol, o[:half], w[:half], b[:half])
    jpool = JB.replay_trace(jpool, cfg, pol, o[half:], w[half:], b[half:])
    tcfg, _, pool = _port_run("c5_ibex_s")
    end = interop.pool_to_numpy(pool)
    _assert_same(_jax_arrays(jpool), end, "c5 replay")
    assert _message(jax_invariants, jpool, cfg) == C5_MESSAGE
    assert _message(check_pool_invariants, end, tcfg) == C5_MESSAGE
    assert first_violation(end, tcfg) == C5_MESSAGE


def test_c5_full_size_cell_alike():
    """ibex_base x pr at the figures' full size (12,000 accesses, 96
    promoted pages): the same metrics (normalized perf 0.0613), pool and
    invariant failure in both packages."""
    kw = dict(n_accesses=12000, promoted_pages=96)
    want, arrays, status = reference_cell("ibex_base", JT.WORKLOADS["pr"],
                                          **kw)
    got, pool, cfg = SE.run_cell("ibex_base", TT.WORKLOADS["pr"],
                                 torch_device="cpu", **kw)
    assert got == want
    assert round(got["normalized_perf"], 4) == 0.0613
    leaves = interop.pool_to_numpy(pool)
    for k, v in arrays.items():
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    assert status is not None and first_violation(leaves, cfg) == status


def _pool_view(arrays):
    """The reference checker reads a pool's leaves by name."""
    from types import SimpleNamespace as NS
    fl = lambda k: NS(items=arrays[f"{k}.items"], top=arrays[f"{k}.top"])  # noqa: E731
    return NS(meta=arrays["meta"], activity=arrays["activity"],
              cfree=fl("cfree"), gfree=fl("gfree"), pfree=fl("pfree"))


def _corruptions(a):
    """(what, corrupt(arrays)) pairs, one for each check of the
    reference's checker, applied to a copy of a pool that holds I1-I4."""
    w0 = a["meta"][:, 0].astype(np.int64)
    valid = (w0 >> 31) & 1 == 1
    prom = np.nonzero(valid & ((w0 >> 30) & 1 == 1))[0]
    clean = prom[((w0[prom] >> 29) & 1) == 0]
    dirty = prom[((w0[prom] >> 29) & 1) == 1]
    single = np.nonzero(valid & (((w0 >> 20) & 0xF) > 0) &
                        (((w0 >> 20) & 0xF) < 8))[0]
    top = int(a["cfree.top"])
    ptr = (1 << 29) - 1

    def set_w0(m, p, fn):
        m["meta"][p, 0] = fn(int(m["meta"][p, 0]))

    def dup_free(m):
        m["cfree.items"][1] = m["cfree.items"][0]

    def dup_p(m):
        m["pfree.items"][1] = m["pfree.items"][0]
        m["pfree.top"] = np.maximum(m["pfree.top"], 2)

    def i3(m):
        set_w0(m, dirty[0], lambda x: (x & ~(0xF << 20)) | (3 << 20))

    def i4(m):
        set_w0(m, clean[0], lambda x: x & ~(1 << 28))

    def ref_free(m):
        word = int(m["meta"][single[1], 1])
        m["meta"][single[1], 1] = (word & ~ptr & 0xFFFFFFFF) | \
            int(m["cfree.items"][0])

    def shared(m):
        m["meta"][single[2], 1] = m["meta"][single[0], 1]

    def p_free(m):
        m["pfree.items"][int(m["pfree.top"])] = m["meta"][prom[1], 7] & ptr
        m["pfree.top"] = m["pfree.top"] + 1

    def p_shared(m):
        m["meta"][prom[2], 7] = m["meta"][prom[0], 7]

    def act_unset(m):
        m["activity"][int(m["meta"][prom[1], 7]) & ptr] &= 0x7FFFFFFF

    def act_other(m):
        m["activity"][int(m["meta"][prom[1], 7]) & ptr] ^= 1

    def act_orphan(m):
        free_p = int(m["pfree.items"][0])
        m["activity"][free_p] = (1 << 31) | int(prom[0])

    def lost_chunk(m):
        m["cfree.top"] = m["cfree.top"] - 1

    def lost_p(m):
        m["pfree.top"] = m["pfree.top"] - 1

    def outside(m):
        # a chunk id past the region standing in for a lost free one: the
        # counts balance, so only the port's extra check sees it
        m["cfree.items"][top - 1] = 1 << 20

    return [("dup_free", dup_free), ("dup_p", dup_p), ("i3", i3), ("i4", i4),
            ("ref_free", ref_free), ("shared", shared), ("p_free", p_free),
            ("p_shared", p_shared), ("act_unset", act_unset),
            ("act_other", act_other), ("act_orphan", act_orphan),
            ("lost_chunk", lost_chunk), ("lost_p", lost_p),
            ("outside", outside)]


def test_first_violation_is_the_reference_checkers_message():
    """Each check of the reference's checker, broken on purpose in a copy
    of a healthy pool: the port reports the reference's message."""
    name, cfg = CONFIGS["ibex_access_cadence_no_payload"]
    tcfg, _, pool = _port_run("ibex_access_cadence_no_payload")
    healthy = interop.pool_to_numpy(pool)
    assert first_violation(healthy, tcfg) is None
    jax_invariants(_pool_view(healthy), cfg)
    seen = set()
    for what, corrupt in _corruptions(healthy):
        a = {k: v.copy() for k, v in healthy.items()}
        corrupt(a)
        got = first_violation(a, tcfg)
        if what == "outside":
            jax_invariants(_pool_view(a), cfg)        # the reference passes
            assert got == "I1 violated: a chunk id outside the region"
            continue
        want = _message(jax_invariants, _pool_view(a), cfg)
        assert got == want, (what, got, want)
        seen.add(want.split(":")[0].split(" ")[0])
    assert len(seen) >= 6, seen
