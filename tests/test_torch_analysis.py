"""Tests of the port's host-sync lint (``repro_torch.analysis``), the
counterpart of ``tests/test_analysis.py`` for eager PyTorch.

Layout: per-rule positive / negative / suppressed fixtures in torch idiom
(each of the reference's tests has a counterpart, named in its
docstring); parity with the reference lint on the same inputs (R3's
findings, fingerprints, the baseline format, the ``host-ok``
suppressions, the CLIs' exit codes); the committed baseline against a
fresh run over ``src/repro_torch``; acceptance demos that mutate real
port source in memory and turn a clean lint into a finding of the named
rule; and the runtime half of the contracts (``get_sync_contract``,
``verify_sync_counters``, and each marked region leaving
``contracts.SYNCS`` unchanged on the CPU at REDUCED size).

Everything but the parity, runtime and import tests is stdlib-only, as
the lint is.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis import core
from repro_torch.analysis import lint as lint_mod
from repro_torch.analysis.lint import lint_file, run_lint
from repro_torch.analysis.rules import r2_recompile_hazard as R2
from repro_torch.analysis.rules import r5_sync_contract as R5

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "src"
PORT = SRC / "repro_torch"
BASELINE = PORT / "analysis" / "baseline.json"


def _lint_src(code: str, name: str = "snippet.py"):
    return lint_file(name, relpath=name, src=textwrap.dedent(code))


def _rules(findings, *, suppressed=False):
    return [f.rule for f in findings if f.suppressed == suppressed]


def _active(findings):
    return [f for f in findings if not f.suppressed]


def _real(rel: str, src: str = None):
    """Lint a port file (``rel`` under src/repro_torch), optionally with
    its source replaced."""
    return lint_file(PORT / rel, relpath=f"repro_torch/{rel}", src=src)


def _mutate(rel: str, old: str, new: str) -> str:
    src = (PORT / rel).read_text()
    assert src.count(old) == 1, f"{old!r} not found once in {rel}"
    return src.replace(old, new)


# ---------------------------------------------------------------------------
# R1: hidden host sync
# ---------------------------------------------------------------------------

def test_r1_positive_casts_and_branches():
    """Counterpart of test_analysis.py::test_r1_positive_casts_and_branches:
    a cast, a branch, a loop test and ``.item()`` on a tensor."""
    fs = _lint_src("""
        import torch

        def f(x: torch.Tensor):
            if x > 0:
                y = int(x)
            while x < 9:
                x = x + 1
            return x.item()
    """)
    msgs = [f.message for f in fs]
    assert _rules(fs).count("R1") == 4, [f.render() for f in fs]
    assert any("`if`" in m for m in msgs)
    assert any("`while`" in m for m in msgs)
    assert any("int()" in m for m in msgs)
    assert any(".item()" in m for m in msgs)


def test_r1_reads_print_and_synchronize():
    """Counterpart of test_analysis.py::test_r1_numpy_print_device_get: the
    other raw reads (``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
    both ways), ``assert`` and ``print`` of a device value, and a device,
    stream or event synchronize."""
    fs = _lint_src("""
        import torch

        def f(t: torch.Tensor, ev):
            y = torch.zeros(4, device=t.device) + t
            a = y.tolist()
            b = y.cpu()
            c = y.numpy()
            d = y.to("cpu")
            e = y.to(device="cpu")
            assert (y > 0).all()
            print(y)
            torch.cuda.synchronize()
            torch.cuda.current_stream().synchronize()
            ev.synchronize()
            return a
    """)
    assert _rules(fs).count("R1") == 10, [f.render() for f in fs]


def test_r1_negative_static_metadata_structural():
    """Counterpart of
    test_analysis.py::test_r1_negative_static_metadata_structural:
    metadata, structural tests, host parameters, numpy, the counted reads' host
    copies and a list's truth are no syncs."""
    fs = _lint_src("""
        import numpy as np
        import torch
        from repro_torch.common import contracts

        def f(q: torch.Tensor, cfg, sm_scale, valid=None):
            if cfg.mode == "fast":              # host parameter
                q = q + 1
            if q.shape[0] > 4 and q.dim() == 3:  # metadata
                q = q * 2
            if valid is None:                   # identity
                valid = q
            out = {"q": q}
            if "q" in out:                      # membership
                q = out["q"]
            flags = int(q.dtype == torch.float32) + int(q.numel())
            scale = float(sm_scale)
            n = np.arange(cfg.n)                # numpy on host values
            got = contracts.fetch_packed({"t": q})
            t32 = got["t"].numpy()              # a fetched host copy
            h = int(contracts.item(q.sum()))
            rows = [x for x in (q, valid)]
            if rows:                            # a list's length
                pass
            return np.asarray(n).tolist(), t32, flags, scale, h
    """)
    assert fs == [], [f.render() for f in fs]


def test_r1_suppressed_counts_but_passes():
    """Counterpart of
    test_analysis.py::test_r1_suppressed_counts_but_passes."""
    fs = _lint_src("""
        import torch

        def f(x: torch.Tensor):
            n = int(x)  # lint: host-ok(debug counter, removed in prod)
            return x
    """)
    assert _rules(fs, suppressed=True) == ["R1"]
    assert _rules(fs) == []
    assert fs[0].suppress_reason == "debug counter, removed in prod"


def test_r1_region_callees_and_counted_reads():
    """Counterpart of
    test_analysis.py::test_r1_combinator_bodies_and_call_propagation:
    a sync-free region covers the local callees it reaches (the argument's
    taint maps onto the callee's parameter), and in it even a counted read is a
    finding."""
    fs = _lint_src("""
        import torch
        from repro_torch.common import contracts

        def helper(v, cfg):
            if cfg.fast:            # a host argument at the only call site
                v = v + 1
            return int(v)           # a device value through the call

        @contracts.sync_contract(syncs_per="step", fetches=0)
        def step(x: torch.Tensor, cfg):
            y = helper(x, cfg)
            return contracts.tolist(x)
    """)
    r1 = [f for f in fs if f.rule == "R1"]
    assert len(r1) == 2, [f.render() for f in fs]
    assert r1[0].func == "helper" and "int()" in r1[0].message
    assert "sync-free region `step`" in r1[0].message
    assert "counted" in r1[1].message
    # outside a region the same helper is clean (v is not known there)
    assert _lint_src("""
        def helper(v, cfg):
            return int(v)
    """) == []


def test_r1_region_host_parameters_untainted():
    """Counterpart of
    test_analysis.py::test_r1_jit_call_site_partial_kwargs_static:
    a region's host parameters (a config, closure values) are host values its
    branches may test."""
    fs = _lint_src("""
        import torch
        from repro_torch.common import contracts

        def make(cfg):
            @contracts.sync_contract(syncs_per="step", fetches=0)
            def step(state: torch.Tensor, k: int):
                if cfg.windows > 1 and k > 2:
                    state = state + 1
                for i in range(k):
                    if i:
                        state = state * 2
                return state
            return step
    """)
    assert fs == [], [f.render() for f in fs]


def test_r1_region_data_shaped_ops():
    """R1(b): ops whose output size depends on the data sync in eager
    torch; ``repeat_interleave`` with an int, or with ``output_size``, and
    ``torch.where`` with three arguments do not."""
    fs = _lint_src("""
        import torch
        from repro_torch.common import contracts

        @contracts.sync_contract(syncs_per="step", fetches=0)
        def step(x: torch.Tensor, g: int):
            a = torch.nonzero(x)
            b = torch.where(x > 0)
            c = x.unique()
            d = torch.masked_select(x, x > 0)
            e = x[x > 0]
            f = torch.repeat_interleave(x, x)
            ok1 = x.repeat_interleave(g, dim=2)
            ok2 = torch.repeat_interleave(x, x, output_size=8)
            ok3 = torch.where(x > 0, x, 0.0)
            return a, b, c, d, e, f, ok1, ok2, ok3
    """)
    assert [f.line for f in fs if f.rule == "R1"] == [7, 8, 9, 10, 11, 12], \
        [f.render() for f in fs]
    # outside a region none of them is a finding
    assert _lint_src("""
        import torch

        def f(x: torch.Tensor):
            return torch.nonzero(x), x[x > 0]
    """) == []


@pytest.mark.parametrize("rel", [
    "kernels/kvc_attn.py", "fabric/replay.py", "fabric/ops.py",
    "serve/engine.py", "kernels/flash_attn.py", "core/engine/batch.py"])
def test_r1_real_tree_negative_fixtures(rel):
    """Real port source the rule must leave alone: ``int(q.dtype ==
    torch.float32)`` and ``float(sm_scale)`` at the B5 launch, the
    ``.numpy()`` of ``contracts.fetch_packed``'s copies in ``Fabric``, the
    numpy ``.tolist()``s of the migration apply and of the lane
    preemption, ``repeat_interleave(g, dim=2)`` in B6's plain version and
    the pool's window step (which fetches by design through
    ``contracts.tolist``)."""
    fs = _real(rel)
    assert not [f for f in _active(fs) if f.rule == "R1"], \
        [f.render() for f in fs]


# ---------------------------------------------------------------------------
# R2: recompile hazards
# ---------------------------------------------------------------------------

def test_r2_mutable_default_on_compiled_callables():
    """Counterpart of
    test_analysis.py::test_r2_mutable_default_and_bad_static_names:
    mutable defaults on a ``torch.compile``d function, by decorator (bare and
    called) and at a call site."""
    fs = _lint_src("""
        import torch

        @torch.compile
        def f(x, cache={}):
            return x

        @torch.compile(dynamic=False)
        def g(x, *, opts=[]):
            return x

        def h(x, table=dict()):
            return x

        hc = torch.compile(h)
    """)
    assert sorted(_rules(fs)) == ["R2", "R2", "R2"], [f.render() for f in fs]
    assert all("mutable default" in f.message for f in fs)


def test_r2_varying_kwarg_at_compiled_call():
    """Counterpart of
    test_analysis.py::test_r2_varying_static_kwarg_at_call."""
    fs = _lint_src("""
        import torch

        def impl(x, mode):
            return x

        f = torch.compile(impl)

        def call(x, i):
            return f(x, mode=f"bucket{i}")
    """)
    assert _rules(fs) == ["R2"], [f.render() for f in fs]
    assert "per-call-varying" in fs[0].message


def test_r2_negative_clean_compile():
    """Counterpart of test_analysis.py::test_r2_negative_clean_jit: a clean
    compiled callable, a constant keyword, and kernel builds named by a
    literal of ``build.SOURCES``."""
    fs = _lint_src("""
        import torch
        from repro_torch.kernels import build as _build

        @torch.compile
        def f(x, cfg=None):
            return x

        def call(x):
            lib = _build.load("kvc_attn", {"kvc_attn_partial": []})
            _build.build("flash_attn")
            return f(x, cfg=None)
    """)
    assert fs == [], [f.render() for f in fs]


def test_r2_kernel_build_names():
    """``_build.load``/``build`` of a non-literal name or of a name not in
    ``build.SOURCES`` is a fresh nvcc run per name; the rule's copy of
    SOURCES is the build module's."""
    from repro_torch.kernels import build
    assert R2.SOURCES == build.SOURCES
    fs = _lint_src("""
        from repro_torch.kernels import build as _build

        def lib(name):
            _build.load(name, {})
            return _build.build("qpack_fused_v2")
    """)
    assert _rules(fs) == ["R2", "R2"], [f.render() for f in fs]
    assert "not a string literal" in fs[0].message
    assert "not a source of build.SOURCES" in fs[1].message


# ---------------------------------------------------------------------------
# R3: counter layout drift
# ---------------------------------------------------------------------------

R3_CASES = [
    """
    def report(counters, tvec):
        a = counters[3]
        b = tvec[0]
        return a + b
    """,
    """
    from repro_torch.core.engine import state as S

    def report(counters, i):
        a = counters[S.C_DATA_RD]
        b = counters[i]
        c = counters[2:5]
        flags = [0, 1][0]
        return a + b
    """,
    """
    def report(pool, ctrs):
        x = pool.counters[7] + ctrs[0]  # lint: host-ok(layout pinned)
        return x + pool.counters[-1] + pool.TRAFFIC_IDX[True]
    """,
]


def test_r3_literal_counter_index():
    """Counterpart of test_analysis.py::test_r3_literal_counter_index."""
    fs = _lint_src(R3_CASES[0])
    assert _rules(fs) == ["R3", "R3"]


def test_r3_negative_named_and_variable_indices():
    """Counterpart of
    test_analysis.py::test_r3_negative_named_and_variable_indices."""
    fs = _lint_src(R3_CASES[1])
    assert fs == [], [f.render() for f in fs]


def test_r3_suppressed():
    """Counterpart of test_analysis.py::test_r3_suppressed."""
    fs = _lint_src("""
        def report(ctrs):
            return ctrs[0]  # lint: host-ok(layout pinned by golden file)
    """)
    assert _rules(fs, suppressed=True) == ["R3"]
    assert _rules(fs) == []


@pytest.mark.parametrize("case", range(len(R3_CASES) + 2))
def test_r3_parity_with_reference(case):
    """R3 is the reference's rule as it is: on the same source both give
    the same (rule, line, col, func, message, suppression) findings. Cases:
    the fixtures above, and two real files (the pool's state and
    fabric/replay.py)."""
    from repro.analysis import core as jcore
    from repro.analysis.rules import r3_pytree_order as JR3
    from repro_torch.analysis.rules import r3_pytree_order as TR3
    if case < len(R3_CASES):
        src = textwrap.dedent(R3_CASES[case])
    else:
        src = (PORT / ("core/engine/state.py", "fabric/replay.py")[
            case - len(R3_CASES)]).read_text()
    key = ("rule", "line", "col", "func", "message", "suppressed",
           "suppress_reason")

    def run(core_mod, rule):
        m = core_mod.ModuleInfo("x.py", src=src, relpath="x.py")
        return [tuple(getattr(f, k) for k in key) for f in rule.check(m)]
    assert run(core, TR3) == run(jcore, JR3)


# ---------------------------------------------------------------------------
# R4: kernel launch hygiene
# ---------------------------------------------------------------------------

def test_r4_literal_route():
    """Counterpart of test_analysis.py::test_r4_literal_interpret: a route
    named at a call site (any of the four keywords), and a kernel's plain
    version called where nothing chose it."""
    fs = _lint_src("""
        from repro_torch.kernels import kvc_attn as KA
        from repro_torch.models import layers as L

        def run(q, k, v, cfg, lengths):
            o = L.attention(q, k, v, impl="plain")
            s = cfg.replace(attn_impl="kernel", quantize_impl="jnp",
                            compress_impl="auto")
            return KA.kvc_decode_partial_plain(q, k, v, lengths, 4, 1.0)
    """)
    assert _rules(fs) == ["R4"] * 4, [f.render() for f in fs]
    assert "literal `impl=\"plain\"`" in fs[0].message
    assert "no resolver or device test" in fs[3].message


def test_r4_argtypes_arity_mismatch():
    """Counterpart of test_analysis.py::test_r4_blockspec_arity_mismatches:
    argtypes against the positional arguments at each launch, through the
    getter, a bound library, a bound function and a module-local list."""
    fs = _lint_src("""
        import ctypes
        from repro_torch.kernels import build as _build

        def _lib():
            P, I = ctypes.c_void_p, ctypes.c_int
            two = [P, I]
            return _build.load("kvc_attn", {"f": [P, P, I], "g": two})

        def launch(a, b, c):
            err = _lib().f(a, b)                      # 2 of 3
            _build.check_launch(err, "f")
            lib = _lib()
            _build.check_launch(lib.g(a, b, c), "g")  # 3 of 2
            fn, name = _lib().f, "f"
            _build.check_launch(fn(a, b, c, a), name)  # 4 of 3
            _build.check_launch(lib.f(a, b, c), "ok")
    """)
    msgs = [f.message for f in fs]
    assert _rules(fs) == ["R4"] * 3, [f.render() for f in fs]
    assert "called with 2 argument(s) but its argtypes in `_lib()` list 3" \
        in msgs[0]
    assert "with 3 argument(s)" in msgs[1] and "list 2" in msgs[1]
    assert "with 4 argument(s)" in msgs[2]


def test_r4_negative_resolver_branches():
    """Counterpart of test_analysis.py::test_r4_negative_resolved_interpret:
    the existing resolver branches (models/layers.py, core/compressor.py)
    and the routes chosen through them (models/decode.py,
    serve/engine.py), and every kernel module's launches, are clean."""
    for rel in ("models/layers.py", "core/compressor.py", "models/decode.py",
                "serve/engine.py", "kernels/kvc_attn.py", "kernels/qpack.py",
                "kernels/flash_attn.py", "kernels/build.py"):
        fs = _real(rel)
        assert not [f for f in _active(fs) if f.rule == "R4"], \
            [f.render() for f in fs]


def test_r4_silent_fallback_and_dropped_error():
    """R4(b) and (c): a handler around a build or launch that falls back to
    the plain version or swallows the error; a launch whose cudaError
    never reaches check_launch. A handler that re-raises is fine."""
    fs = _lint_src("""
        from repro_torch.kernels import build as _build
        from repro_torch.kernels import qpack

        def _lib():
            return _build.load("qpack_fixed", {"k": []})

        def a(x):
            try:
                return _launch_k(x)
            except RuntimeError:
                return qpack.encode_plain(x, 4, 64)

        def b(x):
            try:
                _build.load("qpack_fixed", {})
            except OSError:
                return None

        def c(x):
            try:
                lib = _lib()
            except OSError as e:
                raise RuntimeError("no kernel") from e
            lib.k()
            err = _lib().k()
            return err
    """)
    msgs = [f.message for f in fs]
    assert _rules(fs) == ["R4"] * 5, [f.render() for f in fs]
    assert "calls `qpack.encode_plain`" in msgs[0]
    assert "no resolver or device test" in msgs[1]      # R4(a) there too
    assert "returns without re-raising" in msgs[2]
    assert all("never reaches" in m for m in msgs[3:])


# ---------------------------------------------------------------------------
# R5: sync contracts
# ---------------------------------------------------------------------------

def test_r5_budget_and_loop_findings():
    """Counterpart of test_analysis.py::test_r5_budget_and_loop_findings."""
    fs = _lint_src("""
        from repro_torch.common import contracts

        class Eng:
            @contracts.sync_contract(syncs_per="step", fetches=1)
            def step(self):
                a = contracts.fetch(self.pools.meta)
                b = contracts.tolist(self.pools.counters)   # over budget
                for lane in self.lanes:
                    c = self.tok.item()                     # not a tensor
                    d = contracts.item(self.pools.hand)     # loop fetch
                e = [self._fetch(x) for x in a]             # loop fetch
                return a, b, c, d, e
    """)
    msgs = [f.message for f in fs]
    assert _rules(fs).count("R5") == 3, [f.render() for f in fs]
    assert sum("exceeds the declared budget" in m for m in msgs) == 1
    assert sum("inside a host loop" in m for m in msgs) == 2


def test_r5_negative_single_fused_fetch():
    """Counterpart of test_analysis.py::test_r5_negative_single_fused_fetch:
    the port's fetch shape (Fabric._fetch_view): one fetch_packed, then
    numpy on its host copies, and a loop over the fetched values."""
    fs = _lint_src("""
        import numpy as np
        from repro_torch.common import contracts
        from repro_torch.common.contracts import sync_contract

        class Fab:
            @sync_contract(syncs_per="segment", fetches=1)
            def fetch_view(self, times, stats):
                got = contracts.fetch_packed(
                    {"t": times, "c": self.pools.counters})
                ctrs = got["c"].numpy().astype(np.int64)
                free = np.asarray(got["t"], np.int64)
                for i in range(len(free)):
                    self.rows.append(int(got["t"][i]))
                return ctrs, free

            @sync_contract(syncs_per="segment", fetches=1)
            def rows(self):
                for row in contracts.tolist(self.pools.meta):  # read once
                    self.rows.append(row)
    """)
    assert [f for f in fs if f.rule == "R5"] == [], [f.render() for f in fs]


def test_r5_device_sourced_np_asarray_counts():
    """Counterpart of
    test_analysis.py::test_r5_device_sourced_np_asarray_counts."""
    fs = _lint_src("""
        import numpy as np
        from repro_torch.common import contracts

        class Fab:
            @contracts.sync_contract(syncs_per="epoch", fetches=1)
            def commit(self):
                moved = contracts.fetch(self.moved)
                extra = np.asarray(self.pools.counters)   # 2nd fetch
                return moved, extra
    """)
    assert _rules(fs) == ["R5"], [f.render() for f in fs]
    assert "exceeds the declared budget" in fs[0].message


def test_r5_suppressed_site_excluded_from_budget():
    """Counterpart of
    test_analysis.py::test_r5_suppressed_site_excluded_from_budget."""
    fs = _lint_src("""
        from repro_torch.common import contracts

        class Eng:
            @contracts.sync_contract(syncs_per="step", fetches=1)
            def step(self):
                a = contracts.fetch(self.state)
                b = contracts.fetch(self.dbg)  # lint: host-ok(debug-only path)
                return a, b
    """)
    assert _rules(fs) == [], [f.render() for f in fs]
    assert _rules(fs, suppressed=True) == ["R5"]


def test_r5_pinned_contract_fetches():
    """A pinned region whose ``fetches=0`` is raised is a finding, as a
    missing one is."""
    src = _mutate("optim/adamw.py",
                  '@contracts.sync_contract(syncs_per="step", fetches=0)',
                  '@contracts.sync_contract(syncs_per="step", fetches=1)')
    fs = _active(_real("optim/adamw.py", src))
    assert [f.rule for f in fs] == ["R5"], [f.render() for f in fs]
    assert "pinned contract is (\"step\", 0)" in fs[0].message


# ---------------------------------------------------------------------------
# R6: obs telemetry piggyback
# ---------------------------------------------------------------------------

def test_r6_emission_inside_region():
    """Counterpart of test_analysis.py::test_r6_emission_inside_jit_region."""
    fs = _lint_src("""
        from repro_torch.common import contracts

        @contracts.sync_contract(syncs_per="step", fetches=0)
        def step(pool, obs):
            obs.record_segment(0, None, None, None)
            return pool
    """)
    assert _rules(fs).count("R6") == 1, [f.render() for f in fs]
    assert "inside sync-free region" in fs[0].message


def test_r6_emission_in_region_callee():
    """Counterpart of
    test_analysis.py::test_r6_emission_in_traced_combinator_body:
    an emission in a local callee the region reaches."""
    fs = _lint_src("""
        from repro_torch.common import contracts

        def body(carry, x, rec):
            rec.record_step(carry, x, x, x, [])
            return carry

        @contracts.sync_contract(syncs_per="step", fetches=0)
        def step(xs, rec):
            return body(0, xs, rec)
    """)
    r6 = [f for f in fs if f.rule == "R6"]
    assert len(r6) == 1 and r6[0].func == "body", [f.render() for f in fs]


def test_r6_device_value_handed_to_drain_in_contract():
    """Counterpart of
    test_analysis.py::test_r6_device_value_handed_to_drain_in_contract."""
    fs = _lint_src("""
        import numpy as np
        from repro_torch.common import contracts

        class Fab:
            @contracts.sync_contract(syncs_per="segment", fetches=1)
            def fetch_view(self, times):
                got = contracts.fetch_packed({"c": self.pools.counters})
                # the drain below is handed LIVE device state
                self.obs.record_segment(0, self.pools.meta,
                                        got["c"].numpy(), None)
                return got
    """)
    r6 = [f for f in fs if f.rule == "R6"]
    assert len(r6) == 1, [f.render() for f in fs]
    assert "hidden second sync" in r6[0].message


def test_r6_negative_host_drain_is_sanctioned():
    """Counterpart of
    test_analysis.py::test_r6_negative_host_drain_is_sanctioned:
    the port's drain shape (Engine.step), everything handed over bound from the
    one contracted fetch or host bookkeeping."""
    fs = _lint_src("""
        import torch
        from repro_torch.common import contracts

        class Eng:
            @contracts.sync_contract(syncs_per="step", fetches=1)
            def step(self, done: torch.Tensor, active):
                quad = torch.stack([self.pools.meta[0], done])
                tok_h, done_h = self._fetch(quad, "step_syncs").tolist()
                if self.obs is not None:
                    self.obs.record_step(self.counters["steps"], tok_h,
                                         done_h,
                                         [lane for lane, _ in active])
                return tok_h
    """)
    assert _rules(fs) == [], [f.render() for f in fs]


def test_r6_device_producer_call_as_drain_arg():
    """Counterpart of
    test_analysis.py::test_r6_device_producer_call_as_drain_arg."""
    fs = _lint_src("""
        import torch
        from repro_torch.common import contracts

        class Fab:
            @contracts.sync_contract(syncs_per="epoch", fetches=1)
            def commit(self):
                moved = contracts.fetch(self.moved)
                self.obs.record_epoch(0, torch.sum(self.pools.meta),
                                      kind="sync", overlapped=False,
                                      planned=0, moved=0, urgent=False,
                                      free_units=moved)
                return moved
    """)
    r6 = [f for f in fs if f.rule == "R6"]
    assert len(r6) >= 1, [f.render() for f in fs]


# ---------------------------------------------------------------------------
# Baseline ratchet
# ---------------------------------------------------------------------------

def test_baseline_round_trip(tmp_path):
    """Counterpart of test_analysis.py::test_baseline_round_trip."""
    code = """
        import torch

        def f(x: torch.Tensor):
            return int(x)
    """
    findings = _lint_src(code)
    assert _rules(findings) == ["R1"]
    bpath = tmp_path / "baseline.json"
    baseline_mod.save(bpath, findings, note="test")
    loaded = baseline_mod.load(bpath)
    new, old, stale = baseline_mod.diff(findings, loaded)
    assert new == [] and len(old) == 1 and stale == []
    shifted = _lint_src("\n\n# moved\n" + textwrap.dedent(code))
    new, old, stale = baseline_mod.diff(shifted, loaded)
    assert new == [] and len(old) == 1 and stale == []
    doubled = _lint_src(code + """
        def f(x: torch.Tensor):
            return int(x)
    """)
    new, old, stale = baseline_mod.diff(doubled, loaded)
    assert len(new) == 1 and len(old) == 1
    new, old, stale = baseline_mod.diff([], loaded)
    assert new == [] and old == [] and len(stale) == 1


def test_committed_baseline_matches_fresh_run():
    """Counterpart of
    test_analysis.py::test_committed_baseline_matches_fresh_run:
    the committed baseline is exactly the debt a fresh run over src/repro_torch
    reports (no new findings, no stale entries)."""
    report = run_lint([str(PORT)], baseline_path=BASELINE)
    assert report["counts"]["parse_errors"] == 0
    assert report["files"] > 90
    assert report["new"] == [], json.dumps(report["new"], indent=2)
    assert report["stale_baseline"] == [], report["stale_baseline"]


# ---------------------------------------------------------------------------
# Parity with the reference lint
# ---------------------------------------------------------------------------

def test_fingerprints_match_reference():
    """A Finding with the same fields fingerprints the same in both
    packages (sha1("rule|path|func|message")[:16])."""
    from repro.analysis.core import Finding as JFinding
    fields = [("R1", "repro_torch/x.py", 3, 4, "f", "msg"),
              ("R3", "src/repro/y.py", 9, 0, "<module>", "`counters[3]` ..."),
              ("R5", "a/b.py", 1, 1, "Eng.step", "ünïcode — dash")]
    for f in fields:
        a, b = core.Finding(*f), JFinding(*f)
        assert a.fingerprint() == b.fingerprint()
        assert a.to_dict() == b.to_dict() and a.render() == b.render()


def test_baseline_files_interchange(tmp_path):
    """Each package's ``baseline.load`` reads a file the other's ``save``
    wrote, and ``diff`` gives the same (new, grandfathered, stale)."""
    from repro.analysis import baseline as jbaseline
    from repro.analysis.core import Finding as JFinding
    rows = [("R1", "p.py", 3, 0, "f", "m1"), ("R1", "p.py", 5, 0, "f", "m1"),
            ("R3", "q.py", 7, 2, "g", "m3")]
    tf = [core.Finding(*r) for r in rows]
    jf = [JFinding(*r) for r in rows]
    tpath, jpath = tmp_path / "t.json", tmp_path / "j.json"
    baseline_mod.save(tpath, tf[:2], note="n")
    jbaseline.save(jpath, jf[:2], note="n")
    assert tpath.read_text() == jpath.read_text()
    for path in (tpath, jpath):
        got_t = baseline_mod.diff(tf[1:], jbaseline.load(path))
        got_j = jbaseline.diff(jf[1:], baseline_mod.load(path))

        def norm(res):
            new, old, stale = res
            return ([f.fingerprint() for f in new],
                    [f.fingerprint() for f in old], stale)
        assert norm(got_t) == norm(got_j)
        # multiset semantics: one of the two identical entries is used, so
        # both entries of that fingerprint are reported stale
        assert len(got_t[0]) == 1 and len(got_t[1]) == 1 and \
            len(got_t[2]) == 2


def test_suppressions_parse_the_same():
    """The ``# lint: host-ok(reason)`` comments parse the same in both
    packages: the same lines, reasons and covered nodes."""
    from repro.analysis import core as jcore
    src = textwrap.dedent("""
        def f(counters):
            a = counters[1]  # lint: host-ok(one)
            # lint: host-ok( two, spaced )
            b = counters[2]
            c = (counters[3] +
                 counters[4])  # lint:host-ok(end line)
            d = 1  # lint: host-ok()
            e = counters[5]  # lint: host-ok(no close
            return a, b, c, d  # lint : host-ok(bad)
    """)
    t = core.ModuleInfo("s.py", src=src, relpath="s.py")
    j = jcore.ModuleInfo("s.py", src=src, relpath="s.py")
    assert t.suppressions == j.suppressions
    assert t.suppressions[3] == "one" and t.suppressions[4] == "two, spaced"
    import ast
    for node in ast.walk(t.tree):
        jn = next(n for n in ast.walk(j.tree)
                  if type(n) is type(node) and
                  getattr(n, "lineno", None) == getattr(node, "lineno", None)
                  and getattr(n, "col_offset", None) ==
                  getattr(node, "col_offset", None))
        assert t.suppression_at(node) == j.suppression_at(jn)


def _trees(tmp_path):
    trees = {"clean": "import torch\n\ndef f(x):\n    return x + 1\n",
             "new": "def f(counters):\n    return counters[3]\n",
             "parse": "def f(:\n    pass\n"}
    out = {}
    for name, body in trees.items():
        d = tmp_path / name / "pkg"
        d.mkdir(parents=True)
        (d / "m.py").write_text(body)
        out[name] = d
    return out


def test_cli_exit_codes_match_reference(tmp_path, capsys):
    """Both CLIs give the same exit codes on the same three trees: clean
    (0), a new finding (1), a parse error (2); and the same relpaths,
    anchored at the scan root's parent."""
    from repro.analysis import lint as jlint
    for name, root in _trees(tmp_path).items():
        codes, outs = [], []
        for mod in (lint_mod, jlint):
            codes.append(mod.main([str(root), "--format", "json"]))
            outs.append(json.loads(capsys.readouterr().out))
        assert codes[0] == codes[1] == {"clean": 0, "new": 1,
                                        "parse": 2}[name]
        assert [f["path"] for f in outs[0]["new"] + outs[0]["parse_errors"]] \
            == [f["path"] for f in outs[1]["new"] + outs[1]["parse_errors"]]
        if name == "new":
            assert outs[0]["new"][0]["path"] == "pkg/m.py"
            assert outs[0]["new"][0]["fingerprint"] == \
                outs[1]["new"][0]["fingerprint"]


def test_write_baseline_then_pass(tmp_path, capsys):
    """``--write-baseline`` grandfathers the tree's findings; the lint then
    passes against that baseline, in text format."""
    root = _trees(tmp_path)["new"]
    out = tmp_path / "b.json"
    assert lint_mod.main([str(root), "--write-baseline", str(out)]) == 0
    assert json.loads(out.read_text())["version"] == baseline_mod.VERSION
    assert lint_mod.main([str(root), "--baseline", str(out)]) == 0
    assert capsys.readouterr().out.strip().endswith("OK")


def test_lint_imports_neither_torch_nor_jax():
    """``python -m repro_torch.analysis.lint`` over the port, with torch and
    jax made unimportable, passes against the committed baseline."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "sys.modules['jax'] = None\n"
            "import runpy\n"
            "sys.argv = ['lint', 'src/repro_torch', '--baseline',\n"
            "            'src/repro_torch/analysis/baseline.json']\n"
            "runpy.run_module('repro_torch.analysis.lint',\n"
            "                 run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().endswith("OK"), r.stdout


# ---------------------------------------------------------------------------
# Acceptance demos on real port source
# ---------------------------------------------------------------------------

def _new(findings):
    new, _, _ = baseline_mod.diff(_active(findings),
                                  baseline_mod.load(BASELINE))
    return new


@pytest.mark.parametrize("rel, anchor, line, want", [
    # int(...) of a tensor injected into the decode step (a region: R1(b))
    ("models/decode.py", "    T.check_supported(cfg)\n    dtype = "
     "L.torch_dtype(cfg)\n", "    _n = int(tokens.sum())\n",
     "sync-free region `decode_step`"),
    # a raw .item() in the pool's window step (not a region: R1(a))
    ("core/engine/batch.py", "    s0 = contracts.SYNCS.count\n\n    # phase 0",
     "    _dbg = pool.meta.sum().item()\n", ".item()"),
])
def test_injected_sync_fails_lint(rel, anchor, line, want):
    """Counterpart of test_analysis.py::test_injected_int_traced_fails_lint:
    a synthetic device read injected into real port source is a new R1
    finding against the committed baseline."""
    before = _active(_real(rel))
    assert not [f for f in before if f.rule == "R1"]
    head, tail = anchor.split("\n", 1)
    src = _mutate(rel, anchor, head + "\n" + line + tail)
    new = [f for f in _new(_real(rel, src)) if f.rule == "R1"]
    assert new and want in new[0].message, [f.render() for f in new]


PINNED = [(path, qn) for path, reqs in R5.REQUIRED_CONTRACTS.items()
          for qn in reqs]


@pytest.mark.parametrize("path, qualname", PINNED)
def test_stripping_any_sync_contract_fails_lint(path, qualname):
    """Counterpart of
    test_analysis.py::test_stripping_any_sync_contract_fails_lint,
    over every pinned contract: deleting its annotation is a new R5 "missing"
    finding."""
    rel = path.split("repro_torch/", 1)[1]
    lines = (PORT / rel).read_text().splitlines()
    method = qualname.split(".")[-1]
    hits = [i for i, l in enumerate(lines)
            if "sync_contract(" in l and l.strip().startswith("@")
            and f"def {method}(" in "\n".join(lines[i + 1:i + 3])]
    node = core.ModuleInfo(PORT / rel, relpath=path).get_function(qualname)
    hits = [i for i in hits if i + 1 <= node.lineno <= i + 3]
    assert len(hits) == 1, f"expected one annotation for {qualname}"
    del lines[hits[0]]
    assert not [f for f in _active(_real(rel)) if f.rule == "R5"]
    after = _new(_real(rel, "\n".join(lines) + "\n"))
    missing = [f for f in after if f.rule == "R5" and "missing" in f.message
               and qualname in f.message]
    assert missing, [f.render() for f in after]


def test_kvc_attn_fallback_fails_lint():
    """A try/except around B5's ``_launch`` that falls back to
    ``kvc_decode_partial_plain`` is a new R4(b) finding."""
    src = _mutate(
        "kernels/kvc_attn.py",
        "    return _launch(q, k_codes, k_scales, v_codes, v_scales, lengths, "
        "bits,\n                   sm_scale, empty_uniform=False)\n",
        "    try:\n"
        "        return _launch(q, k_codes, k_scales, v_codes, v_scales,\n"
        "            lengths, bits, sm_scale, empty_uniform=False)\n"
        "    except RuntimeError:\n"
        "        return kvc_decode_partial_plain(q, k_codes, k_scales, "
        "v_codes,\n"
        "                                        v_scales, lengths, bits, "
        "sm_scale)\n")
    new = [f for f in _new(_real("kernels/kvc_attn.py", src))
           if f.rule == "R4"]
    assert len(new) == 1 and "silent fallback" in new[0].message, \
        [f.render() for f in new]


def test_kvc_attn_dropped_argument_fails_lint():
    """One argument dropped from the ``kvc_attn_partial`` launch (21
    argtypes) is a new R4(d) finding."""
    src = _mutate("kernels/kvc_attn.py",
                  "float(sm_scale), int(empty_uniform),", "float(sm_scale),")
    new = [f for f in _new(_real("kernels/kvc_attn.py", src))
           if f.rule == "R4"]
    assert len(new) == 1, [f.render() for f in new]
    assert "`kvc_attn_partial` is called with 20 argument(s) but its " \
        "argtypes in `_lib()` list 21" in new[0].message


def test_literal_attn_impl_fails_lint():
    """``attn_impl="plain"`` at a call in models/transformer.py is a new
    R4(a) finding."""
    src = _mutate("models/transformer.py",
                  "logits, aux = forward(params, batch, cfg, attn_impl, mesh)",
                  "logits, aux = forward(params, batch, cfg, "
                  "attn_impl=\"plain\", mesh=mesh)")
    new = [f for f in _new(_real("models/transformer.py", src))
           if f.rule == "R4"]
    assert len(new) == 1 and "literal `attn_impl=\"plain\"`" in \
        new[0].message, [f.render() for f in new]


# ---------------------------------------------------------------------------
# Runtime half: @sync_contract attribute + verify_sync_counters
# ---------------------------------------------------------------------------

def test_contract_attribute_no_wrapper():
    """Counterpart of test_analysis.py::test_contract_attribute_no_wrapper,
    with the ported ``get_sync_contract``/``expected_syncs`` and a
    ``fetches=0`` contract."""
    from repro_torch.common.contracts import (SyncContract,
                                              get_sync_contract,
                                              sync_contract)
    calls = []

    @sync_contract(syncs_per="step", fetches=1)
    def f(x):
        calls.append(x)
        return x + 1

    assert f(1) == 2 and calls == [1]
    assert f.__name__ == "f"
    assert get_sync_contract(f) == SyncContract("step", 1)
    assert get_sync_contract(f).expected_syncs(7) == 7

    @sync_contract("step", 0)
    def g():
        pass
    assert get_sync_contract(g) == SyncContract("step", 0)
    assert get_sync_contract(g).expected_syncs(7) == 0
    assert get_sync_contract(lambda: 0) is None
    with pytest.raises(ValueError, match="non-negative"):
        sync_contract("step", -1)


def test_verify_sync_counters():
    """Counterpart of test_analysis.py::test_verify_sync_counters, with the
    ``what`` argument and a ``fetches=0`` region."""
    from repro_torch.common.contracts import (sync_contract,
                                              verify_sync_counters)

    @sync_contract(syncs_per="segment", fetches=1)
    def f():
        pass

    verify_sync_counters(f, n_events=5, n_syncs=5)
    with pytest.raises(AssertionError, match="measured 6 syncs"):
        verify_sync_counters(f, n_events=5, n_syncs=6, what="(bench)")

    @sync_contract(syncs_per="step", fetches=0)
    def region():
        pass
    verify_sync_counters(region, n_events=3, n_syncs=0)
    with pytest.raises(AssertionError, match="measured 1 syncs over 3 steps"):
        verify_sync_counters(region, n_events=3, n_syncs=1)

    def bare():
        pass

    with pytest.raises(AssertionError, match="declares no @sync_contract"):
        verify_sync_counters(bare, n_events=1, n_syncs=1, what="x")


def test_hot_paths_declare_contracts():
    """Counterpart of test_analysis.py::test_hot_paths_declare_contracts:
    the pinned contracts are attached at run time too, the regions with
    ``fetches=0``."""
    from repro_torch.common.contracts import SyncContract, get_sync_contract
    from repro_torch.common.types import TrainConfig
    from repro_torch.configs import get_reduced
    from repro_torch.fabric.replay import Fabric
    from repro_torch.models import decode as D
    from repro_torch.optim import adamw
    from repro_torch.serve.engine import Engine
    from repro_torch.train import trainer

    assert get_sync_contract(Engine.step) == SyncContract("step", 1)
    for name, per in (("_fetch_view", "segment"), ("_commit_epoch", "epoch"),
                      ("_commit_boundary", "boundary"),
                      ("_drain_deferred", "drain"),
                      ("delivered_time", "call")):
        assert get_sync_contract(getattr(Fabric, name)) == \
            SyncContract(per, 1)
    zero = SyncContract("step", 0)
    for fn in (D.decode_step, D.gqa_decode_layer, D.mla_decode_layer,
               adamw.update):
        assert get_sync_contract(fn) == zero
    step, _ = trainer.make_train_step(get_reduced("llama3_8b"),
                                      TrainConfig())
    assert get_sync_contract(step) == zero


def test_regions_make_no_counted_sync_on_cpu():
    """One call of each marked region at REDUCED size (llama3-8b: 2 layers,
    d 256) on the CPU leaves ``contracts.SYNCS`` unchanged: the decode
    step (one step after a prefill) and the train step (one step, its
    AdamW update inside)."""
    import dataclasses
    import torch
    from repro_torch.common import contracts
    from repro_torch.common.types import ServeConfig, TrainConfig
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import decode as D
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import trainer

    cfg = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
    scfg = ServeConfig(hot_window=8)
    params = T.init_params(cfg, 0, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    lg, cache = D.prefill(params, {"tokens": tokens}, cfg, scfg, 32)
    pos = torch.full((2,), 12, dtype=torch.int32)
    s0 = contracts.SYNCS.count
    lg2, _ = D.decode_step(params, cache, lg.argmax(-1).to(torch.int32),
                           pos, cfg, scfg)
    contracts.verify_sync_counters(D.decode_step, 1,
                                   contracts.SYNCS.count - s0, "(decode)")
    assert lg2.shape == (2, cfg.vocab_size) and bool(lg2.isfinite().all())

    tcfg = TrainConfig(seq_len=16, global_batch=2)
    tparams = trainer.init_params(cfg, 0, "cpu")
    opt = adamw.init(tparams, tcfg.optimizer)
    step, _ = trainer.make_train_step(cfg, tcfg)
    batch = make_batch(cfg, 0, global_batch=2, seq_len=16, device="cpu")
    s0 = contracts.SYNCS.count
    tparams, opt, m = step(tparams, opt, batch)
    contracts.verify_sync_counters(step, 1, contracts.SYNCS.count - s0,
                                   "(train)")
    assert bool(torch.isfinite(m["loss"]))
