"""The port's telemetry (``repro_torch.obs``) against the JAX package's
(``repro.obs``), on the CPU, with ``tests/test_obs.py``'s two recipes.

The piggyback contract, as the reference's tests pin it:

  * recording on vs off is identical in pool, counter and token state;
  * the sync budgets hold with the Recorder attached
    (``segment_syncs == segments``, ``epoch_syncs == epochs``,
    ``step_syncs == steps``);
  * the Perfetto export validates and its per-expander track totals
    reconcile with ``Fabric.pipeline_times()``;
  * histogram merge is associative; the registry is get-or-create with
    monotonic counters; ``manifest()`` stamps the run's facts (torch, not
    jax, on the port).

Parity (``==``): on the fabric recipe (2 expanders, 0.8 skew, rebalance,
window 8, segments of 8 windows, 512 mcf accesses, seed 7) and the serve
recipe (REDUCED llama3-8b in float32, params carried from the reference's
``init_params(PRNGKey(0))`` through ``interop``; 4 prompts of 20 tokens, 6
new tokens each, 2 lanes, max_len 128), the port's Recorder lists, metrics
snapshot, trace events and every ``otherData`` key but the manifest equal
the reference's; ``run_workload(obs=)`` records two cells as the reference's
Recorder records the reference file's metrics for them. Also: every drain
refuses a ``torch.Tensor``, and both launchers' ``--trace`` on the CPU.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.common.types import ServeConfig as JServeConfig  # noqa: E402
from repro.configs import get_reduced as jget_reduced  # noqa: E402
from repro.core.engine.policy import POLICIES as JPOLICIES  # noqa: E402
from repro.fabric import Fabric as JFabric  # noqa: E402
from repro.fabric import WeightedInterleave as JWeighted  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.obs import Recorder as JRecorder  # noqa: E402
from repro.obs import export as JOBX  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.simx.engine import pool_cfg_for as jpool_cfg_for  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.common import contracts  # noqa: E402
from repro_torch.common.types import PoolConfig, ServeConfig  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.engine import state as S  # noqa: E402
from repro_torch.core.engine.policy import POLICIES  # noqa: E402
from repro_torch.fabric import Fabric, MigrationPlan  # noqa: E402
from repro_torch.fabric import WeightedInterleave  # noqa: E402
from repro_torch.obs import Recorder, manifest  # noqa: E402
from repro_torch.obs import export as OBX  # noqa: E402
from repro_torch.obs.registry import (Histogram, MetricsRegistry,  # noqa: E402
                                      merge_histograms)
from repro_torch.serve import Engine, SerialEngine  # noqa: E402
from repro_torch.simx import engine as SE  # noqa: E402
from repro_torch.simx.trace import (WORKLOADS, make_rates_table,  # noqa: E402
                                    make_trace)

ROOT = Path(__file__).resolve().parents[1]
WINDOW = 8
JCFG = jpool_cfg_for(JPOLICIES["ibex"], n_pages=64, n_pchunks=16,
                     n_cchunks=2 * 64 * 8)
CFG = PoolConfig(**dataclasses.asdict(JCFG))

JMODEL = dataclasses.replace(jget_reduced("llama3_8b"), dtype="float32")
MODEL = dataclasses.replace(get_reduced("llama3_8b"), dtype="float32")
JSCFG = JServeConfig(max_running=2, hot_window=16, attn_chunk=32,
                     kv_rate_bits=8)
SCFG = ServeConfig.from_reference(JSCFG)
MAX_LEN = 128


def _same(a, b, where="") -> None:
    """Recursive ``==`` over dicts, lists and tuples; numpy arrays equal in
    dtype, shape and every value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (where, a, b)
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _same_trace(got: dict, want: dict) -> None:
    _same(got["traceEvents"], want["traceEvents"], "traceEvents")
    assert got["displayTimeUnit"] == want["displayTimeUnit"]
    _same({k: v for k, v in got["otherData"].items() if k != "manifest"},
          {k: v for k, v in want["otherData"].items() if k != "manifest"},
          "otherData")


# -- shared fixtures ---------------------------------------------------------

def _fabric_inputs():
    spec = WORKLOADS["mcf"]
    rates = make_rates_table(spec, CFG.n_pages, seed=7)
    return rates, make_trace(spec, n_accesses=512, n_pages=CFG.n_pages,
                             seed=7)


def _fabric(rates, obs=None) -> Fabric:
    """The migration-live operating point of ``tests/test_obs.py``."""
    return Fabric(CFG, POLICIES["ibex"],
                  WeightedInterleave(2, CFG.n_pages, [0.8, 0.2]), seed=0,
                  rates_table=rates, window=WINDOW, migration="rebalance",
                  spill_interval=8 * WINDOW, obs=obs, device="cpu")


@pytest.fixture(scope="module")
def fabrics():
    """(recorder, fabric with it, fabric without, reference recorder,
    reference fabric)."""
    rates, trace = _fabric_inputs()
    rec = Recorder()
    on = _fabric(rates, obs=rec).replay(*trace)
    off = _fabric(rates).replay(*trace)
    jrec = JRecorder()
    jf = JFabric(JCFG, JPOLICIES["ibex"], JWeighted(2, CFG.n_pages,
                                                     [0.8, 0.2]),
                 seed=0, rates_table=jnp.asarray(rates), window=WINDOW,
                 migration="rebalance", spill_interval=8 * WINDOW, obs=jrec)
    jf.replay(*trace)
    return rec, on, off, jrec, jf


def _prompt(seed, n=20):
    return [int(t) for t in np.random.default_rng(seed).integers(
        1, MODEL.vocab_size, size=n)]


def _serve(eng):
    rids = [eng.submit(_prompt(i), max_new_tokens=6) for i in range(4)]
    eng.run_until_done(max_steps=400)
    return [eng.result(r) for r in rids]


@pytest.fixture(scope="module")
def serves():
    """(recorder, engine with it, its tokens, engine without, its tokens,
    reference recorder, reference engine)."""
    jparams = JT.init_params(jax.random.PRNGKey(0), JMODEL)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), MODEL, device="cpu")
    jrec = JRecorder()
    jeng = JEngine(JMODEL, JSCFG, jparams, max_len=MAX_LEN, obs=jrec)
    _serve(jeng)
    rec = Recorder()
    on = Engine(MODEL, SCFG, params, max_len=MAX_LEN, device="cpu", obs=rec)
    contracts.SYNCS.reset()
    out_on = _serve(on)
    on.syncs = contracts.SYNCS.count
    off = Engine(MODEL, SCFG, params, max_len=MAX_LEN, device="cpu")
    return rec, on, out_on, off, _serve(off), jrec, jeng


# -- fabric: bit-identity + sync budgets -------------------------------------

def test_fabric_recording_is_bit_identical(fabrics):
    """Attaching a Recorder changes nothing on the device: every pool leaf,
    the override table and every counter equal the recording-off run's."""
    _, on, off, _, _ = fabrics
    assert on.state_identical(off), "recording perturbed pool/counter state"
    assert on.counters() == off.counters()
    assert on.sync_stats() == off.sync_stats()


def test_fabric_sync_budgets_hold_with_recorder(fabrics):
    """Zero extra syncs: one fetch a segment and one an epoch with the
    Recorder draining every fetch, and the Recorder saw every event; the
    name-keyed ``fabric.*`` counters sum the recorded replay deltas."""
    rec, fab, _, _, _ = fabrics
    ss = fab.sync_stats()
    assert ss["segment_syncs"] == ss["segments"]
    assert ss["epoch_syncs"] == ss["epochs"]
    contracts.verify_sync_counters(Fabric._fetch_view, ss["segments"],
                                   ss["segment_syncs"])
    contracts.verify_sync_counters(Fabric._commit_epoch, ss["epochs"],
                                   ss["epoch_syncs"])
    assert len(rec.segments) == ss["segments"]
    assert len(rec.epochs) == ss["epochs"]
    assert ss["epochs"] > 0 and rec.plans, "rebalance recorded no epochs"
    snap = rec.metrics.snapshot()["counters"]
    total = int(sum(d["delta"].sum() for d in rec.segments))
    assert total == sum(snap.get(f"fabric.{n}", 0) for n in S.COUNTER_NAMES)


def test_fabric_trace_validates_and_reconciles(fabrics, tmp_path):
    """The exported timeline is well formed and is the same accounting as
    ``pipeline_times()``: the track totals rebuilt from the samples equal
    the scheduler's overlapped and sync seconds at rtol 1e-9."""
    rec, fab, _, _, _ = fabrics
    pt = fab.pipeline_times()
    totals = OBX.fabric_track_totals(rec)
    assert np.allclose(totals["overlapped_s"], pt["overlapped_s"],
                       rtol=1e-9), (totals, pt)
    assert np.allclose(totals["sync_s"], pt["sync_s"], rtol=1e-9)
    assert OBX.fabric_device_totals(rec) is None
    trace = OBX.build_trace(rec)
    assert OBX.validate_trace(trace) == []
    tids = {(ev["pid"], ev["tid"]) for ev in trace["traceEvents"]
            if ev["ph"] == "X"}
    assert {(1, 0), (1, 2)} <= tids, tids            # replay tracks e0/e1
    assert any(t in tids for t in [(1, 1), (1, 3)]), \
        "no migration track emitted on a migration-live run"
    path = tmp_path / "fabric.trace.json"
    OBX.write_trace(rec, path)
    on_disk = json.loads(path.read_text())
    assert on_disk["traceEvents"] and on_disk["otherData"]["manifest"]
    mpath = tmp_path / "fabric.metrics.json"
    OBX.write_metrics(rec, mpath, seed=7)
    snap = json.loads(mpath.read_text())
    assert snap["manifest"]["seed"] == 7
    assert snap["fabric"]["epochs"] == len(rec.epochs)
    assert "fabric.pages_moved" in snap["metrics"]["counters"]
    assert OBX.fabric_summary_table(rec).count("\n") >= len(rec.segments)


def test_fabric_recorder_matches_reference(fabrics):
    """The port's Recorder equals the JAX package's on the same fabric:
    every segment (delta, float32 times as float64, headroom), plan and
    epoch, the metrics snapshot, the trace events and ``otherData``."""
    rec, _, _, jrec, _ = fabrics
    for name in ("segments", "plans", "epochs"):
        _same(getattr(rec, name), getattr(jrec, name), name)
    info = {k: v for k, v in rec.fabric_info.items() if k != "devices"}
    jinfo = {k: v for k, v in jrec.fabric_info.items() if k != "devices"}
    assert info == jinfo
    assert [dataclasses.asdict(d) for d in rec.fabric_info["devices"]] == \
        [dataclasses.asdict(d) for d in jrec.fabric_info["devices"]]
    assert rec.metrics.snapshot() == jrec.metrics.snapshot()
    _same_trace(OBX.build_trace(rec), JOBX.build_trace(jrec))
    got, want = OBX.metrics_snapshot(rec), JOBX.metrics_snapshot(jrec)
    got.pop("manifest"), want.pop("manifest")
    assert got == want
    assert OBX.fabric_summary_table(rec) == JOBX.fabric_summary_table(jrec)


def test_fabric_recorder_with_migration_off():
    """A recorder on a fabric with migration off still records each
    segment's freelist headroom: the segment computes the migration stats
    inside its one fetch (as the reference's does with a recorder), and
    nothing else changes."""
    rates, trace = _fabric_inputs()

    def run(obs=None):
        return Fabric(CFG, POLICIES["ibex"],
                      WeightedInterleave(2, CFG.n_pages, [0.8, 0.2]),
                      seed=0, rates_table=rates, window=WINDOW,
                      migration="off", obs=obs, device="cpu").replay(*trace)

    rec = Recorder()
    on, off = run(rec), run()
    assert on.state_identical(off) and on.sync_stats() == off.sync_stats()
    ss = on.sync_stats()
    assert ss["segment_syncs"] == ss["segments"] == len(rec.segments) >= 1
    assert ss["epochs"] == 0 and not rec.epochs and not rec.plans
    top = (on.pools.cfree.top + 8 * on.pools.gfree.top).tolist()
    assert rec.segments[-1]["free_units"].tolist() == top
    assert off.park_capacity().tolist() == top
    assert OBX.validate_trace(OBX.build_trace(rec)) == []


def test_trace_validator_rejects_malformed(monkeypatch, tmp_path):
    """Out-of-order timestamps on one track, a span overrunning its parent
    and an unknown phase are all findings, and ``write_trace`` refuses to
    write an invalid trace."""
    base = {"otherData": {}, "displayTimeUnit": "ms"}
    bad_order = dict(base, traceEvents=[
        {"ph": "X", "pid": 1, "tid": 0, "ts": 10.0, "dur": 1.0, "name": "a"},
        {"ph": "X", "pid": 1, "tid": 0, "ts": 5.0, "dur": 1.0, "name": "b"},
    ])
    assert OBX.validate_trace(bad_order)
    bad_nest = dict(base, traceEvents=[
        {"ph": "X", "pid": 1, "tid": 0, "ts": 0.0, "dur": 5.0, "name": "p"},
        {"ph": "X", "pid": 1, "tid": 0, "ts": 2.0, "dur": 10.0, "name": "c"},
    ])
    assert OBX.validate_trace(bad_nest)
    bad_phase = dict(base, traceEvents=[
        {"ph": "B", "pid": 1, "tid": 0, "ts": 0.0, "name": "p"},
    ])
    assert OBX.validate_trace(bad_phase)
    assert OBX.validate_trace([]) == ["traceEvents missing or not a list"]
    monkeypatch.setattr(OBX, "build_trace", lambda rec: bad_nest)
    path = tmp_path / "bad.trace.json"
    with pytest.raises(ValueError, match="invalid trace"):
        OBX.write_trace(Recorder(), path)
    assert not path.exists()


# -- serve: bit-identity + sync budget ----------------------------------------

def test_serve_recording_identical_and_one_sync_per_step(serves):
    """The batched engine with a Recorder attached generates the same
    tokens with the same counters as without, still one sync a decode step
    and no uncounted one; the Recorder saw every step, admission, preemption
    and resume, and its byte counters equal the engine's."""
    rec, on, out_on, off, out_off, _, _ = serves
    assert on.counters == off.counters
    assert out_on == out_off
    c = on.counters
    assert c["step_syncs"] == c["steps"]
    contracts.verify_sync_counters(Engine.step, c["steps"], c["step_syncs"])
    assert on.syncs == c["step_syncs"] + c["admit_syncs"]
    assert len(rec.steps) == c["steps"]
    kinds = {ev["type"] for ev in rec.serve_events}
    assert {"admission", "preempt", "resume"} <= kinds
    snap = rec.metrics.snapshot()["counters"]
    assert snap["serve.preempt_bytes"] == c["preempt_bytes"]
    assert snap["serve.resume_bytes"] == c["resume_bytes"]
    assert snap["serve.prefill_batches"] == c["prefill_batches"]
    assert snap["serve.tokens"] == c["tokens"]
    assert OBX.validate_trace(OBX.build_trace(rec)) == []


def test_serve_recorder_matches_reference(serves):
    """The port's Recorder equals the JAX package's on the reference
    engine's run: the steps and serve events, the metrics snapshot, the
    trace events and ``otherData`` (every key but the manifest)."""
    rec, on, _, _, _, jrec, jeng = serves
    assert on.counters == dict(jeng.counters)
    assert rec.serve_info == jrec.serve_info
    _same(rec.steps, jrec.steps, "steps")
    _same(rec.serve_events, jrec.serve_events, "serve_events")
    assert rec.metrics.snapshot() == jrec.metrics.snapshot()
    _same_trace(OBX.build_trace(rec), JOBX.build_trace(jrec))
    got, want = OBX.metrics_snapshot(rec), JOBX.metrics_snapshot(jrec)
    got.pop("manifest"), want.pop("manifest")
    assert got == want


def test_serial_engine_records_resumes(serves):
    """The per-lane baseline takes the recorder too (as the reference's):
    every resume is recorded with the bytes its counter charged."""
    rec0, on, *_ = serves
    rec = Recorder()
    eng = SerialEngine(MODEL, SCFG, on.params, max_len=MAX_LEN,
                       device="cpu", obs=rec)
    _serve(eng)
    res = [ev for ev in rec.serve_events if ev["type"] == "resume"]
    assert len(res) == eng.counters["demotions"] > 0
    assert sum(ev["bytes"] for ev in res) == eng.counters["resume_bytes"]
    assert rec.serve_info == rec0.serve_info


# -- the evaluation path -----------------------------------------------------

CELLS = ["ibex|mcf|n=4000|prom=64", "compresso|pr|n=4000|prom=64"]


def test_run_workload_records_cells_like_reference():
    """``run_workload(obs=)`` returns the reference file's metrics for two
    cells and records them as the reference's Recorder records those
    metrics: ``rec.cells`` and the ``simx.*`` metrics equal."""
    ref = json.loads((ROOT / "src" / "repro_torch" / "simx" /
                      "reference_cells.json").read_text())
    want = {c["key"]: c for c in ref["cells"]}
    rec, jrec = Recorder(), JRecorder()
    for key in CELLS:
        cell = want[key]
        spec = dataclasses.replace(WORKLOADS[cell["spec"]["name"]],
                                   **cell["spec"])
        got = SE.run_workload(cell["scheme"], spec,
                              n_accesses=cell["n_accesses"],
                              promoted_pages=cell["promoted_pages"],
                              torch_device="cpu", obs=rec)
        assert got == cell["metrics"]
        jrec.record_cell(cell["scheme"], spec.name, cell["metrics"])
    assert rec.cells == jrec.cells and len(rec.cells) == len(CELLS)
    assert rec.metrics.snapshot() == jrec.metrics.snapshot()
    assert OBX.metrics_snapshot(rec)["simx"] == \
        JOBX.metrics_snapshot(jrec)["simx"]


# -- the drains refuse device values ------------------------------------------

_T = torch.zeros((2, S.NUM_COUNTERS), dtype=torch.int64)
_PLAN = MigrationPlan(np.array([3]), np.array([0]), np.array([1]))
DRAINS = {
    "record_segment": lambda r: r.record_segment(0, _T, np.zeros(2), None),
    "record_plan": lambda r: r.record_plan(
        0, MigrationPlan(torch.tensor([3]), np.array([0]), np.array([1])),
        "spill"),
    "record_epoch": lambda r: r.record_epoch(
        0, np.zeros((2, S.NUM_COUNTERS), np.int64), kind="sync",
        overlapped=False, planned=1, moved=torch.tensor(1), urgent=False,
        free_units=np.zeros(2, np.int64)),
    "record_cell": lambda r: r.record_cell(
        "ibex", "mcf", {"time_s": torch.tensor(1.0), "normalized_perf": 1.0}),
    "record_step": lambda r: r.record_step(1, [0, 0], torch.zeros(2),
                                           [3, 4], [0, 1]),
    "record_admission": lambda r: r.record_admission(torch.tensor(2), 16),
    "record_preempt": lambda r: r.record_preempt(0, 1, torch.tensor(64),
                                                 False, 0),
    "record_resume": lambda r: r.record_resume(0, 1, torch.tensor(64),
                                               False, 0),
}


@pytest.mark.parametrize("drain", list(DRAINS))
def test_drain_refuses_a_tensor(drain):
    """A tensor handed to a drain would be read by a fetch outside the
    sync contracts: each drain raises ``TypeError`` and records nothing."""
    rec = Recorder()
    with pytest.raises(TypeError, match=f"Recorder.{drain}: .* torch.Tensor"):
        DRAINS[drain](rec)
    assert not (rec.segments or rec.plans or rec.epochs or rec.steps or
                rec.serve_events or rec.cells)
    assert rec.metrics.snapshot() == MetricsRegistry().snapshot()


# -- registry ------------------------------------------------------------------

def test_histogram_merge_is_associative_and_pure():
    bounds = (1.0, 2.0, 5.0, 10.0)
    rng = np.random.default_rng(0)
    hs = []
    for i in range(3):
        h = Histogram(f"h{i}", bounds)
        for v in rng.uniform(0, 15, size=50):
            h.observe(float(v))
        hs.append(h)
    a, b, c = hs
    left = a.merge(b).merge(c)
    right = a.merge(b.merge(c))
    assert left.snapshot() == right.snapshot()
    assert merge_histograms(hs).snapshot() == left.snapshot()
    assert left.n == 150 and sum(left.counts) == 150
    assert a.n == 50 and b.n == 50 and c.n == 50
    with pytest.raises(ValueError):
        a.merge(Histogram("other", (1.0, 2.0)))
    with pytest.raises(ValueError):
        Histogram("unsorted", (2.0, 1.0))


def test_registry_get_or_create_and_counter_monotonicity():
    reg = MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    reg.counter("x").inc(3)
    with pytest.raises(ValueError):
        reg.counter("x").inc(-1)
    reg.gauge("g").set(2.5)
    reg.histogram("h", (1.0,)).observe(0.5)
    snap = reg.snapshot()
    assert snap["counters"] == {"x": 3}
    assert snap["gauges"] == {"g": 2.5}
    assert snap["histograms"]["h"]["count"] == 1


# -- manifest --------------------------------------------------------------------

def test_manifest_stamps_run_facts():
    m = manifest(seed=3, suite="test")
    for key in ("python", "platform", "git_sha", "torch", "cuda", "device",
                "device_count", "gpu_name", "gpu_driver", "gpu_power_limit"):
        assert key in m
    assert "jax" not in m and "backend" not in m
    assert m["torch"] == torch.__version__
    assert m["cuda"] == torch.version.cuda
    assert m["seed"] == 3 and m["suite"] == "test"
    if not torch.cuda.is_available():
        assert m["device"] == "cpu" and m["device_count"] == 0
        assert m["gpu_name"] is None and m["gpu_power_limit"] is None
    json.dumps(m)


def test_obs_imports_no_jax():
    """``repro_torch.obs`` (manifest and exporters included) imports
    neither jax nor the JAX package, and stamps a manifest without them."""
    code = ("import sys; import repro_torch.obs as O; O.manifest(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr


# -- launchers ---------------------------------------------------------------------

def _written(trace_path: Path) -> tuple:
    trace = json.loads(trace_path.read_text())
    assert OBX.validate_trace(trace) == []
    snap = json.loads(Path(OBX.metrics_path(trace_path)).read_text())
    assert snap["manifest"]["torch"] == torch.__version__
    return trace, snap


def test_serve_launcher_trace(tmp_path, capsys):
    """``launch/serve.py --trace`` on the CPU (REDUCED llama3-8b, more
    requests than lanes): a valid trace and its metrics file, one sync a
    step, and the recorder's steps and bytes equal the engine's."""
    from repro_torch.launch import serve as LS
    path = tmp_path / "serve.trace.json"
    eng = LS.main(["--arch", "llama3_8b", "--reduced", "--requests", "5",
                   "--new-tokens", "6", "--lanes", "2", "--device", "cpu",
                   "--trace", str(path)])
    assert "recorded at zero extra syncs (asserted)" in capsys.readouterr().out
    trace, snap = _written(path)
    c = eng.counters
    assert snap["serve"]["steps"] == len(eng.obs.steps) == c["steps"]
    assert snap["metrics"]["counters"]["serve.preempt_bytes"] == \
        c["preempt_bytes"] > 0
    assert any(ev.get("name", "").startswith("step ")
               for ev in trace["traceEvents"])


def test_fabric_launcher_trace(tmp_path, capsys):
    """``launch/fabric.py --trace`` on the CPU (4 expanders, 0.8 skew,
    rebalance): a valid trace and its metrics file, the budgets and the
    reconciliation asserted, segments, plans and epochs recorded."""
    from repro_torch.launch import fabric as LF
    path = tmp_path / "fabric.trace.json"
    fab = LF.main(["--expanders", "4", "--skew", "0.8", "--migration",
                   "rebalance", "--device", "cpu", "--trace", str(path)])
    out = capsys.readouterr().out
    assert "reconcile with pipeline_times (asserted)" in out
    trace, snap = _written(path)
    rec = fab.obs
    ss = fab.sync_stats()
    assert len(rec.segments) == ss["segments"] == snap["fabric"]["segments"]
    assert len(rec.epochs) == ss["epochs"] == snap["fabric"]["epochs"] > 0
    assert rec.plans and snap["manifest"]["seed"] == 0
    assert trace["otherData"]["fabric_overlapped_s"] == \
        [float(t) for t in fab.pipeline_times()["overlapped_s"]]
