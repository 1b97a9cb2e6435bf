"""The port's delivered-time model (``simx/time.py``, ``simx/device.py``)
and the counter helpers of ``core/engine/state.py`` against the
reference's, on seeded counter arrays.

The float64 numpy paths must be bitwise the reference's (same operation
order); the float32 tensor path is held to the reference's eager jnp path
within float32 rounding (rtol 1e-6) and to its jitted path (the one the
fabric prices segments with) bit for bit. ``Engine.modeled_time``
is held to the JAX ``Engine``'s on the REDUCED llama3 serving recipe of
``test_torch_serve.py``.
"""
import dataclasses
import json
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.engine import state as JS  # noqa: E402
from repro.simx import device as JDEV  # noqa: E402
from repro.simx import time as JTM  # noqa: E402
from repro_torch.core.engine import state as S  # noqa: E402
from repro_torch.simx import device as DEV  # noqa: E402
from repro_torch.simx import time as TM  # noqa: E402

RTOL_F32 = 1e-6

PROFILES = ["default", "gen4", "far", "slow_engine"]


def _devices():
    """(reference, port) DeviceConfig pairs with equal fields."""
    out = []
    for name in PROFILES:
        out.append((JTM.DEVICE_PROFILES[name], TM.DEVICE_PROFILES[name]))
    out.append((JTM.DeviceConfig(block_scale=4.0),
                TM.DeviceConfig(block_scale=4.0)))
    out.append((JTM.ideal_bandwidth(JTM.DeviceConfig()),
                TM.ideal_bandwidth(TM.DeviceConfig())))
    return out


def _fields(d) -> dict:
    return dataclasses.asdict(d)


def _counters(shape, seed, hi=50000):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, hi, shape + (S.NUM_COUNTERS,)).astype(np.int32)
    if shape:                           # a host == 0 row
        c[..., 0, S.C_HOST_RD] = 0
        c[..., 0, S.C_HOST_WR] = 0
    return c


def _traffic_samples(n=48, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = {k: int(rng.integers(0, 50000)) for k in S.COUNTER_NAMES}
        if i % 3 == 0:      # fig12's miracle variant: a reduced total
            t["internal_accesses"] = int(rng.integers(0, 50000))
        out.append(t)
    out.append({k: 0 for k in S.COUNTER_NAMES})
    out.append({k: 0 for k in S.COUNTER_NAMES} | {"internal_accesses": 17,
                                                  "zero_served": 3})
    return out


def test_profiles_and_ideal_bandwidth_match():
    assert list(JTM.DEVICE_PROFILES) == list(TM.DEVICE_PROFILES)
    for j, t in _devices():
        assert _fields(j) == _fields(t)
    assert [f.name for f in dataclasses.fields(JTM.DeviceConfig)] == \
        [f.name for f in dataclasses.fields(TM.DeviceConfig)]
    assert JTM.DeviceLanes._fields == TM.DeviceLanes._fields


def test_counter_names_and_traffic_helpers_match():
    assert S.COUNTER_NAMES == JS.COUNTER_NAMES
    assert S.TRAFFIC_IDX == JS.TRAFFIC_IDX
    assert S.TRAFFIC_NAMES == JS.TRAFFIC_NAMES
    c = _counters((3, 5), seed=1)
    want = JS.traffic_vector(c)
    np.testing.assert_array_equal(S.traffic_vector(c), want)
    np.testing.assert_array_equal(S.traffic_vector(torch.from_numpy(c)).numpy(),
                                  want)
    d = _counters((4,), seed=2)
    np.testing.assert_array_equal(S.counters_delta(c[0, :4], d),
                                  JS.counters_delta(c[0, :4], d))
    delta = d - c[1, :4]
    want = JS.counters_delta_dict(delta)
    assert S.counters_delta_dict(delta) == want
    assert S.counters_delta_dict(torch.from_numpy(delta)) == want
    assert S.counters_delta_dict(delta[0]) == JS.counters_delta_dict(delta[0])


def test_total_traffic_and_snapshot_on_a_pool():
    from repro_torch.common.types import PoolConfig
    cfg = PoolConfig(n_pages=16, n_cchunks=64, n_pchunks=8, mcache_sets=2,
                     mcache_ways=2, store_payload=False)
    pool = S.make_pool(cfg, device="cpu")
    c = _counters((), seed=3, hi=1 << 20)
    pool.counters.copy_(torch.from_numpy(c))
    got = S.total_traffic(pool)
    want = JS.total_traffic(SimpleNamespace(counters=jnp.asarray(c)))
    assert got.dtype == torch.int32 and want.dtype == jnp.int32
    assert int(got) == int(want)
    snap = S.counters_snapshot(pool)
    pool.counters[S.C_DATA_RD] += 5
    # the port updates pools in place: a snapshot must not move with them
    np.testing.assert_array_equal(snap.numpy(), c)
    assert S.counters_delta_dict(S.counters_delta(
        snap, S.counters_snapshot(pool)))["data_rd"] == 5


@pytest.mark.parametrize("shape", [(64,), (4, 8)])
def test_exec_time_vec_numpy_is_bitwise_the_reference(shape):
    c = _counters(shape, seed=4)
    for j, t in _devices():
        np.testing.assert_array_equal(TM.exec_time_vec(c, t),
                                      JTM.exec_time_vec(c, j))
        # float64 input and an explicit xp take the same path
        np.testing.assert_array_equal(
            TM.exec_time_vec(c.astype(np.float64), t, xp=np),
            JTM.exec_time_vec(c.astype(np.float64), j, xp=np))
    # a stacked fleet whose lanes broadcast against the leading axes
    jd, td = zip(*_devices())
    c = _counters((3, len(jd)), seed=5)
    np.testing.assert_array_equal(
        TM.exec_time_vec(c, TM.stack_devices(td, xp=np)),
        JTM.exec_time_vec(c, JTM.stack_devices(jd, xp=np)))


def test_exec_time_vec_torch_float32_matches_jnp():
    jd, td = zip(*_devices())
    c = _counters((5, len(jd)), seed=6)
    jl = JTM.stack_devices(jd, xp=jnp)
    tl = TM.stack_devices(td, xp=torch, device="cpu")
    want = np.asarray(JTM.exec_time_vec(jnp.asarray(c), jl))
    got = TM.exec_time_vec(torch.from_numpy(c), tl)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_F32, atol=0)
    # one DeviceConfig broadcast over every row, and under jit/vmap
    for j, t in _devices():
        want = np.asarray(jax.jit(jax.vmap(
            lambda x: JTM.exec_time_vec(x, j)))(jnp.asarray(c[0])))
        got = TM.exec_time_vec(torch.from_numpy(c[0]), t).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL_F32, atol=0)


def test_exec_time_vec_float32_is_bitwise_the_jitted_reference():
    """Segment times as the reference's fabric computes them (float32,
    jitted, vmapped over a stacked fleet) equal the port's bit for bit
    over 80,000 seeded counter vectors at four scales; the unfused
    multiply-add of the latency's first two terms would not (XLA:CPU
    contracts it, ``time._fma_f32``)."""
    rng = np.random.default_rng(1)
    jl = JTM.stack_devices([JTM.DEVICE_PROFILES[p] for p in PROFILES])
    tl = TM.stack_devices([TM.DEVICE_PROFILES[p] for p in PROFILES])
    jitted = jax.jit(jax.vmap(jax.vmap(JTM.exec_time_vec),
                              in_axes=(0, None)))
    unfused = 0
    for scale in (100, 3000, 100000, 3000000):
        c = rng.integers(0, scale, (5000, len(PROFILES), S.NUM_COUNTERS)) \
            .astype(np.int32)
        host = c[..., S.C_HOST_RD] + c[..., S.C_HOST_WR]
        c[..., S.C_ZERO_SERVED] = (rng.random(host.shape) * host *
                                   rng.random(host.shape)).astype(np.int32)
        want = np.asarray(jitted(jnp.asarray(c), jl)).view(np.uint32)
        got = TM.exec_time_vec(torch.from_numpy(c), tl)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TM, "_fma_f32", lambda a, b, c: torch.as_tensor(
                c, dtype=torch.float32) + a * torch.as_tensor(
                    b, dtype=torch.float32))
            plain = TM.exec_time_vec(torch.from_numpy(c), tl)
        unfused += int((plain.numpy().view(np.uint32) != want).sum())
    assert unfused > 0


def _fma_exact_f32(a, b, c) -> np.float32:
    """``a * b + c`` computed exactly in rationals, rounded once to
    float32 (nearest, ties to even)."""
    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda y: (abs(Fraction(float(y)) - x),
                                     int(np.float32(y).view(np.uint32)) & 1))


def test_fma_f32_rounds_once_at_float32_midpoints():
    """``_fma_f32`` equals the exactly rounded multiply-add where the
    float64 sum lands on a float32 midpoint: a * b = ±2^-24 (1 - k^2
    2^-46) with k < 256 puts c + a * b less than 2^-54 from the midpoint
    next to c in [1, 2), so the float64 sum lands on the midpoint, and
    rounding it again to float32 goes the wrong way in about half the
    cases. Both crafted cases and seeded ones, all ==."""
    rng = np.random.default_rng(7)
    k = rng.integers(1, 256, 2000)
    a = (2.0 ** -12 * (1 + k * 2.0 ** -23)).astype(np.float32)
    b = (2.0 ** -12 * (1 - k * 2.0 ** -23)).astype(np.float32)
    b = np.where(rng.random(2000) < 0.5, b, -b).astype(np.float32)
    c = (1 + rng.integers(0, 1 << 23, 2000) * 2.0 ** -23).astype(np.float32)
    # the two smallest: 1 + 2^-23 rounds up to 1 + 2^-22, -(1 + 2^-23)
    # down to -1, when rounded twice
    a = np.concatenate([[2.0 ** -12 * (1 + 2.0 ** -23)] * 2, a])
    b = np.concatenate([[2.0 ** -12 * (1 - 2.0 ** -23)] * 2, b])
    c = np.concatenate([[1 + 2.0 ** -23, -(1 + 2.0 ** -23)], c])
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    want = np.array([_fma_exact_f32(*t) for t in zip(a, b, c)], np.float32)
    got = TM._fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    twice = (a.astype(np.float64) * b.astype(np.float64) +
             c.astype(np.float64)).astype(np.float32)
    assert (twice[:2] != want[:2]).all() and (twice != want).sum() > 500


def test_stack_devices_matches_and_guards_field_drift(monkeypatch):
    jd, td = zip(*_devices())
    jl, tl = JTM.stack_devices(jd, xp=np), TM.stack_devices(td, xp=np)
    jf, tf = JTM.stack_devices(jd, xp=jnp), TM.stack_devices(td, xp=torch)
    for n in TM.DeviceLanes._fields:
        a, b = getattr(tl, n), getattr(jl, n)
        assert a.dtype == np.float64 and a.shape == (len(td),)
        np.testing.assert_array_equal(a, b)
        f = getattr(tf, n)
        assert f.dtype == torch.float32 and f.device.type == "cpu"
        np.testing.assert_array_equal(f.numpy(), np.asarray(getattr(jf, n)))

    @dataclasses.dataclass(frozen=True)
    class Drifted(TM.DeviceConfig):
        new_knob: float = 1.0

    monkeypatch.setattr(TM, "DeviceConfig", Drifted)
    for xp in (np, torch):
        with pytest.raises(TypeError, match="drifted"):
            TM.stack_devices([Drifted()], xp=xp)


def test_exec_time_dict_and_device_shims_are_bitwise_the_reference():
    for t in _traffic_samples():
        np.testing.assert_array_equal(TM.counters_from_dict(t),
                                      JTM.counters_from_dict(t))
        for jd, td in _devices():
            assert TM.exec_time_dict(t, td) == JTM.exec_time_dict(t, jd)
            assert DEV.exec_time(t, td) == JDEV.exec_time(t, jd)
            vec = TM.counters_from_dict(t)
            assert float(TM.exec_time_vec(vec, td)) == \
                float(JTM.exec_time_vec(vec, jd))


def test_uncompressed_baseline_is_bitwise_the_reference():
    for n in (0, 1, 7, 12345):
        np.testing.assert_array_equal(TM.uncompressed_counters(n),
                                      JTM.uncompressed_counters(n))
        for jd, td in _devices():
            got = TM.uncompressed_time(n, td)
            assert type(got) is float and got == JTM.uncompressed_time(n, jd)
            assert DEV.uncompressed_time(n, td) == JDEV.uncompressed_time(n, jd)
    jd, td = zip(*_devices())
    hosts = np.arange(len(jd)) * 1000
    np.testing.assert_array_equal(
        TM.uncompressed_time(hosts, TM.stack_devices(td, xp=np)),
        JTM.uncompressed_time(hosts, JTM.stack_devices(jd, xp=np)))


@pytest.mark.parametrize("overlapped", [True, False])
def test_pipeline_delivered_time_matches(overlapped):
    """A pure function of per-segment counter deltas: [S, N_counters] under
    one device, and [S, N, N_counters] under a fleet of N."""
    jd, td = zip(*_devices())
    rep, mig = _counters((6,), seed=7), _counters((6,), seed=8, hi=5000)
    for j, t in _devices():
        np.testing.assert_array_equal(
            TM.pipeline_delivered_time(rep, mig, t, overlapped),
            JTM.pipeline_delivered_time(rep, mig, j, overlapped))
    rep = _counters((6, len(jd)), seed=9)
    mig = _counters((6, len(jd)), seed=10, hi=5000)
    want = JTM.pipeline_delivered_time(rep, mig, JTM.stack_devices(jd, xp=np),
                                       overlapped)
    got = TM.pipeline_delivered_time(rep, mig, TM.stack_devices(td, xp=np),
                                     overlapped)
    assert got.shape == (len(jd),)
    np.testing.assert_array_equal(got, want)
    want = JTM.pipeline_delivered_time(jnp.asarray(rep), jnp.asarray(mig),
                                       JTM.stack_devices(jd, xp=jnp),
                                       overlapped)
    got = TM.pipeline_delivered_time(torch.from_numpy(rep),
                                     torch.from_numpy(mig),
                                     TM.stack_devices(td, xp=torch),
                                     overlapped)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL_F32,
                               atol=0)


def test_serve_motion_and_modeled_time_match():
    rng = np.random.default_rng(11)
    jd, td = zip(*_devices())
    pre = rng.integers(0, 1 << 30, len(jd))
    res = rng.integers(0, 1 << 30, len(jd))
    np.testing.assert_array_equal(
        TM.serve_motion_time(pre.astype(np.float64), res.astype(np.float64),
                             TM.stack_devices(td, xp=np)),
        JTM.serve_motion_time(pre.astype(np.float64), res.astype(np.float64),
                              JTM.stack_devices(jd, xp=np)))
    counters = {"step_syncs": 123, "admit_syncs": 45, "steps": 120}
    stats = {"preempt_bytes": pre, "resume_bytes": res}
    assert TM.serve_modeled_time(counters, stats, td) == \
        JTM.serve_modeled_time(counters, stats, jd)
    zero, two = dict(counters, steps=0), {k: v[:2] for k, v in stats.items()}
    assert TM.serve_modeled_time(zero, two, td[:2]) == \
        JTM.serve_modeled_time(zero, two, jd[:2])


def test_resolve_fleet_matches():
    d, g = TM.DeviceConfig(), TM.DEVICE_PROFILES["gen4"]
    jdv, jg = JTM.DeviceConfig(), JTM.DEVICE_PROFILES["gen4"]
    for spec, jspec, n in ((None, None, 3), (d, jdv, 2), ([d, g], [jdv, jg], 4),
                           ([g], [jg], 1)):
        assert [_fields(x) for x in TM.resolve_fleet(spec, n)] == \
            [_fields(x) for x in JTM.resolve_fleet(jspec, n)]
    for bad, jbad, n in (([d, g, d], [jdv, jg, jdv], 2), ([], [], 2)):
        with pytest.raises(ValueError) as e1:
            TM.resolve_fleet(bad, n)
        with pytest.raises(ValueError) as e2:
            JTM.resolve_fleet(jbad, n)
        assert str(e1.value) == str(e2.value)


def test_calibrated_device_matches_on_a_file_and_without_one(tmp_path):
    good = tmp_path / "bench.json"
    good.write_text(json.dumps({"calibration": {
        "compress_gbps": 3.7, "decompress_gbps": 11.2, "block_bytes": 1024}}))
    tiny = tmp_path / "tiny.json"     # engine faster than a cycle a block
    tiny.write_text(json.dumps({"calibration": {
        "compress_gbps": 1e9, "decompress_gbps": 1e9}}))
    partial = tmp_path / "partial.json"
    partial.write_text(json.dumps({"calibration": {"compress_gbps": 2.0}}))
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    missing = tmp_path / "missing.json"
    for path in (good, tiny, partial, broken, missing, str(good)):
        for jb, tb in ((None, None), (JTM.DEVICE_PROFILES["gen4"],
                                      TM.DEVICE_PROFILES["gen4"])):
            assert _fields(TM.calibrated_device(path, tb)) == \
                _fields(JTM.calibrated_device(path, jb))
    assert TM.calibrated_device(good).comp_cycles != 256
    # the port's default file is its own, absent: the paper's constants
    assert TM._BENCH_TORCH.name == "BENCH_torch.json"
    assert not TM._BENCH_TORCH.exists()
    assert TM.calibrated_device() == TM.DeviceConfig()


def test_engine_modeled_time_matches_reference():
    """The REDUCED llama3 recipe of test_torch_serve.py (5 requests through
    2 lanes, preemption and resume) through the JAX Engine and the port's:
    equal counters, equal modeled time, for one device and a fleet."""
    from test_torch_serve import (CFG, JCFG, JSCFG, MAX_LEN, SCFG, _serve)
    from repro.models import transformer as JT
    from repro.serve.engine import Engine as JEngine
    from repro_torch import interop
    from repro_torch.serve import Engine

    jparams = JT.init_params(jax.random.PRNGKey(0), JCFG)[0]
    params = interop.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), CFG, device="cpu")
    jeng = JEngine(JCFG, JSCFG, jparams, max_len=MAX_LEN)
    eng = Engine(CFG, SCFG, params, max_len=MAX_LEN, device="cpu")
    assert _serve(eng) == _serve(jeng)
    assert eng.counters == dict(jeng.counters)
    assert eng.counters["preempt_bytes"] > 0
    got, want = eng.modeled_time(), jeng.modeled_time()
    assert got == want and got["modeled_s"] > got["sync_s"] > 0
    gen4, jgen4 = TM.DEVICE_PROFILES["gen4"], JTM.DEVICE_PROFILES["gen4"]
    assert eng.modeled_time(gen4) == jeng.modeled_time(jgen4)
    assert eng.modeled_time([gen4]) == jeng.modeled_time([jgen4])
    with pytest.raises(ValueError):      # two configs for one expander
        eng.modeled_time([gen4, gen4])
