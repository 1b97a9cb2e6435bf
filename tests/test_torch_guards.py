"""Guards on the port's boundaries: it never imports JAX or the reference
package, and its entry points never fall back to the CPU on their own."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            yield ("." * node.level) + (node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro") or mod.startswith(".")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_make_pool_without_device_needs_cuda():
    from repro_torch.common.types import PoolConfig
    from repro_torch.core.engine import make_pool
    cfg = PoolConfig(n_pages=16, n_cchunks=64, n_pchunks=16)
    if torch.cuda.is_available():
        assert make_pool(cfg).meta.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pool(cfg)
    assert make_pool(cfg, device="cpu").meta.device.type == "cpu"


def test_kernel_impl_on_cpu_tensors_raises():
    from repro_torch.common.types import PoolConfig
    from repro_torch.core import compressor as comp
    cfg = PoolConfig(compress_impl="kernel")
    x = torch.zeros((1, cfg.vals_per_page), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        comp.encode_pages(x, cfg)


def test_engine_without_device_needs_cuda():
    from repro_torch.common.types import ServeConfig
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.serve import Engine
    cfg = get_reduced("llama3_8b")
    scfg = ServeConfig(max_running=1, hot_window=8, kv_rate_bits=8)
    params = T.init_params(cfg, device="cpu")
    if torch.cuda.is_available():
        assert Engine(cfg, scfg, params, max_len=32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Engine(cfg, scfg, params, max_len=32)
    eng = Engine(cfg, scfg, params, max_len=32, device="cpu")
    rid = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run_until_done()
    assert len(eng.result(rid)) == 3
    assert eng.counters["step_syncs"] == eng.counters["steps"] == 2


def test_unported_arch_raises():
    """Every one of the reference's 10 arch ids resolves (all are ported),
    by id and by alias; an unknown id raises ``KeyError``."""
    from repro_torch.configs import ALIASES, ARCH_IDS, get_config, get_reduced
    assert len(ARCH_IDS) == 10 and set(ALIASES.values()) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).name and get_reduced(arch).num_layers >= 1
    for alias, arch in ALIASES.items():
        assert get_config(alias) == get_config(arch)
    assert get_config("llama3-8b").num_layers == 32
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("not_an_arch")


def test_check_supported_refuses_the_hybrid_family():
    """The hybrid family (zamba2's Mamba2 groups with shared attention) is
    served: its config and param count are accepted. What the reference
    cannot serve stays refused: the SSM family with Mamba2 mixers (its
    decode runs Mamba1's step) and the hybrid with Mamba1 mixers."""
    from repro.configs import get_config as jget_config
    from repro_torch.common.types import ModelConfig, SSMConfig
    from repro_torch.models import transformer as T
    import dataclasses
    ref = jget_config("zamba2_2p7b")
    cfg = ModelConfig(**{k: v for k, v in dataclasses.asdict(ref).items()
                         if k not in ("moe", "mla", "ssm")},
                      ssm=SSMConfig(**dataclasses.asdict(ref.ssm)))
    assert cfg.family == "hybrid"
    T.check_supported(cfg)
    assert cfg.param_count() == ref.param_count() == 2_526_785_760
    with pytest.raises(NotImplementedError, match="Mamba1 mixers"):
        T.check_supported(dataclasses.replace(
            cfg, family="ssm", attn_kind="none"))   # Mamba2 mixers
    with pytest.raises(NotImplementedError, match="Mamba2 mixers"):
        T.check_supported(dataclasses.replace(
            cfg, ssm=SSMConfig(kind="mamba1")))


@pytest.mark.parametrize("arch", ["qwen3_moe_235b_a22b", "arctic_480b",
                                  "chameleon_34b", "musicgen_medium",
                                  "falcon_mamba_7b", "zamba2_2p7b"])
def test_moe_param_counts_match_reference(arch):
    """The MoE, frontend, SSM and hybrid configs and their parameter
    counts (all and active) are the reference's, published and REDUCED."""
    import dataclasses
    from repro import configs as JC
    from repro_torch import configs as TC
    for get in ("get_config", "get_reduced"):
        want, got = getattr(JC, get)(arch), getattr(TC, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
        assert TC.describe(got) == JC.describe(want)


def test_serve_launcher_refuses_params_past_the_device(monkeypatch):
    """The full qwen3-moe (235B params, 470 GB in bf16) is refused before
    anything is allocated when its params exceed the device's memory, and
    the message states both byte counts."""
    from repro_torch.launch import serve as LS
    monkeypatch.setattr(LS, "device_memory_bytes", lambda dev: 80 * 2**30)
    with pytest.raises(SystemExit, match="470185672704 B of bfloat16 params "
                       "exceed the 85899345920 B"):
        LS.main(["--arch", "qwen3_moe_235b_a22b", "--device", "cpu"])


def test_fabric_without_device_needs_cuda():
    from repro_torch.common.types import PoolConfig
    from repro_torch.core.engine import POLICIES
    from repro_torch.fabric import Fabric, StaticInterleave
    cfg = PoolConfig(n_pages=16, n_cchunks=64, n_pchunks=16,
                     store_payload=False)
    pl = StaticInterleave(2, cfg.n_pages)
    if torch.cuda.is_available():
        assert Fabric(cfg, POLICIES["ibex"], pl).pools.meta.device.type \
            == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Fabric(cfg, POLICIES["ibex"], pl)
    fab = Fabric(cfg, POLICIES["ibex"], pl, device="cpu")
    assert fab.pools.meta.device.type == "cpu"
    assert fab.lanes.ch_bw.device.type == "cpu"


def test_fabric_launcher_without_device_needs_cuda(capsys):
    from repro_torch.launch import fabric as LF
    argv = ["--expanders", "2", "--accesses", "64", "--pages", "64"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            LF.main(argv)
    LF.main(argv + ["--device", "cpu", "--check-parity"])
    assert "parity: summed fabric counters" in capsys.readouterr().out


def test_unported_fabric_parts_raise_naming_roadmap():
    """The sharded driver needs a rank group: without one the fabric raises
    and says so; ``--devices 2`` without two visible cards raises, naming
    the count (never a CPU or gloo fallback)."""
    from repro_torch.common.types import PoolConfig
    from repro_torch.core.engine import POLICIES
    from repro_torch.fabric import Fabric, StaticInterleave
    from repro_torch.launch import fabric as LF
    cfg = PoolConfig(n_pages=16, n_cchunks=64, n_pchunks=16,
                     store_payload=False)
    pl = StaticInterleave(2, cfg.n_pages)
    with pytest.raises(RuntimeError, match="no initialized rank group"):
        Fabric(cfg, POLICIES["ibex"], pl, shard_devices=2, device="cpu")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        with pytest.raises(RuntimeError,
                           match=f"needs 2 CUDA devices; {n} visible"):
            LF.main(["--devices", "2"])


def test_train_launcher_without_device_needs_cuda(capsys):
    from repro_torch.launch import train as LT
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would train on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.main(["--arch", "llama3_8b", "--reduced", "--steps", "1"])
    assert "step" not in capsys.readouterr().out     # nothing trained


def test_mesh_and_dp_compressed_step_raise_naming_roadmap():
    """The mesh step refuses, before anything is made, a model axis that
    does not split the experts (9 over 2) or the Mamba heads (1 over 2),
    naming both counts (a stand-in for the (2, 2) mesh of
    ``plan_mesh(4)``: the check reads its sizes); the data-parallel step
    needs a rank group and says so without one."""
    import dataclasses
    import types
    from repro_torch.common.types import MoEConfig, TrainConfig
    from repro_torch.configs import get_reduced
    from repro_torch.train import elastic, trainer
    cfg, tcfg = get_reduced("llama3_8b"), TrainConfig()
    plan = elastic.plan_mesh(4, prefer_model=2)
    mesh = types.SimpleNamespace(shape=plan.shape, axes=plan.axes,
                                 size=plan.num_devices,
                                 sizes=dict(zip(plan.axes, plan.shape)))
    moe = dataclasses.replace(get_reduced("qwen3_moe_235b_a22b"),
                              moe=MoEConfig(num_experts=9, top_k=2,
                                            expert_d_ff=256))
    with pytest.raises(ValueError, match="9 experts do not split over a "
                       "model axis of 2"):
        trainer.make_train_step(moe, tcfg, mesh)
    hybrid = get_reduced("zamba2_2p7b")
    hybrid = dataclasses.replace(hybrid, ssm=dataclasses.replace(
        hybrid.ssm, headdim=256))
    with pytest.raises(ValueError, match="1 Mamba heads do not split"):
        trainer.make_train_step(hybrid, tcfg, mesh)
    with pytest.raises(RuntimeError, match="no initialized rank group"):
        trainer.make_dp_compressed_step(cfg, tcfg)


def test_grad_requiring_card_input_never_loses_its_gradient(monkeypatch):
    """With the device check stubbed to say "on the card" and B6's launch
    stubbed (its output has no grad_fn, as the ctypes launch's has none),
    ``layers.attention`` gives an output with a gradient through the
    autograd Function, and the bare kernel wrapper refuses the input."""
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.models import layers as L
    launched = []

    def launch(q, k, v, causal, sm_scale):
        launched.append(1)
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        sm_scale=sm_scale).detach()
    monkeypatch.setattr(FA, "_on_card", lambda t: True)
    monkeypatch.setattr(FA, "_launch", launch)
    monkeypatch.setattr(L, "resolve_attn_impl", lambda impl, dev: "kernel")
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 16, 4, 64), generator=g, requires_grad=True)
    k = torch.randn((1, 16, 2, 64), generator=g, requires_grad=True)
    v = torch.randn((1, 16, 2, 64), generator=g, requires_grad=True)
    o = L.attention(q, k, v, causal=True)
    assert o.grad_fn is not None and launched == [1]
    o.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    with pytest.raises(RuntimeError, match="requires grad"):
        FA.flash_attention(q, k, v)
    with torch.no_grad():                   # serving: the bare launch
        assert L.attention(q, k, v).grad_fn is None and len(launched) == 2
