"""Architecture registry: the reference's ten arch ids and their CLI
aliases. Each ported arch has a module exporting ``CONFIG`` (the published
configuration) and ``REDUCED`` (a same-family miniature for CPU tests).
The port serves all ten: the dense family (GQA/MHA and MLA attention, and
the frontend backbones chameleon-34b and musicgen-medium), the MoE family
(GQA), the SSM family (Mamba1) and the hybrid family (Mamba2 groups with
shared attention). An unknown id raises ``KeyError``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.common.types import ModelConfig

ARCH_IDS: List[str] = [
    "chameleon_34b", "qwen3_moe_235b_a22b", "arctic_480b", "deepseek_7b",
    "minicpm3_4b", "codeqwen15_7b", "llama3_8b", "zamba2_2p7b",
    "musicgen_medium", "falcon_mamba_7b",
]

ALIASES: Dict[str, str] = {
    "chameleon-34b": "chameleon_34b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "arctic-480b": "arctic_480b",
    "deepseek-7b": "deepseek_7b",
    "minicpm3-4b": "minicpm3_4b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "llama3-8b": "llama3_8b",
    "zamba2-2.7b": "zamba2_2p7b",
    "musicgen-medium": "musicgen_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

def _module(arch: str):
    arch = ALIASES.get(arch, arch)
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    return _module(arch).REDUCED


def describe(cfg: ModelConfig) -> str:
    n = cfg.param_count()
    na = cfg.active_param_count()
    extra = f", active {na/1e9:.1f}B" if na != n else ""
    return (f"{cfg.name}: {cfg.family} {cfg.num_layers}L d={cfg.d_model} "
            f"{n/1e9:.1f}B params{extra}")
