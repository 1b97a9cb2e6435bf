"""Run manifest: the one description of "what produced this artifact"
(PyTorch port of ``repro.obs.manifest``).

The launchers' ``--trace`` exports and the ``metrics.json`` snapshot stamp
the same dict, built here. Keys: python and platform, the git sha, the
seed when the run has one, torch and the CUDA it was built for, the device
the run can use (``cuda`` or ``cpu``) and how many cards it sees, and on a
card its name, driver and power limit as ``nvidia-smi`` reports them
(``None`` where there is no card). A card may be set below its maximum
power and then runs slower under load, so a number without the limit
beside it cannot be compared.
"""
from __future__ import annotations

import pathlib
import platform
import subprocess
from typing import Any, Dict, Optional

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
_SMI_QUERY = "--query-gpu=name,driver_version,power.limit"
_CARD_KEYS = ("gpu_name", "gpu_driver", "gpu_power_limit")


def _git_sha() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=_REPO_ROOT,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def _card() -> Dict[str, Optional[str]]:
    """The first card's name, driver and power limit from ``nvidia-smi``
    (one call, at most 30 s); ``None`` each where it cannot be read."""
    card = dict.fromkeys(_CARD_KEYS)
    try:
        out = subprocess.run(["nvidia-smi", _SMI_QUERY,
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return card
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return card
    fields = [f.strip() for f in lines[0].split(",")]
    if len(fields) == len(_CARD_KEYS):
        card.update(zip(_CARD_KEYS, fields))
    return card


def manifest(seed: Optional[int] = None, **extra: Any) -> Dict[str, Any]:
    """The run manifest stamped into every obs export.

    ``seed`` is recorded when the producing run has one; ``extra``
    key/values ride along verbatim."""
    import torch
    on_card = torch.cuda.is_available()
    out: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "git_sha": _git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device": "cuda" if on_card else "cpu",
        "device_count": torch.cuda.device_count() if on_card else 0,
    }
    out.update(_card() if on_card else dict.fromkeys(_CARD_KEYS))
    if seed is not None:
        out["seed"] = int(seed)
    out.update(extra)
    return out
