"""Elastic scaling and failure handling (the reference's
``repro.train.elastic``, plain Python).

  * mesh planning: ``plan_mesh(n)`` picks (data, model) or (pod, data,
    model) factors for whatever device count survives a failure;
  * deterministic replay: the data pipeline is a pure function of (step,
    shard), so a replacement rank regenerates its shard exactly and a backup
    rank can race a straggler on the same shard;
  * step-level retry: ``launch/train.py`` retries a failed step from the
    last checkpoint.

``launch/train.py --devices D`` trains on ``plan_mesh(D,
prefer_model=2)`` through ``trainer.make_train_step(mesh=)``, and a
checkpoint restores onto any mesh, a ``degraded_plan`` included
(``checkpoint.restore(shardings=)``), for every family (MLA, MoE, SSM and
hybrid among them). Data-parallel ranks with int8 gradient codes
train through ``trainer.make_dp_compressed_step``.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.common.types import MeshConfig


def _best_2d(n: int, prefer_model: int) -> Tuple[int, int]:
    """Factor n into (data, model) with model as close to prefer_model as
    possible (model must divide n)."""
    best = (n, 1)
    for model in range(1, n + 1):
        if n % model:
            continue
        if model <= prefer_model:
            best = (n // model, model)
    return best


def plan_mesh(n_devices: int, *, prefer_model: int = 16,
              pods: int = 1) -> MeshConfig:
    """Mesh for an arbitrary surviving device count."""
    if pods > 1 and n_devices % pods == 0:
        per_pod = n_devices // pods
        d, m = _best_2d(per_pod, prefer_model)
        return MeshConfig(shape=(pods, d, m), axes=("pod", "data", "model"))
    d, m = _best_2d(n_devices, prefer_model)
    return MeshConfig(shape=(d, m), axes=("data", "model"))


def degraded_plan(old: MeshConfig, lost_devices: int) -> MeshConfig:
    """Re-plan after losing ``lost_devices`` (drop to the largest usable
    device count that keeps the model axis intact)."""
    total = old.num_devices - lost_devices
    model = old.shape[-1]
    usable = (total // model) * model
    if usable == 0:
        model, usable = 1, total
    pods = old.shape[0] if len(old.shape) == 3 else 1
    if pods > 1 and usable % pods != 0:
        pods = 1
    return plan_mesh(usable, prefer_model=model, pods=pods)


class StragglerMonitor:
    """EWMA step-time tracker: flags ranks whose step time exceeds
    ``threshold`` x the fleet median (the launcher would hand their data
    shard to a backup rank: safe, the pipeline is deterministic per
    shard)."""

    def __init__(self, n_ranks: int, alpha: float = 0.2,
                 threshold: float = 2.0):
        self.ewma = [0.0] * n_ranks
        self.alpha = alpha
        self.threshold = threshold

    def record(self, rank: int, step_time: float) -> None:
        e = self.ewma[rank]
        self.ewma[rank] = step_time if e == 0 else \
            (1 - self.alpha) * e + self.alpha * step_time

    def stragglers(self) -> list:
        live = sorted(e for e in self.ewma if e > 0)
        if not live:
            return []
        median = live[len(live) // 2]
        return [i for i, e in enumerate(self.ewma)
                if e > self.threshold * median]
