"""Scalar face of the CXL-device timing model (PyTorch port of
``repro.simx.device``): ``exec_time(traffic_dict, dev)`` and the
uncompressed baseline as thin shims over ``simx.time``."""
from __future__ import annotations

from typing import Dict

from repro_torch.simx.time import (DEVICE_PROFILES, DeviceConfig,  # noqa: F401
                                   DeviceLanes, exec_time_dict,
                                   ideal_bandwidth, stack_devices)
from repro_torch.simx.time import uncompressed_time as _uncompressed_time


def exec_time(traffic: Dict[str, float], dev: DeviceConfig) -> float:
    """Scalar delivered time of a string-keyed traffic dict."""
    return exec_time_dict(traffic, dev)


def uncompressed_time(n_host: int, dev: DeviceConfig) -> float:
    """Uncompressed-device baseline (host reads, one internal access
    each)."""
    return _uncompressed_time(n_host, dev)
