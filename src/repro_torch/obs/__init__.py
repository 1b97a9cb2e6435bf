"""Zero-extra-sync telemetry (PyTorch port of ``repro.obs``; DESIGN.md
§16).

The collection path adds NO host syncs: every sample rides inside a fetch
the hot paths already make under their declared ``@sync_contract``
budgets: the fabric's per-segment fetch (``Fabric._fetch_view``), its
per-epoch fetch (``Fabric._commit_epoch``), and the serving engine's one
per-step ``(tok, done, ref, pos)`` fetch (``serve.Engine.step``). The
:class:`Recorder` accumulates those samples on the host into a metrics
registry (counters, gauges, histograms; counter metrics keyed by
``state.COUNTER_NAMES``) and a structured event log; the exporters turn
them into a Chrome/Perfetto ``trace_event`` timeline and a
``metrics.json`` snapshot, each stamped with the run's manifest.

Recording is opt-in: ``obs=None`` (the default everywhere) is the
recording-off path, identical in pool, counter and token state to
recording on, and every drain refuses a ``torch.Tensor``.
"""
from repro_torch.obs.manifest import manifest
from repro_torch.obs.recorder import Recorder
from repro_torch.obs.registry import (Counter, Gauge, Histogram,
                                      MetricsRegistry, merge_histograms)
from repro_torch.obs import export

__all__ = [
    "Recorder", "manifest", "export",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_histograms",
]
