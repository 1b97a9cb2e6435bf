"""repro_torch.analysis: the port's host-sync lint (the counterpart of
``repro.analysis``, DESIGN.md §15, for eager PyTorch).

Stdlib-only AST pass enforcing the port's host-sync and kernel-route
contracts at the source level: ``python -m repro_torch.analysis.lint
src/repro_torch --baseline src/repro_torch/analysis/baseline.json``.
"""
from repro_torch.analysis.core import Finding, ModuleInfo, Region  # noqa: F401
