"""Rule registry of the port's host-sync lint (the reference's rule ids,
each aimed at what the same hazard looks like in eager PyTorch).

Each rule is a module exposing ``RULE`` (its id), ``TITLE`` (one-line
summary used in reports) and ``check(module: ModuleInfo) -> List[Finding]``.
Adding a rule = adding a module here and appending it to ``ALL_RULES``.
"""
from repro_torch.analysis.rules import (
    r1_hidden_host_sync,
    r2_recompile_hazard,
    r3_pytree_order,
    r4_kernel_hygiene,
    r5_sync_contract,
    r6_obs_piggyback,
)

ALL_RULES = [
    r1_hidden_host_sync,
    r2_recompile_hazard,
    r3_pytree_order,
    r4_kernel_hygiene,
    r5_sync_contract,
    r6_obs_piggyback,
]

RULE_TITLES = {m.RULE: m.TITLE for m in ALL_RULES}
