"""R5: declared host-sync contracts (``@sync_contract``), the static half
of ``repro_torch.common.contracts`` (``verify_sync_counters`` is the
runtime half). The reference rule's semantics, with the port's fetch
sites. For every function annotated ``@sync_contract(syncs_per=...,
fetches=N)``:

  * its lexical device->host *fetch sites* are counted:
    ``contracts.fetch``/``fetch_packed``/``item``/``tolist`` under any
    alias, ``self._fetch(...)``, R1(a)'s raw reads on device values, and
    ``np.asarray``/``np.array`` of a device value (numpy on an
    already-fetched host copy is free and exempt);
  * a fetch site inside a host ``for``/``while`` loop or a comprehension
    is a finding regardless of count: one sync per *iteration* is how
    "one sync per step" quietly becomes O(n);
  * more than ``N`` loop-free sites is a finding per excess site, so a
    ``fetches=0`` region may hold none.

Suppressed sites (``# lint: host-ok(reason)``) do not count against the
budget: that is the designed escape for intentional host work.

``REQUIRED_CONTRACTS`` pins the port's load-bearing contracts to their
functions: deleting the annotation from any of them, or changing a
pinned ``fetches``, is itself a finding, so a contract cannot be removed
to appease the count.
"""
from typing import Dict, List, Tuple

from repro_torch.analysis import core

RULE = "R5"
TITLE = "host-sync contract (@sync_contract) violation"

# path suffix -> {function qualname: (syncs_per, fetches)}
REQUIRED_CONTRACTS: Dict[str, Dict[str, Tuple[str, int]]] = {
    "repro_torch/serve/engine.py": {"Engine.step": ("step", 1)},
    "repro_torch/fabric/replay.py": {
        "Fabric._fetch_view": ("segment", 1),
        "Fabric._commit_epoch": ("epoch", 1),
        "Fabric._commit_boundary": ("boundary", 1),
        "Fabric._drain_deferred": ("drain", 1),
        "Fabric.delivered_time": ("call", 1)},
    # the sync-free regions: the counterparts of the reference's jitted
    # decode and train steps
    "repro_torch/models/decode.py": {
        "decode_step": ("step", 0), "gqa_decode_layer": ("step", 0),
        "mla_decode_layer": ("step", 0)},
    "repro_torch/train/trainer.py": {
        "make_train_step.step": ("step", 0),
        "make_train_step.mesh_step": ("step", 0),
        "make_dp_compressed_step.step": ("step", 0)},
    "repro_torch/optim/adamw.py": {"update": ("step", 0)},
}

_SITES = tuple(c for c in core.RAW_READS if c != "print") + \
    ("counted", "np_fetch")


def _required(module: core.ModuleInfo) -> Dict[str, Tuple[str, int]]:
    for suffix, reqs in REQUIRED_CONTRACTS.items():
        if module.relpath == suffix or module.relpath.endswith("/" + suffix):
            return reqs
    return {}


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []

    for qn, (per, fetches) in _required(module).items():
        node = module.get_function(qn)
        parsed = None if node is None else core.contract_of(node)
        if parsed is None:
            out.append(module.finding(
                RULE, node if node is not None else module.tree,
                f"required @sync_contract(syncs_per=\"{per}\", "
                f"fetches={fetches}) is missing on `{qn}` — the {per}-sync "
                f"contract must stay machine-readable (see "
                f"common/contracts.py)"))
        elif parsed[:2] != (per, fetches):
            out.append(module.finding(
                RULE, parsed[2],
                f"`{qn}` declares @sync_contract(syncs_per=\"{parsed[0]}\", "
                f"fetches={parsed[1]}) where its pinned contract is "
                f"(\"{per}\", {fetches})"))

    for node, qn, per, fetches, _dec in module.contracts:
        budget_sites = []
        for ev in module.function_events(node):
            if ev.category not in _SITES:
                continue
            desc = ev.what
            if module.suppression_at(ev.node) is not None:
                # still reported (as suppressed) so the count is visible
                out.append(module.finding(
                    RULE, ev.node,
                    f"{desc} in `{qn}` excluded from the "
                    f"{fetches}/{per} budget"))
                continue
            if module.in_loop(ev.node, node):
                out.append(module.finding(
                    RULE, ev.node,
                    f"{desc} inside a host loop in `{qn}` — syncs once "
                    f"per iteration, violating the declared {fetches}-"
                    f"fetch-per-{per} contract"))
            else:
                budget_sites.append(ev)
        for ev in budget_sites[fetches:]:
            out.append(module.finding(
                RULE, ev.node,
                f"{ev.what} exceeds the declared budget of {fetches} "
                f"fetch site(s) per {per} in `{qn}` "
                f"({len(budget_sites)} found) — fuse reads into one "
                f"contracts.fetch_packed or raise the contract deliberately"))
    return out
