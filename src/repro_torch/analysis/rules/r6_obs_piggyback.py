"""R6: telemetry piggyback contract (``repro_torch.obs``).

The Recorder's premise is "zero extra syncs": it only ever consumes host
values that the hot paths' *already-budgeted* fetches produced. Two ways
code can break that premise, both visible syntactically:

  * **an obs emission inside a sync-free region**: ``obs.record_*`` /
    ``rec.record_*`` in a ``@sync_contract(fetches=0)`` function, or in a
    local callee it reaches. A drain's arguments are host values, so an
    emission there either records a value the region had to read (a
    sync the region forbids) or belongs on the host side of the step,
    fed by what the step returns.
  * **a device value handed to an obs drain inside a declared sync
    contract**: ``obs.record_*(self.pools.counters, ...)`` inside an
    ``@sync_contract`` method makes the drain's read of it a second,
    hidden fetch site the R5 budget never sees (the Recorder refuses a
    tensor at run time; this catches it on any machine). Drain arguments
    must be host names bound from the contracted fetch, or host
    expressions over them.

String-keyed subscripts (``self.counters["steps"]``) are host
bookkeeping, never device vectors (R3), so they do not count as device
values.
"""
from typing import List

from repro_torch.analysis import core

RULE = "R6"
TITLE = "obs telemetry piggyback violation"


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []

    # 1. no obs emission from inside a sync-free region or its callees
    seen = set()
    for region in module.regions:
        for fn in module.region_walk(region).visited:
            for call in core.iter_calls(fn):
                attr = core.obs_emission(call)
                if attr is None or id(call) in seen:
                    continue
                seen.add(id(call))
                out.append(module.finding(
                    RULE, call,
                    f"obs emission `{attr}` inside sync-free region "
                    f"`{region.qualname}` — telemetry must leave the "
                    f"region in what it returns and drain host-side"))

    # 2. drains inside declared sync contracts consume host values only
    for node, qn, _per, _fetches, _dec in module.contracts:
        for ev in module.function_events(node):
            if ev.category != "drain":
                continue
            out.append(module.finding(
                RULE, ev.node,
                f"obs drain `{ev.what}` in `{qn}` is handed a device value "
                f"— "
                f"inside a @sync_contract the drain may only consume host "
                f"values from the contracted fetch (a device argument is a "
                f"hidden second sync site)"))
    return out
