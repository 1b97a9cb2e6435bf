"""R1: hidden host syncs.

In eager PyTorch every read of a device value into the host waits for
the card. The port makes each such read through ``common/contracts.py``,
whose ``SYNCS`` counts it; a read that bypasses it is a real sync the
counted figures never show. The taint walk in ``core`` finds them; this
rule turns its events into findings, in two parts:

  (a) anywhere in the scanned modules but ``common/contracts.py`` itself,
      a device->host read that bypasses the counter, on a device value:
      ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
      ``.to("cpu")``; ``int()``/``float()``/``bool()``/``complex()``; a
      Python ``if``/``while``/``assert`` (structural tests, ``x is None``,
      ``"k" in tree``, ``isinstance``/``len``, are exempt); ``print``; and
      ``torch.cuda.synchronize()`` or a stream's or event's
      ``.synchronize()``;
  (b) inside a sync-free region (``@sync_contract(fetches=0)``, with the
      local callees it reaches), everything in (a) and also the counted
      reads (``contracts.item``/``tolist``/``fetch``/``fetch_packed``,
      ``self._fetch``) and the ops whose output shape depends on the data:
      ``nonzero``, ``torch.where(cond)``, ``unique``, ``masked_select``,
      indexing with a boolean device mask, ``repeat_interleave`` with
      tensor repeats and no ``output_size``.
"""
from typing import List

from repro_torch.analysis import core

RULE = "R1"
TITLE = "hidden host sync (a device->host read outside the counter)"

_EXEMPT = "repro_torch/common/contracts.py"


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []
    seen = set()

    def add(ev, message):
        key = (getattr(ev.node, "lineno", 0),
               getattr(ev.node, "col_offset", 0), ev.category)
        if key in seen:         # overlapping walks report each site once
            return
        seen.add(key)
        out.append(module.finding(RULE, ev.node, message))

    for region in module.regions:
        for ev in module.region_walk(region).events:
            if ev.category in core.RAW_READS + core.REGION_ONLY:
                add(ev, f"{ev.message} (inside sync-free region "
                        f"`{region.qualname}`)")
    if module.relpath == _EXEMPT or module.relpath.endswith("/" + _EXEMPT):
        return out
    for ev in module.module_events():
        if ev.category in core.RAW_READS:
            add(ev, ev.message)
    return out
