"""R3 — pytree/counter order drift.

The counter block (``core/engine/state.py``) is a single device vector
whose layout is defined ONCE by ``C_* = range(NUM_COUNTERS)`` and
mirrored in ``COUNTER_NAMES`` / ``TRAFFIC_IDX``. Indexing that vector
with a bare integer literal re-encodes the layout at the use site: the
next counter insertion silently shifts every magic number. The drift
guard tests catch it at runtime for the paths they cover; this rule
catches it at the source for every path.

Flags ``X[<int literal>]`` where X is a name or attribute chain that
denotes a counter/traffic vector (``counters``, ``ctrs``, ``traffic``,
``tvec``, ``COUNTER_NAMES``, ``TRAFFIC_NAMES``...). Variable indices,
named-constant indices (``ctrs[S.C_DATA_RD]``) and slices are fine.
"""
import ast
from typing import List

from repro_torch.analysis import core

RULE = "R3"
TITLE = "integer-literal index into a counter/traffic vector"

# terminal names that denote the layout-sensitive vectors
_VECTOR_NAMES = {"counters", "ctrs", "traffic", "tvec", "traffic_vec",
                 "counter_vec", "COUNTER_NAMES", "TRAFFIC_NAMES",
                 "TRAFFIC_IDX"}


def _terminal_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Subscript):
            continue
        if _terminal_name(node.value) not in _VECTOR_NAMES:
            continue
        idx = node.slice
        if isinstance(idx, ast.Constant) and isinstance(idx.value, int) \
                and not isinstance(idx.value, bool):
            out.append(module.finding(
                RULE, node,
                f"`{_terminal_name(node.value)}[{idx.value}]` hard-codes the "
                f"counter layout — use the named `state.C_*` / "
                f"`state.TRAFFIC_IDX` constants so layout changes can't "
                f"silently shift the meaning"))
    return out
