"""Core AST machinery of the port's host-sync lint (the counterpart of
``repro.analysis.core``, reading eager PyTorch instead of traced JAX).

Pure stdlib (``ast`` + ``re`` + ``hashlib``): nothing here imports torch,
so the lint runs on a machine with no accelerator stack. Three layers:

  * **ModuleInfo**: one parsed source file with parent links, function
    qualnames, lexical scope tables (a bare ``Name`` resolves to the local
    function it references), the module's import table (``F`` ->
    ``torch.nn.functional``), ``# lint: host-ok(reason)`` suppressions,
    every ``@sync_contract`` it declares, and its regions.
  * **Regions**: the port runs eagerly, so nothing is traced; what the
    reference's jit regions are to it, a *sync-free region* is to the
    port: a function declared ``@sync_contract(syncs_per=..., fetches=0)``
    (``common/contracts.py``), code that must make no device->host read
    at all. Like the reference's taint walk, a region covers the local
    callees it reaches, one module deep.
  * **Taint walk**: a lightweight device-value dataflow. Seeds are the
    results of ``torch.*`` calls that make tensors, tensor methods on a
    tainted value, parameters annotated ``torch.Tensor`` or a port type
    that holds tensors (``TENSOR_TYPES``), and attributes of the
    device-state set (``DEVICE_ATTRS``). ``.shape``/``.dtype``/
    ``.numel()``-style metadata, numpy results and the host copies that
    ``contracts.fetch``/``fetch_packed``/``item``/``tolist`` return are
    untainted. The walk emits *events* (a host cast, ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``, a Python
    branch, ``assert`` or ``print`` on a device value, a stream or device
    synchronize, a counted read, an op whose output shape depends on the
    data, a device value handed to a telemetry drain) that rules R1, R5
    and R6 turn into findings.

The walk is conservative in both directions, as the reference's is:
unknown names and the results of calls it cannot see into are untainted
(a false positive costs trust; a miss is caught at run time by the
``SYNCS`` counter and PyTorch's sync debug mode), and every finding can be
suppressed inline with ``# lint: host-ok(reason)``.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

SUPPRESS_RE = re.compile(r"#\s*lint:\s*host-ok\(([^)#]*)\)")

# annotation names whose values hold tensors (a parameter so annotated is
# a device value): torch.Tensor, the pool state, the model's and the
# trainer's parameter trees and the optimizer's state
TENSOR_TYPES = {"Tensor", "Pool", "Params", "Tree", "AdamState"}
# attribute names that denote device-resident state in the port whatever
# holds them: the pools' stack and a pool's leaves. The reference R5's
# other names (``counters``, ``state``, ``cache``, ``hand``, ``times``,
# ``stats``) also name host bookkeeping in the port (``Engine.counters``,
# ``Request.state``, ``SegmentView.times``), so they are device values
# only on a device base (``pool.counters`` of a ``Pool``).
DEVICE_ATTRS = {"pools", "cfree", "gfree", "pfree", "meta", "activity"}
# host dicts where a string indexes them (``self.counters["steps"]``):
# device counter vectors take named integer constants (rule R3)
HOST_DICT_ATTRS = {"counters", "stats"}
# metadata of a tensor: host values, no sync
STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                "requires_grad", "itemsize", "nbytes", "is_leaf"}
STATIC_METHODS = {"dim", "numel", "data_ptr", "element_size",
                  "is_contiguous", "size", "stride", "nelement",
                  "storage_offset", "get_device", "is_floating_point",
                  "is_complex"}
# tensor methods that read the device's values into the host
HOST_READ_METHODS = {"item", "tolist", "cpu", "numpy"}
HOST_CASTS = {"int", "float", "bool", "complex"}
# the counted reads of common/contracts.py: host copies, one sync each
COUNTED_READS = {"fetch", "fetch_packed", "item", "tolist"}
CONTRACTS_MODULE = "repro_torch.common.contracts"
# torch calls that return host objects, not tensors
TORCH_HOST_CALLS = {"torch.device", "torch.Size", "torch.finfo",
                    "torch.iinfo", "torch.get_default_dtype",
                    "torch.is_tensor", "torch.is_grad_enabled",
                    "torch.no_grad", "torch.enable_grad",
                    "torch.inference_mode", "torch.manual_seed",
                    "torch.Generator", "torch.compile", "torch.save",
                    "torch.from_numpy"}
TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.distributed.", "torch.backends.",
                       "torch.autograd.", "torch.profiler.", "torch.utils.",
                       "torch.jit.", "torch.library.", "torch.testing.",
                       "torch.multiprocessing.", "torch.set_", "torch.get_",
                       "torch.is_", "torch.use_", "torch.are_")
# torch functions and tensor methods whose result is a boolean tensor
BOOL_OPS = {"eq", "ne", "lt", "gt", "le", "ge", "isnan", "isinf",
            "isfinite", "isin", "logical_and", "logical_or", "logical_not",
            "logical_xor", "bool", "any", "all", "signbit"}
# ops whose output shape depends on the data: eager torch reads the
# device to size the result (a sync)
DATA_SHAPED_OPS = {"nonzero", "unique", "unique_consecutive",
                   "masked_select", "argwhere"}
# builtins whose result holds what their arguments hold: a container of
# them, or one of them
CONTAINERS = {"list", "tuple", "sorted", "reversed", "iter", "dict", "set"}
ELEMENTS = {"sum", "abs", "max", "min", "next"}
# methods of a container of device values that return a container
CONTAINER_METHODS = {"_asdict", "items", "values", "copy", "_replace"}
# a telemetry drain's attach calls
OBS_ATTACH = {"attach_fabric", "attach_serve"}

_TAINT_DEPTH = 3    # local-call propagation depth (module-local only)

# event categories: the raw device->host reads (R1(a), and R5's fetch
# sites but print), and the ones only a region forbids (R1(b))
RAW_READS = ("cast", "item", "tolist", "cpu", "numpy", "to_cpu", "branch",
             "assert", "print", "sync")
REGION_ONLY = ("counted", "data_shaped")


# ---------------------------------------------------------------------------
# Findings.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Finding:
    rule: str
    path: str          # posix-style path relative to the scan root's parent
    line: int
    col: int
    func: str          # enclosing function qualname, or "<module>"
    message: str
    suppressed: bool = False
    suppress_reason: str = ""

    def fingerprint(self) -> str:
        """Line-number-free identity used by the baseline ratchet: findings
        survive unrelated edits above them, and a *new* instance of an
        already-baselined (rule, func, message) in the same file still
        counts as new (baselines are multisets)."""
        key = f"{self.rule}|{self.path}|{self.func}|{self.message}"
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d

    def render(self) -> str:
        sup = f"  [host-ok: {self.suppress_reason}]" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.func}] {self.message}{sup}")


# ---------------------------------------------------------------------------
# Small AST helpers.
# ---------------------------------------------------------------------------

def dotted(node: Optional[ast.AST]) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _literal(node: Optional[ast.AST]):
    if node is None:
        return None
    try:
        return ast.literal_eval(node)
    except (ValueError, TypeError, SyntaxError, MemoryError):
        return None


# what a value holds: a host value, a container of device values (a
# dict, list, tuple or NamedTuple: its truth is its length), a device
# tensor, a boolean device tensor
NONE, SEQ, TAINT, MASK = 0, 1, 2, 3

FuncNode = (ast.FunctionDef, ast.AsyncFunctionDef)
FuncLike = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def param_names(node) -> List[str]:
    """Positional-capable parameter names in order (posonly + args)."""
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args]


def all_params(node) -> List[ast.arg]:
    a = node.args
    out = a.posonlyargs + a.args + a.kwonlyargs
    return out + [p for p in (a.vararg, a.kwarg) if p is not None]


def _type_name(node) -> Optional[str]:
    return node.attr if isinstance(node, ast.Attribute) else \
        node.id if isinstance(node, ast.Name) else None


def annotation_taint(annotation: Optional[ast.AST]) -> int:
    """What an annotated parameter holds: TAINT for a tensor
    (``torch.Tensor``, ``Optional[Tensor]``), SEQ for a container or port
    type that holds tensors (``Dict[str, Tensor]``, ``Pool``, ``Params``),
    else NONE."""
    if annotation is None:
        return NONE
    if isinstance(annotation, ast.Constant) and \
            isinstance(annotation.value, str):
        try:
            annotation = ast.parse(annotation.value, mode="eval").body
        except SyntaxError:
            return NONE
    node = annotation
    while isinstance(node, ast.Subscript) and \
            _type_name(node.value) in ("Optional", "Union"):
        node = node.slice.elts[0] if isinstance(node.slice, ast.Tuple) \
            else node.slice
    if isinstance(node, ast.BinOp):          # Tensor | None
        node = node.left
    if _type_name(node) == "Tensor":
        return TAINT
    if any(_type_name(n) in TENSOR_TYPES for n in ast.walk(annotation)):
        return SEQ
    return NONE


def contract_of(node) -> Optional[Tuple[str, int, ast.AST]]:
    """(syncs_per, fetches, decorator node) of a ``@sync_contract`` (under
    any alias) on ``node``, parsed from source, or None."""
    for dec in getattr(node, "decorator_list", ()):
        if not isinstance(dec, ast.Call):
            continue
        d = dotted(dec.func) or ""
        if d.split(".")[-1] != "sync_contract":
            continue
        per, fetches = None, 1
        if dec.args:
            v = _literal(dec.args[0])
            per = v if isinstance(v, str) else None
        if len(dec.args) > 1:
            v = _literal(dec.args[1])
            fetches = v if isinstance(v, int) else 1
        for kw in dec.keywords:
            v = _literal(kw.value)
            if kw.arg == "syncs_per" and isinstance(v, str):
                per = v
            elif kw.arg == "fetches" and isinstance(v, int):
                fetches = v
        return per or "?", fetches, dec
    return None


def is_build_call(module: "ModuleInfo", call: ast.Call,
                  fns=("load", "build", "build_all")) -> bool:
    """``_build.load(...)``/``build.build(...)``: a call of the kernels'
    build module (``repro_torch.kernels.build``) under any alias."""
    if not isinstance(call.func, ast.Attribute) or call.func.attr not in fns:
        return False
    head = module.qualify(dotted(call.func.value))
    return head == "repro_torch.kernels.build" or \
        dotted(call.func.value) in ("_build", "build")


# ---------------------------------------------------------------------------
# Regions.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Region:
    node: ast.AST                  # FunctionDef / AsyncFunctionDef
    qualname: str


@dataclasses.dataclass
class TaintEvent:
    node: ast.AST
    category: str       # RAW_READS, REGION_ONLY, "np_fetch" or "drain"
    what: str           # the site, e.g. "`.item()` on a device value"
    why: str = ""       # what it costs

    @property
    def message(self) -> str:
        return f"{self.what}: {self.why}" if self.why else self.what


class ModuleInfo:
    """One parsed source file plus everything the rules need from it."""

    def __init__(self, path, src: Optional[str] = None,
                 relpath: Optional[str] = None):
        self.path = Path(path)
        self.src = self.path.read_text() if src is None else src
        self.relpath = (relpath if relpath is not None
                        else self.path.name).replace("\\", "/")
        self.lines = self.src.splitlines()
        self.suppressions: Dict[int, str] = {}
        for i, line in enumerate(self.lines, 1):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions[i] = m.group(1).strip()
        self.tree = ast.parse(self.src, filename=str(self.path))
        self._index()
        self.contracts = [(node, qn, *c) for node, qn in self.functions
                          for c in [contract_of(node)] if c is not None]
        self.regions = [Region(node, qn)
                        for node, qn, _per, fetches, _ in self.contracts
                        if fetches == 0]
        self._events: Dict[int, List[TaintEvent]] = {}
        self._walks: Dict[int, "_TaintWalk"] = {}

    # -- indexing -----------------------------------------------------------

    def _index(self) -> None:
        self.parent: Dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parent[id(child)] = node
        self.qualnames: Dict[int, str] = {}
        self.functions: List[Tuple[ast.AST, str]] = []
        self._scope_of: Dict[int, Optional[ast.AST]] = {}
        self._local_defs: Dict[Optional[int], Dict[str, ast.AST]] = {None: {}}
        self.imports: Dict[str, str] = {}

        def visit(node, scope, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, FuncNode):
                    qn = prefix + child.name
                    self.qualnames[id(child)] = qn
                    self.functions.append((child, qn))
                    self._scope_of[id(child)] = scope
                    key = id(scope) if scope is not None else None
                    self._local_defs.setdefault(key, {})[child.name] = child
                    self._local_defs.setdefault(id(child), {})
                    visit(child, child, qn + ".")
                elif isinstance(child, ast.Lambda):
                    qn = f"{prefix}<lambda:{child.lineno}>"
                    self.qualnames[id(child)] = qn
                    self._scope_of[id(child)] = scope
                    visit(child, scope, prefix)
                elif isinstance(child, ast.ClassDef):
                    visit(child, scope, prefix + child.name + ".")
                else:
                    if isinstance(child, ast.Import):
                        for a in child.names:
                            if a.asname:
                                self.imports[a.asname] = a.name
                            else:
                                root = a.name.split(".")[0]
                                self.imports[root] = root
                    elif isinstance(child, ast.ImportFrom) and \
                            child.module and not child.level:
                        for a in child.names:
                            self.imports[a.asname or a.name] = \
                                f"{child.module}.{a.name}"
                    visit(child, scope, prefix)

        visit(self.tree, None, "")

    def qualify(self, name: Optional[str]) -> str:
        """A dotted name with its root resolved through the module's
        imports (``F.pad`` -> ``torch.nn.functional.pad``)."""
        if not name:
            return ""
        root, _, rest = name.partition(".")
        full = self.imports.get(root)
        if full is None:
            return name
        return f"{full}.{rest}" if rest else full

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parent.get(id(node))
        while cur is not None and not isinstance(cur, FuncLike):
            cur = self.parent.get(id(cur))
        return cur

    def enclosing_def(self, node: ast.AST) -> Optional[ast.AST]:
        """The nearest enclosing ``def`` (lambdas skipped)."""
        cur = self.parent.get(id(node))
        while cur is not None and not isinstance(cur, FuncNode):
            cur = self.parent.get(id(cur))
        return cur

    def func_qualname(self, node: ast.AST) -> str:
        fn = node if isinstance(node, FuncLike) else \
            self.enclosing_function(node)
        if fn is None:
            return "<module>"
        return self.qualnames.get(id(fn), "<?>")

    def get_function(self, qualname: str) -> Optional[ast.AST]:
        for node, qn in self.functions:
            if qn == qualname:
                return node
        return None

    def resolve_function(self, name: str,
                         at: ast.AST) -> Optional[ast.AST]:
        """Resolve a bare Name reference to a function defined in an
        enclosing lexical scope of this module (nearest scope wins)."""
        scope = self.enclosing_function(at)
        while True:
            key = id(scope) if scope is not None else None
            table = self._local_defs.get(key, {})
            if name in table:
                return table[name]
            if scope is None:
                return None
            scope = self._scope_of.get(id(scope))

    def in_loop(self, node: ast.AST, top: ast.AST) -> bool:
        """Whether ``node`` runs once per iteration of a host loop or a
        comprehension between it and ``top`` (a loop's own iterable, and a
        comprehension's first iterable, run once)."""
        child, cur = node, self.parent.get(id(node))
        while cur is not None and cur is not top:
            if isinstance(cur, (ast.For, ast.AsyncFor)) and \
                    child is not cur.iter:
                return True
            if isinstance(cur, ast.While):
                return True
            if isinstance(cur, COMPREHENSIONS) and \
                    child is not cur.generators[0]:
                return True
            if isinstance(cur, ast.comprehension):
                comp = self.parent.get(id(cur))
                if not (cur is comp.generators[0] and child is cur.iter):
                    return True
            child, cur = cur, self.parent.get(id(cur))
        return False

    # -- suppression / finding construction ---------------------------------

    def suppression_at(self, node: ast.AST) -> Optional[str]:
        """Inline suppression covering ``node``: same line, the closing
        line of a multi-line construct, or a comment-only line directly
        above."""
        for ln in {getattr(node, "lineno", 0),
                   getattr(node, "end_lineno", 0) or 0,
                   max(getattr(node, "lineno", 1) - 1, 1)}:
            if ln in self.suppressions:
                if ln == getattr(node, "lineno", 0) - 1:
                    text = self.lines[ln - 1].strip()
                    if not text.startswith("#"):
                        continue          # code line above: not ours
                return self.suppressions[ln]
        return None

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        reason = self.suppression_at(node)
        return Finding(
            rule=rule, path=self.relpath,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            func=self.func_qualname(node), message=message,
            suppressed=reason is not None,
            suppress_reason=reason or "")

    # -- events -------------------------------------------------------------

    def function_events(self, fn) -> List[TaintEvent]:
        """The events of ``fn``'s own body (callees and nested defs not
        entered), its parameters seeded from their annotations."""
        ev = self._events.get(id(fn))
        if ev is None:
            ev = self._events[id(fn)] = _TaintWalk(self, strict=False).run(fn)
        return ev

    def module_events(self) -> List[TaintEvent]:
        """The events of every function's own body and of the module's
        top-level statements."""
        key = id(self.tree)
        ev = self._events.get(key)
        if ev is None:
            ev = _TaintWalk(self, strict=False).run(self.tree)
            for fn, _qn in self.functions:
                ev = ev + self.function_events(fn)
            self._events[key] = ev
        return ev

    def region_walk(self, region: Region) -> "_TaintWalk":
        """The strict walk of a region: its body and the local callees it
        reaches, with every category of event."""
        walk = self._walks.get(id(region.node))
        if walk is None:
            walk = self._walks[id(region.node)] = _TaintWalk(self, strict=True)
            walk.run(region.node)
        return walk


# ---------------------------------------------------------------------------
# Device-value taint walk.
# ---------------------------------------------------------------------------

def is_structural_test(node: ast.AST) -> bool:
    """Tests that never read a tensor's values: identity against None,
    membership, isinstance / hasattr / len, and combinations thereof."""
    if isinstance(node, ast.Compare):
        return all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops)
    if isinstance(node, ast.Call):
        return dotted(node.func) in {"isinstance", "hasattr", "callable",
                                     "len", "getattr"}
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return is_structural_test(node.operand)
    if isinstance(node, ast.BoolOp):
        return all(is_structural_test(v) for v in node.values)
    return False


def obs_emission(call: ast.Call) -> Optional[str]:
    """``<recv>.record_*`` (any receiver), or ``attach_*`` on a chain that
    names ``obs``: the shape of a telemetry drain. Returns the method."""
    if not isinstance(call.func, ast.Attribute):
        return None
    attr = call.func.attr
    on_obs = "obs" in (dotted(call.func) or "").split(".")
    if attr.startswith("record_") or (on_obs and attr in OBS_ATTACH):
        return attr
    return None


def _to_cpu(call: ast.Call) -> bool:
    """``.to("cpu")``, ``.to(device="cpu")`` or
    ``.to(torch.device("cpu"))``."""
    cands = list(call.args[:1]) + [kw.value for kw in call.keywords
                                   if kw.arg == "device"]
    for c in cands:
        if isinstance(c, ast.Call) and (dotted(c.func) or "").endswith(
                "device") and c.args:
            c = c.args[0]
        if isinstance(c, ast.Constant) and isinstance(c.value, str) and \
                c.value.split(":")[0] == "cpu":
            return True
    return False


def _to_device(call: ast.Call) -> bool:
    """``.to(dev)``/``.to(device=...)``: a move to a named device (a dtype,
    ``torch.float32``, names none)."""
    if any(kw.arg == "device" for kw in call.keywords):
        return True
    if not call.args:
        return False
    a = call.args[0]
    return not (isinstance(a, ast.Attribute) and
                (dotted(a) or "").startswith("torch."))


_READ_WHAT = {"item": "`.item()`", "tolist": "`.tolist()`",
              "cpu": "`.cpu()`", "numpy": "`.numpy()`",
              "to_cpu": "`.to(\"cpu\")`"}
_HIDDEN = ("a hidden device->host sync that common/contracts.py's SYNCS "
           "never counts")
_SIZED = "the output's size is read from the device (a sync in eager torch)"



class _TaintWalk:
    """One walk over a function (or the module body). ``strict``: a
    region's walk, which enters local callees and nested defs with the
    caller's taint and reports in them; otherwise a function's own body,
    callees entered silently for their return value only."""

    def __init__(self, module: ModuleInfo, strict: bool):
        self.module = module
        self.strict = strict
        self.events: List[TaintEvent] = []
        self.visited: List[ast.AST] = []
        self._callstack: List[int] = []
        self._memo: Dict[tuple, int] = {}
        self._silent = 0
        self._ret: List[int] = []

    def run(self, node) -> List[TaintEvent]:
        if isinstance(node, ast.Module):
            self._ret.append(NONE)
            self._block(node.body, {}, 0)
            self._ret.pop()
        else:
            self._walk_func(node, self._seed(node), 0)
        seen, out = set(), []
        for ev in self.events:
            key = (getattr(ev.node, "lineno", 0),
                   getattr(ev.node, "col_offset", 0), ev.category)
            if key not in seen:
                seen.add(key)
                out.append(ev)
        self.events = out
        return out

    @staticmethod
    def _seed(fn) -> dict:
        return {p.arg: annotation_taint(p.annotation) for p in all_params(fn)}

    def _emit(self, node, category, what, why=_HIDDEN):
        if not self._silent:
            self.events.append(TaintEvent(node, category, what, why))

    # -- function / statement walking ---------------------------------------

    def _walk_func(self, node, env, depth) -> int:
        if not self._silent and node not in self.visited:
            self.visited.append(node)
        self._ret.append(NONE)
        if isinstance(node, ast.Lambda):
            self._ret[-1] = self._expr(node.body, env, depth)
        else:
            self._block(node.body, env, depth)
        return self._ret.pop()

    def _block(self, stmts, env, depth):
        for st in stmts:
            self._stmt(st, env, depth)

    def _bind(self, target, taint, env, depth):
        if isinstance(target, ast.Name):
            env[target.id] = taint
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind(el, TAINT if taint else NONE, env, depth)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, taint, env, depth)
        elif isinstance(target, ast.Subscript):
            self._expr(target, env, depth)      # a masked store reads too

    def _assign(self, target, value, env, depth):
        if isinstance(target, (ast.Tuple, ast.List)) and \
                isinstance(value, (ast.Tuple, ast.List)) and \
                len(target.elts) == len(value.elts) and \
                not any(isinstance(e, ast.Starred) for e in target.elts):
            for t, v in zip(target.elts, value.elts):
                self._assign(t, v, env, depth)
            return
        self._bind(target, self._expr(value, env, depth), env, depth)

    def _iter_bind(self, target, it, env, depth):
        """Bind a loop target to the elements of ``it``: enumerate's index,
        a dict's keys and range's values are host ints; zip pairs up."""
        if isinstance(it, ast.Call) and isinstance(target, ast.Tuple):
            name = it.func.id if isinstance(it.func, ast.Name) else None
            attr = it.func.attr if isinstance(it.func, ast.Attribute) \
                else None
            if name == "enumerate" and it.args and len(target.elts) == 2:
                self._bind(target.elts[0], NONE, env, depth)
                self._iter_bind(target.elts[1], it.args[0], env, depth)
                return
            if name == "zip" and len(it.args) == len(target.elts) and \
                    not it.keywords:
                for t, a in zip(target.elts, it.args):
                    self._iter_bind(t, a, env, depth)
                return
            if attr == "items" and len(target.elts) == 2:
                t = self._expr(it.func.value, env, depth)
                self._bind(target.elts[0], NONE, env, depth)
                self._bind(target.elts[1], TAINT if t else NONE, env, depth)
                return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) and \
                it.func.id == "range":
            self._expr(it, env, depth)
            self._bind(target, NONE, env, depth)
            return
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute) \
                and it.func.attr == "keys":
            self._expr(it, env, depth)
            self._bind(target, NONE, env, depth)
            return
        t = self._expr(it, env, depth)
        self._bind(target, TAINT if t else NONE, env, depth)

    def _test(self, node, test, env, depth, word: str):
        t = self._expr(test, env, depth)
        if t >= TAINT and not is_structural_test(test):
            cat = "assert" if word == "assert" else "branch"
            self._emit(node, cat, f"Python `{word}` on a device value",
                       f"`bool()` of a tensor, {_HIDDEN}")

    def _stmt(self, st, env, depth):
        if isinstance(st, ast.Assign):
            for tgt in st.targets:
                self._assign(tgt, st.value, env, depth)
        elif isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._assign(st.target, st.value, env, depth)
        elif isinstance(st, ast.AugAssign):
            t = self._expr(st.value, env, depth)
            if isinstance(st.target, ast.Name):
                env[st.target.id] = max(env.get(st.target.id, NONE), t)
            else:
                self._expr(st.target, env, depth)
        elif isinstance(st, (ast.If, ast.While)):
            self._test(st, st.test, env, depth,
                       "if" if isinstance(st, ast.If) else "while")
            self._block(st.body, env, depth)
            self._block(st.orelse, env, depth)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._iter_bind(st.target, st.iter, env, depth)
            self._block(st.body, env, depth)
            self._block(st.orelse, env, depth)
        elif isinstance(st, ast.Assert):
            self._test(st, st.test, env, depth, "assert")
            self._expr(st.msg, env, depth)
        elif isinstance(st, FuncNode):
            env[st.name] = NONE
            if self.strict:
                # a def inside a region runs inside it when called: walk it
                # over the closure's taint
                env2 = dict(env)
                env2.update(self._seed(st))
                self._walk_func(st, env2, depth)
        elif isinstance(st, ast.ClassDef):
            pass
        elif isinstance(st, ast.Return):
            if st.value is not None:
                t = self._expr(st.value, env, depth)
                self._ret[-1] = max(self._ret[-1], t)
        elif isinstance(st, ast.Expr):
            self._expr(st.value, env, depth)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._expr(item.context_expr, env, depth)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, NONE, env, depth)
            self._block(st.body, env, depth)
        elif isinstance(st, ast.Try) or type(st).__name__ == "TryStar":
            self._block(st.body, env, depth)
            for h in st.handlers:
                if h.name:
                    env[h.name] = NONE
                self._block(h.body, env, depth)
            self._block(st.orelse, env, depth)
            self._block(st.finalbody, env, depth)
        else:
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self._expr(child, env, depth)
                elif isinstance(child, ast.stmt):
                    self._stmt(child, env, depth)

    # -- expression taint ---------------------------------------------------

    def _expr(self, node, env, depth) -> int:
        if node is None or isinstance(node, ast.Constant):
            return NONE
        if isinstance(node, ast.Name):
            return env.get(node.id, NONE)
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value, env, depth)
            if node.attr in STATIC_ATTRS:
                return NONE
            if node.attr in DEVICE_ATTRS:
                return TAINT
            return TAINT if base else NONE
        if isinstance(node, ast.Subscript):
            sl = node.slice
            if isinstance(node.value, ast.Attribute) and \
                    node.value.attr in HOST_DICT_ATTRS and \
                    isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                self._expr(node.value.value, env, depth)
                return NONE
            tv = self._expr(node.value, env, depth)
            ts = self._expr(sl, env, depth)
            if tv >= TAINT and ts == MASK:
                self._emit(node, "data_shaped",
                           "indexing with a boolean device mask", _SIZED)
            if tv == SEQ:               # an element, or a slice of a list
                return SEQ if isinstance(sl, ast.Slice) else TAINT
            return tv if tv else (TAINT if ts >= TAINT else NONE)
        if isinstance(node, ast.Call):
            return self._call(node, env, depth)
        if isinstance(node, ast.Compare):
            ts = [self._expr(c, env, depth)
                  for c in [node.left] + node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return NONE
            return MASK if max(ts) >= TAINT else NONE
        if isinstance(node, ast.UnaryOp):
            t = self._expr(node.operand, env, depth)
            if isinstance(node.op, ast.Not):
                return MASK if t >= TAINT else NONE
            return t
        if isinstance(node, ast.BoolOp):
            t = max(self._expr(v, env, depth) for v in node.values)
            return MASK if t >= TAINT else t
        if isinstance(node, ast.BinOp):
            a = self._expr(node.left, env, depth)
            b = self._expr(node.right, env, depth)
            if MASK in (a, b) and isinstance(
                    node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
                return MASK
            return TAINT if max(a, b) >= TAINT else max(a, b)
        if isinstance(node, ast.IfExp):
            self._test(node, node.test, env, depth, "if")
            return max(self._expr(node.body, env, depth),
                       self._expr(node.orelse, env, depth))
        if isinstance(node, ast.Lambda):
            env2 = dict(env)
            env2.update(self._seed(node))
            self._expr(node.body, env2, depth)
            return NONE
        if isinstance(node, COMPREHENSIONS):
            env2 = dict(env)
            for gen in node.generators:
                self._iter_bind(gen.target, gen.iter, env2, depth)
                for cond in gen.ifs:
                    self._test(cond, cond, env2, depth, "if")
            if isinstance(node, ast.DictComp):
                self._expr(node.key, env2, depth)
                return SEQ if self._expr(node.value, env2, depth) else NONE
            return SEQ if self._expr(node.elt, env2, depth) else NONE
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return SEQ if any([self._expr(e, env, depth)
                               for e in node.elts]) else NONE
        if isinstance(node, ast.Dict):
            parts = [self._expr(k, env, depth) for k in node.keys
                     if k is not None]
            parts += [self._expr(v, env, depth) for v in node.values]
            return SEQ if any(parts) else NONE
        if isinstance(node, ast.NamedExpr):
            t = self._expr(node.value, env, depth)
            self._bind(node.target, t, env, depth)
            return t
        if isinstance(node, ast.Starred):
            return self._expr(node.value, env, depth)
        if isinstance(node, ast.JoinedStr):
            for c in ast.iter_child_nodes(node):
                self._expr(c, env, depth)
            return NONE
        # generic: Slice / FormattedValue / Await ...
        return max([self._expr(c, env, depth)
                    for c in ast.iter_child_nodes(node)
                    if isinstance(c, ast.expr)] + [NONE])

    def _counted(self, node: ast.Call, q: str) -> Optional[str]:
        """The counted read a call makes, or None: ``contracts.fetch`` and
        its siblings under any alias, or ``self._fetch``."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "_fetch":
            return f"{dotted(f) or '._fetch'}"
        head, _, last = q.rpartition(".")
        if last in COUNTED_READS and (head == CONTRACTS_MODULE or (
                isinstance(f, ast.Attribute) and
                dotted(f.value) == "contracts")):
            return f"contracts.{last}"
        return None

    def _call(self, node: ast.Call, env, depth) -> int:
        f = node.func
        d = dotted(f) or ""
        q = self.module.qualify(d)
        name = f.id if isinstance(f, ast.Name) else None
        attr = f.attr if isinstance(f, ast.Attribute) else None
        recv = self._expr(f.value, env, depth) if attr else NONE
        arg_t = [self._expr(a, env, depth) for a in node.args]
        kw_t = [self._expr(kw.value, env, depth) for kw in node.keywords]
        held = max(arg_t + kw_t + [NONE])      # what the arguments hold
        on_dev = recv >= TAINT                 # a tensor method

        if obs_emission(node):
            for a, t in zip(list(node.args) + [k.value for k in
                                               node.keywords],
                            arg_t + kw_t):
                if t:
                    self._emit(a, "drain", attr, "")
            return NONE
        counted = self._counted(node, q)
        if counted:
            self._emit(node, "counted", f"`{counted}`",
                       "a counted device->host read")
            return NONE
        if q == "torch.cuda.synchronize" or attr == "synchronize":
            self._emit(node, "sync", f"`{d or '.synchronize'}()`",
                       f"waits for the card on the host, {_HIDDEN}")
            return NONE
        if name in HOST_CASTS and held >= TAINT and name not in env:
            self._emit(node, "cast", f"`{name}()` on a device value")
            return NONE
        if name == "print" and held:
            self._emit(node, "print", "`print` of a device value",
                       f"formats it on the host, {_HIDDEN}")
            return NONE
        if attr in HOST_READ_METHODS and on_dev:
            self._emit(node, attr, f"{_READ_WHAT[attr]} on a device value")
            return NONE
        if attr == "to" and _to_cpu(node):
            if on_dev:
                self._emit(node, "to_cpu",
                           f"{_READ_WHAT['to_cpu']} on a device value")
            return NONE
        if attr in STATIC_METHODS and on_dev:
            return NONE
        op = attr if on_dev else (q.rpartition(".")[2]
                                  if q.startswith("torch.") else None)
        if op is not None:
            self._data_shaped(node, op, on_dev, env, depth)
        root = q.split(".")[0]
        if root == "numpy":
            if d.split(".")[-1] in ("asarray", "array") and held:
                self._emit(node, "np_fetch", f"`{d}` of a device value", "")
            return NONE
        if root == "torch":
            if q in TORCH_HOST_CALLS or q.startswith(TORCH_HOST_PREFIXES):
                return NONE
            return MASK if q.rpartition(".")[2] in BOOL_OPS else TAINT
        if on_dev:
            return MASK if attr in BOOL_OPS else TAINT
        if recv == SEQ:
            return SEQ if attr in CONTAINER_METHODS else TAINT
        if attr == "cuda" or (attr == "to" and _to_device(node)):
            return TAINT                # an upload: a tensor on the card
        if name in CONTAINERS:
            return SEQ if held else NONE
        if name in ELEMENTS:
            return TAINT if held else NONE
        if name is not None and depth < _TAINT_DEPTH:
            fn = self.module.resolve_function(name, node)
            if fn is not None and id(fn) not in self._callstack:
                return self._enter(fn, node, arg_t, kw_t, depth)
        return NONE

    def _data_shaped(self, node, op, recv: bool, env, depth):
        """Ops whose output shape depends on the data (R1(b))."""
        what = None
        n_args = len(node.args) + (1 if recv else 0)
        if op in DATA_SHAPED_OPS:
            what = f"`{op}`"
        elif op == "where" and n_args == 1 and not node.keywords:
            what = "`torch.where(cond)` with one argument"
        elif op == "repeat_interleave":
            kws = {kw.arg: kw.value for kw in node.keywords}
            if "output_size" not in kws:
                i = 0 if recv else 1
                reps = kws.get("repeats", node.args[i]
                               if len(node.args) > i else None)
                if reps is not None and \
                        self._expr(reps, env, depth) >= TAINT:
                    what = "`repeat_interleave` with tensor repeats and no " \
                           "`output_size`"
        if what:
            self._emit(node, "data_shaped", what, _SIZED)

    def _enter(self, fn, node: ast.Call, arg_t, kw_t, depth) -> int:
        """One-module-deep local call: the callee walked over the taint of
        the call's arguments; returns the taint of what it returns."""
        env2 = {}
        pos = param_names(fn)
        has_star = any(isinstance(a, ast.Starred) for a in node.args)
        for p in all_params(fn):
            env2[p.arg] = TAINT if has_star else \
                annotation_taint(p.annotation)
        if not has_star:
            for i, t in enumerate(arg_t):
                if i < len(pos):
                    env2[pos[i]] = t
        for kw, t in zip(node.keywords, kw_t):
            if kw.arg is not None:
                env2[kw.arg] = t
        key = (id(fn), tuple(sorted(env2.items())), self.strict)
        if key in self._memo:
            return self._memo[key]
        self._memo[key] = NONE          # recursion guard
        self._callstack.append(id(fn))
        if not self.strict:
            self._silent += 1
        try:
            out = self._walk_func(fn, env2, depth + 1)
        finally:
            self._callstack.pop()
            if not self.strict:
                self._silent -= 1
        self._memo[key] = out
        return out


def iter_calls(tree: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node
