"""R4: kernel launch hygiene (the counterpart of the reference's literal
``interpret=`` and BlockSpec arity checks).

The port has no fallback: a CUDA tensor launches its kernel or raises,
and the route is decided by the tensor's device through the resolvers
(``models/layers.py::resolve_attn_impl``, ``core/compressor.py::
resolve_impl`` and ``resolve_quantize_impl``), never at a call site.
Four classes of launch-site mistake are visible in the source:

  (a) **a literal route**: a string other than ``"auto"`` passed as
      ``impl``/``attn_impl``/``compress_impl``/``quantize_impl``; or a
      call of a kernel's ``*_plain`` version (a function of
      ``repro_torch.kernels``) outside ``kernels/`` and the resolvers' own
      modules, in a function that makes no route decision (a resolver's
      call or a device test);
  (b) **a silent fallback**: a ``try`` whose body builds or launches a
      kernel (``_build.load``/``build``, a library getter ``*_lib()``, a
      ``_launch*``) and whose handler calls a ``*_plain`` function or
      returns without re-raising;
  (c) **a dropped launch error**: a ctypes launch whose returned
      ``cudaError`` never reaches ``_build.check_launch``;
  (d) **arity**: the ``argtypes`` list given to ``_build.load(name, {fn:
      [...]})`` against the positional arguments at each ``lib.fn(...)``/
      ``_lib().fn(...)`` call in the module (module-local names bound to
      list displays resolved). A wrong count raises only at launch on the
      card; the lint catches it on any machine.
"""
import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis import core

RULE = "R4"
TITLE = "kernel launch hygiene (literal route / fallback / launch error / " \
    "arity)"

ROUTE_KWARGS = {"impl", "attn_impl", "compress_impl", "quantize_impl"}
RESOLVERS = {"resolve_attn_impl", "resolve_impl", "resolve_quantize_impl"}
KERNELS_PKG = "repro_torch.kernels."
_GETTER = re.compile(r"^_?\w*lib$")


def _last(node) -> str:
    return (core.dotted(node) or "").rpartition(".")[2]


def _getters(module) -> Dict[str, ast.Call]:
    """Library getters: module functions that return ``_build.load(...)``
    (name -> the load call)."""
    out = {}
    for node, qn in module.functions:
        if "." in qn:
            continue
        for call in core.iter_calls(node):
            if core.is_build_call(module, call, {"load"}):
                out[node.name] = call
    return out


def _list_len(module, node, scope) -> Optional[int]:
    """The length of a list/tuple display, or of a name bound to one in
    ``scope`` (a function) or at module level."""
    if isinstance(node, (ast.List, ast.Tuple)):
        return len(node.elts)
    if isinstance(node, ast.Name):
        for where in (scope, module.tree):
            if where is None:
                continue
            for st in ast.walk(where):
                if isinstance(st, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == node.id
                        for t in st.targets) and \
                        isinstance(st.value, (ast.List, ast.Tuple)):
                    return len(st.value.elts)
    return None


def _signatures(module, getters) -> Dict[str, Dict[str, int]]:
    """getter -> {C function: argtypes count} from its load call."""
    out: Dict[str, Dict[str, int]] = {}
    for g, load in getters.items():
        table: Dict[str, int] = {}
        if len(load.args) > 1 and isinstance(load.args[1], ast.Dict):
            scope = module.enclosing_def(load)
            for k, v in zip(load.args[1].keys, load.args[1].values):
                n = _list_len(module, v, scope)
                if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                        and n is not None:
                    table[k.value] = n
        out[g] = table
    return out


def _launches(module, getters) -> List[Tuple[ast.Call, str, str]]:
    """(call, getter, C function) of every ctypes launch: ``G().fn(...)``,
    ``lib.fn(...)`` with ``lib = G()``, and ``fn(...)`` with
    ``fn = G().fn`` (tuple assignments included) in the same function."""
    out = []
    for fn_node, _qn in module.functions:
        libs: Dict[str, str] = {}
        funcs: Dict[str, Set[Tuple[str, str]]] = {}
        for st in ast.walk(fn_node):
            if not isinstance(st, ast.Assign):
                continue
            pairs = []
            for t in st.targets:
                if isinstance(t, ast.Name):
                    pairs.append((t, st.value))
                elif isinstance(t, ast.Tuple) and \
                        isinstance(st.value, ast.Tuple) and \
                        len(t.elts) == len(st.value.elts):
                    pairs.extend(zip(t.elts, st.value.elts))
            for t, v in pairs:
                if not isinstance(t, ast.Name):
                    continue
                g = _getter_call(v, getters)
                if g:
                    libs[t.id] = g
                elif isinstance(v, ast.Attribute):
                    g = _getter_call(v.value, getters)
                    if g:
                        funcs.setdefault(t.id, set()).add((g, v.attr))
        for call in core.iter_calls(fn_node):
            if module.enclosing_def(call) is not fn_node:
                continue
            f = call.func
            if isinstance(f, ast.Attribute):
                g = _getter_call(f.value, getters) or (
                    libs.get(f.value.id) if isinstance(f.value, ast.Name)
                    else None)
                if g:
                    out.append((call, g, f.attr))
            elif isinstance(f, ast.Name) and f.id in funcs:
                for g, name in sorted(funcs[f.id]):
                    out.append((call, g, name))
    return out


def _getter_call(node, getters) -> Optional[str]:
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and \
            node.func.id in getters and not node.args:
        return node.func.id
    return None


def _checked(module, call: ast.Call) -> bool:
    """The launch's error reaches ``check_launch``: passed to it directly,
    or bound to a name that is."""
    parent = module.parent.get(id(call))
    if isinstance(parent, ast.Call) and _last(parent.func) == \
            "check_launch" and parent.args and parent.args[0] is call:
        return True
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1 and \
            isinstance(parent.targets[0], ast.Name):
        name = parent.targets[0].id
        scope = module.enclosing_def(call) or module.tree
        return any(_last(c.func) == "check_launch" and c.args and
                   isinstance(c.args[0], ast.Name) and c.args[0].id == name
                   for c in core.iter_calls(scope))
    return False


def _is_plain_kernel(module, call: ast.Call) -> bool:
    d = core.dotted(call.func) or ""
    return d.endswith("_plain") and \
        module.qualify(d).startswith(KERNELS_PKG)


def _routes(module, fn) -> bool:
    """Whether ``fn`` decides a route: calls a resolver or tests a device
    (``.is_cuda``, a comparison with "cuda"/"cpu", ``_device_of``/
    ``_on_card``)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and _last(node.func) in \
                RESOLVERS | {"_device_of", "_on_card"}:
            return True
        if isinstance(node, ast.Attribute) and node.attr == "is_cuda":
            return True
        if isinstance(node, ast.Compare) and any(
                isinstance(c, ast.Constant) and c.value in ("cuda", "cpu")
                for c in [node.left] + node.comparators):
            return True
    return False


def _builds_or_launches(module, body, getters) -> Optional[str]:
    for st in body:
        for call in core.iter_calls(st):
            last = _last(call.func)
            if core.is_build_call(module, call):
                return core.dotted(call.func)
            if isinstance(call.func, ast.Name) and (
                    call.func.id in getters or _GETTER.match(call.func.id)):
                return f"{call.func.id}()"
            if last.startswith("_launch"):
                return core.dotted(call.func)
    return None


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []
    rel = "/" + module.relpath
    in_kernels = "/kernels/" in rel
    resolver_module = any(qn in RESOLVERS for _n, qn in module.functions)
    getters = _getters(module)

    for call in core.iter_calls(module.tree):
        # (a) literal routes
        for kw in call.keywords:
            v = kw.value
            if kw.arg in ROUTE_KWARGS and isinstance(v, ast.Constant) and \
                    isinstance(v.value, str) and v.value != "auto":
                out.append(module.finding(
                    RULE, v,
                    f"literal `{kw.arg}=\"{v.value}\"` at a call site — the "
                    f"route is the tensor's device's, decided by the "
                    f"resolvers (\"auto\"), never a call-site constant"))
        if not in_kernels and not resolver_module and \
                _is_plain_kernel(module, call):
            fn = module.enclosing_def(call)
            if fn is None or not _routes(module, fn):
                out.append(module.finding(
                    RULE, call,
                    f"`{core.dotted(call.func)}` called where no resolver "
                    f"or device test chose it — a CUDA tensor would take "
                    f"the plain version, which the port forbids"))

    # (b) silent fallbacks
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Try):
            continue
        what = _builds_or_launches(module, node.body, getters)
        if what is None:
            continue
        for h in node.handlers:
            plain = [c for c in core.iter_calls(h)
                     if (core.dotted(c.func) or "").endswith("_plain")]
            reraises = any(isinstance(n, ast.Raise) for n in ast.walk(h))
            if plain or not reraises:
                how = (f"calls `{core.dotted(plain[0].func)}`" if plain
                       else "returns without re-raising")
                out.append(module.finding(
                    RULE, h,
                    f"silent fallback: the handler of a `try` around "
                    f"`{what}` {how} — the port has no fallback: a CUDA "
                    f"tensor launches its kernel or raises"))

    # (c) dropped launch errors and (d) arity
    sigs = _signatures(module, getters)
    for call, g, name in _launches(module, getters):
        if not _checked(module, call):
            out.append(module.finding(
                RULE, call,
                f"the cudaError that `{name}` returns never reaches "
                f"`_build.check_launch` — a failed launch would pass "
                f"silently"))
        want = sigs.get(g, {}).get(name)
        if want is None or call.keywords or any(
                isinstance(a, ast.Starred) for a in call.args):
            continue
        if len(call.args) != want:
            out.append(module.finding(
                RULE, call,
                f"`{name}` is called with {len(call.args)} argument(s) but "
                f"its argtypes in `{g}()` list {want} — a wrong count "
                f"raises only at launch on the card"))
    return out
