"""R2: recompile hazards.

The port compiles nothing per call: there is no ``torch.compile``, no
``torch.jit`` and no CUDA graph on its paths, and each kernel library is
built once by ``kernels/build.py``. R2 checks the two places where a
per-call value could force a compile:

  * callables wrapped by ``torch.compile`` (a decorator, or at a call
    site): mutable default arguments (a shared cell the compiled graph
    guards on), and per-call-varying literals (f-strings, dict, list and
    set displays) passed as keyword arguments at a call through a
    compiled name: a non-tensor argument is a guard, so every distinct
    value compiles a fresh graph, as the reference's static kwargs do;
  * ``_build.load`` or ``_build.build`` called with a name that is not a
    string literal of ``build.SOURCES``: each distinct name is a fresh
    ``nvcc`` run.

``torch.compile`` itself is allowed.
"""
import ast
from typing import List, Optional, Tuple

from repro_torch.analysis import core

RULE = "R2"
TITLE = "recompile hazard (compiled callable / kernel build name)"

# kernels/build.py's SOURCES (the lint keeps its own copy: it imports
# nothing of the port; tests hold the two equal)
SOURCES = ("qpack_fused", "qpack_fixed", "kvc_attn", "flash_attn")

_MUTABLE_CALLS = {"dict", "list", "set", "bytearray"}
_VARYING = (ast.JoinedStr, ast.Dict, ast.List, ast.Set, ast.DictComp,
            ast.ListComp, ast.SetComp)


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _MUTABLE_CALLS
    return False


def _is_compile(module, node) -> bool:
    if isinstance(node, ast.Call):
        node = node.func
    return module.qualify(core.dotted(node)) == "torch.compile"


def _iter_defaults(args: ast.arguments) -> List[Tuple[str, Optional[ast.AST]]]:
    pos = args.posonlyargs + args.args
    pairs: List[Tuple[str, Optional[ast.AST]]] = []
    for param, default in zip(pos[len(pos) - len(args.defaults):],
                              args.defaults):
        pairs.append((param.arg, default))
    for param, default in zip(args.kwonlyargs, args.kw_defaults):
        pairs.append((param.arg, default))
    return pairs


def check(module: core.ModuleInfo) -> List[core.Finding]:
    out: List[core.Finding] = []
    compiled = {}                   # function node -> qualname
    names = set()                   # names bound to compiled callables
    for node, qn in module.functions:
        if any(_is_compile(module, d) for d in node.decorator_list):
            compiled[id(node)] = (node, qn)
            names.add(node.name)
    for call in core.iter_calls(module.tree):
        if _is_compile(module, call) and not any(
                call is d for n, _ in module.functions
                for d in n.decorator_list) and call.args and \
                isinstance(call.args[0], ast.Name):
            fn = module.resolve_function(call.args[0].id, call)
            if fn is not None:
                compiled[id(fn)] = (fn, module.qualnames[id(fn)])
            parent = module.parent.get(id(call))
            if isinstance(parent, ast.Assign):
                names.update(t.id for t in parent.targets
                             if isinstance(t, ast.Name))

    for node, qn in compiled.values():
        for param, default in _iter_defaults(node.args):
            if default is not None and _is_mutable_literal(default):
                out.append(module.finding(
                    RULE, default,
                    f"mutable default `{param}=...` on compiled `{qn}` — "
                    f"a shared cell the compiled graph guards on; default "
                    f"to None"))

    for call in core.iter_calls(module.tree):
        if isinstance(call.func, ast.Name) and call.func.id in names:
            for kw in call.keywords:
                if isinstance(kw.value, _VARYING):
                    out.append(module.finding(
                        RULE, kw.value,
                        f"per-call-varying literal passed as `{kw.arg}` to "
                        f"compiled `{call.func.id}` — a non-tensor argument "
                        f"is a guard: every distinct value compiles a fresh "
                        f"graph"))
        if core.is_build_call(module, call, ("load", "build")):
            arg = call.args[0] if call.args else None
            lit = arg.value if isinstance(arg, ast.Constant) and \
                isinstance(arg.value, str) else None
            if lit in SOURCES:
                continue
            what = "a name that is not a string literal" if lit is None \
                else f"\"{lit}\", not a source of build.SOURCES"
            out.append(module.finding(
                RULE, call,
                f"`{core.dotted(call.func)}` of {what} — each distinct name "
                f"is a fresh nvcc run; name a source of build.SOURCES "
                f"literally"))
    return out
