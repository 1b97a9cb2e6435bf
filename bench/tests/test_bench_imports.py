"""Nothing of JAX or the JAX package (``repro``) loads in a run, compared
by whole top-level module names (``repro_torch`` is not ``repro``); the
reference loads nothing of the program either."""
from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest

from tiny import REPO

RUN = """
import sys
sys.path[:0] = [{tests!r}]
import tiny
from pathlib import Path
from bench.harness import cell
tiny.run(tiny.make(Path({root!r})), {workload!r}, trace={trace})
mods = cell.forbidden_modules()
print("FORBIDDEN", mods)
print("PORT", "repro_torch" in sys.modules)
"""


@pytest.mark.parametrize("workload,trace", [
    ("deepseek-7b.serve.oversub", True),
    ("minicpm3-4b.serve.oversub", False), ("deepseek-7b.train.s2k", True)])
def test_a_run_loads_no_jax(tmp_path, workload, trace):
    code = RUN.format(tests=str(REPO / "bench" / "tests"),
                      root=str(tmp_path), workload=workload, trace=trace)
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout
    assert "PORT True" in p.stdout


def test_forbidden_is_by_whole_top_level_name():
    from bench.harness import cell
    saved = dict(sys.modules)
    try:
        for name in ("repro_torch.x", "reprox", "jaxtyping"):
            sys.modules.setdefault(name, object())
        assert not [m for m in cell.forbidden_modules()
                    if m in ("repro_torch.x", "reprox", "jaxtyping")]
        sys.modules["repro.core"] = object()
        assert "repro.core" in cell.forbidden_modules()
    finally:
        for k in list(sys.modules):
            if k not in saved:
                del sys.modules[k]


def test_reference_imports_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(REPO)!r})
        import bench.reference.model, bench.reference.train
        import bench.reference.quant
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("repro_torch", "repro", "jax",
                                      "jaxlib")]
        print("BAD", bad)
    """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert "BAD []" in p.stdout
