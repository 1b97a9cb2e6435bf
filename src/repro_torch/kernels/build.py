"""Build and load the port's CUDA kernels: nvcc compiles each source in
``csrc/`` for sm_90a into a shared library with a plain C interface, cached
under ``build/repro_torch/`` by a hash of the source, the shared headers
and the flags, and
``ctypes`` loads it. Nothing is built when a module is imported; a wrapper
builds its library at its first launch, and ``build_all`` starts one nvcc
per source at once (what ``chip_smoke.py`` does first).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("qpack_fused", "qpack_fixed", "kvc_attn", "flash_attn")
# -Xptxas -v puts each kernel's registers, shared memory and spills in the
# build log; never --use_fast_math (division and exp must round as the
# plain versions do).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# the compression kernels are held bit for bit to their plain versions: no
# fused multiply-add there, so every product rounds on its own
EXACT = ("qpack_fused", "qpack_fixed")


def flags(name: str) -> list:
    return NVCC_FLAGS + (["--fmad=false"] if name in EXACT else [])


_libs: dict = {}


def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (the toolkit's default prefix)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, the headers in
    ``csrc/`` (``wgmma.cuh``) and the flags."""
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(flags(name)).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(name: str, out: Path, tmp, proc, t0: float) -> dict:
    if proc is None:
        return {"name": name, "path": str(out), "seconds": 0.0, "log": ""}
    _, err = proc.communicate()
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):\n"
                           f"{err}")
    os.replace(tmp, out)
    return {"name": name, "path": str(out), "seconds": secs, "log": err}


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` (cached). Returns its library path, the
    build seconds (0 when cached) and the compiler's log."""
    t0 = time.perf_counter()
    return _finish(name, *_start(name), t0)


def build_all(names=SOURCES) -> list:
    """Compile every source at once, one nvcc process each."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names]
    return [_finish(n, out, tmp, proc, t0) for n, out, tmp, proc in started]


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built at first use, with each C
    function's argument types set (every function returns a cudaError_t as
    an int). Pointers and streams must be ``c_void_p``: ctypes would pass a
    bare Python int as a 32-bit int."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name)["path"])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
