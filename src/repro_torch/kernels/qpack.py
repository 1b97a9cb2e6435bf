"""Fused demote / promote kernels (CUDA, ``csrc/qpack_fused.cu``), their
plain PyTorch versions, and the wrappers the compressor calls.

Replaces the JAX package's TPU kernels ``kernels/qpack.py::
qpack_fused_encode_2d`` and ``qpack_fused_decode_2d`` (with their padding
wrappers in ``kernels/ops.py``). Both are memory-bound single passes; the
source note in the ``.cu`` file gives the bound and the design.

The wrappers dispatch on the tensor's device: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs the plain version. There is no
fallback from one to the other. ``fused_encode_launches`` and
``fused_decode_launches`` count kernel launches (not plain-version calls).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.common.utils import f32_to_bytes
from repro_torch.core.bitpack import RATE_4BIT, RATE_8BIT, RATE_RAW, RATE_ZERO

fused_encode_launches = 0
fused_decode_launches = 0

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "qpack_fused.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -Xptxas -v puts each kernel's registers, shared memory and spills in the
# build log; never --use_fast_math (division must round to nearest).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


# ---------------------------------------------------------------------------
# Plain versions: formula for formula the TPU kernel bodies
# (_fused_encode_kernel / _fused_decode_kernel).
# ---------------------------------------------------------------------------

def _quantize_rows(xf: torch.Tensor, bits: int):
    qmax = float(2 ** (bits - 1) - 1)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    c = torch.tensor(1.0 / qmax, dtype=torch.float32, device=xf.device)
    scale = torch.where(amax > 0, amax * c, torch.ones_like(amax))
    recip = torch.ones_like(scale) / scale
    q = torch.clamp(torch.round(xf * recip), -qmax - 1, qmax).to(torch.int32)
    return q, scale


def fused_encode_plain(x: torch.Tensor, *, tol4: float = 0.10,
                       tol8: float = 0.01, lossless: bool = False,
                       zero_elision: bool = True,
                       quanta: tuple = (0, 3, 5, 8)):
    """x [N, V] bf16/f32 -> (dense uint8[N, 2V], rates int32[N],
    quanta int32[N])."""
    xf = x.to(torch.float32)
    t, v = xf.shape
    amax = xf.abs().amax(dim=-1, keepdim=True)
    q4, s4 = _quantize_rows(xf, 4)
    q8, s8 = _quantize_rows(xf, 8)
    deq4 = (q4.to(torch.float32) * s4).to(torch.bfloat16)
    deq8 = (q8.to(torch.float32) * s8).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    if lossless:
        ok4 = (deq4 == xb).all(dim=-1, keepdim=True)
        ok8 = (deq8 == xb).all(dim=-1, keepdim=True)
    else:
        err4 = (deq4.to(torch.float32) - xf).abs().amax(dim=-1, keepdim=True)
        err8 = (deq8.to(torch.float32) - xf).abs().amax(dim=-1, keepdim=True)
        safe = torch.where(amax > 0, amax, torch.ones_like(amax))
        f32 = lambda tol: torch.tensor(tol, dtype=torch.float32, device=x.device)
        ok4 = err4 / safe <= f32(tol4)
        ok8 = err8 / safe <= f32(tol8)
    rate = torch.where(ok8, RATE_8BIT, RATE_RAW)
    rate = torch.where(ok4, RATE_4BIT, rate)
    rate = torch.where(amax == 0, RATE_ZERO, rate).to(torch.int32)
    if not zero_elision:
        rate = torch.clamp(rate, min=RATE_4BIT)
    qtab = torch.tensor(tuple(quanta), dtype=torch.int32, device=x.device)
    qnt = qtab[rate.long()]

    nb = 2 * v
    u4 = (q4 & 0xF).to(torch.uint8)
    p4 = u4[:, 0::2] | (u4[:, 1::2] << 4)
    c4 = torch.cat([f32_to_bytes(s4), p4,
                    torch.zeros((t, nb - 4 - v // 2), dtype=torch.uint8,
                                device=x.device)], dim=1)
    p8 = (q8 & 0xFF).to(torch.uint8)
    c8 = torch.cat([f32_to_bytes(s8), p8,
                    torch.zeros((t, nb - 4 - v), dtype=torch.uint8,
                                device=x.device)], dim=1)
    raw = xb.contiguous().view(torch.uint8).reshape(t, nb)   # little-endian
    dense = torch.where(rate == RATE_4BIT, c4, torch.zeros_like(c4))
    dense = torch.where(rate == RATE_8BIT, c8, dense)
    dense = torch.where(rate == RATE_RAW, raw, dense)
    return dense, rate[:, 0], qnt[:, 0]


def fused_decode_plain(dense: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """(dense uint8[N, 2V], rates int32[N]) -> bf16 [N, V]."""
    t, nb = dense.shape
    v = nb // 2
    rate = rates.reshape(t, 1)
    scale = dense[:, 0:4].contiguous().view(torch.float32)       # [T, 1]
    c4 = dense[:, 4:4 + v // 2]
    lo = (c4 & 0xF).to(torch.int8)
    hi = (c4 >> 4).to(torch.int8)
    qn = torch.stack([lo, hi], dim=-1).reshape(t, v)
    qn = torch.where(qn >= 8, qn - 16, qn)
    out4 = (qn.to(torch.float32) * scale).to(torch.bfloat16)
    q8 = dense[:, 4:4 + v].contiguous().view(torch.int8)
    out8 = (q8.to(torch.float32) * scale).to(torch.bfloat16)
    raw = dense.contiguous().view(torch.bfloat16)                # little-endian
    out = torch.where(rate == RATE_4BIT, out4, torch.zeros_like(out4))
    out = torch.where(rate == RATE_8BIT, out8, out)
    return torch.where(rate == RATE_RAW, raw, out)


# ---------------------------------------------------------------------------
# CUDA build (nvcc -> shared library with a C interface, loaded by ctypes).
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    """nvcc on PATH, else under CUDA_HOME (the toolkit's default prefix)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"{SOURCE.name}")


def build() -> dict:
    """Compile ``qpack_fused.cu`` for sm_90a into ``build/repro_torch/``
    (cached by a hash of the source and flags). Returns the library path,
    the build seconds (0 when cached) and the compiler's log."""
    flags = NVCC_FLAGS
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()) \
        .hexdigest()[:16]
    out = BUILD_DIR / f"libqpack_fused-{digest}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return {"path": str(out), "seconds": secs, "log": proc.stderr}


def load() -> ctypes.CDLL:
    """The built library, building it at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build()["path"])
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.qpack_fused_encode.argtypes = [P, I, P, P, P, I, I, F, F, I, I,
                                           I, I, I, I, P]
        lib.qpack_fused_encode.restype = I
        lib.qpack_fused_decode.argtypes = [P, P, P, I, I, P]
        lib.qpack_fused_decode.restype = I
        _lib = lib
    return _lib


def _check_cuda(t: torch.Tensor, name: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_shape(v: int) -> None:
    if v % 256 or not 256 <= v <= 2048:
        raise ValueError(f"block of {v} values: the kernels take V a "
                         "multiple of 256 in [256, 2048]")


# ---------------------------------------------------------------------------
# Wrappers.
# ---------------------------------------------------------------------------

def fused_encode(x: torch.Tensor, *, tol4: float = 0.10, tol8: float = 0.01,
                 lossless: bool = False, zero_elision: bool = True,
                 quanta: tuple = (0, 3, 5, 8)):
    """Fused demote over blocks x [N, V] (bf16/f32): (dense uint8[N, 2V],
    rates int32[N], quanta int32[N])."""
    global fused_encode_launches
    if x.dim() != 2 or x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x must be [N, V] bf16/f32, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return fused_encode_plain(x, tol4=tol4, tol8=tol8, lossless=lossless,
                                  zero_elision=zero_elision, quanta=quanta)
    if x.device.type != "cuda":
        raise ValueError(f"no fused encode for device {x.device}")
    n, v = x.shape
    _check_shape(v)
    _check_cuda(x, "x")
    dense = torch.empty((n, 2 * v), dtype=torch.uint8, device=x.device)
    rates = torch.empty((n,), dtype=torch.int32, device=x.device)
    qnt = torch.empty((n,), dtype=torch.int32, device=x.device)
    if n == 0:
        return dense, rates, qnt
    q = tuple(int(a) for a in quanta)
    err = load().qpack_fused_encode(
        x.data_ptr(), int(x.dtype == torch.float32), dense.data_ptr(),
        rates.data_ptr(), qnt.data_ptr(), n, v, tol4, tol8, int(lossless),
        int(zero_elision), q[0], q[1], q[2], q[3],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"qpack_fused_encode launch failed: cudaError {err}")
    fused_encode_launches += 1
    return dense, rates, qnt


def fused_decode(dense: torch.Tensor, rates: torch.Tensor) -> torch.Tensor:
    """Fused promote over dense blocks [N, 2V] + rates [N] -> bf16 [N, V]."""
    global fused_decode_launches
    if dense.dim() != 2 or dense.dtype != torch.uint8:
        raise ValueError("dense must be uint8 [N, 2V]")
    if dense.device.type == "cpu":
        return fused_decode_plain(dense, rates)
    if dense.device.type != "cuda":
        raise ValueError(f"no fused decode for device {dense.device}")
    n, nb = dense.shape
    v = nb // 2
    _check_shape(v)
    rates = rates.to(torch.int32).contiguous()
    if rates.shape != (n,) or rates.device != dense.device:
        raise ValueError("rates must be int32[N] on the same device")
    _check_cuda(dense, "dense")
    out = torch.empty((n, v), dtype=torch.bfloat16, device=dense.device)
    if n == 0:
        return out
    err = load().qpack_fused_decode(
        dense.data_ptr(), rates.data_ptr(), out.data_ptr(), n, v,
        torch.cuda.current_stream(dense.device).cuda_stream)
    if err:
        raise RuntimeError(f"qpack_fused_decode launch failed: cudaError {err}")
    fused_decode_launches += 1
    return out
