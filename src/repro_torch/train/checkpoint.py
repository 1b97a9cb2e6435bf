"""Fault-tolerant checkpointing in the reference's on-disk format (the
reference's ``repro.train.checkpoint``): a checkpoint written by either
package restores in the other.

* Format: ``<dir>/step_<8 digits>/arrays.npz`` holds every leaf under its
  key path joined by "/" (written "|" in the npz), bf16 leaves as uint16
  under ``<key>@bf16``, a host int (a compressed moment's ``block``) as an
  int32 scalar; ``manifest.json`` holds ``step``, ``sha256`` over the
  sorted keys and bytes, ``keys`` and ``extra``.
* Atomic: written to ``<dir>/tmp.<step>`` then renamed, so a crash mid-save
  never corrupts the newest checkpoint.
* Content-hashed: ``latest()`` skips a checkpoint whose bytes do not match
  its manifest and falls back to the previous one.
* Async: ``save_async`` copies to the host (one counted sync) and hands the
  disk I/O to a writer thread.
* Re-sharding (the reference's ``restore(shardings=)``): ``save`` from a
  mesh (``shardings``, a ``common.sharding.TreeSharding``) gathers every
  leaf whole and rank 0 writes the single-device files; ``restore`` with
  ``shardings`` gives each rank its blocks on any mesh, so a checkpoint
  moves between meshes and one device either way.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common import contracts
from repro_torch.common import tree as TR

Tree = Any
_SEP = "/"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _host(tree: Tree) -> Dict[str, Any]:
    """Key -> host copy of every leaf (the device's in one counted sync)."""
    flat = {_key(p): x for p, x in TR.leaves_with_paths(tree)}
    dev = {k: x for k, x in flat.items() if isinstance(x, torch.Tensor)}
    if dev:
        flat.update(contracts.fetch(dev))
    return flat


def _flatten(flat_host: Dict[str, Any]) -> Dict[str, np.ndarray]:
    out = {}
    for key, x in flat_host.items():
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:   # npz has no bf16
                out[key + "@bf16"] = x.view(torch.int16).numpy().view(
                    np.uint16)
                continue
            arr = x.numpy()
        elif isinstance(x, (int, np.integer)) and not isinstance(x, bool):
            arr = np.asarray(x, np.int32)
        else:
            arr = np.asarray(x)
        out[key] = arr
    return out


def _write(ckpt_dir: str, step: int, flat: Dict[str, np.ndarray], keep: int,
           extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    h = hashlib.sha256()
    for key in sorted(flat):
        h.update(key.encode())
        h.update(flat[key].tobytes())
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{k.replace("/", "|"): v for k, v in flat.items()})
    manifest = {"step": step, "sha256": h.hexdigest(),
                "keys": sorted(flat), "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, tree: Tree, *, keep: int = 3,
         extra: Optional[Dict[str, Any]] = None, shardings=None) -> str:
    """Write ``tree`` as step ``step``. With ``shardings`` (``tree`` this
    rank's blocks on a mesh; every rank calls it) the leaves are gathered
    whole, rank 0 writes them, and every rank waits for the write."""
    if shardings is None:
        return _write(ckpt_dir, step, _flatten(_host(tree)), keep, extra)
    whole = shardings.gather(tree)
    if shardings.mesh.rank == 0:
        _write(ckpt_dir, step, _flatten(_host(whole)), keep, extra)
    del whole
    shardings.mesh.barrier()
    return os.path.join(ckpt_dir, f"step_{step:08d}")


_PENDING: List[threading.Thread] = []


def save_async(ckpt_dir: str, step: int, tree: Tree, *, keep: int = 3,
               extra: Optional[Dict[str, Any]] = None) -> threading.Thread:
    """The device->host copy happens here; the disk I/O on a worker
    thread (``wait_pending`` joins it)."""
    flat = _flatten(_host(tree))
    t = threading.Thread(target=_write, args=(ckpt_dir, step, flat, keep,
                                               extra), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def list_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _verify(path: str) -> bool:
    """Whether the checkpoint at ``path`` reads back to its manifest's hash.
    Any failure to read it (a missing file, a broken zip, an npy header
    that no longer parses: numpy's parser raises ``tokenize.TokenError``
    there) means it is not a valid checkpoint."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            h = hashlib.sha256()
            for key in sorted(manifest["keys"]):
                h.update(key.encode())
                h.update(z[key.replace("/", "|")].tobytes())
        return h.hexdigest() == manifest["sha256"]
    except Exception:        # noqa: BLE001 -- every read failure is corrupt
        return False


def latest(ckpt_dir: str) -> Optional[int]:
    """Newest checkpoint that passes integrity verification."""
    for s in reversed(list_steps(ckpt_dir)):
        if _verify(os.path.join(ckpt_dir, f"step_{s:08d}")):
            return s
    return None


def _to_like(arr: np.ndarray, like):
    """A checkpoint array as ``like``'s kind of leaf: a tensor in its dtype
    on its device, a host int, or a numpy array of its dtype."""
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(like.dtype).to(like.device)
    if isinstance(like, (int, np.integer)) and not isinstance(like, bool):
        return int(arr)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def restore(ckpt_dir: str, step: int, like: Tree,
            shardings=None) -> Tuple[Tree, Dict]:
    """The checkpoint in the structure of ``like``, each leaf as
    ``like``'s (``_to_like``); bf16 arrays are exact in float32. With
    ``shardings`` (``like`` this rank's blocks on a mesh) each tensor leaf
    is this rank's block of the whole leaf written."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: z[k.replace("/", "|")] for k in manifest["keys"]}

    def one(p, leaf):
        key = _key(p)
        if key + "@bf16" in flat:
            bits = np.array(flat[key + "@bf16"], copy=True).view(np.int16)
            arr = torch.from_numpy(bits).view(torch.bfloat16)
            arr = arr if isinstance(leaf, torch.Tensor) else \
                arr.float().numpy()
        else:
            arr = flat[key]
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        spec = None
        if shardings is not None and isinstance(leaf, torch.Tensor):
            spec = shardings.spec(p)
            shape = shardings.mesh.full_shape(shape, spec)
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {key}: shape "
                             f"{tuple(arr.shape)}, expected {shape}")
        if spec is not None:                # the block, cut on the host
            if not isinstance(arr, torch.Tensor):
                arr = torch.from_numpy(np.array(arr, copy=True))
            arr = shardings.mesh.shard(arr, spec)
        if isinstance(arr, torch.Tensor):
            return arr.to(leaf.dtype).to(leaf.device)
        return _to_like(arr, leaf)

    return TR.map_with_paths(one, like), manifest.get("extra", {})
