"""Pool state, model params and KV caches <-> numpy, in the reference
package's dtypes and layouts.

A pool is a dict of numpy arrays keyed by dotted leaf names in the
reference ``Pool``'s field order ("meta", "activity", "hand",
"cfree.items", "cfree.top", ..., "cache.tags", "cache.age", "counters",
"rng", "c_store", "p_store", "rates_table"). The reference's uint32 leaves
(metadata and activity words, the PRNG key) are int64 inside the port;
this module is the only place that converts them. A stacked pool (the
fabric's, ``state.make_pool_stack``) has the same names, every leaf with a
leading expander axis.

Training: ``stacked_params_from_numpy``/``stacked_params_to_numpy`` carry
the reference's tree as it is (the trainer's stacked layout), and
``opt_state_from_numpy``/``opt_state_to_numpy`` the AdamW state, raw or
compressed ({"codes", "scales", "block"} a leaf; ``block`` a host int in
the port, an int32 array in the reference).

Model params: the reference's ``init_params`` tree (layers stacked on a
leading axis, f32 leaves; the hybrid's Mamba2 layers [G, period, ...] and
its shared blocks [n_shared, ...]) becomes the port's (lists of per-layer
dicts, in the model's dtype, the hybrid's Mamba2 layers flat; the mixer
leaves the reference uses in float32 stay float32). Caches: the port's
stacked cache as numpy, bf16 leaves as float32 (exact); the dotted leaves
``ssm.h``/``ssm.conv`` as the reference's ``{"ssm": {"h", "conv"}}``
subtree, the hybrid's [L, B, ...] as the reference's [G, period, B, ...]
(G the cache's KV sites).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import tree as TR
from repro_torch.common.types import PoolConfig
from repro_torch.common.utils import resolve_device
from repro_torch.core.engine.state import Pool
from repro_torch.core.freelist import FreeList
from repro_torch.core.mcache import MCache

_UINT32 = ("meta", "activity", "rng")


def leaves(pool, prefix: str = ""):
    """(dotted name, leaf) pairs of a pool, in field order. Works on any
    nest of NamedTuples, so it walks the reference ``Pool`` too."""
    if isinstance(pool, tuple) and hasattr(pool, "_fields"):
        for f in pool._fields:
            yield from leaves(getattr(pool, f), f"{prefix}.{f}" if prefix else f)
    else:
        yield prefix, pool


def pool_to_numpy(pool: Pool) -> dict:
    """A snapshot of the pool's leaves (copies: the port updates its
    tensors in place, and a CPU tensor's ``numpy()`` shares memory)."""
    out = {}
    for name, t in leaves(pool):
        a = t.detach().cpu().numpy()
        out[name] = a.astype(np.uint32) if name in _UINT32 else a.copy()
    return out


def pool_from_numpy(arrays: dict, cfg: PoolConfig, device=None) -> Pool:
    """Build the port's pool from reference leaves (``uint32`` words,
    ``int32`` freelists and cache, ``uint8`` stores) on ``device``."""
    pool = _pool_from_arrays(arrays, resolve_device(device))
    if pool.meta.shape != (cfg.n_pages, 8):
        raise ValueError(f"meta {tuple(pool.meta.shape)} does not match "
                         f"n_pages={cfg.n_pages}")
    return pool


def pool_stack_to_numpy(stack: Pool) -> dict:
    """A snapshot of a stacked pool (``state.make_pool_stack``): the
    reference stack's leaves, each with its leading expander axis."""
    return pool_to_numpy(stack)


def pool_stack_from_numpy(arrays: dict, cfg: PoolConfig, device=None) -> Pool:
    """The port's stacked pool from a reference stack's leaves (every leaf
    with a leading expander axis) on ``device``; ``pool_slice`` of the
    result gives each expander's pool."""
    stack = _pool_from_arrays(arrays, resolve_device(device))
    if stack.meta.dim() != 3 or stack.meta.shape[1:] != (cfg.n_pages, 8):
        raise ValueError(f"meta {tuple(stack.meta.shape)} is not a stack "
                         f"of n_pages={cfg.n_pages} pools")
    return stack


def _pool_from_arrays(arrays: dict, dev: torch.device) -> Pool:
    def t(name):
        a = np.asarray(arrays[name])
        if name in _UINT32:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a)).to(dev)

    fl = lambda f: FreeList(t(f"{f}.items"), t(f"{f}.top"))
    return Pool(meta=t("meta"), activity=t("activity"), hand=t("hand"),
                cfree=fl("cfree"), gfree=fl("gfree"), pfree=fl("pfree"),
                cache=MCache(t("cache.tags"), t("cache.age")),
                counters=t("counters"), rng=t("rng"), c_store=t("c_store"),
                p_store=t("p_store"), rates_table=t("rates_table"))


def params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The port's params from the reference ``init_params`` tree (any
    array-likes: numpy, or JAX arrays), cast to ``cfg.dtype`` on
    ``device``: the same rounding the reference applies at each use. A
    Mamba1 mixer's ``ssm.F32_PARAMS``, which the reference uses in float32
    without a cast, stay float32."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.ssm import F32_PARAMS
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def t(a, dt=dtype):
        return torch.from_numpy(np.array(a, np.float32)).to(dev).to(dt)

    def per_layer(sub, i, keep=frozenset()):
        return {k: per_layer(v, i, F32_PARAMS if k == "mixer" else keep)
                if isinstance(v, dict) else
                t(np.asarray(v)[i], torch.float32 if k in keep else dtype)
                for k, v in sub.items()}

    def flat(sub):
        """[G, period, ...] leaves as [G * period, ...]."""
        return {k: flat(v) if isinstance(v, dict) else
                np.asarray(v).reshape((-1,) + np.shape(v)[2:])
                for k, v in sub.items()}

    stacked = ("layers", "shared")
    out = {k: t(v) for k, v in tree.items() if k not in stacked}
    layers = flat(tree["layers"]) if "shared" in tree else tree["layers"]
    out["layers"] = [per_layer(layers, i) for i in range(cfg.num_layers)]
    if "shared" in tree:
        out["shared"] = [per_layer(tree["shared"], i)
                         for i in range(cfg.attn_shared_blocks)]
    return out


def _hybrid_sites(cache: dict):
    """The KV sites of a cache holding both recurrent state and KV leaves
    (the hybrid's), else None."""
    names = {k.split(".")[-1] for k in cache} | set(cache.get("ssm", {}))
    if {"h", "cold_len"} <= names:
        return cache["cold_len"].shape[0]
    return None


def cache_to_numpy(cache: dict) -> dict:
    """A snapshot of a stacked cache (copies; bf16 leaves as f32), in the
    reference's tree: dotted leaves ("ssm.h") nest ({"ssm": {"h": ...}})."""
    out = {}
    sites = _hybrid_sites(cache)
    for k, v in cache.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            v = v.to(torch.float32)
        if sites and k.startswith("ssm."):
            v = v.reshape((sites, -1) + tuple(v.shape[1:]))
        *outer, leaf = k.split(".")
        sub = out
        for o in outer:
            sub = sub.setdefault(o, {})
        sub[leaf] = v.numpy().copy()
    return out


# cache leaves held in bf16 (the rings and the SSM conv tail)
_BF16_LEAVES = ("k_hot", "v_hot", "lat_hot", "ssm.conv")


def cache_from_numpy(arrays: dict, device=None) -> dict:
    """A stacked cache from numpy (the reference's tree, or
    ``cache_to_numpy``'s): nested leaves get dotted names (the hybrid's
    [G, period, B, ...] state leaves flat, [L, B, ...]), ring leaves and
    the SSM conv tail become bf16, the rest keep their dtype."""
    dev = resolve_device(device)
    out = {}
    hybrid = _hybrid_sites(arrays) is not None

    def put(name, a):
        if isinstance(a, dict):
            for k, v in a.items():
                put(f"{name}.{k}", v)
            return
        if hybrid and name.startswith("ssm."):
            a = np.asarray(a).reshape((-1,) + np.shape(a)[2:])
        if name in _BF16_LEAVES:
            out[name] = torch.from_numpy(np.array(a, np.float32)).to(
                torch.bfloat16).to(dev)
        else:
            out[name] = torch.from_numpy(np.array(a)).to(dev)

    for k, a in arrays.items():
        put(k, a)
    return out


def stacked_params_from_numpy(tree: dict, cfg, device=None) -> dict:
    """The trainer's stacked params from the reference ``init_params``
    tree, cast to ``cfg.dtype`` on ``device`` (a Mamba1 mixer's
    ``ssm.F32_PARAMS`` stay float32, as in ``params_from_numpy``)."""
    from repro_torch.models.layers import torch_dtype
    from repro_torch.models.ssm import F32_PARAMS
    dev = resolve_device(device)
    dtype = torch_dtype(cfg)

    def one(path, a):
        f32 = len(path) >= 2 and path[-2] == "mixer" and \
            path[-1] in F32_PARAMS and cfg.family == "ssm"
        return torch.from_numpy(np.array(a, np.float32)).to(dev).to(
            torch.float32 if f32 else dtype)
    return TR.map_with_paths(one, tree)


def stacked_params_to_numpy(params: dict) -> dict:
    """The trainer's params as the reference's tree of float32 arrays
    (bf16 is exact in float32)."""
    return TR.map_tree(lambda t: t.detach().to("cpu", torch.float32).numpy(),
                       params)


def opt_state_from_numpy(state, device=None):
    """The port's ``AdamState`` from the reference's (step, m, v): raw
    moments as tensors of their dtype, compressed leaves with ``block`` as
    a host int."""
    from repro_torch.optim.adamw import AdamState
    dev = resolve_device(device)

    def one(path, a):
        if path and path[-1] == "block":
            return int(np.asarray(a))
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":          # bf16 moments: exact via f32
            return torch.from_numpy(a.astype(np.float32)).to(dev).to(
                torch.bfloat16)
        return torch.from_numpy(a.copy()).to(dev)
    step, m, v = state
    return AdamState(torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                                  device=dev),
                     TR.map_with_paths(one, m), TR.map_with_paths(one, v))


def opt_state_to_numpy(state):
    """``AdamState(step, m, v)`` of numpy arrays, the reference's leaves:
    ``block`` an int32 scalar array."""
    from repro_torch.optim.adamw import AdamState

    def one(x):
        if isinstance(x, int):
            return np.asarray(x, np.int32)
        if x.dtype == torch.bfloat16:
            return x.detach().to("cpu", torch.float32).numpy()
        return x.detach().cpu().numpy().copy()
    return AdamState(one(state.step), TR.map_tree(one, state.m),
                     TR.map_tree(one, state.v))
