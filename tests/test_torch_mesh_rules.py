"""The port's GSPMD rule tables against the JAX package's, exactly, with no
ranks: ``transformer.param_axes`` (the logical-axes tree of every arch id,
in the trainer's stacked layout) against the tree the reference's
``init_params`` returns (taken under ``jax.eval_shape``, as
``repro/launch/dryrun.py::abstract_params`` does: no full-size model is
allocated); ``launch/mesh.py::rules_for`` and
``common/sharding.py::logical_to_spec`` on every param leaf, the batch and
the activation and KV cache axes the reference's dry run shards, for every
(arch x shape) on the production meshes (16, 16) and (2, 16, 16) and on
``plan_mesh(n, prefer_model=2)`` for n in 1, 2, 4, 8; ``batch_spec`` and
``batch_shards`` on the same meshes. A port spec is a plain tuple, so it
is compared with ``tuple(PartitionSpec)``.
"""
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.common import sharding as JSH  # noqa: E402
from repro.common.types import ALL_SHAPES as JSHAPES  # noqa: E402
from repro.common.types import ServeConfig as JServe  # noqa: E402
from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import dryrun as JDRY  # noqa: E402
from repro.launch import mesh as JM  # noqa: E402
from repro.models import decode as JD  # noqa: E402
from repro_torch.common import sharding as SH  # noqa: E402
from repro_torch.common.types import ALL_SHAPES, MeshConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.train import elastic  # noqa: E402

MESHES = [MeshConfig((16, 16), ("data", "model")),
          MeshConfig((2, 16, 16), ("pod", "data", "model"))] + \
    [elastic.plan_mesh(n, prefer_model=2) for n in (1, 2, 4, 8)]
# the activations the reference's dry run shards (train, prefill, decode)
ACTIVATIONS = [("batch", "seq"), ("batch", "seq", "embed"),
               ("batch", "vocab"), ("batch",), ("batch", "embed")]


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _axes_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=_is_axes)


@pytest.fixture(scope="module")
def ref_axes():
    """{arch: the reference's logical-axes tree at its published config}."""
    return {a: JDRY.abstract_params(jget_config(a))[1] for a in ARCH_IDS}


def _jmesh(mc: MeshConfig):
    """What the reference's batch helpers read of a jax Mesh."""
    return types.SimpleNamespace(axis_names=mc.axes,
                                 devices=np.empty(mc.shape, np.int8))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_reference(ref_axes, arch):
    """Every leaf's logical axes, key for key, at the published config."""
    assert T.param_axes(get_config(arch)) == ref_axes[arch]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_specs_equal_reference(ref_axes, arch):
    """For each shape and mesh: the rule table, then the spec of every
    param leaf, activation and KV cache leaf under it."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cache = _axes_leaves(JD.cache_axes(jcfg, JServe()))
    leaves = _axes_leaves(ref_axes[arch]) + cache + ACTIVATIONS
    assert [s.name for s in ALL_SHAPES] == [s.name for s in JSHAPES]
    n = 0
    for shape, jshape in zip(ALL_SHAPES, JSHAPES):
        assert (shape.seq_len, shape.global_batch, shape.kind) == \
            (jshape.seq_len, jshape.global_batch, jshape.kind)
        for mc in MESHES:
            m = dict(zip(mc.axes, mc.shape)).get("model", 1)
            rules = M.rules_for(shape, mc.axes, cfg, m)
            jrules = JM.rules_for(jshape, mc.axes, jcfg, m)
            assert rules == jrules, (shape.name, mc)
            for axes in leaves:
                got = SH.logical_to_spec(axes, rules, mc.axes)
                assert got == tuple(JSH.logical_to_spec(axes, jrules,
                                                        mc.axes)), axes
                n += 1
    assert n == len(ALL_SHAPES) * len(MESHES) * len(leaves)


def test_tree_specs_equal_reference_tree_shardings(ref_axes):
    """``tree_specs`` (the reference's ``tree_shardings``) maps a whole
    axes tree leaf for leaf: llama3-8b's on the (16, 16) mesh."""
    mc = MESHES[0]
    got = SH.tree_specs(T.param_axes(get_config("llama3_8b")),
                        SH.DEFAULT_RULES, mc.axes)
    want = jax.tree_util.tree_map(
        lambda a: tuple(JSH.logical_to_spec(a, JSH.DEFAULT_RULES, mc.axes)),
        ref_axes["llama3_8b"], is_leaf=_is_axes)
    assert got == want
    assert got["layers"]["attn"]["wq"] == (None, "data", "model")


@pytest.mark.parametrize("mc", MESHES, ids=lambda mc: "x".join(
    map(str, mc.shape)))
def test_batch_spec_and_shards_equal_reference(mc):
    assert SH.DEFAULT_RULES == JSH.DEFAULT_RULES
    assert SH.batch_spec(mc) == tuple(JSH.batch_spec(_jmesh(mc)))
    for shape, jshape in zip(ALL_SHAPES, JSHAPES):
        assert M.batch_shards(shape, mc) == JM.batch_shards(jshape,
                                                            _jmesh(mc))
    for rules in (M.TRAIN_RULES, M.DECODE_RULES, M.LONG_RULES):
        jrules = {id(M.TRAIN_RULES): JM.TRAIN_RULES,
                  id(M.DECODE_RULES): JM.DECODE_RULES,
                  id(M.LONG_RULES): JM.LONG_RULES}[id(rules)]
        assert rules == jrules
        assert SH.batch_spec(mc, rules) == tuple(
            JSH.batch_spec(_jmesh(mc), jrules))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_cache_axes_specs_equal_reference(arch):
    """The port's own ``models/decode.py::cache_axes`` (the dry run's
    cache layout): its tree is the reference's, and every leaf's spec
    under each shape's rules on each mesh equals the reference's."""
    from repro_torch.models import decode as D
    cfg, jcfg = get_config(arch), jget_config(arch)
    port = D.cache_axes(cfg, JServe())
    assert port == JD.cache_axes(jcfg, JServe())
    for shape, jshape in zip(ALL_SHAPES, JSHAPES):
        for mc in MESHES:
            m = dict(zip(mc.axes, mc.shape)).get("model", 1)
            rules = M.rules_for(shape, mc.axes, cfg, m)
            jrules = JM.rules_for(jshape, mc.axes, jcfg, m)
            for axes in _axes_leaves(port):
                assert SH.logical_to_spec(axes, rules, mc.axes) == tuple(
                    JSH.logical_to_spec(axes, jrules, mc.axes)), axes
