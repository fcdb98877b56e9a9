"""Port vs JAX package: `models/sharding.py` and the LM meshes of
`launch/mesh.py`, in the main process, without devices.

* `mesh_axes` of the port's 2 × 2 host mesh, 16 × 16 and 2 × 16 × 16
  production meshes (logical CPU cells) `==` the reference's of the same
  `AbstractMesh`.
* `param_specs` of every config's meta tree at full depth
  (``lm.init_params(device="meta")``) `==` the reference's of
  ``jax.eval_shape(init_params)``, leaf for leaf, on the three meshes
  with ``fsdp`` and ``moe_ep2d`` on and off; each leaf's `shard_shape`
  `==` ``jax.sharding.NamedSharding(AbstractMesh, spec).shard_shape``,
  both raising where a dimension does not divide.
* `batch_specs` on `launch/specs.py`'s batch trees and `cache_specs` on
  its decode caches for every `SHAPES` cell `==` the reference's on its
  own trees (the port's cache ``pos`` is a Python int, both ``P()``).
* A mesh needs as many devices as cells: without enough logical cells
  `make_production_mesh` raises.
"""
import dataclasses
import functools

import jax
import pytest
from jax.sharding import AbstractMesh
from jax.sharding import NamedSharding as JNamed

from repro.configs import base as JCB
from repro.launch import specs as JS
from repro.models import lm as jlm
from repro.models import sharding as JSH
from repro_torch import prng
from repro_torch import tree as T
from repro_torch.configs import base as CB
from repro_torch.launch import mesh as M
from repro_torch.launch import specs as S
from repro_torch.models import lm
from repro_torch.models import sharding as SH

NAMES = CB.names()
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
FLAGS = [dict(fsdp=f, moe_ep2d=e) for f in (False, True)
         for e in (False, True)]


@pytest.fixture
def meshes(monkeypatch):
    """name → (the port's mesh of logical CPU cells, the reference's
    `AbstractMesh` of the same shape)."""
    monkeypatch.setenv(M.LOGICAL_DEVICES, "512")
    return {k: (M.compat_mesh(shape, axes, device="cpu"),
                AbstractMesh(shape, axes))
            for k, (shape, axes) in MESHES.items()}


@functools.lru_cache(maxsize=None)
def _trees(name):
    """(the port's meta tree, the reference's ShapeDtypeStruct tree)."""
    cfg, jcfg = CB.get(name), JCB.get(name)
    return (lm.init_params(cfg, prng.PRNGKey(0), model_shards=16,
                           device="meta"),
            jax.eval_shape(lambda: jlm.init_params(
                jcfg, jax.random.PRNGKey(0), model_shards=16)))


def _jax_leaves(tree):
    """[(path, leaf)] of a JAX tree whose leaves may be PartitionSpecs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf) for path, leaf in flat]


def _port_leaves(tree, prefix=""):
    """[(path, spec)] of a port spec tree, in `tree.leaves` order."""
    if isinstance(tree, SH.P):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _port_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def _same_specs(got, want):
    """A port spec tree against a reference one, path for path."""
    g = _port_leaves(got)
    w = _jax_leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    assert [s for _, s in g] == SH.spec_leaves(got)
    for (path, a), (_, b) in zip(g, w):
        assert isinstance(a, SH.P), path
        assert tuple(a) == tuple(b), (path, a, b)
    return g


def _shard_shape_both(mesh, amesh, spec, shape):
    """The port's and the reference's shard shape, or the error type."""
    out = []
    for fn in (lambda: SH.NamedSharding(mesh, spec).shard_shape(shape),
               lambda: JNamed(amesh, jax.sharding.PartitionSpec(*spec)
                              ).shard_shape(shape)):
        try:
            out.append(tuple(fn()))
        except ValueError:
            out.append(ValueError)
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
def test_mesh_axes_equal_jax(meshes, mesh_name):
    mesh, amesh = meshes[mesh_name]
    assert mesh.shape == dict(amesh.shape)
    assert mesh.axis_names == amesh.axis_names
    assert mesh.size == amesh.size == len(mesh.cells())
    assert mesh.devices.shape == MESHES[mesh_name][0]
    assert SH.mesh_axes(mesh) == JSH.mesh_axes(amesh)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_and_shard_shapes_equal_jax(meshes, name, mesh_name):
    mesh, amesh = meshes[mesh_name]
    tree, jtree = _trees(name)
    axes = SH.mesh_axes(mesh)
    assert axes == JSH.mesh_axes(amesh)
    shapes = {p: tuple(t.shape) for p, t in T.leaves_with_paths(tree)}
    for flags in FLAGS:
        cfg = dataclasses.replace(CB.get(name), **flags)
        jcfg = dataclasses.replace(JCB.get(name), **flags)
        got = SH.param_specs(cfg, tree, axes)
        for path, spec in _same_specs(got, JSH.param_specs(jcfg, jtree,
                                                           axes)):
            a, b = _shard_shape_both(mesh, amesh, spec, shapes[path])
            assert a == b, (flags, path, spec, a, b)


@pytest.mark.parametrize("shape", list(CB.SHAPES))
@pytest.mark.parametrize("name", NAMES)
def test_batch_and_cache_specs_equal_jax(meshes, name, shape):
    cfg, jcfg = CB.get(name), JCB.get(name)
    got_in = S.input_specs(cfg, CB.SHAPES[shape])
    want_in = JS.input_specs(jcfg, JCB.SHAPES[shape])
    for mesh, amesh in meshes.values():
        axes = SH.mesh_axes(mesh)
        if "batch" in want_in:
            _same_specs(SH.batch_specs(cfg, got_in["batch"], axes),
                        JSH.batch_specs(jcfg, want_in["batch"], axes))
            continue
        specs = _same_specs(SH.cache_specs(cfg, got_in["cache"], axes),
                            JSH.cache_specs(jcfg, want_in["cache"], axes))
        assert dict(specs)["pos"] == SH.P()
        _same_specs(SH.batch_specs(cfg, {"tokens": got_in["tokens"]}, axes),
                    JSH.batch_specs(jcfg, {"tokens": want_in["tokens"]},
                                    axes))
        for path, spec in specs:
            leaf = dict(T.leaves_with_paths(got_in["cache"]))[path]
            a, b = _shard_shape_both(mesh, amesh, spec,
                                     tuple(getattr(leaf, "shape", ())))
            assert a == b, (path, spec, a, b)


def test_spec_and_sharding_basics(meshes):
    mesh, _ = meshes["2x16x16"]
    spec = SH.P(("pod", "data"), "model", None)
    assert spec == (("pod", "data"), "model", None) and len(SH.P()) == 0
    named = SH.to_named({"a": spec, "b": [SH.P(None)]}, mesh)
    assert named["a"].shard_shape((64, 32, 5)) == (2, 2, 5)
    assert named["b"][0].shard_shape((7,)) == (7,)
    with pytest.raises(ValueError):
        SH.NamedSharding(mesh, SH.P("model", "model"))
    with pytest.raises(ValueError):
        SH.NamedSharding(mesh, SH.P("nope"))
    with pytest.raises(ValueError):
        named["a"].shard_shape((63, 32, 5))


def test_production_mesh_needs_its_cells(monkeypatch):
    monkeypatch.setenv(M.LOGICAL_DEVICES, "255")
    with pytest.raises(ValueError, match="exceeds"):
        M.make_production_mesh(device="cpu")
    monkeypatch.setenv(M.LOGICAL_DEVICES, "256")
    assert M.make_production_mesh(device="cpu").shape == {"data": 16,
                                                          "model": 16}
    with pytest.raises(ValueError, match="exceeds"):
        M.make_production_mesh(multi_pod=True, device="cpu")


def test_constraints_check_the_installed_mesh(meshes):
    """`constrain` (the reference's `with_sharding_constraint`) returns its
    input untouched; under `use_mesh` it refuses an axis the mesh lacks
    or a spec longer than the tensor."""
    import torch
    mesh, _ = meshes["2x2"]
    x = torch.ones(4, 6, 8)
    with M.use_mesh(mesh):
        assert M.current_mesh() is mesh
        assert SH.constrain(x, SH.P("data", "model", None)) is x
        with pytest.raises(ValueError):
            SH.constrain(x, SH.P("pod", None, None))
        with pytest.raises(ValueError):
            SH.constrain(x, SH.P(None, None, None, None))
    assert M.current_mesh() is None
    assert SH.constrain(x, SH.P("pod")) is x      # no mesh: rank only


@pytest.mark.parametrize("one_hot", [True, False])
def test_embed_tokens_equals_jax(one_hot):
    """`embed_tokens`' one-hot product and its row gather (``one_hot=
    False``) against the reference's, on a 2 × 2 mesh's axes (the vocab
    constraint leaves the values as they are)."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    cfg = dataclasses.replace(CB.reduced(CB.get("llama3-8b")),
                              dtype="float32")
    jcfg = dataclasses.replace(JCB.reduced(JCB.get("llama3-8b")),
                               dtype="float32")
    rng = np.random.default_rng(0)
    table = rng.normal(size=(cfg.vocab, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, 7)).astype(np.int32)
    axes = {"dp": "data", "tp": "model", "ndp": 2, "ntp": 2}
    got = lm.embed_tokens({"embed": torch.from_numpy(table)}, cfg,
                          torch.from_numpy(toks), axes, one_hot=one_hot)
    want = jlm.embed_tokens({"embed": jnp.asarray(table)}, jcfg,
                            jnp.asarray(toks), None, one_hot=one_hot)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
