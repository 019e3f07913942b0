"""Port parity: the partition rules against the JAX package's.

``repro_torch.sharding.rules`` against ``repro.sharding.rules``, every
spec compared entry for entry (``tuple(spec)``), bitwise:

- ``param_specs`` for every leaf of all ten configs' parameter trees at
  full size: the shapes from ``jax.eval_shape`` of JAX's ``init_lm``,
  fed to the port as meta tensors, on the meshes ``(data 16, model
  16)``, ``(pod 2, data 16, model 16)``, ``(1, 2)`` and ``(2, 2)``
  (layouts only: a duck-typed mesh for JAX, as ``tests/test_sharding.py``
  builds it, and a hand-built ``placement.Mesh`` for the port);
- ``_fit_spec``, ``auto_spec`` and ``batch_specs`` on the shapes of
  ``tests/test_sharding.py`` and a training batch;
- ``state_specs`` on decode states of four configs under each
  ``REPRO_STATE_SPEC_ORDER`` (``trailing``, ``leading``, ``none``);
- ``shard_leaf`` against the ``addressable_shards`` of
  ``jax.device_put(x, NamedSharding(mesh, spec))`` on the conftest's 8
  CPU devices, for every device's coordinates.
"""

import functools

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_config as j_get_config
from repro.models import init_lm as j_init_lm
from repro.models import transformer as jt
from repro.sharding import rules as jrules
from repro_torch._tree import key_str, tree_flatten_with_path
from repro_torch.experiments.placement import Mesh
from repro_torch.sharding import rules as trules

MESHES = {"d16m16": {"data": 16, "model": 16},
          "p2d16m16": {"pod": 2, "data": 16, "model": 16},
          "d1m2": {"data": 1, "model": 2}, "d2m2": {"data": 2, "model": 2}}


class FakeMesh:
    """Duck-typed JAX mesh carrying only names/shape (spec logic is
    pure), as ``tests/test_sharding.py`` has it."""

    def __init__(self, shape_by_name):
        self.axis_names = tuple(shape_by_name)
        self.devices = np.empty(tuple(shape_by_name.values()))


def _meshes(name):
    shape = MESHES[name]
    grid = np.arange(int(np.prod(list(shape.values())))).reshape(
        tuple(shape.values()))
    return FakeMesh(shape), Mesh(tuple(shape), grid)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = j_get_config(arch)
    return jax.eval_shape(lambda: j_init_lm(jax.random.PRNGKey(0), cfg))


def _meta(tree):
    return jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), tree)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _same(jspec, tspec, what):
    assert isinstance(tspec, trules.PartitionSpec), what
    assert tuple(tspec) == tuple(jspec), (what, jspec, tspec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(J_REGISTRY))
def test_param_specs_match_jax(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    shapes = _shapes(arch)
    jspecs = jrules.param_specs(shapes, jmesh)
    tspecs = trules.param_specs(_meta(shapes), tmesh)
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, JP))[0]
    leaves, _ = tree_flatten_with_path(_meta(shapes))
    assert len(flat) == len(leaves)
    for (jpath, jspec), (tpath, _) in zip(flat, leaves):
        assert jrules._path_str(jpath) == key_str(tpath)
        _same(jspec, _at(tspecs, tpath), f"{arch} {mesh} {key_str(tpath)}")


def test_suffix_rules_are_jax_s():
    assert trules.SUFFIX_RULES == jrules.SUFFIX_RULES


FIT = [((8, 4, 4096, 6400), ("data", "model")),
       ((51865, 384), ("model", "data")),
       ((32, 16, 4096, 6400), ("model", "data", None)),
       ((7, 12), (("pod", "data"), "model")),
       ((12,), (None,))]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_and_auto_spec_match_jax(mesh):
    jmesh, tmesh = _meshes(mesh)
    sizes = MESHES[mesh]
    for shape, spec in FIT:
        _same(jrules._fit_spec(shape, spec, sizes),
              trules._fit_spec(shape, spec, sizes), (shape, spec))
    for shape in ((256, 4096), (256,), (1, 8192, 8, 128), (3, 5),
                  (32, 2048, 16, 64), ()):
        for batch_axis in (0, None, 1):
            if batch_axis is not None and batch_axis >= len(shape):
                continue
            _same(jrules.auto_spec(shape, jmesh, batch_axis),
                  trules.auto_spec(shape, tmesh, batch_axis),
                  (shape, batch_axis))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_jax(mesh):
    jmesh, tmesh = _meshes(mesh)
    batch = {"tokens": (256, 4096), "labels": (256, 4096),
             "loss_mask": (256, 4096), "vision_embeds": (256, 256, 1536),
             "audio_feats": (2, 1500, 384)}
    jspecs = jrules.batch_specs(
        {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in batch.items()},
        jmesh)
    tspecs = trules.batch_specs(
        {k: torch.empty(v, device="meta") for k, v in batch.items()}, tmesh)
    for name in batch:
        _same(jspecs[name], tspecs[name], name)


STATES = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b",
          "xlstm-1.3b")


@pytest.mark.parametrize("order", ["trailing", "leading", "none"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_state_specs_match_jax(mesh, order, monkeypatch):
    """JAX reads ``REPRO_STATE_SPEC_ORDER`` once at import, the port at
    each call: the JAX module's constant is set, the port's variable."""
    monkeypatch.setattr(jrules, "_STATE_AXIS_ORDER", order)
    monkeypatch.setenv("REPRO_STATE_SPEC_ORDER", order)
    jmesh, tmesh = _meshes(mesh)
    for arch in STATES:
        cfg = j_get_config(arch)
        for batch in (32, 3):
            states = jax.eval_shape(
                lambda: jt.init_decode_state(cfg, batch, 64))
            jspecs = jrules.state_specs(states, jmesh)
            tspecs = trules.state_specs(_meta(states), tmesh)
            flat = jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, JP))[0]
            leaves, _ = tree_flatten_with_path(_meta(states))
            assert len(flat) == len(leaves) > 0
            for (_, jspec), (tpath, _) in zip(flat, leaves):
                _same(jspec, _at(tspecs, tpath), (arch, batch, tpath))


SHARDS = [((2, 4), ("data", "model"),
           [JP(), JP("data"), JP("data", "model"), JP(None, "model"),
            JP("model", None, "data"), JP(("data", "model")),
            JP(None, ("model", "data")), JP(None, None, "data")]),
          ((2, 2, 2), ("pod", "data", "model"),
           [JP(("pod", "data"), "model"), JP("model", ("pod", "data")),
            JP(None, None, ("pod", "data", "model")), JP("data")]),
          ((1, 8), ("data", "model"),
           [JP(None, "model"), JP("model"), JP("data", None, "model")])]


@pytest.mark.parametrize("shape,names,specs", SHARDS,
                         ids=["d2m4", "p2d2m2", "d1m8"])
def test_shard_leaf_matches_jax_shards(shape, names, specs):
    jmesh = jax.make_mesh(shape, names)
    x = np.arange(8 * 16 * 24, dtype=np.float32).reshape(8, 16, 24)
    devices = np.asarray(jmesh.devices)
    tmesh = Mesh(names, np.arange(devices.size).reshape(shape))
    for spec in specs:
        arr = jax.device_put(x, NamedSharding(jmesh, spec))
        assert len(arr.addressable_shards) == devices.size
        for shard in arr.addressable_shards:
            coords = tuple(int(i[0]) for i in np.nonzero(
                devices == shard.device))
            got = trules.shard_leaf(torch.from_numpy(x), trules.P(*spec),
                                    tmesh, coords)
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(shard.data))


def test_shard_leaf_refuses_what_jax_refuses():
    tmesh = Mesh(("data", "model"), np.arange(8).reshape(2, 4), (1, 3))
    with pytest.raises(ValueError, match="does not split"):
        trules.shard_leaf(torch.zeros(6, 6), trules.P(None, "model"), tmesh)
    with pytest.raises(ValueError, match="not an axis"):
        trules.shard_leaf(torch.zeros(8), trules.P("pod"), tmesh)
    assert trules.shard_leaf(torch.arange(8), trules.P("model"),
                             tmesh).tolist() == [6, 7]
