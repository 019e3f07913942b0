"""Parameter / activation / state partition rules.

Port of ``repro.sharding.rules``. Strategy (MaxText-style FSDP + TP):
  * ``data``  — batch dimension of activations; FSDP dimension of weights
  * ``model`` — tensor parallel: attention heads & FFN columns & experts
  * ``pod``   — pure data parallel across pods (weights replicated
                pod-wise; gradients all-reduce over pod)

Rules are *suffix-matched* on the parameter tree path so the same table
covers stacked parameters — leading (n_super, count) axes are padded
with None. Every named axis is divisibility-checked against the mesh and
dropped when it doesn't divide (e.g. whisper's odd 51865 vocab stays
replicated; xlstm's 4 heads skip TP).

The spec logic is the JAX package's, line for line; it reads only each
leaf's ``.shape`` (a meta tensor serves) and the mesh's axis sizes
(``mesh.shape``, a :class:`repro_torch.experiments.placement.Mesh`'s).
A spec is a :class:`PartitionSpec`, a tuple of ``None``, an axis name
or a tuple of names. ``jax.sharding.NamedSharding`` has no counterpart:
the port's ranks each hold their own block, which :func:`shard_leaf`
cuts. The port applies only the expert axis
(:func:`repro_torch.models.transformer.place_params`); the TP and FSDP
placement these rules specify is ROADMAP work.
"""

from __future__ import annotations

from typing import Any

from repro_torch._env import state_spec_order
from repro_torch._tree import tree_flatten_with_path, tree_map, tree_unflatten

#: The mesh-axis names: experts, heads and FFN columns over "model"; the
#: batch over "pod" and "data", the first the major.
MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")


def _entry(e):
    """A one-name tuple is the name, as ``jax.sharding.PartitionSpec``
    keeps it."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a leading
    axis of the leaf (``None``, an axis name, or a tuple of names whose
    product the axis is split over, the first the major); axes past the
    last entry are replicated. ``tuple(spec)`` reads as JAX's."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(tuple(self))


P = PartitionSpec

# (path-suffix, spec for the TRAILING dims of the leaf)
# Suffixes are matched against the end of the '/'-joined leaf path.
SUFFIX_RULES: list[tuple[str, tuple]] = [
    # attention
    ("attn/wq/w", ("data", "model")),
    ("attn/wk/w", ("data", "model")),
    ("attn/wv/w", ("data", "model")),
    ("attn/wo/w", ("model", "data")),
    ("self/wq/w", ("data", "model")),
    ("self/wk/w", ("data", "model")),
    ("self/wv/w", ("data", "model")),
    ("self/wo/w", ("model", "data")),
    ("cross/wq/w", ("data", "model")),
    ("cross/wk/w", ("data", "model")),
    ("cross/wv/w", ("data", "model")),
    ("cross/wo/w", ("model", "data")),
    # dense FFN
    ("mlp/gate/w", ("data", "model")),
    ("mlp/up/w", ("data", "model")),
    ("mlp/down/w", ("model", "data")),
    # MoE: experts on the model axis (expert parallelism)
    ("moe/router/w", (None, None)),
    ("moe/w_gate", ("model", "data", None)),
    ("moe/w_up", ("model", "data", None)),
    ("moe/w_down", ("model", None, "data")),
    ("moe/shared/gate/w", ("data", "model")),
    ("moe/shared/up/w", ("data", "model")),
    ("moe/shared/down/w", ("model", "data")),
    # SSM mixers
    ("mixer/in_proj/w", ("data", "model")),
    ("mixer/out_proj/w", ("model", "data")),
    ("mixer/wq", ("model", None, None)),
    ("mixer/wk", ("model", None, None)),
    ("mixer/wv", ("model", None, None)),
    ("mixer/w_in/w", ("data", "model")),
    ("mixer/r", ("model", None, None)),
    # embeddings / head
    ("embed/w", ("model", "data")),
    ("lm_head/w", ("data", "model")),
]


def _mesh_shape(mesh) -> dict:
    """Axis name → size."""
    return dict(mesh.shape)


def _path_str(path) -> str:
    """A leaf's path of dict keys and sequence indices, ``/``-joined."""
    return "/".join(str(p) for p in path)


def _axis_size(mesh_shape: dict, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh_shape.get(a, 1)
        return n
    return mesh_shape.get(entry, 1)


def _fit_spec(shape, trailing_spec, mesh_shape) -> PartitionSpec:
    """Pad leading Nones and divisibility-check every named axis."""
    ndim = len(shape)
    k = len(trailing_spec)
    lead = (None,) * (ndim - k)
    fitted = []
    for dim, entry in zip(shape[ndim - k:], trailing_spec):
        size = _axis_size(mesh_shape, entry)
        present = entry is not None and all(
            a in mesh_shape for a in (entry if isinstance(entry, tuple) else (entry,)))
        fitted.append(entry if (present and size > 1 and dim % size == 0) else None)
    return P(*(lead + tuple(fitted)))


def param_specs(params: Any, mesh) -> Any:
    """PartitionSpec tree matching ``params`` (suffix rules + checks)."""
    mesh_shape = _mesh_shape(mesh)

    def one(path, leaf):
        ps = _path_str(path)
        for suffix, spec in SUFFIX_RULES:
            if ps.endswith(suffix):
                return _fit_spec(tuple(leaf.shape), spec, mesh_shape)
        return P()  # norms, biases, gates, scalars: replicated

    leaves, treedef = tree_flatten_with_path(params)
    return tree_unflatten(treedef, [one(path, leaf) for path, leaf in leaves])


def auto_spec(shape, mesh, batch_axis: int | None = 0) -> PartitionSpec:
    """Heuristic spec for activations / decode state leaves.

    Axis ``batch_axis`` shards over ("pod","data") (with fallbacks to
    whichever divides); the first later axis divisible by the model-axis
    size gets "model" (for KV caches this lands on the sequence axis —
    context-parallel cache — or the head axis, whichever divides first).
    """
    mesh_shape = _mesh_shape(mesh)
    ndim = len(shape)
    entries: list = [None] * ndim
    if batch_axis is not None and ndim > 0:
        b = shape[batch_axis]
        for cand in (("pod", "data"), ("data",), ("pod",)):
            if all(a in mesh_shape for a in cand):
                size = _axis_size(mesh_shape, tuple(cand))
                if size > 1 and b % size == 0:
                    entries[batch_axis] = cand if len(cand) > 1 else cand[0]
                    break
    msize = mesh_shape.get("model", 1)
    if msize > 1:
        for ax in range(ndim):
            if ax == batch_axis or entries[ax] is not None:
                continue
            if shape[ax] % msize == 0 and shape[ax] >= msize:
                entries[ax] = "model"
                break
    return P(*entries)


def batch_specs(batch: Any, mesh) -> Any:
    """Specs for a training/prefill batch: leading axis = global batch."""
    return tree_map(lambda leaf: auto_spec(tuple(leaf.shape), mesh,
                                           batch_axis=0), batch)


def state_specs(states: Any, mesh) -> Any:
    """Specs for decode state trees.

    Leaves carry leading (n_super[, count]) stacking axes before the batch
    axis; the first axis divisible by the (pod×data) size is treated as
    batch, and one later axis (order per :func:`repro_torch._env.
    state_spec_order`) divisible by the model-axis size gets "model".
    """
    mesh_shape = _mesh_shape(mesh)
    dp = _axis_size(mesh_shape, ("pod", "data")) if "pod" in mesh_shape \
        else _axis_size(mesh_shape, ("data",))
    msize = mesh_shape.get("model", 1)
    dp_axes = ("pod", "data") if "pod" in mesh_shape else "data"
    order_name = state_spec_order()

    def one(leaf):
        shape = tuple(leaf.shape)
        entries: list = [None] * len(shape)
        batch_axis = None
        for ax, dim in enumerate(shape):
            if dim % dp == 0 and dim >= dp:
                batch_axis = ax
                entries[ax] = dp_axes
                break
        if msize > 1 and order_name != "none":
            start = (batch_axis + 1) if batch_axis is not None else 0
            order = range(len(shape) - 1, start - 1, -1) \
                if order_name == "trailing" else range(start, len(shape))
            for ax in order:
                if entries[ax] is None and shape[ax] % msize == 0 \
                        and shape[ax] >= msize:
                    entries[ax] = "model"
                    break
        return P(*entries)

    return tree_map(one, states)


def block_index(entry, mesh, coords=None) -> tuple[int, int]:
    """(index, count): which of ``count`` equal blocks of an axis split
    over ``entry`` (an axis name, or a tuple of names, the first the
    major) the rank at ``coords`` (default: this rank's, ``mesh.coords``)
    holds; ``(0, 1)`` for ``None``."""
    if entry is None:
        return 0, 1
    coords = mesh.coords if coords is None else tuple(coords)
    if coords is None:
        raise ValueError("this rank is not in the mesh: it holds no block")
    names = tuple(mesh.axis_names)
    sizes = _mesh_shape(mesh)
    index, count = 0, 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        if a not in sizes:
            raise ValueError(f"spec axis {a!r} is not an axis of the mesh "
                             f"{names}")
        index = index * sizes[a] + coords[names.index(a)]
        count *= sizes[a]
    return index, count


def shard_leaf(x, spec, mesh, coords=None):
    """The block of ``x`` that ``jax.sharding.NamedSharding(mesh, spec)``
    gives the device at ``coords`` (default: this rank's, ``mesh.coords``):
    each axis split over its entry's ranks into equal blocks, the rest
    whole. A view of ``x``; an axis the entry does not divide raises, as
    JAX's sharding does."""
    spec = tuple(spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{x.dim()} axes")
    index = []
    for axis, entry in enumerate(spec):
        i, n = block_index(entry, mesh, coords)
        dim = x.shape[axis]
        if dim % n:
            raise ValueError(f"axis {axis} of size {dim} does not split "
                             f"into {n} blocks over {entry!r}")
        size = dim // n
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)]


__all__ = ["PartitionSpec", "P", "SUFFIX_RULES", "MODEL_AXIS", "DATA_AXES",
           "param_specs", "auto_spec", "batch_specs", "state_specs",
           "block_index", "shard_leaf"]
