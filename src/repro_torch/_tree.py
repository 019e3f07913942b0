"""Parameter trees as plain containers, flattened in ``jax.tree_util`` order.

The JAX package keeps parameters and optimizer state as pytrees. The
port keeps the same containers (dicts, tuples, NamedTuples, lists) and
flattens them in the order ``jax.tree_util`` does: dict keys sorted,
sequences in order, ``None`` an empty node. That order fixes the layout
of the flat ``(P,)`` buffer (:func:`repro_torch.core.aggregation.
ravel_spec`), so flat parameter and gradient buffers of the two packages
can be compared element by element. ``torch.utils._pytree`` keeps dicts
in insertion order, which is why the port does not use it here.

:func:`tree_flatten_with_path` gives each leaf a readable path in the
same order — a dict key, a NamedTuple field name or a sequence index a
level — and :func:`key_str` joins one with ``/``, as the JAX package
names checkpoint members (``carry/params``, ``carry/fault_state/0``).
"""

from __future__ import annotations

from typing import Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(node, path, leaves):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("dict", keys,
                tuple(_walk(node[k], path + (k,), leaves) for k in keys))
    if _is_namedtuple(node):
        return ("namedtuple", type(node),
                tuple(_walk(c, path + (f,), leaves)
                      for f, c in zip(node._fields, node)))
    if isinstance(node, (tuple, list)):
        return (type(node).__name__,
                tuple(_walk(c, path + (i,), leaves)
                      for i, c in enumerate(node)))
    leaves.append((path, node))
    return ("leaf",)


def tree_flatten_with_path(tree) -> tuple[list[tuple[tuple, Any]], Any]:
    """``tree`` → ([(path, leaf), ...], treedef); ``treedef`` is
    hashable and ``path`` is a tuple of dict keys, NamedTuple field
    names and sequence indices."""
    # The recursion is a module function: a nested one would hold itself
    # and the leaves in a reference cycle, which keeps every leaf (a
    # model's weights) alive until the garbage collector runs.
    leaves: list = []
    return leaves, _walk(tree, (), leaves)


def key_str(path) -> str:
    """A leaf's path as ``a/b/0``."""
    return "/".join(map(str, path))


def tree_flatten(tree) -> tuple[list, Any]:
    """``tree`` → (leaves, treedef); ``treedef`` is hashable."""
    leaves, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in leaves], treedef


def _build(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    if kind == "namedtuple":
        return d[1](*(_build(c, it) for c in d[2]))
    children = [_build(c, it) for c in d[1]]
    return tuple(children) if kind == "tuple" else children


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])
