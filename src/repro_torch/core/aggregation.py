"""Server-side aggregation (paper eq. 11 / 12) on one flat buffer.

Port of the unsharded half of ``repro.core.aggregation``. The server
update is

    w ← w − η · Σ_{i∈S_t} p_i · scale_i^t · g_i(w, ξ_i)

a weighted sum over the client axis with ω_i = p_i · mask_i · scale_i.
The whole gradient tree is raveled into one ``(N, P)`` buffer (a cached
:class:`RavelSpec` records where each leaf lives), reduced by one kernel
launch or one matvec per step, and unraveled by offset slicing.
:func:`aggregate_client_grads` is the per-leaf reference the flat path
is held against.

The flat layout is ``jax.tree_util``'s: leaves in sorted-key order
(:mod:`repro_torch._tree`), each row-major. A flat buffer of the port is
therefore the same vector as the JAX package's, element by element.

:func:`per_example_coefficients` carries the same weighting into the
SPMD LM train step (:func:`repro_torch.core.trainer.
build_energy_train_step`), as a coefficient on each example's loss.

The client-sharded half (``reduce_flat_client_sharded``,
``_cross_shard_sum``, the sharded branch of
:func:`fused_flat_sgd_update`) waits for ROADMAP Queue 1 step 7.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.core.scheduling import Decision
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.optim.optimizers import SGDState, resolve_lr


def client_weights(p: torch.Tensor, decision: Decision) -> torch.Tensor:
    """ω_i = p_i · mask_i · scale_i — the per-client aggregation weight."""
    return p * decision.mask * decision.scale


def _mask_rows(leaf: torch.Tensor, mask) -> torch.Tensor:
    """Zero the masked-out client rows of an (N, ...) buffer.

    A select, not a multiply: padded rows contribute exact zeros even
    when a grads_fn emits inf/NaN for clients that do not exist
    (DESIGN.md §7), and active rows are untouched.
    """
    if mask is None:
        return leaf
    m = mask.reshape((-1,) + (1,) * (leaf.dim() - 1))
    return torch.where(m > 0, leaf, torch.zeros((), dtype=leaf.dtype,
                                                device=leaf.device))


def compose_masks(*masks):
    """Product of (N,) 0/1 row masks; ``None`` means no constraint and
    drops out, and all-None composes to None."""
    out = None
    for m in masks:
        if m is None:
            continue
        out = m if out is None else out * m
    return out


# --------------------------------------------------------------- raveler

class RavelSpec(NamedTuple):
    """Static flat-space layout of a tree: where each leaf lives in P.

    ``shapes`` exclude leading batch axes, so one spec describes both the
    stacked ``(N, P)`` gradient buffer and the ``(P,)`` parameter vector.
    """

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    dtype: Any
    total: int


_SPEC_CACHE: dict = {}


def ravel_spec(tree, *, lead_axes: int = 0) -> RavelSpec:
    """Cached flat-space spec for ``tree``; ``lead_axes`` axes are
    stripped from every leaf shape. Raises ``ValueError`` on mixed leaf
    dtypes (the flat buffer is one concatenation)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot ravel an empty tree")
    shapes = tuple(tuple(l.shape[lead_axes:]) for l in leaves)
    dtypes = {l.dtype for l in leaves}
    if len(dtypes) != 1:
        raise ValueError(
            f"flat path needs a single leaf dtype, got {sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    key = (treedef, shapes, dtype)
    spec = _SPEC_CACHE.get(key)
    if spec is None:
        sizes = tuple(math.prod(s) for s in shapes)
        offsets, off = [], 0
        for sz in sizes:
            offsets.append(off)
            off += sz
        spec = RavelSpec(treedef=treedef, shapes=shapes, offsets=tuple(offsets),
                         sizes=sizes, dtype=dtype, total=off)
        _SPEC_CACHE[key] = spec
    return spec


def ravel_pytree(tree, spec: RavelSpec | None = None) -> torch.Tensor:
    """Concatenate every leaf of ``tree`` into one ``(P,)`` vector."""
    leaves = tree_leaves(tree)
    if len(leaves) == 1:
        return leaves[0].reshape(-1)
    return torch.cat([l.reshape(-1) for l in leaves])


def ravel_stacked(tree, spec: RavelSpec | None = None) -> torch.Tensor:
    """Client-stacked tree (leaves ``(N, ...)``) → one ``(N, P)`` buffer."""
    leaves = tree_leaves(tree)
    n = leaves[0].shape[0]
    if len(leaves) == 1:
        return leaves[0].reshape(n, -1)
    return torch.cat([l.reshape(n, -1) for l in leaves], dim=1)


def unravel_pytree(vec: torch.Tensor, spec: RavelSpec):
    """``(..., P)`` flat vector → tree with leaves ``(..., *shape)``
    (views into ``vec``)."""
    lead = tuple(vec.shape[:-1])
    parts = [vec[..., o:o + sz].reshape(lead + shp)
             for o, sz, shp in zip(spec.offsets, spec.sizes, spec.shapes)]
    return tree_unflatten(spec.treedef, parts)


# ------------------------------------------------ flat grads_fn boundary

def make_flat_grads_fn(grads_fn, spec: RavelSpec, n_clients: int):
    """Wrap ``grads_fn`` into an emitter of the flat ``(N, P)`` buffer.

    ``grads_fn`` may return a client-stacked tree mirroring the
    parameter tree (raveled here; a mixed-dtype gradient tree is cast to
    the parameter dtype first) or one ``(N, ...)`` tensor that is flat up
    to a reshape.
    """

    def flatten(stacked):
        if isinstance(stacked, torch.Tensor):
            g = stacked.reshape(n_clients, -1)
            if g.shape[1] != spec.total:
                raise ValueError(
                    f"flat grads_fn output has {g.shape[1]} parameters per "
                    f"client; the parameter tree has {spec.total}")
            return g
        try:
            gspec = ravel_spec(stacked, lead_axes=1)
        except ValueError:
            stacked = tree_map(lambda x: x.to(spec.dtype), stacked)
            gspec = ravel_spec(stacked, lead_axes=1)
        if gspec.shapes != spec.shapes or gspec.treedef != spec.treedef:
            raise ValueError(
                "grads_fn output does not mirror the parameter tree; "
                "flat-carry execution needs matching structure+shapes "
                f"(params {spec.shapes}, grads {gspec.shapes})")
        return ravel_stacked(stacked, gspec)

    def flat_grads(params, key, t):
        return flatten(grads_fn(params, key, t))

    return flat_grads


# ----------------------------------------------------- aggregation paths

def aggregate_client_grads(stacked_grads, weights: torch.Tensor, mask=None):
    """Per-leaf weighted sum over the leading (client) axis — the
    reference path, leaf dtypes kept."""

    def _one(leaf):
        w = weights.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.dtype)
        return torch.sum(w * _mask_rows(leaf, mask), dim=0)

    return tree_map(_one, stacked_grads)


def _accum_dtype(dtype):
    return torch.float64 if dtype == torch.float64 else torch.float32


def reduce_flat(g: torch.Tensor, weights: torch.Tensor, *,
                use_kernel: bool = False, out_dtype=None,
                mask=None) -> torch.Tensor:
    """``(N, P)`` flat gradient buffer → ``(P,)`` = ω @ g, in one pass.

    Accumulation is f32 or wider; ``out_dtype`` overrides the result
    dtype (e.g. bf16 client gradients into an f32 aggregate). ``mask``
    rows are excluded exactly (a row select). ``use_kernel`` routes
    through kernel K1 (:func:`repro_torch.kernels.aggregate.ops.
    masked_scaled_aggregate`); otherwise one torch matvec.
    """
    od = g.dtype if out_dtype is None else out_dtype
    if use_kernel:
        return agg_ops.masked_scaled_aggregate(
            g, weights.to(torch.float32), out_dtype=od, mask=mask)
    acc = _accum_dtype(g.dtype)
    out = weights.to(acc) @ _mask_rows(g, mask).to(acc)
    return out.to(od)


def fused_flat_sgd_update(g: torch.Tensor, weights: torch.Tensor,
                          params: torch.Tensor, opt_state, optimizer, *,
                          mask=None, use_kernel: bool = False, shard=None):
    """Fused reduce-and-update (DESIGN.md §9): mask select, per-client
    scaling, the ``(N, P) → (P,)`` reduction and the flat SGD step in one
    pass — one launch of kernel K2 when ``use_kernel``, a matvec and an
    axpy otherwise. Returns ``(new_params, new_opt_state, weight_sum)``.

    Only for a tagged plain-SGD optimizer (``kind == "sgd"``): the step
    is ``w − η·(ω_sel @ g)``, which momentum, Adam or clipping are not.
    """
    if getattr(optimizer, "kind", "") != "sgd":
        raise ValueError(
            "fused_flat_sgd_update requires a plain sgd() optimizer "
            f"(kind='sgd'); got kind={getattr(optimizer, 'kind', '')!r}")
    if shard is not None:
        raise NotImplementedError(
            "client-sharded fused update: ROADMAP Queue 1 step 7")
    eta = resolve_lr(optimizer.hyper, opt_state.step)
    new_state = SGDState(step=opt_state.step + 1)
    w32 = weights.to(torch.float32)
    if use_kernel:
        new_params = agg_ops.masked_scaled_aggregate_update(
            g, w32, eta, params, mask)
    else:
        agg = reduce_flat(g, weights, out_dtype=torch.float32, mask=mask)
        new_params = (params.to(torch.float32) - eta * agg).to(params.dtype)
    return new_params, new_state, torch.sum(weights)


def per_example_coefficients(client_ids: torch.Tensor, weights: torch.Tensor,
                             examples_per_client) -> torch.Tensor:
    """Per-example loss coefficients realizing the paper's update in SPMD.

    If client i owns b_i examples of the batch and g_i is the *mean*
    gradient over its examples, then

        Σ_i ω_i g_i = Σ_i Σ_{j∈i} (ω_i / b_i) · ∇l_ij

    so example j of client i gets coefficient ω_i / b_i, and the gradient
    of ``sum(coeff * per_example_loss)`` is the paper's aggregated update.

    client_ids : (B,) int — owning client of each example.
    weights    : (N,) float32 — ω_i.
    examples_per_client : scalar or (N,) — b_i (a per-client b_i below 1
        is taken as 1).
    """
    b = torch.as_tensor(examples_per_client, dtype=torch.float32,
                        device=weights.device)
    if b.dim() == 0:
        per_client = weights / b
    else:
        per_client = weights / torch.clamp(b, min=1.0)
    return per_client[client_ids.long()]
