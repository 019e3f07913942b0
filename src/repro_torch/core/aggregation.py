"""Server-side aggregation (paper eq. 11 / 12) on one flat buffer.

Port of the unsharded half of ``repro.core.aggregation``. The server
update is

    w ← w − η · Σ_{i∈S_t} p_i · scale_i^t · g_i(w, ξ_i)

a weighted sum over the client axis with ω_i = p_i · mask_i · scale_i.
The whole gradient tree is raveled into one ``(N, P)`` buffer (a cached
:class:`RavelSpec` records where each leaf lives), reduced by one kernel
launch or one matvec per step, and unraveled by offset slicing.
:func:`aggregate_client_grads` is the per-leaf reference the flat path
is held against. The legacy per-leaf carry
(:class:`~repro_torch.core.trainer.ClientSimulator` with ``flat=False``,
or a tree of mixed dtypes) aggregates through
:func:`aggregate_client_grads_flat` (one reduction, or per leaf when the
gradient tree mixes dtypes) and
:func:`aggregate_client_grads_kernel_per_leaf` (K1 once a leaf, each in
its leaf's dtype).

The flat layout is ``jax.tree_util``'s: leaves in sorted-key order
(:mod:`repro_torch._tree`), each row-major. A flat buffer of the port is
therefore the same vector as the JAX package's, element by element.

:func:`per_example_coefficients` carries the same weighting into the
SPMD LM train step (:func:`repro_torch.core.trainer.
build_energy_train_step`), as a coefficient on each example's loss.

The client-sharded half (DESIGN.md §8–9): under an active
:func:`repro_torch.core.energy.client_sharding` context each rank holds
the ``(n_local, P)`` rows of its shard. :func:`make_flat_grads_fn` emits
those rows; :func:`reduce_flat_client_sharded` and the sharded branch of
:func:`fused_flat_sgd_update` reduce across the shard's process group
and leave the server update replicated, each in one of the
:func:`parse_reduction` modes.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, NamedTuple

import torch

from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.core.energy import (client_shard, shard_all_gather,
                                     shard_all_reduce)
from repro_torch.core.scheduling import Decision
from repro_torch.kernels.aggregate import ops as agg_ops
from repro_torch.optim.optimizers import SGDState, resolve_lr


def client_weights(p: torch.Tensor, decision: Decision) -> torch.Tensor:
    """ω_i = p_i · mask_i · scale_i — the per-client aggregation weight."""
    return p * decision.mask * decision.scale


# ----------------------------------------------------- reduction grammar

_REDUCTION_MODES = ("gather", "psum", "fused")


def parse_reduction(reduction: str) -> tuple[str, Any]:
    """Parse a cross-shard reduction string → ``(mode, wire_dtype)``.

    Grammar (DESIGN.md §9): ``gather | psum | psum_bf16 | fused |
    fused_bf16``. The ``_bf16`` suffix quantizes the ``(P,)`` partial
    sums on the wire only: each shard's partial is cast to bf16,
    gathered, and summed in f32. ``gather`` is the bit-for-bit oracle
    and takes no wire dtype.
    """
    mode, _, wire = reduction.partition("_")
    if mode not in _REDUCTION_MODES or wire not in ("", "bf16"):
        raise ValueError(
            f"reduction must be one of gather, psum[_bf16], fused[_bf16]; "
            f"got {reduction!r}")
    if wire and mode == "gather":
        raise ValueError(
            "gather is the bitwise oracle and takes no wire dtype; "
            f"got {reduction!r}")
    return mode, (torch.bfloat16 if wire else None)


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

def accepts_clients_kwarg(grads_fn) -> bool:
    """True if ``grads_fn`` takes a ``clients`` keyword — the client-axis
    sharding protocol (DESIGN.md §8): a client-aware grads_fn is called
    with ``clients=(n_local,) int64`` global client indices and computes
    only those rows. Only an explicitly named ``clients`` parameter opts
    in; a bare ``**kwargs`` does not, since a grads_fn that ignores
    ``clients`` would return full-population rows."""
    try:
        sig = inspect.signature(grads_fn)
    except (TypeError, ValueError):
        return False
    return "clients" in sig.parameters


def make_flat_grads_fn(grads_fn, spec: RavelSpec, n_clients: int):
    """Wrap ``grads_fn`` into an emitter of the flat ``(N, P)`` buffer.

    ``grads_fn`` may return a client-stacked tree mirroring the
    parameter tree (raveled here; a mixed-dtype gradient tree is cast to
    the parameter dtype first) or one ``(N, ...)`` tensor that is flat up
    to a reshape.

    Under an active client-sharding context the wrapper returns this
    shard's ``(n_local, P)`` rows: a client-aware grads_fn
    (:func:`accepts_clients_kwarg`) is called with the shard's global
    client indices; a plain one is called in full, and its rows are
    sliced under ``psum`` / ``fused`` but handed over whole under
    ``gather``, where every rank already holds the same buffer
    (:func:`reduce_flat_client_sharded` then gathers only the weights).
    """
    accepts = accepts_clients_kwarg(grads_fn)

    def flatten(stacked, n_rows):
        if isinstance(stacked, torch.Tensor):
            g = stacked.reshape(n_rows, -1)
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
        shard = client_shard()
        if shard is None:
            return flatten(grads_fn(params, key, t), n_clients)
        n_local = n_clients // shard.shards
        off = shard.index * n_local
        if accepts:
            idx = off + torch.arange(n_local, dtype=torch.int64,
                                     device=key.device)
            return flatten(grads_fn(params, key, t, clients=idx), n_local)
        full = flatten(grads_fn(params, key, t), n_clients)
        if parse_reduction(shard.reduction)[0] == "gather":
            return full
        return full[off:off + n_local]

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


def _cross_shard_sum(partial: torch.Tensor, shard, wire_dtype=None
                     ) -> torch.Tensor:
    """Sum ``(P,)`` partials across ``shard``'s ranks.

    ``wire_dtype=None`` is one f32 ``all_reduce``. With a wire dtype
    (bf16) each rank's partial is quantized once, the parts are
    gathered, and the sum runs in f32 or wider on every rank: one
    rounding per shard, whatever the shard count, where an all-reduce of
    bf16 operands would round at every add.
    """
    if wire_dtype is None:
        return shard_all_reduce(partial, shard)
    acc = _accum_dtype(partial.dtype)
    wired = shard_all_gather(partial.to(wire_dtype)[None], shard)
    return torch.sum(wired.to(acc), dim=0)


def reduce_flat_client_sharded(g: torch.Tensor, weights: torch.Tensor, *,
                               shard, use_kernel: bool = False,
                               out_dtype=None, mask=None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Client-sharded flat reduction: this rank's ``(n_local, P)`` rows →
    the replicated ``((P,), weight_sum)`` across ``shard``'s ranks.

    * ``gather`` — gather the weights and mask (and the rows, unless
      ``g`` is already at full width, as a plain grads_fn gives it) and
      run the unsharded reduction on every rank: bit for bit the
      one-rank result.
    * ``psum`` — one local reduction over this rank's rows (kernel K1
      under ``use_kernel``, through
      :func:`~repro_torch.kernels.aggregate.ops.
      masked_scaled_aggregate_sharded`) and a ``(P,)`` f32 sum across
      the ranks, cast to ``out_dtype`` only after it; the client sum is
      reassociated across shards (f32 tolerance). ``psum_bf16``
      quantizes the partials on the wire (:func:`_cross_shard_sum`).

    ``fused`` is refused here: it owns the parameter step as well and
    lives in :func:`fused_flat_sgd_update`.
    """
    mode, wire_dtype = parse_reduction(shard.reduction)
    if mode == "fused":
        raise ValueError(
            "reduction 'fused' bundles the parameter update; use "
            "fused_flat_sgd_update (the trainer routes it)")
    if mode == "gather":
        weights = shard_all_gather(weights, shard)
        if mask is not None:
            mask = shard_all_gather(mask, shard)
        if g.shape[0] != weights.shape[0]:
            g = shard_all_gather(g, shard)
        out = reduce_flat(g, weights, use_kernel=use_kernel,
                          out_dtype=out_dtype, mask=mask)
        return out, torch.sum(weights)
    od = g.dtype if out_dtype is None else out_dtype
    if use_kernel and wire_dtype is None:
        out = agg_ops.masked_scaled_aggregate_sharded(
            g, weights.to(torch.float32), shard=shard, out_dtype=od,
            mask=mask)
    else:
        partial = reduce_flat(g, weights, use_kernel=use_kernel,
                              out_dtype=_accum_dtype(g.dtype), mask=mask)
        out = _cross_shard_sum(partial, shard, wire_dtype).to(od)
    return out, shard_all_reduce(torch.sum(weights), shard)


def fused_flat_sgd_update(g: torch.Tensor, weights: torch.Tensor,
                          params: torch.Tensor, opt_state, optimizer, *,
                          mask=None, use_kernel: bool = False, shard=None,
                          wire_dtype=None):
    """Fused reduce-and-update (DESIGN.md §9): mask select, per-client
    scaling, the ``(N, P) → (P,)`` reduction and the flat SGD step in one
    pass — one launch of kernel K2 when ``use_kernel``, a matvec and an
    axpy otherwise. Returns ``(new_params, new_opt_state, weight_sum)``.

    Only for a tagged plain-SGD optimizer (``kind == "sgd"``): the step
    is ``w − η·(ω_sel @ g)``, which momentum, Adam or clipping are not.

    Sharded (``shard`` a :class:`~repro_torch.core.energy.ClientShard`):
    each rank's launch emits its local update delta ``−η·(ω_sel @
    g_local)`` (K2's delta form, ``params=None``); SGD is linear in the
    gradient, so ``params + Σ_ranks delta`` is the update of the global
    reduction. The collective stays ``(P,)``-sized
    (:func:`_cross_shard_sum`; ``wire_dtype`` quantizes it to bf16 on
    the wire), and the replicated parameters take the summed delta in
    f32 before the cast back.
    """
    if getattr(optimizer, "kind", "") != "sgd":
        raise ValueError(
            "fused_flat_sgd_update requires a plain sgd() optimizer "
            f"(kind='sgd'); got kind={getattr(optimizer, 'kind', '')!r}")
    eta = resolve_lr(optimizer.hyper, opt_state.step)
    new_state = SGDState(step=opt_state.step + 1)
    w32 = weights.to(torch.float32)
    if shard is None:
        if use_kernel:
            new_params = agg_ops.masked_scaled_aggregate_update(
                g, w32, eta, params, mask)
        else:
            agg = reduce_flat(g, weights, out_dtype=torch.float32, mask=mask)
            new_params = (params.to(torch.float32) - eta * agg).to(params.dtype)
        return new_params, new_state, torch.sum(weights)
    if use_kernel:
        delta = agg_ops.masked_scaled_aggregate_update(g, w32, eta, None,
                                                       mask)
    else:
        agg = reduce_flat(g, weights, out_dtype=torch.float32, mask=mask)
        delta = -eta * agg
    delta = _cross_shard_sum(delta, shard, wire_dtype)
    new_params = (params.to(torch.float32) + delta).to(params.dtype)
    return new_params, new_state, shard_all_reduce(torch.sum(weights), shard)


def aggregate_client_grads_flat(stacked_grads, weights: torch.Tensor, *,
                                use_kernel: bool = False, mask=None):
    """Single-pass aggregation: ravel → one kernel launch or matvec →
    unravel.

    Same contract as :func:`aggregate_client_grads` (f32 accumulation);
    one reduction whatever the number of leaves. A mixed-dtype tree
    falls back to the per-leaf route (K1 once a leaf under
    ``use_kernel``).
    """
    try:
        spec = ravel_spec(stacked_grads, lead_axes=1)
    except ValueError:
        if use_kernel:
            return aggregate_client_grads_kernel_per_leaf(
                stacked_grads, weights, mask)
        return aggregate_client_grads(stacked_grads, weights, mask)
    g = ravel_stacked(stacked_grads, spec)
    return unravel_pytree(
        reduce_flat(g, weights, use_kernel=use_kernel, mask=mask), spec)


def aggregate_client_grads_kernel(stacked_grads, weights: torch.Tensor,
                                  mask=None):
    """Kernel-route aggregation: the tree raveled once into ``(N, P)``
    and reduced by one launch of K1."""
    return aggregate_client_grads_flat(stacked_grads, weights,
                                       use_kernel=True, mask=mask)


def aggregate_client_grads_kernel_per_leaf(stacked_grads,
                                           weights: torch.Tensor, mask=None):
    """One launch of K1 a leaf, each ``(N, ...)`` leaf reduced as an
    ``(N, size)`` buffer into its own dtype: the mixed-dtype fallback
    and the ``ClientSimulator(flat=False)`` route.

    The JAX package rounds ω to the leaf's dtype before its kernel,
    which widens it to f32 again; K1 takes f32 weights, so the rounding
    is made here and a bf16 leaf sees the same ω bits as in JAX.
    """

    def _one(leaf):
        n = leaf.shape[0]
        w = weights.to(leaf.dtype).to(torch.float32)
        out = agg_ops.masked_scaled_aggregate(
            leaf.reshape(n, -1).contiguous(), w, mask=mask)
        return out.reshape(leaf.shape[1:])

    return tree_map(_one, stacked_grads)


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


def server_update(params, aggregated_grads, lr):
    """Plain SGD server update, w ← w − η · aggregate (paper eq. 11),
    leaf by leaf, each aggregate cast to its leaf's dtype."""
    return tree_map(lambda w, g: w - lr * g.to(w.dtype), params,
                    aggregated_grads)
