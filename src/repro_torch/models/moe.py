"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``: ``init_moe`` key for key, and
``apply_moe`` on both of the JAX package's paths.

Dispatch is scatter/gather based, as in the JAX package: each (token, k)
assignment gets its position among its expert's assignments, counted in
token-major, k-minor order; assignments at a position of ``capacity`` or
beyond drop (combine weight 0, the residual passes through). Kept rows
are copied into their own slots of an ``(E·capacity, d)`` buffer, so no
slot is written twice and no sum runs through float atomics; the
experts run as batched products over the buffer, and each token's k
outputs are gathered back and summed in order.

**The global path** (off a mesh, or where the expert-parallel path does
not apply) runs every expert on this rank. Under a mesh the token axis
counts as ``ds`` data shards (:func:`_data_shards`): positions are
counted within each shard, the capacity is a shard's, and token t of
shard s can only take slots of shard s's slice, slot
``(e·ds + s)·capacity + position``.

**The expert-parallel path** (:func:`_apply_moe_ep`, the JAX package's
``_apply_moe_shardmap``), under a mesh of ranks with a ``"model"`` axis
(:func:`repro_torch.models.common.use_mesh`) whose size divides the
experts, when the data axes divide the batch: each rank holds its
``E/tp`` experts (:func:`repro_torch.models.transformer.place_params`)
and its data shard's rows, replicated over ``"model"``. It routes its
tokens over all E experts, counts positions over its tokens, keeps only
the assignments to its own experts (:func:`_local_moe`), and the partial
outputs of a data row are summed by one ``all_reduce`` over the row's
process group, in the activations' dtype; the load-balance loss is the
mean of the ranks' own. It trains as the JAX package's ``shard_map``
transposes (``check_rep=False``): the sum's backward is the identity
(every rank of a row holds the same cotangent), the gradients of the
rank's tokens and of the router, replicated over ``"model"``, are summed
over the row (each rank's covers its own experts' share), and the aux's
mean passes back ``1/(dp·tp)`` of its cotangent with no collective. With
the data-axis sum of a training step
(:func:`repro_torch.core.trainer.build_energy_train_step`) every leaf
gets the gradient JAX's does under the same mesh. Every rank issues the
same collectives in the same order, in a recomputation under remat too.

Covers both MoE configs: phi3.5-moe (16 experts, top-2) and
llama4-scout (16 experts, top-1, plus an always-on shared expert, added
after the reduction).

:data:`dispatch_counts` counts the assignments routed and dropped since
:func:`reset_dispatch_counts` (tensors, so counting adds no
synchronisation); on the expert-parallel path a rank counts the
assignments to its own experts. Every call of :func:`apply_moe` adds to
it, so a forward under remat counts its recomputation too. While
:data:`routing_log` is a list, every call appends its routing choice
``(top_e, keep)`` for this rank's tokens, both ``(T, K)``, one entry a
layer in call order; ``keep`` is the capacity's verdict, whichever rank
holds the expert.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch import random as trandom
from repro_torch._tree import tree_flatten_with_path
from repro_torch.models.common import (
    activation,
    current_mesh,
    data_shards,
    dense,
    dense_init,
    lecun_init,
    rows_split,
)
from repro_torch.sharding.rules import block_index

dispatch_counts = {"assigned": 0, "dropped": 0}
routing_log = None

#: The expert leaves of an MoE layer, split over the "model" axis on
#: their expert axis (the third from last; the JAX package's in_spec
#: ``P("model", None, None)``).
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def reset_dispatch_counts():
    for name in dispatch_counts:
        dispatch_counts[name] = 0


def dropped_share() -> float:
    """The dropped share of the assignments counted since the last reset
    (0.0 when none were)."""
    assigned = int(dispatch_counts["assigned"])
    return int(dispatch_counts["dropped"]) / assigned if assigned else 0.0


def expert_slice(n_experts: int, mesh=None) -> slice | None:
    """This rank's experts under ``mesh`` (default: the current one): its
    block of ``n_experts`` over the ``"model"`` axis, or None when the
    rank holds them all (no mesh, no ``"model"`` axis of more than one
    rank, or one that does not divide them)."""
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        return None
    tp = dict(mesh.shape).get("model", 1)
    if tp == 1 or n_experts % tp:
        return None
    index, _ = block_index("model", mesh)
    count = n_experts // tp
    return slice(index * count, (index + 1) * count)


def model_split(params) -> frozenset:
    """The paths of the leaves of a model tree ``params`` of which a rank
    holds its block over ``"model"`` (``place_params``, ``init_lm(mesh=)``):
    each MoE layer's expert leaves that hold fewer experts than its
    router scores. A global gradient norm sums their squares over the
    rank's row (:func:`repro_torch.optim.chain_clip`'s ``split``)."""
    leaves, _ = tree_flatten_with_path(params)
    scored = {tuple(path[:-2]): leaf.shape[-1] for path, leaf in leaves
              if tuple(path[-3:]) == ("moe", "router", "w")}
    return frozenset(
        tuple(path) for path, leaf in leaves
        if len(path) > 1 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES
        and leaf.shape[-3] < scored.get(tuple(path[:-1]), 0))


def init_moe(key, d_model, d_ff, n_experts, dtype, use_bias=False,
             shared_expert=False, shared_d_ff=None):
    """The JAX package's ``init_moe``: an f32 router beside experts in
    ``dtype``, ``(E, d_model, d_ff)`` and ``(E, d_ff, d_model)``. Under a
    mesh that splits the experts (:func:`expert_slice`), only this rank's
    are drawn, with the bits they have in the whole draw."""
    ks = trandom.split(key, 5)
    rows = expert_slice(n_experts)
    p = {
        "router": dense_init(ks[0], d_model, n_experts, torch.float32),
        "w_gate": lecun_init(ks[1], (n_experts, d_model, d_ff), dtype,
                             fan_in=d_model, rows=rows),
        "w_up": lecun_init(ks[2], (n_experts, d_model, d_ff), dtype,
                           fan_in=d_model, rows=rows),
        "w_down": lecun_init(ks[3], (n_experts, d_ff, d_model), dtype,
                             fan_in=d_ff, rows=rows),
    }
    if shared_expert:
        from repro_torch.models.blocks import init_mlp  # avoids a cycle
        p["shared"] = init_mlp(ks[4], d_model, shared_d_ff or d_ff, dtype,
                               use_bias)
    return p


def route(router, xt, *, n_experts, top_k, capacity_factor, ds=1):
    """The router's choice for tokens ``xt`` (T, d): softmax probabilities
    of the f32 logits (T, E), the top-k experts (T, K) in ``lax.top_k``'s
    order (a tie goes to the lower expert index: a stable descending
    sort), their renormalised weights, each assignment's position among
    its expert's (T·K,) within its data shard (the tokens as ``ds``
    equal shards), and a shard's capacity. The two parts run under the
    ``torch.profiler`` ranges ``moe_router`` and ``moe_dispatch``."""
    t = xt.shape[0]
    with record_function("moe_router"):
        logits = dense(router, xt.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    cap = int(max(1, ((t // ds) * top_k * capacity_factor) // n_experts))
    with record_function("moe_dispatch"):
        # The one-hot expert-major, (DS, E, T·K/DS): each expert's running
        # count is a scan along contiguous memory (token-major, as JAX's
        # cumsum over the assignments), where a (T·K, E) layout would
        # scan each expert's column with a stride of E.
        flat_e = top_e.reshape(ds, -1)
        experts = torch.arange(n_experts, device=xt.device)[:, None]
        counts = torch.cumsum(
            (flat_e[:, None, :] == experts).to(torch.int32), dim=2)
        pos = torch.gather(counts, 1, flat_e[:, None, :])[:, 0] - 1
    return probs, top_p, top_e, pos.reshape(-1), cap


def _experts(buf, w_gate, w_up, w_down, act_fn):
    with record_function("moe_experts"):
        h = act_fn(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
        return torch.bmm(h, w_down)


def _combine(out, slot, keep, top_p, t, top_k, dtype):
    """Each token's k expert outputs, weighted and summed in order from
    zero, as the JAX package's scatter-add."""
    with record_function("moe_combine"):
        w = torch.where(keep, top_p.reshape(-1), 0.0).to(dtype)
        terms = (out[slot] * w[:, None]).reshape(t, top_k, -1)
        y = torch.zeros((t, out.shape[-1]), dtype=dtype, device=out.device)
        for k in range(top_k):
            y = y + terms[:, k]
    return y


def _dispatch(xt, slot, keep, n_slots, top_k):
    """The kept assignments' rows in their slots of an ``(n_slots, d)``
    buffer. A dropped one goes to a spare row past the buffer, cut off
    before the experts; the JAX package adds dropped rows as zeros into
    a slot instead, which leaves it unchanged."""
    tok_idx = torch.arange(xt.shape[0], device=xt.device).repeat_interleave(
        top_k)
    buf = torch.zeros((n_slots + 1, xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    buf[torch.where(keep, slot, n_slots)] = xt[tok_idx]
    return buf[:n_slots]


def _aux_terms(probs, top_e, n_experts):
    """The Switch load-balance loss's two factors: each expert's share of
    the tokens' first choices, and its mean probability."""
    frac = torch.mean(torch.nn.functional.one_hot(
        top_e[:, 0], n_experts).to(torch.float32), dim=0)
    return frac, torch.mean(probs, dim=0)


def _log(top_e, keep_all, counted, dropped):
    dispatch_counts["assigned"] += counted
    dispatch_counts["dropped"] += dropped
    if routing_log is not None:
        routing_log.append((top_e, keep_all.reshape(top_e.shape)))


class _RowSum(torch.autograd.Function):
    """The partial outputs of a data row summed in place by one
    ``all_reduce`` over the row's group; the backward is the identity,
    since every rank of the row holds the same cotangent."""

    @staticmethod
    def forward(ctx, y, group):
        with record_function("moe_all_reduce"):
            dist.all_reduce(y, group=group)
        ctx.mark_dirty(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _RowReplicated(torch.autograd.Function):
    """Tensors replicated over a data row (the rank's tokens, the router
    weight) as they are; the backward sums their gradients over the
    row's group, in argument order, since each rank's covers only its
    own experts' share."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for g in grads:
            g = g.clone(memory_format=torch.contiguous_format)
            with record_function("moe_all_reduce"):
                dist.all_reduce(g, group=ctx.group)
            out.append(g)
        return (None, *out)


class _MeshMean(torch.autograd.Function):
    """The sum over ``group`` divided by ``size``; the backward passes
    back ``back`` of the cotangent with no collective (the rest of the
    mean's transpose is the sums the gradients take after it)."""

    @staticmethod
    def forward(ctx, x, group, size, back):
        ctx.back = back
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / size

    @staticmethod
    def backward(ctx, g):
        return g * ctx.back, None, None, None


def _local_moe(router_w, w_gate, w_up, w_down, xt, *, n_experts, top_k,
               act, capacity, e_start, e_count):
    """A rank's MoE over its slice of experts (the JAX package's
    ``shard_map`` body helper).

    xt: (t_local, d) — this data shard's tokens (replicated across the
    model axis). w_*: (e_count, …) — this rank's experts. Positions are
    counted over the rank's tokens and all E experts; an assignment is
    kept where its position is below ``capacity`` and its expert is in
    ``[e_start, e_start + e_count)``. Returns this rank's *partial*
    output (its experts' contributions only) and its tokens' aux loss;
    the caller sums the outputs over "model"."""
    act_fn = activation(act)
    t, d = xt.shape
    # The capacity is the caller's (a data shard's), not route's.
    probs, top_p, top_e, pos, _ = route(
        {"w": router_w}, xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=0.0)
    with record_function("moe_dispatch"):
        flat_e = top_e.reshape(-1)
        mine = (flat_e >= e_start) & (flat_e < e_start + e_count)
        fits = pos < capacity
        keep = fits & mine
        local_e = torch.clamp(flat_e - e_start, 0, e_count - 1)
        slot = local_e * capacity + torch.clamp(pos, max=capacity - 1)
        buf = _dispatch(xt, slot, keep, e_count * capacity, top_k)
        _log(top_e, fits, torch.sum(mine), torch.sum(mine & ~fits))
    out = _experts(buf.reshape(e_count, capacity, d), w_gate, w_up, w_down,
                   act_fn).reshape(e_count * capacity, d)
    y = _combine(out, slot, keep, top_p, t, top_k, xt.dtype)
    frac, mean_p = _aux_terms(probs, top_e, n_experts)
    return y, n_experts * torch.sum(frac * mean_p)


def _apply_moe_ep(params, x, *, n_experts, top_k, act, capacity_factor,
                  mesh):
    """Expert-parallel MoE across the mesh's ranks (the JAX package's
    ``_apply_moe_shardmap``). ``x`` is this rank's rows (B/dp, S, D),
    replicated over "model"; ``params``' experts are its ``E/tp``. Every
    rank of a data row dispatches the SAME tokens to ITS expert slice,
    and the partial outputs combine with one ``all_reduce`` over the
    row's "model" group: a (t_local, d) sum a layer."""
    sizes = dict(mesh.shape)
    tp, dp = sizes["model"], data_shards(mesh)
    if dp > 1 and not rows_split():
        raise ValueError(
            f"the expert-parallel MoE path over {dp} data shards takes this "
            f"rank's rows: give use_mesh(mesh, batch=...) the global batch "
            f"and each rank its data_rows")
    b, s, d = x.shape
    capacity = int(max(1, (b * s * top_k * capacity_factor) // n_experts))
    e_count = n_experts // tp
    if params["w_gate"].shape[0] != e_count:
        raise ValueError(
            f"this rank's expert leaves hold {params['w_gate'].shape[0]} "
            f"experts; the {tp}-way 'model' axis gives it {e_count} of "
            f"{n_experts} (place_params)")
    index, _ = block_index("model", mesh)
    xt, router_w = x.reshape(-1, d), params["router"]["w"]
    if tp > 1:
        xt, router_w = _RowReplicated.apply(mesh.row_group, xt, router_w)
    y, aux = _local_moe(router_w, params["w_gate"], params["w_up"],
                        params["w_down"], xt, n_experts=n_experts,
                        top_k=top_k, act=act, capacity=capacity,
                        e_start=index * e_count, e_count=e_count)
    if tp > 1:
        y = _RowSum.apply(y, mesh.row_group)
    if mesh.group is not None:
        # Each rank's aux counts its data shard's tokens once a rank of
        # the row: 1/(dp·tp) of the cotangent, summed over the row by the
        # router's and the tokens' backward, then over the data shards.
        aux = _MeshMean.apply(aux.reshape(1), mesh.group, mesh.size,
                              1.0 / mesh.size)[0]
    return y.reshape(b, s, d), aux


def _data_shards(t: int) -> int:
    """Number of data shards the token axis is split over (1 off-mesh)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    dp = data_shards(mesh)
    return dp if dp > 1 and t % dp == 0 else 1


def _expert_parallel(mesh, n_experts: int, b: int) -> bool:
    """Whether ``apply_moe`` takes the expert-parallel path for ``b`` rows
    of this rank: the JAX package's conditions on the global batch."""
    if mesh is None or "model" not in mesh.axis_names:
        return False
    tp, dp = dict(mesh.shape)["model"], data_shards(mesh)
    b_all = b * dp if rows_split() else b
    return n_experts % tp == 0 and b_all % max(dp, 1) == 0


def check_expert_shards(stack, n_experts: int, b: int):
    """Under a mesh, before any layer runs: every MoE layer of ``stack``
    must hold the experts its path takes on this rank for ``b`` rows
    (``E/tp`` on the expert-parallel path, all E else). A mismatch on any
    rank raises on every rank of the mesh (a rank that raised alone
    would leave the others waiting in a collective)."""
    mesh = current_mesh()
    if mesh is None:
        return
    want = n_experts
    if _expert_parallel(mesh, n_experts, b):
        want //= dict(mesh.shape)["model"]
    leaves, _ = tree_flatten_with_path(stack)
    bad = [("/".join(map(str, path)), tuple(leaf.shape))
           for path, leaf in leaves
           if len(path) > 1 and path[-2] == "moe" and path[-1] in EXPERT_LEAVES
           and leaf.shape[-3] != want]
    flag = torch.tensor([len(bad)], device=leaves[0][1].device)
    if mesh.group is not None:
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
    if int(flag[0]):
        mine = f"; this rank's: {bad[0][0]} {bad[0][1]}" if bad else ""
        raise ValueError(
            f"a rank's MoE expert leaves do not hold the {want} experts of "
            f"{n_experts} its path takes for {b} rows on the mesh "
            f"{dict(mesh.shape)}{mine}")


def apply_moe(params, x, *, n_experts, top_k, act="silu",
              capacity_factor=1.25, shared_expert=False):
    """x: (B, S, D) -> (y, aux_loss), as the JAX package's ``apply_moe``.
    Under a mesh, ``x`` is this rank's rows (:func:`repro_torch.models.
    common.data_rows`)."""
    b, s, d = x.shape
    mesh = current_mesh()
    if _expert_parallel(mesh, n_experts, b):
        y, aux = _apply_moe_ep(params, x, n_experts=n_experts, top_k=top_k,
                               act=act, capacity_factor=capacity_factor,
                               mesh=mesh)
        if shared_expert:
            from repro_torch.models.blocks import apply_mlp  # avoids a cycle
            y = y + apply_mlp(params["shared"], x, act=act)
        return y, aux
    t = b * s
    xt = x.reshape(t, d)
    act_fn = activation(act)
    # Rows split over the data shards are one shard: positions and the
    # capacity count over this rank's tokens; the aux's factors are then
    # averaged over the shards below.
    split = rows_split()
    ds = 1 if split else _data_shards(t)
    probs, top_p, top_e, pos, cap = route(
        params["router"], xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, ds=ds)
    with record_function("moe_dispatch"):
        keep = pos < cap
        flat_e = top_e.reshape(-1)
        shard = torch.arange(ds, device=x.device).repeat_interleave(
            t // ds * top_k)
        slot = (flat_e * ds + shard) * cap + torch.clamp(pos, max=cap - 1)
        buf = _dispatch(xt, slot, keep, n_experts * ds * cap, top_k)
        _log(top_e, keep, keep.numel(), torch.sum(~keep))
    out = _experts(buf.reshape(n_experts, ds * cap, d), params["w_gate"],
                   params["w_up"], params["w_down"], act_fn).reshape(-1, d)
    y = _combine(out, slot, keep, top_p, t, top_k, x.dtype)

    if shared_expert:
        from repro_torch.models.blocks import apply_mlp  # avoids a cycle
        y = y + apply_mlp(params["shared"], x, act=act).reshape(t, d)

    # Switch load-balance aux loss: E · Σ_e f_e · P_e, over the batch.
    frac, mean_p = _aux_terms(probs, top_e, n_experts)
    if split and mesh.group is not None:
        # Every rank's factors summed (the "model" ranks of a shard hold
        # the same), then the mean over the shards. Every leaf is whole
        # on the ranks of a row and not summed along it, so the backward
        # passes back 1/dp of the cotangent, then summed over the shards.
        frac, mean_p = _MeshMean.apply(torch.stack([frac, mean_p]),
                                       mesh.group, mesh.size,
                                       1.0 / data_shards(mesh))
    aux = n_experts * torch.sum(frac * mean_p)
    return y.reshape(b, s, d), aux

