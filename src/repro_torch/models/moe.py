"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Port of ``repro.models.moe``'s single-device path: ``init_moe`` key for
key, and ``apply_moe`` with one data shard, which is what the JAX
package runs off a mesh. Its expert-parallel path (``_local_moe``,
``_apply_moe_shardmap``, ``_data_shards``: experts split over the
cards) is ROADMAP Queue 1 step 7, part two; part one, studies placed
across ranks, is :mod:`repro_torch.experiments.placement`.

Dispatch is scatter/gather based, as in the JAX package: each (token, k)
assignment gets its position among its expert's assignments, counted in
token-major, k-minor order; assignments at a position of ``capacity`` or
beyond drop (combine weight 0, the residual passes through). Kept rows
are copied into their own slots of an ``(E·capacity, d)`` buffer, so no
slot is written twice and no sum runs through float atomics; the
experts run as batched products over the buffer, and each token's k
outputs are gathered back and summed in order.

Covers both MoE configs: phi3.5-moe (16 experts, top-2) and
llama4-scout (16 experts, top-1, plus an always-on shared expert).

:data:`dispatch_counts` counts the assignments routed and dropped since
:func:`reset_dispatch_counts` (the dropped count a device tensor, so
counting adds no synchronisation); every call of :func:`apply_moe` adds
to it, so a forward under remat counts its recomputation too. While
:data:`routing_log` is a list, every call appends its routing choice
``(top_e, keep)``, both ``(T, K)``, one entry a layer in call order.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch import random as trandom
from repro_torch.models.common import activation, dense, dense_init, lecun_init

dispatch_counts = {"assigned": 0, "dropped": 0}
routing_log = None


def reset_dispatch_counts():
    for name in dispatch_counts:
        dispatch_counts[name] = 0


def dropped_share() -> float:
    """The dropped share of the assignments counted since the last reset
    (0.0 when none were)."""
    assigned = int(dispatch_counts["assigned"])
    return int(dispatch_counts["dropped"]) / assigned if assigned else 0.0


def init_moe(key, d_model, d_ff, n_experts, dtype, use_bias=False,
             shared_expert=False, shared_d_ff=None):
    """The JAX package's ``init_moe``: an f32 router beside experts in
    ``dtype``, ``(E, d_model, d_ff)`` and ``(E, d_ff, d_model)``."""
    ks = trandom.split(key, 5)
    p = {
        "router": dense_init(ks[0], d_model, n_experts, torch.float32),
        "w_gate": lecun_init(ks[1], (n_experts, d_model, d_ff), dtype,
                             fan_in=d_model),
        "w_up": lecun_init(ks[2], (n_experts, d_model, d_ff), dtype,
                           fan_in=d_model),
        "w_down": lecun_init(ks[3], (n_experts, d_ff, d_model), dtype,
                             fan_in=d_ff),
    }
    if shared_expert:
        from repro_torch.models.blocks import init_mlp  # avoids a cycle
        p["shared"] = init_mlp(ks[4], d_model, shared_d_ff or d_ff, dtype,
                               use_bias)
    return p


def route(router, xt, *, n_experts, top_k, capacity_factor):
    """The router's choice for tokens ``xt`` (T, d): softmax probabilities
    of the f32 logits (T, E), the top-k experts (T, K) in ``lax.top_k``'s
    order (a tie goes to the lower expert index: a stable descending
    sort), their renormalised weights, each assignment's position among
    its expert's (T·K,), and the capacity. The two parts run under the
    ``torch.profiler`` ranges ``moe_router`` and ``moe_dispatch``."""
    t = xt.shape[0]
    with record_function("moe_router"):
        logits = dense(router, xt.to(torch.float32))
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]
        top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    cap = int(max(1, (t * top_k * capacity_factor) // n_experts))
    with record_function("moe_dispatch"):
        # The one-hot expert-major, (E, T·K): each expert's running count
        # is a scan along contiguous memory (token-major, as JAX's cumsum
        # over the assignments), where a (T·K, E) layout would scan each
        # expert's column with a stride of E.
        flat_e = top_e.reshape(-1)
        experts = torch.arange(n_experts, device=xt.device)[:, None]
        counts = torch.cumsum((flat_e[None, :] == experts).to(torch.int32),
                              dim=1)
        pos = torch.gather(counts, 0, flat_e[None, :])[0] - 1
    return probs, top_p, top_e, pos, cap


def apply_moe(params, x, *, n_experts, top_k, act="silu",
              capacity_factor=1.25, shared_expert=False):
    """x: (B, S, D) -> (y, aux_loss), as the JAX package's ``apply_moe``
    off a mesh."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    act_fn = activation(act)

    probs, top_p, top_e, pos, cap = route(
        params["router"], xt, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    with record_function("moe_dispatch"):
        keep = pos < cap
        flat_e = top_e.reshape(-1)
        slot = flat_e * cap + torch.clamp(pos, max=cap - 1)
        tok_idx = torch.arange(t, device=x.device).repeat_interleave(top_k)
        # A kept assignment owns its slot; a dropped one goes to a spare
        # row past the buffer, cut off before the experts. The JAX package
        # adds dropped rows as zeros into a slot instead, which leaves it
        # unchanged.
        spare = n_experts * cap
        buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
        buf[torch.where(keep, slot, spare)] = xt[tok_idx]
        buf = buf[:spare].reshape(n_experts, cap, d)
        dispatch_counts["assigned"] += keep.numel()
        dispatch_counts["dropped"] += torch.sum(~keep)
        if routing_log is not None:
            routing_log.append((top_e, keep.reshape(t, top_k)))
    with record_function("moe_experts"):
        h = act_fn(torch.bmm(buf, params["w_gate"])) * torch.bmm(
            buf, params["w_up"])
        out = torch.bmm(h, params["w_down"]).reshape(n_experts * cap, d)
    with record_function("moe_combine"):
        w = torch.where(keep, top_p.reshape(-1), 0.0).to(x.dtype)
        terms = (out[slot] * w[:, None]).reshape(t, top_k, d)
        y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
        for k in range(top_k):  # summed in order from zero, as JAX's scatter
            y = y + terms[:, k]

    if shared_expert:
        from repro_torch.models.blocks import apply_mlp  # avoids a cycle
        y = y + apply_mlp(params["shared"], x, act=act).reshape(t, d)

    # Switch load-balance aux loss: E · Σ_e f_e · P_e.
    frac = torch.mean(torch.nn.functional.one_hot(
        top_e[:, 0], n_experts).to(torch.float32), dim=0)
    mean_p = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(frac * mean_p)
    return y.reshape(b, s, d), aux
