"""SGD / momentum / Adam(W) as gradient transformations over trees.

Port of ``repro.optim.optimizers``. The API is the JAX package's:

    opt = adam(3e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``params`` may be one tensor (the simulator's flat ``(P,)`` buffer) or a
tree of tensors (:mod:`repro_torch._tree`). The learning rate may be a
float or a ``schedule(step) -> lr`` callable (:mod:`.schedules`); it is
evaluated on the step counter's device, so the host never waits for it.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch._tree import tree_flatten_with_path, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]  # (grads, state, params) -> (updates, state)
    # Fusion tag (DESIGN.md §9): ``kind`` names the update rule when a
    # fused kernel reproduces it ("sgd"), and ``hyper`` carries what that
    # kernel needs (for sgd: the lr or schedule). Wrappers such as
    # chain_clip stay untagged, since their update is not linear in the
    # gradient.
    kind: str = ""
    hyper: Any = None


def resolve_lr(lr, step):
    """Evaluate a float-or-schedule learning rate at ``step`` (f32, on
    ``step``'s device)."""
    if callable(lr):
        return lr(step)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


def _step0(params):
    device = tree_leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _weak(x: float, dtype) -> float:
    """The Python scalar ``x`` as a JAX weak-typed scalar meets an array
    of ``dtype``: rounded to that dtype (0.9 is 0.8984375 beside a bf16
    leaf), where torch would keep it at f32 precision."""
    return float(torch.tensor(x, dtype=dtype)) if dtype.is_floating_point \
        else x


def _step_of(eta, g):
    """``-eta * g`` with JAX's promotion: the f32 learning rate and a bf16
    leaf give an f32 step (``apply_updates`` rounds it once, onto the
    leaf), where torch would round eta to bf16 first."""
    return -eta * g.to(torch.promote_types(g.dtype, eta.dtype))


class SGDState(NamedTuple):
    step: torch.Tensor


def sgd(lr) -> Optimizer:
    def init(params):
        return SGDState(step=_step0(params))

    def update(grads, state, params=None):
        del params
        eta = resolve_lr(lr, state.step)
        updates = tree_map(lambda g: _step_of(eta, g), grads)
        return updates, SGDState(step=state.step + 1)

    return Optimizer(init, update, kind="sgd", hyper=lr)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: Any


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return MomentumState(step=_step0(params),
                             velocity=tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        del params
        eta = resolve_lr(lr, state.step)
        vel = tree_map(lambda v, g: _weak(beta, v.dtype) * v + g,
                       state.velocity, grads)
        if nesterov:
            updates = tree_map(
                lambda v, g: _step_of(eta, _weak(beta, v.dtype) * v + g),
                vel, grads)
        else:
            updates = tree_map(lambda v: _step_of(eta, v), vel)
        return updates, MomentumState(step=state.step + 1, velocity=vel)

    return Optimizer(init, update)


class AdamState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, decoupled: bool = True) -> Optimizer:
    """Adam; with ``weight_decay > 0`` and ``decoupled=True`` this is AdamW.
    Moments are float32 whatever the parameter dtype."""

    def init(params):
        f32zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device)
        return AdamState(step=_step0(params), mu=tree_map(f32zeros, params),
                         nu=tree_map(f32zeros, params))

    def update(grads, state, params=None):
        step = state.step + 1
        eta = resolve_lr(lr, state.step)
        g32 = tree_map(lambda g: g.to(torch.float32), grads)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, g32)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, g32)
        stepf = step.to(torch.float32)
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

        def _upd(m, v, p):
            u = -(eta * (m / bc1) / (torch.sqrt(v / bc2) + eps))
            if weight_decay > 0.0 and decoupled and p is not None:
                u = u - eta * weight_decay * p.to(torch.float32)
            return u.to(p.dtype if p is not None else u.dtype)

        if params is None:
            updates = tree_map(lambda m, v: _upd(m, v, None), mu, nu)
        else:
            updates = tree_map(_upd, mu, nu, params)
        return updates, AdamState(step=step, mu=mu, nu=nu)

    return Optimizer(init, update)


def adamw(lr, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, decoupled=True, **kw)


def global_norm(grads, mesh=None, split=frozenset()) -> torch.Tensor:
    """The f32 norm of all of ``grads``' leaves. On a rank of ``mesh`` it
    is the global norm GSPMD gives the JAX package: the squares of the
    leaves at ``split`` (their paths, of which this rank holds its block
    over ``"model"``: :func:`repro_torch.models.moe.model_split`) are
    summed over the rank's row, and those of a leaf whole on the row are
    counted once."""
    leaves, _ = tree_flatten_with_path(grads)
    squares = [(tuple(path) in split,
                torch.sum(torch.square(g.to(torch.float32))))
               for path, g in leaves]
    whole = sum(sq for cut, sq in squares if not cut)
    row = None if mesh is None else mesh.row_group
    if row is None or not split:
        return torch.sqrt(whole + sum(sq for cut, sq in squares if cut))
    own = torch.stack([sq for cut, sq in squares if cut]).sum()
    dist.all_reduce(own, group=row)
    return torch.sqrt(whole + own)


def chain_clip(opt: Optimizer, max_norm: float, *, mesh=None,
               split=frozenset()) -> Optimizer:
    """Global-norm gradient clipping wrapped around another optimizer;
    on a rank of ``mesh``, with the paths of the leaves cut over
    ``"model"`` (``split``), the norm of the whole tree
    (:func:`global_norm`)."""
    split = frozenset(tuple(path) for path in split)

    def init(params):
        return opt.init(params)

    def update(grads, state, params=None):
        gnorm = global_norm(grads, mesh, split)
        scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
        clipped = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(clipped, state, params)

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
