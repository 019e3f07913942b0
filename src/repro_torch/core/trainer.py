"""ClientSimulator — energy process, scheduler and SGD, in torch.

Port of the flat-carry path of ``repro.core.trainer.ClientSimulator``:
N clients, per-client stochastic gradients, and the server aggregation
with ω_i = p_i·mask_i·scale_i (paper eq. 11/12). Params and optimizer
state live in the carry as flat ``(P,)`` buffers (DESIGN.md §5): each
step emits one ``(N, P)`` gradient buffer and reduces it with one kernel
launch or one matvec. With ``use_kernel`` and a plain ``sgd``
optimizer the reduction and the parameter step are one launch of the
fused kernel K2; with any other optimizer the reduction is kernel K1.

Where the JAX package runs the loop as one ``lax.scan``, the port runs a
Python loop on the device; nothing in a step waits for the device
except what the caller reads. The JAX package donates the carry to its
scan; the port allocates each step's new parameter buffer instead (the
buffer is 4·P bytes, small beside the (N, P) gradients), and leaves the
input carry valid.

Fault injection (``faults=``, :mod:`repro_torch.core.faults`) acts on
the flat ``(N, P)`` gradient buffer before the reduction: the fault's
delivery mask zero-weights the dropped rows and joins the active-row
mask that K1 and K2 take as their ``mask``, so a dropped row is an
exact zero even when its payload is NaN. The fault key is
``fold_in(k_grad, FAULT_SALT)`` and the fault state's is
``fold_in(k_run, FAULT_SALT)``, so a run without faults draws the bits
it drew before, and ``faults=None`` adds no work to a step.

:func:`build_energy_train_step` is the SPMD train step of the LM path
(``repro_torch.launch.train``): one global batch whose examples belong
to clients, the paper's weighting as a coefficient on each example's
loss (:func:`~repro_torch.core.aggregation.per_example_coefficients`),
gradients by ``torch.autograd``.

**Client-axis sharding** (DESIGN.md §8): inside a
:func:`repro_torch.core.energy.client_sharding` context this rank runs
its shard of the population — its scheduler and energy rows, its
``p`` / ``active_mask`` rows, its ``(n_local, P)`` gradient rows — and
the step's one collective runs on the shard's process group
(:func:`~repro_torch.core.aggregation.reduce_flat_client_sharded`, or
the sharded :func:`~repro_torch.core.aggregation.fused_flat_sgd_update`
under ``fused``). Params and optimizer state stay replicated, and the
participation history is gathered back to full width at the end of a
run. Faults are refused under a clients axis, as in the JAX package.

Not ported yet: the legacy per-leaf carry (``flat=False``, and
mixed-dtype parameters; ROADMAP Queue 1 step 5), refused with
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import random as trandom
from repro_torch._device import resolve_device
from repro_torch._tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from repro_torch.core import aggregation
from repro_torch.core.energy import client_shard, shard_all_gather
from repro_torch.core.faults import FAULT_SALT
from repro_torch.core.scheduling import Decision
from repro_torch.optim import Optimizer, apply_updates


FAULTS_UNDER_CLIENTS = (
    "fault injection is not supported under a clients mesh axis "
    "(DESIGN.md §10) — use a cells-only mesh or drop the fault component")
FUSED_NEEDS_SGD = (
    "reduction 'fused' bundles the SGD parameter update into the reduction "
    "kernel and needs a plain sgd() optimizer (kind='sgd'); use 'psum' for "
    "stateful/clipped optimizers")


class SimCarry(NamedTuple):
    params: Any
    opt_state: Any
    sched_state: Any
    energy_state: Any
    key: torch.Tensor
    t: torch.Tensor
    fault_state: Any = ()


class SimHistory(NamedTuple):
    loss: torch.Tensor           # (T,) global loss (if loss_fn given, else 0)
    participation: torch.Tensor  # (T, N) masks
    weight_sum: torch.Tensor     # (T,) Σ_i ω_i (≈1 in expectation for unbiased)
    finite: torch.Tensor = None  # (T,) bool — params finite after the step


class ClientSimulator:
    """Paper-faithful N-client distributed-SGD simulator.

    Parameters
    ----------
    grads_fn : (params, key, t) -> (N,)-stacked gradient tree, or one
        ``(N, ...)`` tensor. Owns data sampling (eq. 4).
    p : (N,) data weights p_i = D_i / D.
    optimizer : :class:`repro_torch.optim.Optimizer`; ``sgd(eta)`` for
        the paper's semantics.
    scheduler, energy : :mod:`repro_torch.core.scheduling` /
        :mod:`repro_torch.core.energy` objects, here or per call.
    faults : optional :mod:`repro_torch.core.faults` component, here or
        per call (a per-call component replaces this one).
    loss_fn : optional (params) -> scalar global loss, logged per step.
    use_kernel : aggregate through the CUDA kernels K1/K2 (their plain
        versions for CPU tensors); default a torch matvec.
    flat : only the flat carry is ported; ``False`` raises.
    device : where the loop runs; None means the CUDA card and raises
        when there is none.
    """

    def __init__(self, *, grads_fn, p, optimizer: Optimizer,
                 scheduler=None, energy=None, faults=None,
                 loss_fn=None, use_kernel: bool = False,
                 flat: bool | None = None, device=None):
        if flat is False:
            raise NotImplementedError(
                "the legacy per-leaf carry (flat=False) is not ported; the "
                "port runs the flat carry only (ROADMAP Queue 1 step 5)")
        self.device = resolve_device(device)
        self.grads_fn = grads_fn
        self.scheduler = scheduler
        self.energy = energy
        self.faults = faults
        self.p = self._f32(p)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.use_kernel = use_kernel
        self._gfn_cache: dict = {}

    def _f32(self, x):
        if x is None:
            return None
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    def _components(self, scheduler, energy, faults=None):
        """(scheduler, energy, faults): each argument, else the
        constructor's, the energy process and the fault component placed
        on the simulator's device."""
        scheduler = self.scheduler if scheduler is None else scheduler
        energy = self.energy if energy is None else energy
        faults = self.faults if faults is None else faults
        if scheduler is None or energy is None:
            raise ValueError(
                "scheduler/energy must be given either at construction or "
                "as arguments to init/step/run")
        # Built-in processes and faults keep their tables on the CPU
        # until placed here; a custom one without ``to`` places itself.
        energy, faults = (c if getattr(c, "to", None) is None
                          else c.to(self.device) for c in (energy, faults))
        return scheduler, energy, faults

    def flat_spec(self, params):
        """The :class:`~repro_torch.core.aggregation.RavelSpec` the
        simulator runs ``params`` under."""
        try:
            return aggregation.ravel_spec(params)
        except ValueError as e:
            raise NotImplementedError(
                "mixed-dtype parameters need the legacy per-leaf carry, "
                f"which is not ported (ROADMAP Queue 1 step 5; {e})") from None

    def _flat_grads(self, spec):
        fn = self._gfn_cache.get(spec)
        if fn is None:
            fn = aggregation.make_flat_grads_fn(
                self.grads_fn, spec, int(self.p.shape[0]))
            self._gfn_cache[spec] = fn
        return fn

    def init(self, key, params, *, scheduler=None, energy=None,
             faults=None, spec=None) -> SimCarry:
        """Build the carry: params and optimizer state flat under ``spec``
        (default: :meth:`flat_spec` of ``params``), and the fault
        component's state."""
        scheduler, energy, faults = self._components(scheduler, energy,
                                                     faults)
        spec = self.flat_spec(params) if spec is None else spec
        params = aggregation.ravel_pytree(params, spec).to(self.device)
        key = key.to(self.device)
        k_sched, k_energy, k_run = trandom.split(key, 3).unbind(0)
        fault_state = ()
        if faults is not None:
            fault_state = faults.init(trandom.fold_in(k_run, FAULT_SALT),
                                      int(self.p.shape[0]), int(spec.total))
        return SimCarry(
            params=params,
            opt_state=self.optimizer.init(params),
            sched_state=scheduler.init(k_sched),
            energy_state=energy.init(k_energy),
            key=k_run,
            t=torch.zeros((), dtype=torch.int32, device=self.device),
            fault_state=fault_state,
        )

    def step(self, carry: SimCarry, scheduler=None, energy=None, *, spec,
             p=None, active_mask=None, faults=None) -> tuple[SimCarry, dict]:
        """One server round on a flat carry made under ``spec``."""
        scheduler, energy, faults = self._components(scheduler, energy,
                                                     faults)
        return self._step(carry, scheduler, energy, spec, self._f32(p),
                          self._f32(active_mask), faults)

    @torch.no_grad()
    def _step(self, carry: SimCarry, scheduler, energy, spec, p=None,
              active_mask=None, faults=None) -> tuple[SimCarry, dict]:
        """The step body. ``p`` overrides the constructor weights and
        ``active_mask`` is the (N,) 0/1 existing-client mask (DESIGN.md
        §7); both are f32 tensors on the simulator's device or None.
        ``faults`` is a placed fault component or None."""
        shard = client_shard()
        if shard is not None and faults is not None:
            raise ValueError(FAULTS_UNDER_CLIENTS)
        p = self.p if p is None else p
        key, k_arr, k_sched, k_grad = trandom.split(carry.key, 4).unbind(0)
        energy_state, arr = energy.arrivals(carry.energy_state, carry.t, k_arr)
        sched_state, dec = scheduler.step(carry.sched_state, carry.t, k_sched,
                                          arr, active=active_mask)
        weights = aggregation.client_weights(p, dec)
        if active_mask is not None:
            # Zero weight for rows that do not exist even if a custom
            # scheduler leaked mass to them (×1 on active rows is exact).
            weights = weights * active_mask
        params_tree = aggregation.unravel_pytree(carry.params, spec)
        g = self._flat_grads(spec)(params_tree, k_grad, carry.t)
        fault_state, row_mask = carry.fault_state, active_mask
        if faults is not None:
            # The delivery mask joins the active-row select, so a dropped
            # row is an exact zero through K1/K2 even when its payload is
            # NaN, and zero weights keep weight_sum the delivered mass.
            k_fault = trandom.fold_in(k_grad, FAULT_SALT)
            fault_state, g, keep = faults.apply(carry.fault_state, carry.t,
                                                k_fault, g)
            if keep is not None:
                weights = weights * keep
                row_mask = aggregation.compose_masks(active_mask, keep)
        fusable = getattr(self.optimizer, "kind", "") == "sgd"
        agg = params = wsum = None
        if shard is not None:
            mode, wire = aggregation.parse_reduction(shard.reduction)
            if mode == "fused":
                if not fusable:
                    raise ValueError(FUSED_NEEDS_SGD)
                params, opt_state, wsum = aggregation.fused_flat_sgd_update(
                    g, weights, carry.params, carry.opt_state,
                    self.optimizer, mask=row_mask,
                    use_kernel=self.use_kernel, shard=shard, wire_dtype=wire)
            else:
                agg, wsum = aggregation.reduce_flat_client_sharded(
                    g, weights, shard=shard, use_kernel=self.use_kernel,
                    mask=row_mask)
        elif self.use_kernel and fusable:
            # One launch of K2: the same f32 op sequence as
            # reduce → −η·agg → add.
            params, opt_state, _ = aggregation.fused_flat_sgd_update(
                g, weights, carry.params, carry.opt_state, self.optimizer,
                mask=row_mask, use_kernel=True)
        else:
            agg = aggregation.reduce_flat(g, weights,
                                          use_kernel=self.use_kernel,
                                          mask=row_mask)
        if params is None:
            updates, opt_state = self.optimizer.update(
                agg, carry.opt_state, carry.params)
            params = apply_updates(carry.params, updates)
        loss = (self.loss_fn(aggregation.unravel_pytree(params, spec))
                if self.loss_fn is not None
                else torch.zeros((), dtype=torch.float32, device=self.device))
        out = {
            "loss": loss,
            "participation": dec.mask,
            "weight_sum": torch.sum(weights) if wsum is None else wsum,
            "finite": torch.all(torch.isfinite(params)),
        }
        new_carry = SimCarry(params=params, opt_state=opt_state,
                             sched_state=sched_state, energy_state=energy_state,
                             key=key, t=carry.t + 1, fault_state=fault_state)
        return new_carry, out

    def _steps(self, carry, num_steps, scheduler, energy, spec, p,
               active_mask, faults):
        outs = []
        for _ in range(num_steps):
            carry, out = self._step(carry, scheduler, energy, spec, p,
                                    active_mask, faults)
            outs.append(out)
        return carry, outs

    @staticmethod
    def _history(outs) -> SimHistory:
        """The steps' outputs stacked; under a client shard, each step's
        participation holds this rank's rows, and the history's is
        gathered back to the full client axis (T, N)."""
        if not outs:
            raise ValueError("a run needs num_steps >= 1")
        stack = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        participation = stack["participation"]
        shard = client_shard()
        if shard is not None:
            participation = shard_all_gather(participation, shard, dim=-1)
        return SimHistory(loss=stack["loss"],
                          participation=participation,
                          weight_sum=stack["weight_sum"],
                          finite=stack["finite"])

    def run(self, key, params, num_steps: int, *, scheduler=None, energy=None,
            faults=None, p=None, active_mask=None, eval_fn=None,
            eval_every: int = 0):
        """Run ``num_steps`` rounds from ``params``.

        Without ``eval_fn``: returns ``(final_params, SimHistory)``. With
        ``eval_fn`` (params -> metric tree): evaluates after every
        ``eval_every`` steps and returns ``(final_params, SimHistory,
        evals)``, every ``evals`` leaf with leading axis
        ``num_steps // eval_every``. ``final_params`` has the structure
        of ``params``.
        """
        scheduler, energy, faults = self._components(scheduler, energy,
                                                     faults)
        spec = self.flat_spec(params)
        carry = self.init(key, params, scheduler=scheduler, energy=energy,
                          faults=faults, spec=spec)
        p, active_mask = self._f32(p), self._f32(active_mask)
        if eval_fn is None:
            carry, outs = self._steps(carry, num_steps, scheduler, energy,
                                      spec, p, active_mask, faults)
            return (aggregation.unravel_pytree(carry.params, spec),
                    self._history(outs))
        if eval_every <= 0:
            eval_every = num_steps
        if num_steps % eval_every != 0:
            raise ValueError(
                f"num_steps={num_steps} must divide by eval_every={eval_every}")
        outs, evals = [], []
        for _ in range(num_steps // eval_every):
            carry, chunk = self._steps(carry, eval_every, scheduler, energy,
                                       spec, p, active_mask, faults)
            outs += chunk
            with torch.no_grad():
                evals.append(eval_fn(aggregation.unravel_pytree(carry.params,
                                                                spec)))
        evals = tree_map(lambda *xs: torch.stack(xs), *evals)
        return (aggregation.unravel_pytree(carry.params, spec),
                self._history(outs), evals)

    def run_carry(self, carry: SimCarry, num_steps: int, *, scheduler=None,
                  energy=None, faults=None, p=None, active_mask=None,
                  spec) -> tuple[SimCarry, SimHistory]:
        """Advance a flat carry (from :meth:`init`, or converted from the
        JAX package by :func:`repro_torch.convert.carry_from_jax`)
        ``num_steps`` rounds. ``spec`` is the :meth:`flat_spec` of the
        original params. The whole step stream is a function of the
        carry, so a resumed run equals the uninterrupted one."""
        scheduler, energy, faults = self._components(scheduler, energy,
                                                     faults)
        carry, outs = self._steps(carry, num_steps, scheduler, energy, spec,
                                  self._f32(p), self._f32(active_mask),
                                  faults)
        return carry, self._history(outs)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def build_energy_train_step(
    *,
    per_example_loss_fn: Callable[..., Any],
    optimizer: Optimizer,
    n_clients: int,
    p=None,
    aux_loss_weight: float = 0.0,
    flat: bool = False,
    use_kernel: bool = False,
):
    """SPMD train step with the paper's weighting baked into the loss.

    per_example_loss_fn(params, batch) must return per-example losses of
    shape (B,) — or (B,), aux_scalar when the model carries an auxiliary
    loss. ``batch`` must contain ``client_ids`` (B,) int. The returned
    step:

        train_step(state, batch, mask, scale) -> (state, metrics)

    where (mask, scale) are the (N,) scheduler outputs for this step, on
    the batch's device. The aux loss is weighted by Σω so a masked
    client contributes nothing to it either. Gradients come from
    ``torch.autograd.grad`` over the parameter leaves, in their dtype.

    ``flat=True`` ravels the gradient into one ``(P,)`` buffer, keeps
    the optimizer state flat and rebuilds the tree only at
    ``TrainState.params``; elementwise optimizers give the per-leaf
    route's bits. With a tagged ``sgd()`` the flat step goes through
    :func:`repro_torch.core.aggregation.fused_flat_sgd_update` as a
    one-row stack with unit weight: one launch of kernel K2 when
    ``use_kernel`` (its plain version for CPU tensors).
    """
    if p is None:
        p = torch.full((n_clients,), 1.0 / n_clients, dtype=torch.float32)
    p = torch.as_tensor(p, dtype=torch.float32)
    placed = {}

    def on(device):
        if device not in placed:
            placed[device] = p.to(device)
        return placed[device]

    def loss_fn(params, batch, weights):
        out = per_example_loss_fn(params, batch)
        aux = None
        if isinstance(out, tuple):
            losses, aux = out
        else:
            losses = out
        bsz = losses.shape[0]
        coeff = aggregation.per_example_coefficients(
            batch["client_ids"], weights, bsz // n_clients)
        total = torch.sum(coeff * losses)
        if aux_loss_weight and aux is not None:
            # Scale aux by the client weights so the energy mask also
            # de-biases router statistics.
            total = total + aux_loss_weight * aux * torch.sum(weights)
        # Unweighted mean loss for logging.
        return total, torch.mean(losses)

    def train_step(state: TrainState, batch, mask, scale):
        weights = aggregation.client_weights(on(mask.device),
                                             Decision(mask=mask, scale=scale))
        leaves, treedef = tree_flatten(state.params)
        wrt = [leaf.detach().requires_grad_() for leaf in leaves]
        with torch.enable_grad():
            total, mean_loss = loss_fn(tree_unflatten(treedef, wrt), batch,
                                       weights)
            grads = torch.autograd.grad(total, wrt, materialize_grads=True)
        with torch.no_grad():
            grads = tree_unflatten(treedef, list(grads))
            if flat:
                spec = aggregation.ravel_spec(state.params)
                gflat = aggregation.ravel_pytree(
                    tree_map(lambda g: g.to(spec.dtype), grads), spec)
                pflat = aggregation.ravel_pytree(state.params, spec)
                if getattr(optimizer, "kind", "") == "sgd":
                    # The SPMD gradient is already reduced over examples,
                    # so the fused op sees a one-client stack with unit
                    # weight: one reduce-and-update pass (one K2 launch
                    # under use_kernel) replaces update+apply.
                    pnew, opt_state, _ = aggregation.fused_flat_sgd_update(
                        gflat[None, :],
                        torch.ones((1,), dtype=torch.float32,
                                   device=gflat.device),
                        pflat, state.opt_state, optimizer,
                        use_kernel=use_kernel)
                    params = aggregation.unravel_pytree(pnew, spec)
                else:
                    updates, opt_state = optimizer.update(
                        gflat, state.opt_state, pflat)
                    params = aggregation.unravel_pytree(pflat + updates, spec)
            else:
                updates, opt_state = optimizer.update(grads, state.opt_state,
                                                      state.params)
                params = apply_updates(state.params, updates)
            metrics = {
                "weighted_loss": total.detach(),
                "loss": mean_loss.detach(),
                "active_clients": torch.sum(mask),
                "weight_sum": torch.sum(weights),
            }
        return TrainState(params=params, opt_state=opt_state,
                          step=state.step + 1), metrics

    def init_state(params) -> TrainState:
        if flat:
            spec = aggregation.ravel_spec(params)
            opt_state = optimizer.init(aggregation.ravel_pytree(params, spec))
        else:
            opt_state = optimizer.init(params)
        device = tree_leaves(params)[0].device
        return TrainState(params=params, opt_state=opt_state,
                          step=torch.zeros((), dtype=torch.int32, device=device))

    return init_state, train_step
