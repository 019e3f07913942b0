"""Core of the port: the paper's contribution in torch.

* :mod:`repro_torch.core.energy` — energy-arrival processes E_i^t (§II-B)
* :mod:`repro_torch.core.scheduling` — Algorithm 1 / 2 + benchmarks (§III, §V)
* :mod:`repro_torch.core.aggregation` — unbiased scaled aggregation (eq. 11/12)
* :mod:`repro_torch.core.convergence` — Theorem 1 / Corollary 1 constants
* :mod:`repro_torch.core.faults` — client fault injection (delivery faults)
* :mod:`repro_torch.core.trainer` — the ClientSimulator and the SPMD
  LM train step (``build_energy_train_step``)
"""

from repro_torch.core.energy import (
    Arrivals,
    BinaryArrivals,
    DayNightArrivals,
    DeterministicArrivals,
    UniformArrivals,
    arrival_family_names,
    client_keys,
    client_randint,
    client_uniform,
    expected_participation,
    make_arrivals,
    pad_arrivals,
    register_arrival_family,
)
from repro_torch.core.scheduling import (
    AlwaysOnScheduler,
    BatteryAdaptiveScheduler,
    BestEffortScheduler,
    Decision,
    EHAppointmentScheduler,
    WaitForAllScheduler,
    make_scheduler,
    mask_arrivals,
    pad_scheduler,
    register_scheduler,
    scheduler_names,
)
from repro_torch.core.aggregation import (
    RavelSpec,
    aggregate_client_grads,
    aggregate_client_grads_flat,
    aggregate_client_grads_kernel,
    aggregate_client_grads_kernel_per_leaf,
    client_weights,
    compose_masks,
    fused_flat_sgd_update,
    make_flat_grads_fn,
    per_example_coefficients,
    ravel_pytree,
    ravel_spec,
    ravel_stacked,
    reduce_flat,
    server_update,
    unravel_pytree,
)
from repro_torch.core.convergence import (
    QuadraticProblem,
    biased_fixed_point,
    error_floor,
    make_quadratic,
    max_step_size,
    theorem1_bound,
    variance_constant,
)
from repro_torch.core.faults import (
    CompositeFault,
    CorruptGradients,
    DropUpdates,
    OfflineWindows,
    StaleUpdates,
    fault_family_names,
    make_fault,
    pad_faults,
    register_fault_family,
)
from repro_torch.core.trainer import (
    ClientSimulator,
    SimCarry,
    SimHistory,
    TrainState,
    build_energy_train_step,
)

__all__ = [
    "Arrivals", "BinaryArrivals", "DayNightArrivals", "DeterministicArrivals",
    "UniformArrivals", "arrival_family_names", "client_keys",
    "client_randint", "client_uniform", "expected_participation",
    "make_arrivals", "pad_arrivals", "register_arrival_family",
    "AlwaysOnScheduler", "BatteryAdaptiveScheduler", "BestEffortScheduler",
    "Decision", "EHAppointmentScheduler", "WaitForAllScheduler",
    "make_scheduler", "mask_arrivals", "pad_scheduler", "register_scheduler",
    "scheduler_names",
    "RavelSpec", "aggregate_client_grads", "aggregate_client_grads_flat",
    "aggregate_client_grads_kernel", "aggregate_client_grads_kernel_per_leaf",
    "client_weights", "compose_masks", "per_example_coefficients",
    "fused_flat_sgd_update", "make_flat_grads_fn", "ravel_pytree",
    "ravel_spec", "ravel_stacked", "reduce_flat", "server_update",
    "unravel_pytree",
    "QuadraticProblem", "biased_fixed_point", "error_floor", "make_quadratic",
    "max_step_size", "theorem1_bound", "variance_constant",
    "CompositeFault", "CorruptGradients", "DropUpdates", "OfflineWindows",
    "StaleUpdates", "fault_family_names", "make_fault", "pad_faults",
    "register_fault_family",
    "ClientSimulator", "SimCarry", "SimHistory", "TrainState",
    "build_energy_train_step",
]
