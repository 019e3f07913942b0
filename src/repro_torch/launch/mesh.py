"""Mesh definitions for drivers.

Port of ``repro.launch.mesh``. The placement layer's rank meshes
(DESIGN.md §5, §8) are re-exported here, so drivers import every mesh
from one module:

  cell mesh  : (D,)        axis ("cells",)   — scenario-grid sharding
  client mesh: (D,)        axis ("clients",) — within-cell client sharding
  grid mesh  : (Dc, Dn)    axes ("cells", "clients") — both, composed

Each factory is a function, not a constant: building a mesh makes
process groups, which needs the process group started first
(:func:`repro_torch.launch.distributed.initialize`).
"""

from __future__ import annotations

from repro_torch.experiments.placement import (  # noqa: F401
    CELL_AXIS,
    CLIENT_AXIS,
    Mesh,
    _make_mesh,
    _world,
    make_cell_mesh,
    make_client_mesh,
    make_grid_mesh,
    make_multihost_mesh,
)


def make_production_mesh(*, multi_pod: bool = False):
    """The JAX package's 256- or 512-chip TPU pod mesh (``("data",
    "model")`` at 16 × 16, or ``("pod", "data", "model")``). It has no
    counterpart on one H100 host; the pod tooling is ROADMAP's "Last"
    queue."""
    raise NotImplementedError(
        f"make_production_mesh(multi_pod={multi_pod}) is a TPU-pod mesh "
        "of 256 or 512 chips; it is not ported (ROADMAP Queue 1, \"Last "
        "— TPU-pod tooling\")")


def make_host_mesh() -> Mesh:
    """1-rank ``("data", "model")`` mesh of this rank, for smoke paths
    (tests, examples)."""
    return _make_mesh([[_world()[1]]], ("data", "model"))
