"""The environment variables the port reads.

Port of the ``REPRO_DIST_*`` half of ``repro._env``: the variable names
:func:`repro_torch.launch.distributed.init_from_env` reads and the
simulated harness sets on each worker it spawns, and
:func:`distributed_env`, which parses them. They live here so the names
have one home that both sides import without importing torch. Beside
them, :func:`state_spec_order`: ``REPRO_STATE_SPEC_ORDER``, which
:func:`repro_torch.sharding.rules.state_specs` reads (the JAX package
reads it in ``repro.sharding.rules``).

The JAX module's other half, ``ensure_host_device_count``, has no
counterpart: it gives XLA's CPU backend placeholder devices, one
process holding several. A rank of the port is a process with one
device of its own (a card, or the CPU), so a run on N devices is N
processes and no flag is needed. ``REPRO_DIST_LOCAL_DEVICES`` keeps its
name and says, in the port, how many ranks share this host: the
launcher gives a rank the card ``process_id % local_devices`` and lets
ranks share cards when the host has fewer cards than ranks.
"""

from __future__ import annotations

import os

DIST_COORDINATOR = "REPRO_DIST_COORDINATOR"
DIST_NUM_PROCESSES = "REPRO_DIST_NUM_PROCESSES"
DIST_PROCESS_ID = "REPRO_DIST_PROCESS_ID"
DIST_LOCAL_DEVICES = "REPRO_DIST_LOCAL_DEVICES"
STATE_SPEC_ORDER = "REPRO_STATE_SPEC_ORDER"


def state_spec_order() -> str:
    """Which axis of a decode state leaf takes the ``"model"`` mesh axis
    (``REPRO_STATE_SPEC_ORDER``): ``"trailing"`` (the default) walks the
    axes from the end, ``"leading"`` from the one after the batch axis,
    ``"none"`` gives none. Read at each call, where the JAX package reads
    it once at import."""
    return os.environ.get(STATE_SPEC_ORDER, "trailing")


def distributed_env() -> dict | None:
    """Parse the ``REPRO_DIST_*`` worker environment, or None when unset.

    Returns ``{"coordinator": str, "num_processes": int,
    "process_id": int, "local_devices": int | None}``. Partial
    configuration raises: a worker with a coordinator but no process id
    would hang the whole rendezvous, so refusing early is the kind
    option.
    """
    coord = os.environ.get(DIST_COORDINATOR)
    if coord is None:
        if any(v in os.environ for v in (DIST_NUM_PROCESSES,
                                         DIST_PROCESS_ID)):
            raise ValueError(
                f"partial REPRO_DIST_* environment: {DIST_COORDINATOR} is "
                f"unset but process-topology variables are present")
        return None
    try:
        nproc = int(os.environ[DIST_NUM_PROCESSES])
        pid = int(os.environ[DIST_PROCESS_ID])
    except KeyError as e:
        raise ValueError(
            f"partial REPRO_DIST_* environment: {DIST_COORDINATOR} is set "
            f"but {e.args[0]} is missing") from None
    local = os.environ.get(DIST_LOCAL_DEVICES)
    return {"coordinator": coord, "num_processes": nproc, "process_id": pid,
            "local_devices": int(local) if local is not None else None}
