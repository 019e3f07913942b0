"""Test-session configuration: multi-device CPU for the sharded grid path.

The placement layer (DESIGN.md §5) is only exercised with ≥ 2 devices,
so CI gives the CPU backend 8 placeholder devices
(``repro._env.ensure_host_device_count``, shared with
``benchmarks/run.py``). The flag must be set before the *first* jax
import — pytest imports conftest before any test module, which is the
one reliable hook for that.

Tests that genuinely need multiple devices carry
``@pytest.mark.multidevice`` and are skipped when the session ends up
single-device anyway (e.g. a user overriding XLA_FLAGS).
"""

import pytest

from repro._env import ensure_host_device_count

ensure_host_device_count(8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: requires >= 2 jax devices (sharded grid placement)")
    config.addinivalue_line(
        "markers",
        "ragged: ragged client populations (mask-aware padded grids, "
        "DESIGN.md §7) — select with `-m ragged`")
    config.addinivalue_line(
        "markers",
        "clientshard: within-cell client-axis sharding (DESIGN.md §8) — "
        "select with `-m clientshard`")
    config.addinivalue_line(
        "markers",
        "faults: fault injection, non-finite quarantine and "
        "preemption-safe resumable execution (DESIGN.md §10) — select "
        "with `-m faults`")
    config.addinivalue_line(
        "markers",
        "serve: Study manifests, the batching StudyService and the "
        "keyed executable cache (DESIGN.md §11) — select with `-m serve`")
    config.addinivalue_line(
        "markers",
        "multihost: simulated multi-process `jax.distributed` execution "
        "(subprocess workers, DESIGN.md §13) — select with `-m multihost`")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (the port's kernels have no CPU mode); "
        "skips inside the test when there is none")


def pytest_collection_modifyitems(config, items):
    import jax

    if jax.device_count() >= 2:
        return
    skip = pytest.mark.skip(reason="requires >= 2 jax devices")
    for item in items:
        if "multidevice" in item.keywords:
            item.add_marker(skip)
