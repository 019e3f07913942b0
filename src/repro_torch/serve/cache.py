"""Keyed executable cache: (structure fingerprint, config) → runner.

Port of ``repro.serve.cache``, with the same keys and counters. The JAX
engine's process-global jit cache grows monotonically and can only be
cleared wholesale; :class:`ExecutableCache` replaces it on the serve
path (``execute_cells(..., executable_cache=)``): each distinct
(component structure, execution config, step budget, eval hook) gets
its **own** runner (:func:`repro_torch.experiments.engine.
make_group_runner`), stored in a bounded LRU (:mod:`repro_torch._lru`).
Eviction drops the runner object and the simulator and closures it
pins.

The port compiles nothing: a runner runs the engine's own code, and its
``on_trace`` hook fires on the first run of each batch signature it has
not run before — the signature that makes the JAX package's jit trace
again (group key, raggedness, S cells, R seeds, N_cap). So
``stats()["compiles"]`` takes the JAX package's values on the same
traffic: a mixed-population batch of one structure counts one, repeat
traffic none. What such a first run pays on the card is allocator
growth and cuDNN's algorithm choice for new shapes, not a compile.
"""

from __future__ import annotations

import threading

from repro_torch._lru import LRUCache
from repro_torch.experiments import engine


class ExecutableCache:
    """Bounded LRU of group runners, keyed on (structure, config, …).

    ``group_runner`` is the protocol :func:`repro_torch.experiments.
    engine.execute_cells` calls per structure group: ``key`` is the
    engine's hashable signature (group key + raggedness); the cache
    widens it with the runner-defining arguments (``sim`` identity, step
    budget, eval hook) plus any :meth:`bind`-time extras (the serve
    layer binds the request's ExecutionConfig). Distinct batch *shapes*
    under one key run as new signatures inside the same runner —
    counted as compiles, not as new cache entries.
    """

    def __init__(self, maxsize: int = 32):
        self._lru = LRUCache(maxsize=maxsize)
        self._compiles = 0
        self._compile_lock = threading.Lock()

    def _on_trace(self) -> None:
        with self._compile_lock:
            self._compiles += 1

    def group_runner(self, key, *, sim, num_steps: int, eval_fn=None,
                     eval_every: int = 0, extra=()):
        full_key = (key, tuple(extra), sim, int(num_steps), eval_fn,
                    int(eval_every))
        return self._lru.get_or_create(
            full_key, lambda: engine.make_group_runner(
                sim=sim, num_steps=num_steps, eval_fn=eval_fn,
                eval_every=eval_every, on_trace=self._on_trace))

    def chunk_runner(self, key, *, sim, chunk: int, spec, extra=()):
        """Memoized :func:`repro_torch.experiments.engine.
        make_chunk_runner` — the resumable path's analogue of
        :meth:`group_runner`. Keyed on (structure key, chunk length,
        flat spec, extras), so a warm resume of an interrupted dispatch
        — same structure, same checkpoint cadence — reuses the runner
        that has run its signature: zero new compiles (DESIGN.md §12)."""
        full_key = ("chunk", key, tuple(extra), sim, int(chunk), spec)
        return self._lru.get_or_create(
            full_key, lambda: engine.make_chunk_runner(
                sim=sim, chunk=chunk, spec=spec, on_trace=self._on_trace))

    def bind(self, *extra) -> "BoundExecutableCache":
        """A view whose keys are widened with ``extra`` (hashable) —
        e.g. one request's ExecutionConfig, so two configs never share
        an executable entry."""
        return BoundExecutableCache(self, extra)

    def fingerprint(self, key) -> str:
        """Response-visible digest of one structure key."""
        return engine.structure_fingerprint(key)

    def cache_entries(self) -> int:
        """Batch signatures held across the live runners — the
        counterpart of the JAX package's compiled-program count, which
        the single-trace assertions probe."""
        return sum(r.cache_size() for r in self._lru.values())

    def stats(self) -> dict:
        with self._compile_lock:
            compiles = self._compiles
        return {**self._lru.stats(), "compiles": compiles}

    def clear(self) -> dict:
        """Drop every runner; returns the final stats snapshot."""
        stats = self.stats()
        self._lru.clear()
        return stats


class BoundExecutableCache:
    """:meth:`ExecutableCache.bind` view — same store, widened keys."""

    def __init__(self, cache: ExecutableCache, extra: tuple):
        self._cache = cache
        self._extra = tuple(extra)

    def group_runner(self, key, **kw):
        return self._cache.group_runner(key, extra=self._extra, **kw)

    def chunk_runner(self, key, **kw):
        return self._cache.chunk_runner(key, extra=self._extra, **kw)

    def stats(self) -> dict:
        return self._cache.stats()
