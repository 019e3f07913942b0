"""Bounded LRU mapping with hit/miss/eviction accounting.

Port of ``repro._lru``, kept as the port's own copy (the port imports
nothing of the JAX package). :meth:`repro_torch.experiments.Study.
simulator` memoizes its simulators in one, so a long-running process
cycling through many problems evicts the coldest simulator instead of
pinning every simulator and the dataset its ``grads_fn`` captured. The
serve layer keeps two more: the executable cache's runners
(:class:`repro_torch.serve.ExecutableCache`) and the StudyService's
bounded response store.

The cache is thread-safe: every mutation of the underlying
``OrderedDict`` (including ``move_to_end`` on a hit) holds an internal
lock. :meth:`get_or_create` is the atomic check-build-insert concurrent
callers need — a plain get/put pair has a race window where two
threads both miss and both build.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable


class LRUCache:
    """Least-recently-used bounded mapping (thread-safe).

    ``get`` refreshes recency and counts a hit or miss; ``put`` inserts
    (refreshing recency on overwrite) and evicts the coldest entry past
    ``maxsize``, invoking ``on_evict(key, value)`` so owners can release
    per-entry resources. ``on_evict`` runs *outside* the internal lock —
    it may call back into the cache. Counters survive :meth:`clear` —
    they describe the cache's lifetime, not its current contents.
    """

    def __init__(self, maxsize: int = 32,
                 on_evict: Callable[[Any, Any], None] | None = None):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._data: OrderedDict = OrderedDict()
        self._on_evict = on_evict
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                self.misses += 1
                return default
            self._data.move_to_end(key)
            self.hits += 1
            return value

    def _insert_locked(self, key, value) -> list:
        """Insert under the held lock; return evicted pairs for the
        caller to notify outside it."""
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        evicted = []
        while len(self._data) > self.maxsize:
            evicted.append(self._data.popitem(last=False))
            self.evictions += 1
        return evicted

    def _notify(self, evicted) -> None:
        if self._on_evict is not None:
            for old_key, old_value in evicted:
                self._on_evict(old_key, old_value)

    def put(self, key, value) -> None:
        with self._lock:
            evicted = self._insert_locked(key, value)
        self._notify(evicted)

    def get_or_create(self, key, factory: Callable[[], Any]):
        """Atomic get-else-build-else-insert.

        Exactly one caller's ``factory()`` runs per missing key even
        under contention — the whole check-build-insert sequence holds
        the lock (the lock is reentrant, so a factory may read the
        cache, but it must not block on another thread that needs it).
        Counts one hit or one miss, like ``get``.
        """
        with self._lock:
            try:
                value = self._data[key]
            except KeyError:
                self.misses += 1
                value = factory()
                evicted = self._insert_locked(key, value)
            else:
                self._data.move_to_end(key)
                self.hits += 1
                return value
        self._notify(evicted)
        return value

    def pop(self, key, default=None):
        """Remove and return ``key`` without eviction accounting (the
        entry left by request, it wasn't pushed out)."""
        with self._lock:
            return self._data.pop(key, default)

    def __contains__(self, key) -> bool:  # no recency/counter side effects
        with self._lock:
            return key in self._data

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def values(self):
        with self._lock:
            return list(self._data.values())

    def keys(self):
        with self._lock:
            return list(self._data.keys())

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def stats(self) -> dict:
        """Lifetime counters + current occupancy, one flat dict."""
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._data),
                    "maxsize": self.maxsize}
