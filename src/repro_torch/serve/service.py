"""Structure-batched Study service: manifests in, labeled results out.

Port of ``repro.serve.service`` on one device: the card unless
``device=`` says otherwise, never falling back to the CPU.
:class:`StudyService` is the request-driven front end of the scenario
engine (DESIGN.md §11–§12). The service owns the *model context* — one
:class:`~repro_torch.core.trainer.ClientSimulator` (grads_fn, weights,
optimizer) and the initial parameters — while clients submit
**manifests** (:mod:`repro_torch.experiments.manifest`, the wire format
the JAX package shares): what to run, never code. The pipeline per
batch:

1. **Admit** — :meth:`submit` parses/validates the manifest (unknown
   registry names fail here, naming the registry), resolves its cells,
   and checks the population capacity. Invalid requests raise at submit;
   admitted requests queue.
2. **Batch** — :meth:`flush` drains the queue and groups requests by
   dispatch signature (step budget, seed list, ExecutionConfig). Each
   group's cells — across *all* its requests — go to
   :func:`repro_torch.experiments.engine.execute_cells` as one scenario
   list, so the engine's structure grouping applies across requests:
   any mix of population sizes of one component structure is one
   structure group and one runner signature (one "compile" in the
   keyed :class:`~repro_torch.serve.cache.ExecutableCache`'s count),
   and repeat structures are cache hits. The group's cells run in turn
   through K2 (``sgd``) or K1 (other optimizers) with ``use_kernel``.
3. **Demux** — results are split back per request (cell names are
   namespaced on the wire and restored in responses), each response
   carrying its own labeled :class:`~repro_torch.experiments.GridResult`,
   summary records, quarantine report (diverged cells are *reported* —
   they never fail sibling cells or sibling requests), cache/batching
   counters and timings. ``execute_us`` and ``latency_us`` are taken
   after the device has finished the dispatch (a CUDA synchronize), so
   they time the work and not its enqueue.

Execution errors fail only the dispatch group that raised — sibling
groups' responses still complete, every waiter is released, and the
error is the response's ``error`` field, which callers must read.

**Resumable dispatches** (DESIGN.md §12): a request whose config sets
``checkpoint_dir``/``checkpoint_every`` routes through
:func:`repro_torch.experiments.engine.execute_cells_resumable` instead.
The dispatch group gets its own checkpoint subdirectory
``<root>/d<fingerprint>`` — named by the study fingerprint of the
*canonically ordered* merged scenario list, the same name the JAX
package gives the same manifests, so either package recovers the
other's root — and a ``serve-dispatch/v1`` record (``dispatch.json``)
holding the member study manifests. A service killed mid-dispatch
(including ``kill -9``) is recovered by pointing a fresh service at the
same ``checkpoint_root`` and calling :meth:`StudyService.recover`:
partial dispatches resume from their newest checkpoints and return
responses bitwise identical to the uninterrupted run; completed ones
restore without re-execution. Warm resumes are zero-compile — chunk
advances route through the keyed executable cache's
:meth:`~repro_torch.serve.cache.ExecutableCache.chunk_runner`.

:class:`BackgroundServer` runs the flush loop on a worker thread with a
small batching window, which is what gives concurrent submitters the
cross-request structure collapse. Its :meth:`~BackgroundServer.stop`
closes admissions, drains the queue until verifiably empty, then
reopens admissions — a request is either served or refused at submit,
never silently stranded. Dispatches of competing flushers may overlap
on the card's default stream; the kernels' launch counts stay exact
(:mod:`repro_torch.kernels.aggregate.ops`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Callable

import torch

from repro_torch._lru import LRUCache
from repro_torch.checkpoint import write_json_atomic
from repro_torch.experiments import engine, manifest as manifest_mod
from repro_torch.experiments.results import GridResult
from repro_torch.experiments.study import ExecutionConfig, Study
from repro_torch.serve.cache import ExecutableCache

#: ExecutionConfig fields a manifest-driven request must leave at their
#: defaults: they carry live objects (mesh, eval_fn) or select the
#: sequential baseline, none of which the batching engine serves. The
#: admission check compares against the dataclass *defaults* — not
#: truthiness — so falsy-but-set values cannot slip through.
_UNSERVABLE = ("mesh", "eval_fn", "sequential")

#: Fields that only have meaning on the checkpointed (resumable) path;
#: set without ``checkpoint_dir``/``checkpoint_every`` they would be
#: silently ignored, so admission raises a located error instead.
_RESUMABLE_ONLY = ("checkpoint_keep", "halt_on_divergence")

_CONFIG_DEFAULTS = {f.name: f.default
                    for f in dataclasses.fields(ExecutionConfig)}

#: Schema tag of the per-dispatch recovery record (``dispatch.json``).
DISPATCH_FORMAT = "serve-dispatch/v1"


@dataclasses.dataclass
class ServeResponse:
    """One request's result envelope.

    ``records`` are :meth:`GridResult.to_records` rows (per-cell seed
    stats + quarantine fields); ``quarantined`` names the cells with at
    least one diverged seed; ``batch`` describes the dispatch this
    request shared (sibling request count, merged cell count, structure
    dispatches, new compiles — plus, for resumable dispatches, the
    checkpoint dir, chunk count and the step the run resumed from);
    ``cache`` is the executable-cache snapshot after the dispatch;
    ``timings`` carries per-request ``latency_us`` (submit → response)
    and the batch's ``execute_us``. ``error`` is set — and result
    fields empty — when the request's dispatch group failed.
    """

    request_id: str
    study: str
    records: list = dataclasses.field(default_factory=list)
    divergence: dict = dataclasses.field(default_factory=dict)
    quarantined: list = dataclasses.field(default_factory=list)
    batch: dict = dataclasses.field(default_factory=dict)
    cache: dict = dataclasses.field(default_factory=dict)
    timings: dict = dataclasses.field(default_factory=dict)
    result: GridResult | None = None
    error: str | None = None


@dataclasses.dataclass
class _Request:
    rid: str
    study: Study
    config: ExecutionConfig
    cells: list  # [(Scenario, labels)] resolved at submit
    seeds_key: tuple
    submitted_at: float
    done: threading.Event


class StudyService:
    """Request-driven scenario-evaluation service (module docstring).

    Parameters mirror :meth:`repro_torch.experiments.Study.run`'s
    simulator ingredients — the service is the long-lived owner of
    exactly one simulator, so every request's cache keys agree.
    ``device`` places it (None: the card, raising when there is none; a
    prebuilt ``sim`` brings its own). ``cache_size`` bounds the keyed
    executable cache; ``response_cache_size`` bounds the response store
    (a long-lived service would otherwise pin every GridResult ever
    served); ``checkpoint_root`` is where resumable dispatches that
    don't name their own ``checkpoint_dir`` land, and the directory
    :meth:`recover` scans after a restart; ``metric`` (``cell -> (R,)``)
    customizes the per-seed scalar behind response records.
    """

    def __init__(self, *, params0, grads_fn=None, p=None, optimizer=None,
                 loss_fn=None, use_kernel: bool = False, sim=None,
                 cache_size: int = 32, response_cache_size: int = 256,
                 checkpoint_root: str | None = None,
                 metric: Callable | None = None, device=None):
        self._sim = engine._resolve_sim(sim, grads_fn, p, optimizer,
                                        loss_fn, use_kernel, device)
        self._params0 = params0
        self._cache = ExecutableCache(maxsize=cache_size)
        self._checkpoint_root = checkpoint_root
        self._metric = metric
        self._lock = threading.Lock()
        self._pending: list[_Request] = []
        self._requests: dict[str, _Request] = {}
        self._responses = LRUCache(maxsize=response_cache_size,
                                   on_evict=self._drop_request)
        self._progress: dict[str, dict] = {}
        self._ids = itertools.count()
        self._draining = False
        self._n_requests = 0
        self._n_cells = 0
        self._n_flushes = 0

    # ------------------------------------------------------------ admission

    @property
    def capacity(self) -> int:
        """Population capacity N_cap = len(sim.p) — the ceiling every
        request's ``n_clients`` must respect."""
        return int(self._sim.p.shape[0])

    def _parse(self, manifest, config):
        if isinstance(manifest, Study):
            return manifest, config
        if isinstance(manifest, str):
            manifest = manifest_mod.loads(manifest)
        study, mconfig = manifest_mod.request_from_manifest(manifest)
        if config is not None and mconfig is not None:
            raise ValueError(
                "request carries an execution config both in the manifest "
                "and as the config= argument — pass one")
        return study, (mconfig if config is None else config)

    def _check_config(self, config: ExecutionConfig) -> bool:
        """Admission-validate ``config``; returns whether it selects the
        resumable (checkpointed) dispatch path.

        Every check compares against the :class:`ExecutionConfig` field
        *default* and raises a located error naming the field — a
        truthiness check would silently pass ``sequential=False``-style
        falsy-but-set values and silently ignore e.g.
        ``checkpoint_every=20`` without a directory to write to.
        """
        bad = [f for f in _UNSERVABLE
               if getattr(config, f) != _CONFIG_DEFAULTS[f]]
        if bad:
            raise ValueError(
                f"ExecutionConfig fields {bad} are not serveable — the "
                f"service batches requests on the one-device engine; run "
                f"those studies through Study.run directly")
        resumable = (config.checkpoint_dir is not None
                     or config.checkpoint_every != 0)
        if config.checkpoint_every < 0:
            raise ValueError(
                f"ExecutionConfig.checkpoint_every="
                f"{config.checkpoint_every} must be >= 0")
        if resumable and config.checkpoint_dir is None \
                and self._checkpoint_root is None:
            raise ValueError(
                f"ExecutionConfig.checkpoint_every="
                f"{config.checkpoint_every} requests checkpointing but "
                f"there is nowhere to write: the config has no "
                f"checkpoint_dir and the service has no checkpoint_root")
        if not resumable:
            stray = [f"{f}={getattr(config, f)!r}" for f in _RESUMABLE_ONLY
                     if getattr(config, f) != _CONFIG_DEFAULTS[f]]
            if stray:
                raise ValueError(
                    f"ExecutionConfig fields [{', '.join(stray)}] only "
                    f"apply to checkpointed dispatches — set "
                    f"checkpoint_dir/checkpoint_every too, or drop them")
        else:
            if config.client_reduction != _CONFIG_DEFAULTS[
                    "client_reduction"]:
                raise ValueError(
                    f"ExecutionConfig.client_reduction="
                    f"{config.client_reduction!r} has no effect on the "
                    f"checkpointed dispatch path (it is not client-"
                    f"sharded) — leave it at the default")
            if config.degrade != _CONFIG_DEFAULTS["degrade"]:
                raise ValueError(
                    "ExecutionConfig.degrade has no effect on the "
                    "checkpointed dispatch path — leave it at the default")
        return resumable

    def submit(self, manifest, config: ExecutionConfig | None = None) -> str:
        """Admit one request; returns its id.

        ``manifest`` is a JSON string, a ``study/v1`` or
        ``study-request/v1`` dict, or a Study instance. Invalid requests
        — malformed manifest, unknown registry name, unserveable config,
        population above capacity — raise here, before anything queues.
        Raises ``RuntimeError`` while a :class:`BackgroundServer` drain
        is closing the queue (so no request is admitted without a
        flusher to serve it).
        """
        study, config = self._parse(manifest, config)
        config = config or ExecutionConfig()
        self._check_config(config)
        cells = study._resolve_labeled()  # validates axes & unique names
        over = [f"{sc.name} (N={sc.n_clients})" for sc, _ in cells
                if sc.n_clients > self.capacity]
        if over:
            raise ValueError(
                f"request exceeds the service population capacity "
                f"N_cap={self.capacity}: {over}")
        with self._lock:
            if self._draining:
                raise RuntimeError(
                    "service is draining (BackgroundServer.stop()) — "
                    "resubmit after shutdown completes")
            rid = f"r{next(self._ids):04d}"
            req = _Request(
                rid=rid, study=study, config=config, cells=cells,
                seeds_key=study._seed_values(),
                submitted_at=time.perf_counter(),
                done=threading.Event())
            self._pending.append(req)
            self._requests[rid] = req
            self._n_requests += 1
        return rid

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _begin_drain(self) -> None:
        with self._lock:
            self._draining = True

    def _end_drain(self) -> None:
        with self._lock:
            self._draining = False

    # ------------------------------------------------------------- dispatch

    def flush(self) -> list[ServeResponse]:
        """Execute every pending request, batched, and release waiters.

        Requests group by dispatch signature (num_steps, seeds, config);
        each group's cells merge into one ``execute_cells`` call, where
        the engine collapses same-structure cells — across requests —
        into one structure group and one runner of the keyed executable
        cache.
        Groups whose config requests checkpointing run through the
        chunked resumable path instead (module docstring).
        """
        with self._lock:
            batch, self._pending = self._pending, []
        if not batch:
            return []
        self._n_flushes += 1

        dispatch: dict[tuple, list[_Request]] = {}
        for req in batch:
            key = (req.study.num_steps, req.seeds_key, req.config)
            dispatch.setdefault(key, []).append(req)

        responses = []
        for (num_steps, seeds_key, config), reqs in dispatch.items():
            responses.extend(
                self._run_dispatch(num_steps, seeds_key, config, reqs))
        return responses

    @staticmethod
    def _canonical_order(reqs: list[_Request]) -> list[_Request]:
        """Sort a resumable dispatch group by the canonical JSON of each
        request's study manifest — a pure function of the *study*, so a
        restarted service (fresh rids) reproduces the same merged
        scenario list, the same fingerprint, and therefore the same
        checkpoint subdirectory."""
        return sorted(reqs, key=lambda r: json.dumps(
            manifest_mod.study_to_manifest(r.study), sort_keys=True))

    def _run_dispatch(self, num_steps, seeds_key, config, reqs):
        resumable = (config.checkpoint_dir is not None
                     or config.checkpoint_every != 0)
        if resumable:
            reqs = self._canonical_order(reqs)
        merged, wires = [], {}
        for j, req in enumerate(reqs):
            prefix = f"q{j:04d}" if resumable else req.rid
            for sc, _labels in req.cells:
                wire = f"{prefix}/{sc.name}"
                merged.append(dataclasses.replace(sc, name=wire))
                wires[(req.rid, sc.name)] = wire
        before = self._cache.stats()
        t0 = time.perf_counter()
        try:
            if resumable:
                results, extra = self._execute_resumable(
                    merged, num_steps, seeds_key, config, reqs)
            else:
                results = engine.execute_cells(
                    merged, sim=self._sim, params0=self._params0,
                    num_steps=num_steps, seeds=list(seeds_key),
                    client_reduction=config.client_reduction,
                    executable_cache=self._cache.bind(config))
                extra = {}
            self._sync()
        except Exception as e:  # noqa: BLE001 — fail this group, not siblings
            responses = []
            for req in reqs:
                resp = ServeResponse(request_id=req.rid,
                                     study=req.study.name,
                                     error=f"{type(e).__name__}: {e}")
                self._finish(req, resp)
                responses.append(resp)
            return responses
        execute_us = (time.perf_counter() - t0) * 1e6
        after = self._cache.stats()
        delta = {k: after[k] - before[k]
                 for k in ("hits", "misses", "evictions", "compiles")}
        self._n_cells += len(merged)

        now = time.perf_counter()
        responses = []
        for req in reqs:
            cells = {sc.name: results[wires[(req.rid, sc.name)]]
                     for sc, _ in req.cells}
            labels = {sc.name: lab for sc, lab in req.cells}
            axes = dict(req.study._sweep_axes())
            axes["seed"] = seeds_key
            grid = GridResult(cells=cells, labels=labels, axes=axes,
                              name=req.study.name)
            div = grid.divergence()
            resp = ServeResponse(
                request_id=req.rid,
                study=req.study.name,
                records=grid.to_records(self._metric),
                divergence=div,
                quarantined=sorted(n for n, d in div.items()
                                   if d["n_diverged"] > 0),
                batch={"requests": len(reqs), "cells": len(merged),
                       "dispatches": delta["hits"] + delta["misses"],
                       "cache_hits": delta["hits"],
                       "new_compiles": delta["compiles"], **extra},
                cache=after,
                timings={"latency_us": (now - req.submitted_at) * 1e6,
                         "execute_us": execute_us},
                result=grid)
            self._finish(req, resp)
            responses.append(resp)
        return responses

    def _sync(self) -> None:
        """Wait for the simulator's card to finish what it was given."""
        if self._sim.device.type == "cuda":
            torch.cuda.synchronize(self._sim.device)

    def _execute_resumable(self, merged, num_steps, seeds_key, config, reqs):
        """One checkpointed dispatch group: fingerprint-keyed subdir,
        ``dispatch.json`` recovery record, chunked execution through the
        keyed executable cache. Returns ``(results, batch_extras)``."""
        seed_list = list(seeds_key)
        fingerprint = engine.study_fingerprint(
            merged, int(num_steps), seed_list, self._params0)
        root = config.checkpoint_dir or self._checkpoint_root
        cdir = os.path.join(root, f"d{fingerprint[:16]}")
        os.makedirs(cdir, exist_ok=True)
        write_json_atomic(os.path.join(cdir, "dispatch.json"), {
            "format": DISPATCH_FORMAT,
            "fingerprint": fingerprint,
            "num_steps": int(num_steps),
            "seeds": seed_list,
            "config": manifest_mod.execution_config_to_manifest(config),
            "studies": [manifest_mod.study_to_manifest(r.study)
                        for r in reqs],
            "rids": [r.rid for r in reqs],
        })

        first_step: dict[str, int] = {}
        chunks = {"n": 0}

        def _progress(gid, step, total):
            if gid not in first_step:
                first_step[gid] = int(step)
            else:
                chunks["n"] += 1
            with self._lock:
                self._progress.setdefault(fingerprint[:16], {})[gid] = (
                    int(step), int(total))

        try:
            results = engine.execute_cells_resumable(
                merged, sim=self._sim, params0=self._params0,
                num_steps=num_steps, seeds=seed_list,
                checkpoint_dir=cdir,
                checkpoint_every=config.checkpoint_every,
                keep=config.checkpoint_keep,
                halt_on_divergence=config.halt_on_divergence,
                executable_cache=self._cache.bind(config),
                progress=_progress)
        finally:
            with self._lock:
                self._progress.pop(fingerprint[:16], None)
        extra = {"resumable": True, "checkpoint_dir": cdir,
                 "chunks": chunks["n"],
                 "resumed_steps": int(sum(first_step.values()))}
        return results, extra

    # ------------------------------------------------------------- recovery

    def recover(self, *, flush: bool = True) -> list[str]:
        """Resubmit every dispatch recorded under ``checkpoint_root``.

        Scans the root for ``d*/dispatch.json`` (``serve-dispatch/v1``)
        records — written atomically *before* each resumable dispatch
        executes — and resubmits their member studies with the stored
        execution config. Because resumable wire names and ordering are
        canonical (rid-independent), each resubmission lands on the
        *same* fingerprint subdirectory: partial dispatches resume from
        their newest checkpoints (bitwise equal to the uninterrupted
        run), completed ones restore without re-execution, and warm
        resumes add zero compiles. Records are flushed one at a time so
        recovered dispatches keep their original grouping. Returns the
        new request ids (responses via :meth:`result` / :meth:`wait`).
        """
        if self._checkpoint_root is None:
            raise RuntimeError(
                "recover() needs a service checkpoint_root — construct "
                "StudyService(..., checkpoint_root=...)")
        root = self._checkpoint_root
        rids: list[str] = []
        if not os.path.isdir(root):
            return rids
        for entry in sorted(os.listdir(root)):
            path = os.path.join(root, entry, "dispatch.json")
            if not os.path.isfile(path):
                continue
            with open(path) as f:
                rec = json.load(f)
            if rec.get("format") != DISPATCH_FORMAT:
                raise ValueError(
                    f"{path}: unknown dispatch record format "
                    f"{rec.get('format')!r} (want {DISPATCH_FORMAT})")
            config = manifest_mod.execution_config_from_manifest(
                rec["config"])
            batch = [self.submit(manifest_mod.study_from_manifest(doc),
                                 config)
                     for doc in rec["studies"]]
            rids.extend(batch)
            if flush:
                self.flush()
        return rids

    # ------------------------------------------------------------- results

    def _drop_request(self, rid: str, _resp) -> None:
        # response-store eviction also forgets the request record, so
        # the pair of dicts can never diverge into a slow leak
        with self._lock:
            self._requests.pop(rid, None)

    def _finish(self, req: _Request, resp: ServeResponse) -> None:
        self._responses.put(req.rid, resp)
        req.done.set()

    def result(self, rid: str) -> ServeResponse:
        """The response for ``rid`` (KeyError if not yet flushed, or
        already evicted from the bounded response store)."""
        resp = self._responses.get(rid)
        if resp is None:
            raise KeyError(
                f"no response for request {rid!r} — not yet flushed "
                f"(call flush() or run a BackgroundServer) or evicted "
                f"from the response store")
        return resp

    def wait(self, rid: str, timeout: float | None = None) -> ServeResponse:
        """Block until ``rid`` has been served (by any flushing thread)."""
        with self._lock:
            req = self._requests.get(rid)
        if req is None:
            raise KeyError(f"unknown request id {rid!r}")
        if not req.done.wait(timeout):
            raise TimeoutError(f"request {rid!r} not served in {timeout}s")
        return self.result(rid)

    def dispatch_progress(self) -> dict:
        """Per-chunk progress of in-flight resumable dispatches:
        ``{fingerprint: {gid: (step, num_steps)}}`` snapshot."""
        with self._lock:
            return {fp: dict(groups)
                    for fp, groups in self._progress.items()}

    def stats(self) -> dict:
        """Service lifetime counters + executable-cache stats + the
        bounded response-store policy/occupancy."""
        with self._lock:
            out = {"requests": self._n_requests, "flushes": self._n_flushes,
                   "cells": self._n_cells,
                   "resumable_in_flight": len(self._progress)}
        out.update(self._cache.stats())
        out["executable_entries"] = self._cache.cache_entries()
        out["response_store"] = self._responses.stats()
        return out


class BackgroundServer:
    """Worker thread that flushes a :class:`StudyService` continuously.

    ``window_s`` is the batching window: once the queue goes non-empty
    the server waits that long before flushing, so a burst of
    submissions lands in one batch (and one structure-grouped dispatch)
    instead of N. Use as a context manager::

        with BackgroundServer(service):
            rids = [service.submit(m) for m in manifests]
            responses = [service.wait(r) for r in rids]

    :meth:`stop` closes admissions, joins the worker, then flushes
    until the queue is verifiably empty — a submit that raced the old
    single final flush used to strand its request with no flusher;
    now it is either drained here or refused at submit with a
    ``RuntimeError``. Admissions reopen after the drain (requests
    submitted after shutdown queue for a manual ``flush()``).
    """

    def __init__(self, service: StudyService, window_s: float = 0.002,
                 poll_s: float = 0.0005):
        self._service = service
        self._window_s = float(window_s)
        self._poll_s = float(poll_s)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "BackgroundServer":
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="study-serve")
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            if self._service.pending:
                time.sleep(self._window_s)  # let the burst accumulate
                self._service.flush()
            else:
                time.sleep(self._poll_s)

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        # close admissions, then drain: with no concurrent submitter able
        # to enqueue, `pending` can only fall, so this verifiably empties
        # the queue before the last flusher (this thread) walks away.
        self._service._begin_drain()
        try:
            while self._service.pending:
                self._service.flush()
        finally:
            self._service._end_drain()

    def __enter__(self) -> "BackgroundServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
