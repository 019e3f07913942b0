"""The Study service of the port (``repro_torch.serve``), on the CPU.

Every case of ``tests/test_service.py`` runs against the port, on the
quadratic problem at the JAX tests' sizes (capacity 8, dim 4, 20 steps,
populations ``[3, 4, 5, 6, 7, 8, 3, 5]``) with ``device="cpu"`` and
``use_kernel=True`` (the kernels' plain versions on the CPU). The
counters take the values those tests assert for the JAX package: one
compile for the mixed-population batch, none on repeat traffic, bounded
LRU eviction, configs never sharing an entry, none on a warm resume. A
batched response is bit for bit the port's own solo ``Study.run``
(``_assert_grids_bitwise``), the check the JAX tests make and cannot
pass on this jax (ROADMAP caveat R1: their solo ``Study.run`` and the
plain dispatch reach ``jax.core.trace_state_clean``).

Against the JAX package's own ``StudyService``:
- admission: the same manifest and config are admitted or refused by
  both, with the same exception type and a message naming the same
  field or registry;
- the checkpointed route (``checkpoint_every=5``, which does not reach
  R1): the same dispatch directory name and ``dispatch.json``, and in
  the responses participation, ``finite``, ``diverged`` and the
  records' integer fields bit for bit, float fields within ``rtol=1e-5,
  atol=1e-6`` (``tests/test_torch_resumable.py``'s tolerance). Both
  services are built as the JAX tests build theirs, without a
  ``loss_fn``: the floats held are the params and ``weight_sum``. (With
  the quadratic's suboptimality f(w) − f* as the loss, the params agree
  to ~3e-7 relative at these sizes but the loss, a difference of nearly
  equal numbers, only to ~2e-5.);
- recovery across packages, both ways: a dispatch that one package's
  service was interrupted in after two chunks (the ``dying_save`` patch
  of the JAX tests) is finished by the other's fresh service with
  ``recover()``, and equals that package's own uninterrupted
  checkpointed dispatch to the same rules.
"""

import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (a worker's share of the cores)

import repro.checkpoint as jckpt
import repro.experiments as jx
import repro.serve as jserve
import repro_torch.experiments as tx
from repro.core.convergence import make_quadratic as j_make_quadratic
from repro.optim import sgd as j_sgd
from repro_torch import random as trandom
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.convergence import make_quadratic
from repro_torch.experiments import (ExecutionConfig, Study, engine,
                                     request_to_manifest)
from repro_torch.kernels.aggregate import ops
from repro_torch.optim import sgd
from repro_torch.serve import BackgroundServer, StudyService

CAPACITY, DIM, STEPS = 8, 4, 20
POPULATIONS = [3, 4, 5, 6, 7, 8, 3, 5]
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def prob():
    return make_quadratic(trandom.PRNGKey(0, device="cpu"), CAPACITY, dim=DIM)


@pytest.fixture(scope="module")
def grads_fn(prob):
    return lambda w, k, t: prob.all_grads(w)


@pytest.fixture(scope="module")
def jprob():
    return j_make_quadratic(jax.random.PRNGKey(0), CAPACITY, dim=DIM)


def make_service(prob, grads_fn, **kw):
    kw.setdefault("cache_size", 8)
    return StudyService(grads_fn=grads_fn, p=prob.p, optimizer=sgd(0.05),
                        params0=torch.zeros(DIM), use_kernel=True,
                        device="cpu", **kw)


def make_study(name: str, n: int, *, scheduler="alg1", arrivals="periodic",
               steps=STEPS, faults=None, seeds=(0, 1), pkg=tx):
    study = (pkg.Study(name, num_steps=steps).axis("scheduler", scheduler)
             .axis("arrivals", arrivals).axis("n_clients", n)
             .axis("seeds", list(seeds)))
    if faults is not None:
        study.axis("faults", faults)
    return study


def solo(study, prob, grads_fn):
    return study.run(grads_fn=grads_fn, p=prob.p, optimizer=sgd(0.05),
                     params0=torch.zeros(DIM), use_kernel=True, device="cpu")


def _assert_cells_bitwise(a, b):
    la, lb = tree_leaves(tuple(a)), tree_leaves(tuple(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_grids_bitwise(a, b):
    assert set(a.cells) == set(b.cells)
    for name in a.cells:
        _assert_cells_bitwise(a.cells[name], b.cells[name])


# ----------------------------------------------------- single-trace collapse

def test_mixed_population_batch_compiles_one_trace(prob, grads_fn):
    """≥ 8 manifests, 6 distinct population sizes, one structure ->
    exactly one compile and one live cache entry."""
    svc = make_service(prob, grads_fn)
    for i, n in enumerate(POPULATIONS):
        svc.submit(make_study(f"s{i}", n).to_json())
    responses = svc.flush()
    assert len(responses) == len(POPULATIONS)
    assert all(r.error is None for r in responses)
    stats = svc.stats()
    assert stats["compiles"] == 1
    assert stats["executable_entries"] == 1  # ONE batch signature total
    assert responses[0].batch == {
        "requests": 8, "cells": 8, "dispatches": 1, "cache_hits": 0,
        "new_compiles": 1}


def test_batched_result_bitwise_equals_solo_study_run(prob, grads_fn):
    """Every request demuxed from the shared dispatch must be bitwise
    identical to running its Study alone."""
    svc = make_service(prob, grads_fn)
    studies = [make_study(f"s{i}", n) for i, n in enumerate(POPULATIONS)]
    rids = [svc.submit(s.to_json()) for s in studies]
    svc.flush()
    for rid, study in zip(rids, studies):
        _assert_grids_bitwise(solo(study, prob, grads_fn),
                              svc.result(rid).result)


def test_repeat_submission_is_pure_cache_hit(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    manifests = [make_study(f"s{i}", n).to_json()
                 for i, n in enumerate(POPULATIONS)]
    for m in manifests:
        svc.submit(m)
    svc.flush()
    first = svc.stats()
    for m in manifests:  # identical manifest set again
        svc.submit(m)
    responses = svc.flush()
    second = svc.stats()
    assert second["compiles"] == first["compiles"] == 1
    assert second["hits"] == first["hits"] + 1
    assert responses[0].batch["new_compiles"] == 0
    assert responses[0].batch["cache_hits"] == 1


def test_new_batch_shape_is_a_new_signature_not_a_new_entry(prob, grads_fn):
    """What makes the JAX package's jit trace again makes a runner count
    a compile: more cells (S) or seeds (R) under one structure key."""
    svc = make_service(prob, grads_fn)
    svc.submit(make_study("a", 4).to_json())
    svc.flush()
    svc.submit(make_study("a", 4).to_json())
    svc.submit(make_study("b", 5).to_json())
    svc.flush()
    svc.submit(make_study("c", 6, seeds=(0, 1, 2)).to_json())
    svc.flush()
    stats = svc.stats()
    assert stats["size"] == 1 and stats["compiles"] == 3
    assert stats["executable_entries"] == 3


# ------------------------------------------------------------ cache bounds

def test_executable_cache_eviction_is_bounded_lru(prob, grads_fn):
    svc = make_service(prob, grads_fn, cache_size=1)
    a = make_study("a", 4).to_json()  # structure 1
    b = make_study("b", 4, scheduler="alg2", arrivals="binary").to_json()
    for m in (a, b, a):  # b evicts a; the re-run of a evicts b
        svc.submit(m)
        svc.flush()
    stats = svc.stats()
    assert stats["evictions"] == 2
    assert stats["size"] == 1
    assert stats["executable_entries"] >= 1
    assert stats["compiles"] == 3  # the third submit recompiled structure 1


def test_distinct_execution_configs_never_share_entries(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    m = make_study("a", 4).to_json()
    svc.submit(m, config=ExecutionConfig(client_reduction="psum"))
    svc.flush()
    svc.submit(m, config=ExecutionConfig(client_reduction="gather"))
    svc.flush()
    assert svc.stats()["size"] == 2  # one entry per (structure, config)


def test_cached_engine_equals_uncached(prob, grads_fn, tmp_path):
    """Without a cache the engine gives what it gave before; through a
    cache's runners, the same bits (plain and checkpointed routes)."""
    from repro_torch.serve import ExecutableCache

    sim = Study("x", num_steps=1).simulator(
        grads_fn=grads_fn, p=prob.p, optimizer=sgd(0.05), use_kernel=True,
        device="cpu")
    cells = [sc for i, n in enumerate((3, 8, 5))
             for sc in make_study(f"s{i}", n).resolve()]
    for i, sc in enumerate(cells):
        sc.name = f"c{i}"
    kw = dict(sim=sim, params0=torch.zeros(DIM), num_steps=STEPS,
              seeds=[0, 1])
    cache = ExecutableCache()
    plain = engine.execute_cells(cells, **kw)
    cached = engine.execute_cells(cells, executable_cache=cache, **kw)
    ck = engine.execute_cells_resumable(
        cells, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=7,
        executable_cache=cache.bind("x"), **kw)
    for name in plain:
        _assert_cells_bitwise(plain[name], cached[name])
        _assert_cells_bitwise(plain[name], ck[name])
    assert cache.stats()["compiles"] == 3  # the group; chunks of 7 and 6


def test_structure_fingerprint_is_per_structure(prob, grads_fn):
    """Cells of one structure give one digest whatever their
    population; two structures give two."""
    sim = Study("x", num_steps=1).simulator(
        grads_fn=grads_fn, p=prob.p, optimizer=sgd(0.05), device="cpu")
    one = [sc for i, n in enumerate((3, 8, 5))
           for sc in make_study(f"s{i}", n).resolve()]
    two = make_study("t", 4, scheduler="alg2", arrivals="binary").resolve()
    for i, sc in enumerate(one + two):
        sc.name = f"c{i}"
    _, _, groups = engine.resolve_structure_groups(one + two, sim=sim)
    assert [len(g.members) for g in groups] == [3, 1]
    digests = {engine.structure_fingerprint(g.key) for g in groups}
    assert len(digests) == 2 and all(len(d) == 12 for d in digests)
    _, _, alone = engine.resolve_structure_groups(one[1:2], sim=sim)
    assert engine.structure_fingerprint(alone[0].key) == \
        engine.structure_fingerprint(groups[0].key)


# --------------------------------------------------------------- quarantine

def test_poisoned_request_quarantined_without_failing_siblings(prob, grads_fn):
    """A fault-poisoned cell is reported in ITS response's quarantine
    list; sibling requests in the same flush complete clean."""
    svc = make_service(prob, grads_fn)
    clean = [svc.submit(make_study(f"c{i}", n).to_json())
             for i, n in enumerate((3, 5))]
    poisoned = svc.submit(make_study(
        "p", 4, faults=("corrupt", {"rate": 1.0, "scale": float("nan")}),
    ).to_json())
    responses = svc.flush()
    assert len(responses) == 3 and all(r.error is None for r in responses)
    bad = svc.result(poisoned)
    assert bad.quarantined  # every seed poisoned from step 0
    assert bad.divergence[bad.quarantined[0]]["n_diverged"] == 2
    assert all(r["first_bad_step"] == 0 for r in bad.records)
    for rid in clean:
        resp = svc.result(rid)
        assert resp.quarantined == []
        assert all(r["n_diverged"] == 0 for r in resp.records)


def test_dispatch_failure_isolated_to_its_group(prob, grads_fn, monkeypatch):
    """An engine error fails only the dispatch group that raised; other
    groups in the same flush still answer, and every waiter is
    released."""
    real = engine.execute_cells

    def exploding(scenarios, **kw):
        if kw.get("num_steps") == STEPS + 5:  # the doomed dispatch group
            raise RuntimeError("injected engine failure")
        return real(scenarios, **kw)

    monkeypatch.setattr(engine, "execute_cells", exploding)
    svc = make_service(prob, grads_fn)
    ok = svc.submit(make_study("fine", 4).to_json())
    # different num_steps -> its own dispatch group
    bad = svc.submit(make_study("boom", 4, steps=STEPS + 5).to_json())
    responses = svc.flush()
    assert len(responses) == 2
    assert svc.result(bad).error is not None
    assert "injected engine failure" in svc.result(bad).error
    assert svc.result(bad).records == []
    assert svc.result(ok).error is None and svc.result(ok).records


# ---------------------------------------------------------------- admission

def test_unserveable_config_rejected_at_submit(prob, grads_fn):
    """Live-object / sequential configs still refuse at submit — and the
    check compares against field *defaults*, not truthiness."""
    svc = make_service(prob, grads_fn)
    study = make_study("s", 4)
    for field, value in (("sequential", True), ("eval_fn", lambda p: p),
                         ("mesh", object())):
        cfg = ExecutionConfig(**{field: value})
        with pytest.raises(ValueError, match=rf"{field}.*not serveable"):
            svc.submit(study, config=cfg)
    assert svc.pending == 0


def _incoherent_cases(tmp):
    return (
        (dict(checkpoint_every=20), r"checkpoint_every=20"),
        (dict(checkpoint_every=-1), r"checkpoint_every=-1"),
        (dict(checkpoint_keep=5), r"checkpoint_keep=5"),
        (dict(halt_on_divergence=True), r"halt_on_divergence=True"),
        (dict(checkpoint_every=5, checkpoint_dir=tmp,
              client_reduction="gather"), r"client_reduction='gather'"),
        (dict(checkpoint_every=5, checkpoint_dir=tmp, degrade=True),
         r"degrade"),
    )


def test_incoherent_checkpoint_config_raises_located_error(prob, grads_fn,
                                                           tmp_path):
    """checkpoint_every without anywhere to write, and resumable-only or
    resumable-meaningless fields set on the wrong path, must raise an
    error naming the offending field — not pass silently."""
    svc = make_service(prob, grads_fn)  # no checkpoint_root
    study = make_study("s", 4)
    for fields, pattern in _incoherent_cases(str(tmp_path / "x")):
        with pytest.raises(ValueError, match=pattern):
            svc.submit(study, config=ExecutionConfig(**fields))
    assert svc.pending == 0
    assert not (tmp_path / "x").exists()


def test_checkpoint_every_admitted_with_service_root(prob, grads_fn,
                                                     tmp_path):
    """The same checkpoint_every-only config that raises without a root
    is serveable once the service owns one."""
    svc = make_service(prob, grads_fn, checkpoint_root=str(tmp_path))
    rid = svc.submit(make_study("s", 4), ExecutionConfig(checkpoint_every=10))
    (resp,) = svc.flush()
    assert resp.error is None and resp.request_id == rid
    assert resp.batch["resumable"] is True


def test_capacity_overflow_rejected_at_submit(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    with pytest.raises(ValueError, match=rf"N_cap={CAPACITY}.*N=40"):
        svc.submit(make_study("big", 40).to_json())
    assert svc.pending == 0


def test_unknown_registry_name_rejected_at_submit(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    doc = make_study("s", 4).to_manifest()
    doc["axes"][0]["values"] = ["sgd_magic"]
    with pytest.raises(ValueError, match=r"scheduler registry"):
        svc.submit(doc)


def test_duplicate_config_sources_rejected(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    doc = request_to_manifest(make_study("s", 4),
                              ExecutionConfig(client_reduction="gather"))
    with pytest.raises(ValueError, match=r"both in the manifest"):
        svc.submit(doc, config=ExecutionConfig())


def test_service_defaults_to_the_card(prob, grads_fn):
    """No device given means the card: without one the service raises,
    it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA device"):
        StudyService(grads_fn=grads_fn, p=prob.p, optimizer=sgd(0.05),
                     params0=torch.zeros(DIM))


# -------------------------------------------------------------------- demux

def test_demux_restores_request_local_names_and_labels(prob, grads_fn):
    """Two requests may use identical study/cell names — the service
    namespaces on the wire and restores local names in each response."""
    svc = make_service(prob, grads_fn)
    r1 = svc.submit(make_study("same", 3).to_json())
    r2 = svc.submit(make_study("same", 5).to_json())
    svc.flush()
    g1, g2 = svc.result(r1).result, svc.result(r2).result
    assert list(g1.cells) == list(g2.cells) == ["alg1_periodic"]
    assert g1.labels("alg1_periodic")["n_clients"] == 3
    assert g2.labels("alg1_periodic")["n_clients"] == 5
    assert svc.result(r1).records[0]["n_clients"] == 3


def test_wait_via_background_server(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    with BackgroundServer(svc):
        rids = [svc.submit(make_study(f"s{i}", n).to_json())
                for i, n in enumerate(POPULATIONS)]
        responses = [svc.wait(rid, timeout=300) for rid in rids]
    assert all(r.error is None for r in responses)
    assert svc.stats()["compiles"] <= 2  # burst may split into <=2 batches
    with pytest.raises(KeyError, match="unknown request id"):
        svc.wait("r9999")


def test_result_before_flush_raises(prob, grads_fn):
    svc = make_service(prob, grads_fn)
    rid = svc.submit(make_study("s", 4).to_json())
    with pytest.raises(KeyError, match="no response"):
        svc.result(rid)
    svc.flush()
    assert svc.result(rid).request_id == rid


# -------------------------------------------------- resumable dispatch (§12)

def test_resumable_dispatch_bitwise_equals_unchunked(prob, grads_fn,
                                                     tmp_path):
    """A checkpointed (chunked) serve dispatch returns results bitwise
    equal to the plain unchunked engine."""
    svc = make_service(prob, grads_fn, checkpoint_root=str(tmp_path))
    cfg = ExecutionConfig(checkpoint_every=5)
    studies = [make_study(f"s{i}", n) for i, n in enumerate((3, 5, 8))]
    rids = [svc.submit(s, cfg) for s in studies]
    responses = svc.flush()
    assert all(r.error is None for r in responses)
    assert responses[0].batch["chunks"] == STEPS // 5
    for rid, study in zip(rids, studies):
        _assert_grids_bitwise(solo(study, prob, grads_fn),
                              svc.result(rid).result)


def _dying_save(monkeypatch, cls, after=2):
    """Patch ``cls.save`` to raise once ``after`` saves have been made —
    the preemption the JAX tests inject."""
    real_save, saves = cls.save, [0]

    def dying_save(self, step, state):
        if saves[0] >= after:
            raise RuntimeError("injected preemption")
        saves[0] += 1
        return real_save(self, step, state)

    monkeypatch.setattr(cls, "save", dying_save)
    return real_save


def test_interrupted_dispatch_warm_resume_zero_new_compiles(
        prob, grads_fn, tmp_path, monkeypatch):
    """Kill a checkpointed dispatch mid-run (save raises after 2 chunks),
    resubmit the same manifests: the retry resumes from the checkpoint
    tail with ZERO new compiles (chunk runners come from the keyed
    executable cache) and the result is bitwise equal to an
    uninterrupted run."""
    svc = make_service(prob, grads_fn, checkpoint_root=str(tmp_path))
    cfg = ExecutionConfig(checkpoint_every=5)
    manifests = [make_study(f"s{i}", n).to_json() for i, n in
                 enumerate((3, 5, 8))]

    real_save = _dying_save(monkeypatch, CheckpointManager)
    for m in manifests:
        svc.submit(m, ExecutionConfig(checkpoint_every=5))
    (first, *_) = svc.flush()
    assert first.error is not None and "injected preemption" in first.error

    monkeypatch.setattr(CheckpointManager, "save", real_save)
    rids = [svc.submit(m, cfg) for m in manifests]
    before = svc.stats()["compiles"]
    responses = svc.flush()
    assert all(r.error is None for r in responses)
    assert responses[0].batch["resumed_steps"] == 10  # 2 chunks survived
    assert responses[0].batch["new_compiles"] == 0
    assert svc.stats()["compiles"] == before  # warm resume: pure dispatch
    for i, (rid, n) in enumerate(zip(rids, (3, 5, 8))):
        _assert_grids_bitwise(solo(make_study(f"s{i}", n), prob, grads_fn),
                              svc.result(rid).result)


def test_recover_restores_completed_dispatch_without_execution(
        prob, grads_fn, tmp_path):
    """A fresh service pointed at the checkpoint root rediscovers a
    finished dispatch from its dispatch.json and serves it by pure
    checkpoint restore — zero compiles, zero chunks, bitwise equal."""
    root = str(tmp_path)
    cfg = ExecutionConfig(checkpoint_every=5)
    svc = make_service(prob, grads_fn, checkpoint_root=root)
    rid = svc.submit(make_study("s", 5), cfg)
    svc.flush()
    original = svc.result(rid).result

    fresh = make_service(prob, grads_fn, checkpoint_root=root)
    (rid2,) = fresh.recover()
    resp = fresh.result(rid2)
    assert resp.error is None
    assert resp.batch["resumed_steps"] == STEPS
    assert resp.batch["chunks"] == 0
    assert fresh.stats()["compiles"] == 0
    _assert_grids_bitwise(original, resp.result)


def test_recover_without_root_raises(prob, grads_fn):
    with pytest.raises(RuntimeError, match="checkpoint_root"):
        make_service(prob, grads_fn).recover()


# ------------------------------------------------- response store (bounded)

def test_response_store_is_bounded_lru(prob, grads_fn):
    """The response store is a bounded LRU; eviction forgets the request
    record too, and the policy shows up in stats()."""
    svc = make_service(prob, grads_fn, response_cache_size=2)
    rids = [svc.submit(make_study(f"s{i}", n).to_json())
            for i, n in enumerate((3, 5, 8))]
    svc.flush()
    store = svc.stats()["response_store"]
    assert store["maxsize"] == 2 and store["size"] == 2
    assert store["evictions"] == 1
    with pytest.raises(KeyError, match="no response"):
        svc.result(rids[0])  # evicted (oldest)
    with pytest.raises(KeyError, match="unknown request id"):
        svc.wait(rids[0])  # request record evicted with it
    assert svc.result(rids[1]).error is None
    assert svc.result(rids[2]).error is None


# --------------------------------------------------------- shutdown & races

def test_stop_drains_queue_verifiably_empty(prob, grads_fn):
    """Requests sitting in the queue when stop() is called are served by
    the drain loop — stop() never walks away from a non-empty queue."""
    svc = make_service(prob, grads_fn)
    server = BackgroundServer(svc, window_s=0.05)
    server.start()
    rids = [svc.submit(make_study(f"s{i}", n).to_json())
            for i, n in enumerate(POPULATIONS)]
    server.stop()  # immediately: worker may not have flushed yet
    assert svc.pending == 0
    for rid in rids:
        assert svc.result(rid).error is None


def test_submit_while_draining_is_refused_not_stranded(prob, grads_fn):
    """During the stop() drain admissions are closed: a racing submit
    raises instead of landing in a queue with no flusher. Admissions
    reopen afterwards (the post-shutdown manual-flush pattern)."""
    svc = make_service(prob, grads_fn)
    svc._begin_drain()
    with pytest.raises(RuntimeError, match="draining"):
        svc.submit(make_study("s", 4).to_json())
    svc._end_drain()
    rid = svc.submit(make_study("s", 4).to_json())
    svc.flush()
    assert svc.result(rid).error is None


def test_concurrent_submitters_with_competing_flushers(prob, grads_fn):
    """Many threads submit mixed-population manifests through one
    BackgroundServer while another thread hammers flush(); every waiter
    releases, every response is bitwise equal to its solo Study.run, and
    the cache counters stay consistent (each miss inserted exactly one
    entry — no lost updates)."""
    svc = make_service(prob, grads_fn, cache_size=8,
                       response_cache_size=256)
    pops = POPULATIONS
    ref = {n: solo(make_study(f"ref{n}", n), prob, grads_fn)
           for n in sorted(set(pops))}
    n_threads, per_thread = 6, len(pops)
    errors, results = [], {}
    lock = threading.Lock()
    barrier = threading.Barrier(n_threads + 1)

    def submitter(tid):
        try:
            barrier.wait()
            for i, n in enumerate(pops):
                rid = svc.submit(make_study(f"t{tid}_{i}", n).to_json())
                resp = svc.wait(rid, timeout=300)
                with lock:
                    results[(tid, i, n)] = resp
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)

    def flusher():
        barrier.wait()
        for _ in range(200):
            svc.flush()
            time.sleep(0.001)

    with BackgroundServer(svc):
        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        threads.append(threading.Thread(target=flusher))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()

    assert not errors
    assert len(results) == n_threads * per_thread  # every waiter released
    for (tid, i, n), resp in results.items():
        assert resp.error is None
        (ref_cell,) = ref[n].cells.values()
        (served_cell,) = resp.result.cells.values()
        _assert_cells_bitwise(ref_cell, served_cell)
    stats = svc.stats()
    assert stats["requests"] == n_threads * per_thread
    # no lost updates: every miss inserted exactly one cache entry
    assert stats["misses"] == stats["size"] + stats["evictions"]
    assert stats["compiles"] >= 1
    assert stats["response_store"]["size"] == n_threads * per_thread


def test_launch_counts_exact_under_threads():
    """The kernels' launch counts take no lost update when flushers on
    many threads launch at once (more threads than cores, a shortened
    switch interval)."""
    name = "masked_scaled_aggregate_update"
    n_threads, per_thread = 4 * (os.cpu_count() or 4), 2000
    saved = sys.getswitchinterval()
    before = ops.launch_counts[name]
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(
            target=lambda: [ops._count(name) for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(saved)
    assert ops.launch_counts[name] - before == n_threads * per_thread
    ops.launch_counts[name] = before


# -------------------------------------------- against the JAX StudyService

def _jax_service(jprob, **kw):
    return jserve.StudyService(
        grads_fn=lambda w, k, t: jprob.all_grads(w), p=jprob.p,
        optimizer=j_sgd(0.05), params0=jnp.zeros(DIM), **kw)


def _admission_cases():
    """(id, manifest maker (pkg -> manifest), config fields or None,
    word the refusal must name or None when admitted)."""
    def study(pkg, **kw):
        return make_study("s", 4, pkg=pkg, **kw)

    def bad_scheduler(pkg):
        doc = study(pkg).to_manifest()
        doc["axes"][0]["values"] = ["sgd_magic"]
        return doc

    def truncated(pkg):
        text = study(pkg).to_json()
        return text[: len(text) // 2]

    return [
        ("json", lambda pkg: study(pkg).to_json(), None, None),
        ("dict", lambda pkg: study(pkg).to_manifest(), None, None),
        ("request", lambda pkg: pkg.request_to_manifest(
            study(pkg), pkg.ExecutionConfig(client_reduction="gather")),
         None, None),
        ("faulted", lambda pkg: study(pkg, faults=("drop", {"rate": 0.3}))
         .to_json(), None, None),
        ("checkpointed", lambda pkg: study(pkg).to_json(),
         dict(checkpoint_every=5), None),
        ("capacity", lambda pkg: make_study("b", 40, pkg=pkg).to_json(), None,
         "N_cap=8"),
        ("registry", bad_scheduler, None, "scheduler registry"),
        ("truncated", truncated, None, "not valid JSON"),
        ("sequential", lambda pkg: study(pkg).to_json(),
         dict(sequential=True), "sequential"),
        ("eval_every", lambda pkg: study(pkg).to_json(),
         dict(checkpoint_keep=5), "checkpoint_keep"),
        ("every<0", lambda pkg: study(pkg).to_json(),
         dict(checkpoint_every=-1), "checkpoint_every=-1"),
        ("halt", lambda pkg: study(pkg).to_json(),
         dict(halt_on_divergence=True), "halt_on_divergence"),
        ("reduction", lambda pkg: study(pkg).to_json(),
         dict(checkpoint_every=5, client_reduction="gather"),
         "client_reduction"),
        ("degrade", lambda pkg: study(pkg).to_json(),
         dict(checkpoint_every=5, degrade=True), "degrade"),
        ("two configs", lambda pkg: pkg.request_to_manifest(
            study(pkg), pkg.ExecutionConfig(client_reduction="gather")),
         dict(), "both in the manifest"),
    ]


@pytest.mark.parametrize("build,fields,words",
                         [c[1:] for c in _admission_cases()],
                         ids=[c[0] for c in _admission_cases()])
def test_admission_matches_jax(prob, grads_fn, jprob, tmp_path, build,
                              fields, words):
    """The same manifest and config are admitted by both services or
    refused by both, with the same exception type and a message naming
    the same field or registry."""
    outcomes = []
    for pkg, svc in ((jx, _jax_service(jprob, checkpoint_root=str(
            tmp_path / "j"))), (tx, make_service(
            prob, grads_fn, checkpoint_root=str(tmp_path / "t")))):
        config = None if fields is None else pkg.ExecutionConfig(**fields)
        try:
            svc.submit(build(pkg), config)
            outcomes.append(None)
            assert svc.pending == 1
        except Exception as e:  # noqa: BLE001 — compared below
            outcomes.append(e)
            assert svc.pending == 0
    if words is None:
        assert outcomes == [None, None]
    else:
        assert None not in outcomes, outcomes
        assert type(outcomes[0]) is type(outcomes[1])
        assert all(words in str(e) for e in outcomes), outcomes


def _dispatch_records(root):
    out = {}
    for entry in sorted(os.listdir(root)):
        with open(os.path.join(root, entry, "dispatch.json")) as f:
            out[entry] = json.dumps(json.load(f), sort_keys=True)
    return out


def _assert_same_run(got, want):
    """Two responses of one request (either package on either side):
    participation and ``finite`` bitwise, floats to tolerance."""
    assert got.error is None and want.error is None, (got.error, want.error)
    assert list(got.result.cells) == list(want.result.cells)
    for name in got.result.cells:
        a, b = got.result.cells[name], want.result.cells[name]
        for x, y in ((a.history.participation, b.history.participation),
                     (a.history.finite, b.history.finite)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), name)
        for x, y in ((a.history.loss, b.history.loss),
                     (a.history.weight_sum, b.history.weight_sum),
                     (a.params, b.params)):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


def _assert_response_like(t, j):
    """A port response against a JAX response of the same request: the
    run as :func:`_assert_same_run`, ``diverged`` and the records'
    integer fields bitwise, their float fields to tolerance."""
    _assert_same_run(t, j)
    assert t.study == j.study and t.quarantined == j.quarantined
    for name in t.result.cells:
        np.testing.assert_array_equal(
            np.asarray(t.result.cells[name].diverged),
            np.asarray(j.result.cells[name].diverged), name)
    assert len(t.records) == len(j.records)
    for rt, rj in zip(t.records, j.records):
        assert sorted(rt) == sorted(rj)
        for key, want in rj.items():
            if isinstance(want, float):
                np.testing.assert_allclose(rt[key], want, rtol=RTOL,
                                           atol=ATOL, err_msg=key)
            else:
                assert rt[key] == want, key


def _cross_manifests(pkg):
    return [make_study(f"s{i}", n, pkg=pkg).to_json()
            for i, n in enumerate((3, 5, 8))] + [
        make_study("d", 6, pkg=pkg, faults=("drop", {"rate": 0.3})).to_json()]


def _serve(svc, manifests, cfg):
    for m in manifests:
        svc.submit(m, cfg)
    return sorted(svc.flush(), key=lambda r: r.study)


def test_checkpointed_dispatch_matches_jax(prob, grads_fn, jprob, tmp_path):
    """The checkpointed route against JAX's own StudyService: the same
    dispatch directories and dispatch.json records, and responses alike
    (participation bitwise, floats to tolerance)."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    jresp = _serve(_jax_service(jprob, checkpoint_root=jroot),
                   _cross_manifests(jx), jx.ExecutionConfig(checkpoint_every=5))
    tresp = _serve(make_service(prob, grads_fn, checkpoint_root=troot),
                   _cross_manifests(tx), ExecutionConfig(checkpoint_every=5))
    assert _dispatch_records(troot) == _dispatch_records(jroot)
    assert len(_dispatch_records(troot)) == 1
    for t, j in zip(tresp, jresp):
        # two structure groups (fault-free, drop) of STEPS // 5 chunks
        assert t.batch["chunks"] == j.batch["chunks"] == 2 * (STEPS // 5)
        assert t.batch["new_compiles"] == j.batch["new_compiles"]
        assert os.path.basename(t.batch["checkpoint_dir"]) == \
            os.path.basename(j.batch["checkpoint_dir"])
        _assert_response_like(t, j)


@pytest.mark.parametrize("writer,reader", [(jx, tx), (tx, jx)],
                         ids=["jax->port", "port->jax"])
def test_recovery_across_packages(prob, grads_fn, jprob, tmp_path,
                                  monkeypatch, writer, reader):
    """One package's service is interrupted after two chunks; a fresh
    service of the other package finishes the dispatch with recover().
    Each recovered response equals the recovering package's own
    uninterrupted checkpointed dispatch."""
    def make(pkg, root):
        return (_jax_service(jprob, checkpoint_root=root) if pkg is jx
                else make_service(prob, grads_fn, checkpoint_root=root))

    root = str(tmp_path / "root")
    cls = jckpt.CheckpointManager if writer is jx else CheckpointManager
    real_save = _dying_save(monkeypatch, cls)
    died = _serve(make(writer, root), _cross_manifests(writer),
                  writer.ExecutionConfig(checkpoint_every=5))
    assert all("injected preemption" in (r.error or "") for r in died)
    monkeypatch.setattr(cls, "save", real_save)

    fresh = make(reader, root)
    rids = fresh.recover()
    recovered = sorted((fresh.result(r) for r in rids), key=lambda r: r.study)
    whole = _serve(make(reader, str(tmp_path / "whole")),
                   _cross_manifests(reader),
                   reader.ExecutionConfig(checkpoint_every=5))
    assert len(recovered) == len(whole) == 4
    for got, want in zip(recovered, whole):
        _assert_same_run(got, want)
        # the first group was cut after 2 chunks, the second not begun
        assert got.batch["resumed_steps"] == 10
        assert got.batch["chunks"] == 2 * (STEPS // 5) - 2
