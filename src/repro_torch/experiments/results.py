"""Labeled grid results: one table type for every reduction loop.

:class:`GridResult` is what :meth:`repro_torch.experiments.Study.run` returns —
a mapping from cell name to :class:`~repro_torch.experiments.engine.CellResult`
that *also* carries the named sweep axes each cell was resolved from, so
selection and reduction are declarative:

    result.sel(scheduler="alg1")                    # sub-grid
    result.reduce(metric, over="seed")              # mean±std per cell
    result.reduce(metric, over="capacity")          # pool an axis
    result.to_records() / result.to_json()          # export

Reductions are NaN-aware (:func:`seed_stats`): one diverged seed shows
up as ``n_nan`` instead of poisoning the scenario's mean/std. The same
helper backs the legacy :func:`repro_torch.experiments.grid_summary`, so there
is exactly one reduction implementation.

Port of ``repro.experiments.results``. A cell's leaves stay torch
tensors on the simulator's device; the reductions here copy what they
read to the host once per cell (:func:`host`), so the same code serves a
CUDA run and a CPU run.
"""

from __future__ import annotations

import json
from typing import Callable, Mapping

import numpy as np
import torch


def host(x) -> np.ndarray:
    """A host numpy copy of a tensor (on any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def seed_stats(vals) -> dict:
    """NaN-aware mean/std over a (R,) per-seed metric vector.

    Returns ``{"mean", "std", "n_seeds", "n_nan"}`` where mean/std are
    computed over the finite entries only (NaN if none survive) and
    ``n_nan`` counts the discarded seeds — a diverged run is *reported*,
    not silently averaged in and not able to poison the stat.
    """
    vals = host(vals).astype(np.float64).reshape(-1)
    nan = ~np.isfinite(vals)
    n_nan = int(nan.sum())
    kept = vals[~nan]
    if kept.size:
        mean, std = float(kept.mean()), float(kept.std())
    else:
        mean, std = float("nan"), float("nan")
    return {"mean": mean, "std": std, "n_seeds": int(vals.size),
            "n_nan": n_nan}


def default_metric(cell) -> np.ndarray:
    """Mean loss over the final 10% of steps, one scalar per seed."""
    loss = host(cell.history.loss)
    tail = max(1, loss.shape[-1] // 10)
    return loss[..., -tail:].mean(axis=-1)


class GridResult(Mapping):
    """Structure-of-results with named axes.

    Mapping protocol gives dict-compatible access by cell name
    (``result["alg1_periodic"].history`` works exactly like the legacy
    ``run_grid`` dict), while ``axes`` / ``labels`` carry the sweep
    coordinates each cell came from.

    Parameters
    ----------
    cells : ordered ``{name: CellResult}`` (every leaf's leading axis is
        the seed axis R).
    labels : ``{name: {axis: value}}`` — the sweep coordinates of each
        cell (excluding the seed axis).
    axes : ordered ``{axis: tuple(values)}`` for the sweep axes, in
        canonical resolution order; includes ``"seed"`` last.
    name : study name, carried into exports.
    """

    def __init__(self, cells: dict, labels: dict, axes: dict,
                 name: str = "grid", downgrades: tuple = ()):
        self._cells = dict(cells)
        self._labels = {k: dict(v) for k, v in labels.items()}
        self.axes = {k: tuple(v) for k, v in axes.items()}
        self.name = name
        #: graceful-degradation events recorded while executing this grid
        #: (:class:`repro_torch.experiments.engine.DowngradeRecord`); empty when
        #: every group ran at its requested placement/reduction.
        self.downgrades = tuple(downgrades)

    # ------------------------------------------------------------ mapping

    def __getitem__(self, key):
        return self._cells[key]

    def __iter__(self):
        return iter(self._cells)

    def __len__(self):
        return len(self._cells)

    def __repr__(self):
        ax = ", ".join(f"{k}={len(v)}" for k, v in self.axes.items())
        return f"GridResult({self.name!r}: {len(self)} cells; {ax})"

    @property
    def cells(self) -> dict:
        return dict(self._cells)

    def labels(self, name: str) -> dict:
        """Sweep coordinates of one cell."""
        return dict(self._labels[name])

    # ---------------------------------------------------------- selection

    def sel(self, **selectors) -> "GridResult":
        """Filter cells by axis value(s): ``sel(scheduler="alg1")`` or
        ``sel(arrivals=["binary", "uniform"])``. Scalar selections drop
        the axis from ``axes`` (it no longer varies).

        Membership is by equality, never hashing — axis values may be
        unhashable (an explicit taus list, a ``(kind, kwargs)`` arrival
        pair). A selector that equals one axis value verbatim is a
        scalar selection even if it is itself a list/tuple.

        A selector value absent from its axis raises ``KeyError`` naming
        the axis and its valid values; an unknown axis *name* raises
        ``ValueError`` naming the selectable axes.
        """
        for axis in selectors:
            if axis not in self.axes or axis == "seed":
                selectable = [a for a in self.axes if a != "seed"]
                raise ValueError(
                    f"unknown axis {axis!r}; selectable axes: {selectable}")

        def is_scalar(axis, v):
            if any(v == av for av in self.axes[axis]):
                return True
            return not isinstance(v, (list, tuple, set))

        scalar = {a for a, v in selectors.items() if is_scalar(a, v)}
        wanted = {a: ([v] if a in scalar else list(v))
                  for a, v in selectors.items()}
        for axis, vs in wanted.items():
            missing = [v for v in vs
                       if not any(v == av for av in self.axes[axis])]
            if missing:
                raise KeyError(
                    f"axis {axis!r} has no value {missing[0]!r}; valid "
                    f"values: {list(self.axes[axis])}")
        names = [n for n, lab in self._labels.items()
                 if all(any(lab[a] == w for w in vs)
                        for a, vs in wanted.items())]
        if not names:
            # Every selector value exists on its axis, but the joint
            # combination has no cell (possible on irregular grids).
            raise KeyError(f"no cells match {selectors!r}")
        cells = {n: self._cells[n] for n in names}
        labels = {n: self._labels[n] for n in names}

        def surviving(axis, vals):
            if axis == "seed":
                return vals
            kept = [labels[n][axis] for n in names]
            return [v for v in vals if any(v == k for k in kept)]

        axes = {a: tuple(surviving(a, vals))
                for a, vals in self.axes.items() if a not in scalar}
        return GridResult(cells, labels, axes, name=self.name,
                          downgrades=self.downgrades)

    def only(self):
        """The single CellResult of a fully-selected grid."""
        if len(self._cells) != 1:
            raise ValueError(
                f"expected exactly one cell, have {len(self)}: "
                f"{list(self._cells)}")
        return next(iter(self._cells.values()))

    # ---------------------------------------------------------- reduction

    def reduce(self, metric: Callable | None = None,
               over: str = "seed") -> dict[str, dict]:
        """NaN-aware mean±std of a per-seed scalar metric.

        ``metric(cell) -> (R,)`` extracts one scalar per seed (default:
        mean loss over the final 10% of steps). ``over="seed"`` returns
        ``{cell_name: seed_stats}``; ``over=<axis>`` pools the metric
        across that axis's cells (seeds included), keyed by the joined
        remaining labels.
        """
        metric = default_metric if metric is None else metric
        if over == "seed":
            return {name: seed_stats(metric(cell))
                    for name, cell in self._cells.items()}
        if over not in self.axes:
            raise ValueError(
                f"unknown axis {over!r}; have {list(self.axes)}")
        keep = [a for a in self.axes
                if a not in (over, "seed") and len(self.axes[a]) > 1]
        groups: dict[str, list] = {}
        for name, cell in self._cells.items():
            lab = self._labels[name]
            key = "_".join(str(lab[a]) for a in keep) or "all"
            groups.setdefault(key, []).append(
                host(metric(cell)).reshape(-1))
        return {key: seed_stats(np.concatenate(vs))
                for key, vs in groups.items()}

    def divergence(self) -> dict[str, dict]:
        """Per-cell quarantine report (DESIGN.md §10):
        ``{name: {"n_diverged", "first_bad_step"}}`` — how many seeds
        went non-finite and the earliest first-bad-step (−1: none).
        Delegates to :func:`repro_torch.experiments.engine.divergence_summary`.
        """
        from repro_torch.experiments.engine import divergence_summary

        return divergence_summary(self._cells)

    # ------------------------------------------------------------- export

    def to_records(self, metric: Callable | None = None) -> list[dict]:
        """One flat record per cell: name + axis labels + seed stats +
        the quarantine fields (``n_diverged`` / ``first_bad_step``)."""
        metric = default_metric if metric is None else metric
        div = self.divergence()
        return [
            {"name": name, **self._labels[name],
             **seed_stats(metric(cell)), **div[name]}
            for name, cell in self._cells.items()
        ]

    def to_json(self, path: str | None = None,
                metric: Callable | None = None) -> str:
        """Records + axes as a JSON document (optionally written to
        ``path``); values are reduced to plain python scalars."""
        doc = {
            "study": self.name,
            "axes": {a: [_jsonable(v) for v in vals]
                     for a, vals in self.axes.items()},
            "records": [{k: _jsonable(v) for k, v in rec.items()}
                        for rec in self.to_records(metric)],
        }
        text = json.dumps(doc, indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.ndarray, torch.Tensor)):
        v = host(v).tolist()
        return _jsonable(v) if isinstance(v, list) else v
    if isinstance(v, (tuple, list)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v
