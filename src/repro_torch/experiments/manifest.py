"""Serializable Study manifests: typed config-from-dict over the registries.

Port of ``repro.experiments.manifest``, with the same schema tags, value
codec, checks and error texts: the wire format is shared, so a manifest
that either package writes loads in the other and re-encodes to the same
canonical JSON (``json.dumps(..., sort_keys=True)``).

A **manifest** is the JSON form of a :class:`~repro_torch.experiments.Study`
(and optionally an :class:`~repro_torch.experiments.ExecutionConfig`) — the
wire format of the serve layer (DESIGN.md §11). Three schema-versioned
envelopes:

* ``study/v1`` — a Study: name, step budget, ordered sweep axes with
  their fixed/swept flags, seeds.
* ``execution-config/v1`` — the serializable subset of ExecutionConfig
  (``mesh`` / ``eval_fn`` carry live objects and are rejected with a
  named error; manifests run the one-device engine).
* ``study-request/v1`` — the service request: a study envelope plus an
  optional execution envelope.

Decoding is *typed-config-from-dict* over the existing registries: every
axis name resolves through :func:`repro_torch.experiments.axes.get_axis` (an
unknown axis names the axis registry and its keys) and every axis value
runs the axis's ``validate`` hook (an unknown scheduler / arrival family
/ fault family / taus profile names **its** registry and valid keys) —
so a malformed manifest fails loudly at ``from_json`` time, never deep
inside a dispatch. Round-trip is exact:
``Study.from_json(study.to_json())`` reproduces axes, fixed-ness, seeds
and resolution (tuple values — ``("day_night", {"period": 50})`` pairs,
explicit taus vectors — are tagged in JSON so they decode back to
tuples).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

#: Schema tags — bump on incompatible layout changes.
STUDY_FORMAT = "study/v1"
EXEC_FORMAT = "execution-config/v1"
REQUEST_FORMAT = "study-request/v1"

_TUPLE_TAG = "__tuple__"


# ------------------------------------------------------------ value codec

def encode_value(v, *, where: str = "value"):
    """Encode one axis value into JSON-safe form.

    Tuples are tagged (``{"__tuple__": [...]}``) so round-trip restores
    them exactly — the axes layer distinguishes tuples (one
    hyperparameterized ``(kind, kwargs)`` value) from lists (a sweep).
    Unserializable values (callables, arbitrary objects) raise naming
    the offending location.
    """
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return [encode_value(x, where=where) for x in v.tolist()]
    if isinstance(v, tuple):
        return {_TUPLE_TAG: [encode_value(x, where=where) for x in v]}
    if isinstance(v, list):
        return [encode_value(x, where=where) for x in v]
    if isinstance(v, dict):
        bad = [k for k in v if not isinstance(k, str)]
        if bad:
            raise ValueError(
                f"{where}: dict keys must be strings, got {bad!r}")
        if _TUPLE_TAG in v:
            raise ValueError(
                f"{where}: dict key {_TUPLE_TAG!r} is reserved by the "
                f"manifest codec")
        return {k: encode_value(x, where=f"{where}[{k}]")
                for k, x in v.items()}
    raise ValueError(
        f"{where}: {type(v).__name__} value {v!r} is not manifest-"
        f"serializable (plain scalars, strings, lists, dicts and tuples "
        f"only)")


def decode_value(v):
    """Inverse of :func:`encode_value` (tagged tuples restored)."""
    if isinstance(v, dict):
        if set(v) == {_TUPLE_TAG}:
            return tuple(decode_value(x) for x in v[_TUPLE_TAG])
        return {k: decode_value(x) for k, x in v.items()}
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    return v


# -------------------------------------------------------------- envelopes

def _require_dict(doc, what: str) -> dict:
    if not isinstance(doc, dict):
        raise ValueError(
            f"{what} manifest must be a JSON object, got "
            f"{type(doc).__name__}")
    return doc


def _check_format(doc: dict, want: str, what: str) -> None:
    got = doc.get("format")
    if got != want:
        raise ValueError(
            f"{what} manifest has unsupported format {got!r}; this "
            f"build reads {want!r}")


def _check_keys(doc: dict, allowed, what: str) -> None:
    unknown = sorted(set(doc) - set(allowed))
    if unknown:
        raise ValueError(
            f"{what} manifest has unknown key(s) {unknown}; valid keys: "
            f"{sorted(allowed)}")


def loads(text: str) -> dict:
    """``json.loads`` with a manifest-flavored error for bad payloads
    (truncated uploads are the common service failure mode)."""
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(
            f"manifest is not valid JSON (truncated or corrupt?): {e}"
        ) from None


# ---------------------------------------------------------------- study

def study_to_manifest(study) -> dict:
    """Encode a Study as a ``study/v1`` envelope (see module docstring)."""
    axes_doc = []
    for name, values in study.axes.items():
        if name == "seeds":
            continue
        axes_doc.append({
            "axis": name,
            "fixed": name in study._fixed,
            "values": [encode_value(v, where=f"axis {name!r}")
                       for v in values],
        })
    return {
        "format": STUDY_FORMAT,
        "name": study.name,
        "num_steps": int(study.num_steps),
        "axes": axes_doc,
        "seeds": encode_value(study.seeds(), where="seeds"),
    }


def study_from_manifest(doc: dict):
    """Decode a ``study/v1`` envelope into a Study.

    Every axis resolves through the axis registry and every value runs
    the axis's registry validator — errors name the registry and its
    valid keys (module docstring).
    """
    from repro_torch.experiments.axes import get_axis
    from repro_torch.experiments.study import Study

    doc = _require_dict(doc, "study")
    _check_format(doc, STUDY_FORMAT, "study")
    _check_keys(doc, ("format", "name", "num_steps", "axes", "seeds"),
                "study")
    for key in ("name", "num_steps", "axes"):
        if key not in doc:
            raise ValueError(f"study manifest missing required key {key!r}")

    study = Study(str(doc["name"]), num_steps=int(doc["num_steps"]))
    axes_doc = doc["axes"]
    if not isinstance(axes_doc, list):
        raise ValueError(
            f"study manifest 'axes' must be a list of axis entries, got "
            f"{type(axes_doc).__name__}")
    for entry in axes_doc:
        entry = _require_dict(entry, "axis entry")
        _check_keys(entry, ("axis", "fixed", "values"), "axis entry")
        for key in ("axis", "values"):
            if key not in entry:
                raise ValueError(
                    f"axis entry missing required key {key!r}: {entry}")
        name = entry["axis"]
        spec = get_axis(name)  # unknown axis -> names the axis registry
        values = [decode_value(v) for v in entry["values"]]
        if not values:
            raise ValueError(f"axis {name!r} has an empty values list")
        if spec.validate is not None:
            for v in values:
                try:
                    spec.validate(v)
                except ValueError as e:
                    raise ValueError(f"axis {name!r}: {e}") from None
        fixed = bool(entry.get("fixed", len(values) == 1))
        study.axis(name, values[0] if fixed else list(values))
    if "seeds" in doc:
        study.axis("seeds", decode_value(doc["seeds"]))
    return study


# ----------------------------------------------------- execution config

#: ExecutionConfig fields that carry live python objects — they cannot
#: cross a JSON boundary, so a manifest must leave them at their
#: defaults (None); the serve layer runs the one-device engine.
_EXEC_LIVE_FIELDS = ("mesh", "eval_fn")


def _exec_fields():
    from repro_torch.experiments.study import ExecutionConfig

    return [f.name for f in dataclasses.fields(ExecutionConfig)]


def execution_config_to_manifest(config) -> dict:
    """Encode an ExecutionConfig as an ``execution-config/v1`` envelope."""
    doc: dict[str, Any] = {"format": EXEC_FORMAT}
    for f in dataclasses.fields(config):
        value = getattr(config, f.name)
        if f.name in _EXEC_LIVE_FIELDS:
            if value is not None:
                raise ValueError(
                    f"ExecutionConfig.{f.name} holds a live object and is "
                    f"not manifest-serializable — manifests execute on the "
                    f"one-device engine; leave {f.name}=None")
            continue
        doc[f.name] = encode_value(value, where=f"ExecutionConfig.{f.name}")
    return doc


def execution_config_from_manifest(doc: dict):
    """Decode an ``execution-config/v1`` envelope."""
    from repro_torch.experiments.study import ExecutionConfig

    doc = _require_dict(doc, "execution-config")
    _check_format(doc, EXEC_FORMAT, "execution-config")
    valid = [f for f in _exec_fields() if f not in _EXEC_LIVE_FIELDS]
    _check_keys(doc, ["format", *valid], "execution-config")
    kw = {k: decode_value(v) for k, v in doc.items() if k != "format"}
    return ExecutionConfig(**kw)


# --------------------------------------------------------------- request

def request_to_manifest(study, config=None) -> dict:
    """Encode a service request: ``study-request/v1`` envelope wrapping a
    study (and optionally an execution-config) envelope."""
    doc = {"format": REQUEST_FORMAT, "study": study_to_manifest(study)}
    if config is not None:
        doc["execution"] = execution_config_to_manifest(config)
    return doc


def request_from_manifest(doc: dict):
    """Decode a service request to ``(study, config)``.

    Accepts either a ``study-request/v1`` envelope or a bare ``study/v1``
    envelope (config defaults to None).
    """
    doc = _require_dict(doc, "request")
    if doc.get("format") == STUDY_FORMAT:
        return study_from_manifest(doc), None
    _check_format(doc, REQUEST_FORMAT, "request")
    _check_keys(doc, ("format", "study", "execution"), "request")
    if "study" not in doc:
        raise ValueError("request manifest missing required key 'study'")
    study = study_from_manifest(doc["study"])
    config = None
    if doc.get("execution") is not None:
        config = execution_config_from_manifest(doc["execution"])
    return study, config
