"""Study/ExecutionConfig manifests in the port
(``repro_torch.experiments.manifest``), and the wire format shared with
the JAX package.

Every case of ``tests/test_manifest.py`` runs against the port: the
``to_json -> from_json`` round trip is exact over every registered
scheduler, arrival family, fault family and sweep axis, and a malformed
manifest fails at decode time with an error naming the registry (and its
valid keys) or the offending key.

Across packages: each study and config of those cases is encoded by one
package, decoded by the other and re-encoded, and the canonical JSON
(``json.dumps(..., sort_keys=True)``) must be the same text in both
directions; each malformed manifest raises the same exception type in
both packages, with a message naming the same registry or field.
"""

import json

import pytest

import repro.experiments as jx
import repro_torch.experiments as tx
from repro_torch.core.energy import arrival_family_names
from repro_torch.core.faults import fault_family_names
from repro_torch.core.scheduling import scheduler_names
from repro_torch.experiments import ExecutionConfig, Study, axis_names
from repro_torch.experiments.manifest import (
    EXEC_FORMAT,
    REQUEST_FORMAT,
    STUDY_FORMAT,
    decode_value,
    encode_value,
    request_from_manifest,
    request_to_manifest,
)


def base_study(pkg=tx, **axes):
    merged = {"scheduler": "alg1", "arrivals": "periodic",
              "n_clients": 4, "seeds": [0, 1], **axes}
    return pkg.Study("t", num_steps=50, axes=merged)


def assert_roundtrip(study):
    """from_json(to_json) must reproduce the manifest, the axes (values
    and fixed-ness), the seeds and the resolved cell names exactly."""
    back = Study.from_json(study.to_json())
    assert back.to_manifest() == study.to_manifest()
    assert back.axes == study.axes
    assert back._fixed == study._fixed
    assert back._seed_values() == study._seed_values()
    assert [sc.name for sc in back.resolve()] == \
        [sc.name for sc in study.resolve()]
    return back


def _fault_value(family):
    return (family, {"rate": 0.25}) \
        if family in ("drop", "corrupt", "stale") else family


#: The studies of the round-trip cases, as axes over ``base_study``.
STUDY_CASES = (
    [(f"scheduler={s}", {"scheduler": s}) for s in scheduler_names()]
    + [(f"arrivals={a}", {"arrivals": (a, {"period": 50})
                          if a == "day_night" else a})
       for a in arrival_family_names()]
    + [(f"faults={f}", {"faults": _fault_value(f)})
       for f in [None] + fault_family_names()]
    + [("every axis swept", {
        "scheduler": ["alg1", "alg2"],
        "arrivals": ["periodic",
                     ("day_night", {"period": 20, "contrast": 2.0})],
        "capacity": [1.0, 4.0], "n_clients": [3, 4],
        "taus_profile": "paper",
        "faults": [None, ("drop", {"rate": 0.5})]}),
       ("explicit taus", {"taus_profile": (4.0, 8.0, 16.0)}),
       ("taus list", {"taus_profile": [1, 5, 10, 20]}),
       ("seed count", {"seeds": 5}),
       ("seed list", {"seeds": [7, 3]}),
       ("fixed n", {"n_clients": 4}),
       ("swept singleton n", {"n_clients": [4]})])

CONFIG_CASES = (
    {},
    {"client_reduction": "gather", "degrade": True, "checkpoint_every": 25,
     "halt_on_divergence": True},
    {"checkpoint_dir": "ck", "checkpoint_every": 5, "checkpoint_keep": 2},
    {"sequential": True, "eval_every": 10},
)


def _canon(doc) -> str:
    return json.dumps(doc, sort_keys=True)


# ------------------------------------------------------------- round-trips

@pytest.mark.parametrize("scheduler", scheduler_names())
def test_roundtrip_every_scheduler(scheduler):
    assert_roundtrip(base_study(scheduler=scheduler))


@pytest.mark.parametrize("family", arrival_family_names())
def test_roundtrip_every_arrival_family(family):
    value = (family, {"period": 50}) if family == "day_night" else family
    assert_roundtrip(base_study(arrivals=value))


@pytest.mark.parametrize("family", [None] + fault_family_names())
def test_roundtrip_every_fault_family(family):
    assert_roundtrip(base_study(faults=_fault_value(family)))


def test_roundtrip_every_builtin_axis_swept():
    """One study sweeping every built-in axis at once."""
    study = base_study(**dict(STUDY_CASES)["every axis swept"])
    back = assert_roundtrip(study)
    assert len(back.resolve()) == len(study.resolve()) == 32


def test_roundtrip_explicit_taus_vector_stays_tuple():
    study = base_study(taus_profile=(4.0, 8.0, 16.0))
    back = assert_roundtrip(study)
    assert back.axes["taus_profile"] == ((4.0, 8.0, 16.0),)


def test_roundtrip_int_seed_count_and_explicit_list():
    assert Study.from_json(base_study(seeds=5).to_json())._seed_values() \
        == (0, 1, 2, 3, 4)
    assert Study.from_json(base_study(seeds=[7, 3]).to_json())._seed_values() \
        == (7, 3)


def test_roundtrip_fixed_vs_swept_singleton():
    """A 1-element sweep list is NOT a fixed axis: the value appears in
    cell names. The flag must survive the round-trip."""
    fixed = base_study(n_clients=4)
    swept = base_study(n_clients=[4])
    assert "n_clients" in fixed._fixed and "n_clients" not in swept._fixed
    assert_roundtrip(fixed)
    back = assert_roundtrip(swept)
    assert "n4" in back.resolve()[0].name


def test_execution_config_roundtrip():
    cfg = ExecutionConfig(client_reduction="gather", degrade=True,
                          checkpoint_every=25, halt_on_divergence=True)
    assert ExecutionConfig.from_json(cfg.to_json()) == cfg


def test_request_envelope_roundtrip():
    study = base_study()
    cfg = ExecutionConfig(client_reduction="gather")
    doc = request_to_manifest(study, cfg)
    assert doc["format"] == REQUEST_FORMAT
    back_study, back_cfg = request_from_manifest(
        json.loads(json.dumps(doc)))
    assert back_study.to_manifest() == study.to_manifest()
    assert back_cfg == cfg
    # bare study envelope is also an accepted request
    s2, c2 = request_from_manifest(study.to_manifest())
    assert s2.to_manifest() == study.to_manifest() and c2 is None


# ------------------------------------------------------------ failure paths

def _mangle(study, axis: str, value):
    doc = study.to_manifest()
    for entry in doc["axes"]:
        if entry["axis"] == axis:
            entry["values"] = [encode_value(value)]
    return doc


def test_unknown_scheduler_names_registry():
    with pytest.raises(ValueError, match=r"scheduler registry has.*alg1"):
        Study.from_manifest(_mangle(base_study(), "scheduler", "sgd_magic"))


def test_unknown_arrival_family_names_registry():
    with pytest.raises(ValueError,
                       match=r"arrival-family registry has.*periodic"):
        Study.from_manifest(_mangle(base_study(), "arrivals", "solar"))


def test_unknown_fault_family_names_registry():
    study = base_study(faults="drop")
    with pytest.raises(ValueError, match=r"fault-family registry has.*drop"):
        Study.from_manifest(_mangle(study, "faults", "gamma_ray"))


def test_unknown_taus_profile_names_registry():
    study = base_study(taus_profile="paper")
    with pytest.raises(ValueError,
                       match=r"taus-profile registry has.*paper"):
        Study.from_manifest(_mangle(study, "taus_profile", "lunar"))


def test_unknown_axis_names_axis_registry():
    doc = base_study().to_manifest()
    doc["axes"].append({"axis": "warp_factor", "values": [9]})
    with pytest.raises(ValueError, match=r"unknown sweep axis 'warp_factor'"):
        Study.from_manifest(doc)
    # the error lists the registered axes
    with pytest.raises(ValueError, match=r"scheduler"):
        Study.from_manifest(doc)
    assert "scheduler" in axis_names()


def test_wrong_schema_version_rejected():
    doc = base_study().to_manifest()
    doc["format"] = "study/v2"
    with pytest.raises(ValueError,
                       match=rf"unsupported format 'study/v2'.*{STUDY_FORMAT}"):
        Study.from_manifest(doc)


def test_truncated_json_rejected():
    text = base_study().to_json()
    with pytest.raises(ValueError, match=r"not valid JSON"):
        Study.from_json(text[: len(text) // 2])


def test_unknown_manifest_key_rejected():
    doc = base_study().to_manifest()
    doc["stepz"] = 10
    with pytest.raises(ValueError, match=r"unknown key.*stepz.*valid keys"):
        Study.from_manifest(doc)


def test_empty_axis_values_rejected():
    doc = base_study().to_manifest()
    doc["axes"][0]["values"] = []
    with pytest.raises(ValueError, match=r"empty values"):
        Study.from_manifest(doc)


def test_live_execution_config_fields_not_serializable():
    cfg = ExecutionConfig(eval_fn=lambda p: p)
    with pytest.raises(ValueError, match=r"eval_fn holds a live object"):
        cfg.to_manifest()


def test_execution_config_unknown_key_rejected():
    doc = ExecutionConfig().to_manifest()
    doc["warp"] = 9
    with pytest.raises(ValueError, match=r"unknown key.*warp.*valid keys"):
        ExecutionConfig.from_manifest(doc)
    assert "mesh" not in doc  # live fields never serialize
    assert doc["format"] == EXEC_FORMAT


def test_unserializable_value_names_location():
    with pytest.raises(ValueError, match=r"axis 'taus_profile'"):
        encode_value(lambda n: n, where="axis 'taus_profile'")


def test_tuple_tag_is_reserved():
    with pytest.raises(ValueError, match=r"__tuple__.*reserved"):
        encode_value({"__tuple__": [1]})


def test_codec_tuple_vs_list_distinction():
    v = ("day_night", {"period": 50, "xs": [1, 2]})
    assert decode_value(json.loads(json.dumps(encode_value(v)))) == v
    assert decode_value(encode_value([1, 2])) == [1, 2]


# ------------------------------------------------------- across packages

@pytest.mark.parametrize("axes", [a for _, a in STUDY_CASES],
                         ids=[i for i, _ in STUDY_CASES])
@pytest.mark.parametrize("writer,reader", [(jx, tx), (tx, jx)],
                         ids=["jax->port", "port->jax"])
def test_study_manifest_crosses_packages(writer, reader, axes):
    """A study written by one package loads in the other and re-encodes
    to the same canonical JSON; both resolve the same cells."""
    study = base_study(writer, **axes)
    text = study.to_json(sort_keys=True)
    back = reader.Study.from_json(text)
    assert back.to_json(sort_keys=True) == text
    assert [sc.name for sc in back.resolve()] == \
        [sc.name for sc in study.resolve()]
    doc = reader.request_to_manifest(back)
    study2, config = writer.request_from_manifest(json.loads(json.dumps(doc)))
    assert config is None and _canon(study2.to_manifest()) == \
        _canon(study.to_manifest())


@pytest.mark.parametrize("fields", CONFIG_CASES)
@pytest.mark.parametrize("writer,reader", [(jx, tx), (tx, jx)],
                         ids=["jax->port", "port->jax"])
def test_config_manifest_crosses_packages(writer, reader, fields):
    cfg = writer.ExecutionConfig(**fields)
    text = cfg.to_json(sort_keys=True)
    back = reader.ExecutionConfig.from_json(text)
    assert back.to_json(sort_keys=True) == text
    doc = writer.request_to_manifest(base_study(writer), cfg)
    study, back = reader.request_from_manifest(json.loads(json.dumps(doc)))
    assert _canon(reader.request_to_manifest(study, back)) == _canon(doc)


def _malformed_studies():
    """(id, manifest dict, words the message must name) — built with the
    port; the same dict goes to both packages."""
    def doc_with(**change):
        doc = base_study().to_manifest()
        doc.update(change)
        return doc

    extra_axis = base_study().to_manifest()
    extra_axis["axes"].append({"axis": "warp_factor", "values": [9]})
    empty = base_study().to_manifest()
    empty["axes"][0]["values"] = []
    bad_entry = base_study().to_manifest()
    bad_entry["axes"][0]["colour"] = "red"
    return [
        ("scheduler", _mangle(base_study(), "scheduler", "sgd_magic"),
         "scheduler registry"),
        ("arrivals", _mangle(base_study(), "arrivals", "solar"),
         "arrival-family registry"),
        ("faults", _mangle(base_study(faults="drop"), "faults", "gamma_ray"),
         "fault-family registry"),
        ("taus", _mangle(base_study(taus_profile="paper"), "taus_profile",
                         "lunar"), "taus-profile registry"),
        ("axis", extra_axis, "warp_factor"),
        ("format", doc_with(format="study/v2"), "study/v2"),
        ("key", doc_with(stepz=10), "stepz"),
        ("empty", empty, "empty values"),
        ("entry key", bad_entry, "colour"),
        ("not a dict", ["study"], "JSON object"),
        ("axes type", doc_with(axes={"scheduler": "alg1"}), "'axes'"),
    ]


@pytest.mark.parametrize("doc,words", [(d, w) for _, d, w in
                                        _malformed_studies()],
                         ids=[i for i, _, _ in _malformed_studies()])
def test_malformed_study_refused_alike(doc, words):
    """Both packages refuse the same malformed manifest with the same
    exception type and a message naming the same registry or field."""
    errors = []
    for pkg in (jx, tx):
        with pytest.raises(Exception) as info:
            pkg.Study.from_manifest(json.loads(json.dumps(doc)))
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    for e in errors:
        assert words in str(e), (type(e), str(e))
    assert str(errors[0]) == str(errors[1])


@pytest.mark.parametrize("change,words", [
    ({"warp": 9}, "warp"),
    ({"format": "execution-config/v0"}, "execution-config/v0"),
    ({"mesh": None}, "mesh"),
], ids=["unknown key", "format", "live field"])
def test_malformed_config_refused_alike(change, words):
    errors = []
    for pkg in (jx, tx):
        doc = dict(pkg.ExecutionConfig().to_manifest(), **change)
        with pytest.raises(Exception) as info:
            pkg.ExecutionConfig.from_manifest(doc)
        errors.append(info.value)
    assert type(errors[0]) is type(errors[1])
    for e in errors:
        assert words in str(e)
    assert str(errors[0]) == str(errors[1])


def test_truncated_request_refused_alike():
    text = json.dumps(request_to_manifest(base_study()))
    for pkg in (jx, tx):
        with pytest.raises(ValueError, match=r"not valid JSON"):
            pkg.Study.from_json(text[: len(text) // 2])
