"""BENCHMARK.json against the contract's form: names, units, lengths, and
that the harness finds every file a cell names."""

import re

import pytest

import harness
from helpers import SPEC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _names():
    out = [("config", c["name"]) for c in SPEC["configs"]]
    out += [("workload", w["name"]) for w in SPEC["workloads"]]
    out += [("config of", w["config"]) for w in SPEC["workloads"]]
    out += [("traffic", w["traffic"]) for w in SPEC["workloads"]]
    out += [("metric", m["name"]) for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    out += [("reduced", k) for c in SPEC["configs"] for k in c["reduced"]]
    return out


@pytest.mark.parametrize("kind,name", _names())
def test_name_is_allowed(kind, name):
    assert NAME.match(name), (kind, name)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_form(metric):
    assert UNIT.match(metric["unit"]), metric
    assert metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells


def test_unique_names_and_shape():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_is_found(workload):
    cell = harness.Cell(SPEC, workload)
    assert hasattr(cell.driver_mod, "Driver")
    assert "pcm_err" in cell.limits
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]).read)
