"""BENCHMARK.json keeps the contract's shape, and every file a cell, a
configuration or a metric names is found by its name."""

import importlib
import json
import os
import re

import pytest

from harness.manifest import HERE, Manifest, load_module

from small import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return Manifest(ROOT)


def test_top_level_keys(manifest):
    d = manifest.data
    assert set(d) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert d["command"] == ["python3", "gpbench/run.py"]
    assert d["paths"] == ["gpbench"]
    assert isinstance(d["run_seconds"], int) and 1 <= d["run_seconds"] <= 51
    assert len(json.dumps(d)) < 64 * 1024


def test_names_units_and_entries(manifest):
    d = manifest.data
    for c in d["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("gpbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] \
            == c["name"]
    for w in d["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in d["end_to_end"] + d["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in d["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    ends = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in ends


@pytest.mark.parametrize("workload", ["exact_edr"])
def test_cell_files_found_by_name(manifest, workload):
    cell = manifest.cell(workload)
    config = manifest.config(cell)
    assert config["name"] == cell["config"]
    traffic = manifest.traffic(cell)
    assert traffic["name"] == cell["traffic"]
    mix = manifest.mix(traffic)
    assert all(callable(getattr(mix, f)) for f in (
        "setup", "window", "end_to_end", "summary", "release", "judge"))
    reference = importlib.import_module("reference." + config["reference"])
    assert all(callable(getattr(reference, f)) for f in (
        "objective", "mean_diag", "factored", "coef", "centres"))
    limits = manifest.limits(cell)
    assert "grad" in limits and all(v > 0 for v in limits.values())
    assert callable(manifest.flops(config))
    per_layer = manifest.per_layer(cell)
    assert per_layer, "every cell reports a per-layer metric"
    for m in per_layer:
        assert callable(manifest.reader(m))
    names = {m["name"] for m in manifest.end_to_end(cell)}
    assert "setup_s" in names and len(names) >= 2


def test_every_reader_has_a_metric(manifest):
    listed = {m["name"] for m in manifest.data["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(HERE, "layer_metrics"))
             if f.endswith(".py")}
    assert files == listed
    for name in files:
        assert callable(load_module("layer_metrics", name + ".py").read)
