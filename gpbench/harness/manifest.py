"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); its limits are ``limits/<cell>.json``.  A
traffic file names the generator that runs it (``mixes/<generator>.py``,
whose ``Mix`` sets up, runs the window, gives the end-to-end values by
metric name and judges what it computed); a configuration names its
plain reference (``reference/<reference>.py``) and its objective's counts
(``counts/<flops>.py``); a per-layer metric is read by
``layer_metrics/<metric>.py``.  Nothing else in the harness names a cell,
a configuration, a mix or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(*parts):
    """A module of the benchmark by file path (metric names hold dots)."""
    path = os.path.join(HERE, *parts)
    spec = importlib.util.spec_from_file_location(
        "gpbench_" + "_".join(parts).replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    def __init__(self, root: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    @staticmethod
    def config(cell: dict) -> dict:
        return _json("configs", cell["config"] + ".json")

    @staticmethod
    def traffic(cell: dict) -> dict:
        return _json("traffic", cell["traffic"] + ".json")

    @staticmethod
    def mix(traffic: dict):
        """The generator class that runs the traffic."""
        return load_module("mixes", traffic["generator"] + ".py").Mix

    @staticmethod
    def limits(cell: dict) -> dict:
        return _json("limits", cell["name"] + ".json")["limits"]

    def end_to_end(self, cell: dict) -> list:
        return [m for m in self.data["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict) -> list:
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose end-to-end metric it reports."""
        own = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in own)]

    @staticmethod
    def reader(metric: dict):
        return load_module("layer_metrics", metric["name"] + ".py").read

    @staticmethod
    def flops(config: dict):
        return load_module("counts", config["flops"] + ".py").flops
