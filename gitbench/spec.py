"""Finds the benchmark's pieces by name: a cell in BENCHMARK.json, its
configuration file, its traffic file (`traffic/<traffic>.json`), its
correctness limits (`workloads/<cell>.json`) and each metric's reader
(`metrics/<metric>.py`, a `read(ctx)` that returns a number, or None when it
finds nothing to read).  A new cell, traffic mix or metric is new files and
new entries, never an edit."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload {!r} in BENCHMARK.json (there are: {})".format(
        name, ", ".join(w["name"] for w in bench["workloads"])))


def config(bench, name, root=ROOT):
    for c in bench["configs"]:
        if c["name"] == name:
            return read_json(os.path.join(root, c["file"]))
    raise KeyError("no config {!r} in BENCHMARK.json".format(name))


def traffic(name):
    return read_json(os.path.join(HERE, "traffic", name + ".json"))


def workload(name):
    return read_json(os.path.join(HERE, "workloads", name + ".json"))


def reports(metric, cell_name, bench):
    """Whether a cell reports a metric: listed in its `workloads`, or, with
    no such key, whenever the cell reports the end-to-end metric it moves
    (every cell, for an end-to-end metric without the key)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        for m in bench["end_to_end"]:
            if m["name"] == metric["moves"]:
                return reports(m, cell_name, bench)
        return False
    return True


def metrics(bench, cell_name, kind):
    """The cell's metrics of `kind` ('end_to_end' or 'per_layer')."""
    return [m for m in bench[kind] if reports(m, cell_name, bench)]


_READERS = {}


def reader(name):
    """metrics/<name>.py's `read`."""
    if name not in _READERS:
        path = os.path.join(HERE, "metrics", name + ".py")
        mod_spec = importlib.util.spec_from_file_location(
            "gitbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _READERS[name] = mod.read
    return _READERS[name]
