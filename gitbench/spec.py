"""Finds the benchmark's pieces by name: a cell in BENCHMARK.json, its
configuration file, its traffic file (`traffic/<traffic>.json`), its
correctness limits (`workloads/<cell>.json`) and each metric's reader
(`metrics/<metric>.py`, a `read(ctx)` that returns a number, or None when it
finds nothing to read), a traffic kind's driver missing from
`drivers.KINDS` (`kinds/<kind>.py`, its `Driver`) and a configuration's
reference (the module its optional `reference` key names, `reference.py`
by default).  A new cell, traffic mix, kind, reference or metric is new
files and new entries, never an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

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


def reader(name):
    """metrics/<name>.py's `read`."""
    return module("metrics/" + name).read


MODULE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*(/[A-Za-z0-9_][A-Za-z0-9_.-]*)*$")
_MODULES = {}


def module(rel):
    """The module file `<rel>.py` under gitbench/ (`rel` a relative path
    with `/`, e.g. 'kinds/caption_tsv_mesh'), loaded once by its path."""
    if not MODULE.match(rel):  # each part starts with a letter, digit or _: no '..', no '/x'
        raise ValueError("{!r} does not name a module file under gitbench/".format(rel))
    if rel not in _MODULES:
        path = os.path.join(HERE, *rel.split("/")) + ".py"
        if not os.path.isfile(path):
            raise FileNotFoundError("no module file gitbench/{}.py".format(rel))
        mod_spec = importlib.util.spec_from_file_location(
            "gitbench_file_" + re.sub(r"[^A-Za-z0-9_]", "_", rel), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _MODULES[rel] = mod
    return _MODULES[rel]


def reference(cfg):
    """The plain reference module a configuration names (`reference`, a
    module file under gitbench/; default `reference.py`): its `Reference`
    and `pixels` judge the configuration's outputs."""
    rel = cfg.get("reference", "reference")
    if rel == "reference":
        return importlib.import_module("gitbench.reference")
    return module(rel)
