"""BENCHMARK.json against the contract, and every piece it names found by
name: configurations, traffic, correctness limits, metric readers."""

import os
import re

import pytest

from gitbench import drivers, spec, weights

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gitbench/run.py"]
    assert BENCH["paths"] == ["gitbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_are_named_and_short(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_metrics_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for c in m["workloads"]:
            assert c in cells and spec.reports(e2e[m["moves"]], c, BENCH), (m["name"], c)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        names = {m["name"] for m in spec.metrics(BENCH, c, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics(BENCH, c, "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    w = spec.cell(BENCH, cell)
    assert w["chips"] in (1, 4)
    cfg = spec.config(BENCH, w["config"])
    traffic = spec.traffic(w["traffic"])
    limits = spec.workload(cell)
    assert callable(drivers.driver_class(traffic["kind"]))
    assert {"unmatched", "missing", "score_gap_bf16"} <= set(limits["limits"]) \
        <= {"unmatched", "missing", "score_gap_bf16", "search_gap_nats"}
    assert cfg["assumed"]["eos_gate"] > 0
    for kind in ("end_to_end", "per_layer"):
        for m in spec.metrics(BENCH, cell, kind):
            assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configs_hold_the_port_zoo_widths(name):
    from gitax_torch.models.git import GitModel

    from gitbench.program import port_config

    c = [c for c in BENCH["configs"] if c["name"] == name][0]
    assert c["file"].startswith("gitbench/") and c["reduced"] == []
    cfg = spec.config(BENCH, name)
    model = GitModel(port_config(cfg), device="meta")
    names = [n for n, _, _ in weights.param_specs(cfg)] + ["textual.output.weight"]
    assert sorted(names) == sorted(model.state_dict())
    shapes = {n: s for n, s, _ in weights.param_specs(cfg)}
    for n, t in model.state_dict().items():
        if n in shapes:
            assert tuple(t.shape) == tuple(shapes[n]), n


def test_every_metric_named_has_its_reader_file():
    names = {m["name"] for m in BENCH["per_layer"] + BENCH["end_to_end"]}
    files = {f[:-3] for f in os.listdir(os.path.join(spec.HERE, "metrics")) if f.endswith(".py")}
    assert names <= files
