"""Whole runs of each cell on the CPU at a tiny size (the same harness, the
port's plain kernel versions and eager search), the control, planted faults,
and what a run may import; and, marked `card`, one short run of each cell on
a CUDA card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

import dataclasses

from gitbench import harness, judge, spec
from gitbench.tests import tiny

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.load()["workloads"]]
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    # where libjpeg's headers are installed the native loader builds; the
    # H100's machine has none and decodes with PIL, as the reference does
    import gitax_torch.runtime.engine as engine

    monkeypatch.setattr(engine, "resolve_use_native", lambda use_native: False)


def _run(bench, cell, **kw):
    b, traffic = bench
    w = spec.cell(b, cell)
    # a mesh's CPU ranks take ~0.5-1 s a tiny batch: a window holding whole passes
    seconds = 2.0 if w["chips"] == 1 else 8.0
    return harness.run(b, w, SEED, seconds, 0, "cpu", time.perf_counter(), lambda m: None,
                       traffic=traffic[w["traffic"]], **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_reports_its_metrics(bench, cell):
    r = _run(bench, cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["failed"] == 0 and r["attempted"] > 0
    names = {m["name"] for m in spec.metrics(bench[0], cell, "end_to_end")}
    assert set(r["metrics"]) == names
    assert all(v["value"] > 0 for v in r["metrics"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_above_the_program(bench, cell):
    r = _run(bench, cell, control=True)
    c = r["checks"]
    assert c["control_score_gap_bf16"]["value"] > 3 * c["score_gap_bf16"]["value"]
    assert r["correct"] and not judge.control_passed(c), c


def _token_altered(program):
    """A token altered where the search produces it: the first word of every
    row the search returns."""
    model = program.model
    gen = model.generate

    def generate(*a, **kw):
        seqs, scores = gen(*a, **kw)
        seqs = seqs.clone()
        seqs[:, 0] = torch.where(seqs[:, 0] == 104, 105, 104)
        return seqs, scores

    model.generate = generate


def _answer_altered(program):
    """An answer altered after its tokens: the detokeniser adds a word."""
    tok = program.engine.tokenizer
    decode = tok.decode

    def decode_(ids, **kw):
        return decode(ids, **kw) + " beco"

    tok.decode = decode_


def _fewer_beams(program):
    """The search falls back to one beam (greedy with its scores right)."""
    eng = program.engine
    eng.beam = dataclasses.replace(eng.beam, num_beams=1)


def _top_k_loses_the_best(program, monkeypatch):
    """A top-k that keeps each beam's candidates from its second best on:
    every token scored right, the best never chosen."""
    from gitax_torch.decode import beam

    inner = beam._top_k_blocked

    def top_k(x, k, **kw):
        vals, idx = inner(x, k + 1, **kw)
        return vals[..., 1:], idx[..., 1:]

    monkeypatch.setattr(beam, "_top_k_blocked", top_k)


# one-card cells: planted in this process, a search fault reaches only a mesh's rank 0 rows
# (test_gitbench_mesh.py breaks the mesh's own exchange)
SEARCHED = [c for c in CELLS if "search_gap_nats" in spec.workload(c)["limits"]
            and spec.cell(spec.load(), c)["chips"] == 1]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_token_altered, _answer_altered])
def test_a_planted_fault_reads_not_correct(bench, cell, fault):
    r = _run(bench, cell, fault=fault)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", SEARCHED)
@pytest.mark.parametrize("fault", [_fewer_beams, _top_k_loses_the_best])
def test_a_search_fault_reads_not_correct_by_its_choices(bench, cell, fault, monkeypatch):
    """Faults whose scores are right: only the search's choices read them."""
    plant = fault
    if fault is _top_k_loses_the_best:
        def plant(program):
            fault(program, monkeypatch)
    r = _run(bench, cell, fault=plant)
    c = r["checks"]
    assert c["score_gap_bf16"]["value"] <= c["score_gap_bf16"]["limit"], c
    assert c["search_gap_nats"]["value"] > c["search_gap_nats"]["limit"], c
    assert not r["correct"], c


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, {!r}); import gitbench.reference, gitbench.vocab, "
            "gitbench.weights, gitbench.traffic, gitbench.peaks; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"jax", "jaxlib", "flax", "gitax", "gitax_torch"}
    from gitbench import run

    assert "gitax_torch" not in run.FORBIDDEN
    sys.modules["jax"] = sys.modules.get("jax") or type(sys)("jax")
    try:
        assert run.forbidden_modules() == ["jax"] or "jax" in run.forbidden_modules()
    finally:
        if isinstance(sys.modules.get("jax"), type(sys)) and not hasattr(sys.modules["jax"],
                                                                         "__file__"):
            del sys.modules["jax"]


def test_the_sources_import_neither_jax_nor_gitax():
    import ast

    for dirpath, _, files in os.walk(spec.HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                    names = [node.module]
                for n in names:
                    top = n.split(".")[0]
                    assert top not in ("jax", "jaxlib", "flax", "gitax"), (f, n)
                    if f == "reference.py":
                        assert top != "gitax_torch", n


def test_run_refuses_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "gitbench/run.py", "--workload", "coco.tsv", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in spec.load()["workloads"]])
def test_a_short_run_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "gitbench/run.py", "--workload", cell, "--seed",
                        str(SEED), "--seconds", "5", "--trace", "1"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
