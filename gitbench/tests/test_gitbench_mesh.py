"""The mesh driver (`kinds/caption_tsv_mesh.py`) on two gloo CPU ranks: the
port's `open_mesh_engine` spawns rank 1 as the CLI's `-p` with
`mesh_shape` does.  Its sample, its judge of the rows searched on the other
rank, the exchange between ranks broken, and its deadline."""

import json
import subprocess
import sys
import time

import pytest
import torch

from gitbench import drivers, harness, spec
from gitbench.judge import Served
from gitbench.tests import mesh_faults, tiny

CELL = "coco.tsv.dp4"
SEED = 2 ** 31 + 91


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.tiny_bench(tmp_path_factory.mktemp("tiny_mesh"))


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    import gitax_torch.runtime.engine as engine

    monkeypatch.setattr(engine, "resolve_use_native", lambda use_native: False)


def _run(bench, log=None, **kw):
    b, traffic = bench
    w = spec.cell(b, CELL)
    return harness.run(b, w, SEED, 8.0, 0, "cpu", time.perf_counter(),
                       log.append if log is not None else (lambda m: None),
                       traffic=traffic[w["traffic"]], **kw)


def test_the_cell_is_the_mesh_kind_on_four_cards():
    w = spec.cell(spec.load(), CELL)
    t = spec.traffic(w["traffic"])
    assert w["chips"] == 4 and t["mesh_shape"] == [4, 1] and t["rows_per_rank"] == 32
    assert t["rows"] == 16 * 4 * 32 and t["payloads"] == 256
    assert drivers.driver_class(t["kind"]).__name__ == "Driver"
    assert spec.workload(CELL) == spec.workload("coco.tsv")


def test_the_judge_holds_rank_0s_scores_and_every_ranks_choices(bench):
    log = []
    r = _run(bench, log)
    assert r["correct"], r["checks"]
    judged = log[-1]
    assert "'unscored_rows': 0" not in judged and "'scored_rows': 0" not in judged, judged
    assert r["checks"]["search_gap_nats"]["value"] is not None


def test_the_sample_draws_from_each_data_rank_alike(bench):
    b, traffic = bench
    t = dict(traffic["coco_tsv_dp4"], rows=2048, rows_per_rank=32, mesh_shape=[4, 1])
    d = drivers.make({}, t, SEED, ".")
    served = [Served("p", "", "w " * (i % 13)) for i in range(3 * 2048)]
    chosen = d.pick(served, 32, SEED)
    assert len(chosen) == 32 and chosen == d.pick(served, 32, SEED)
    ranks = [d.data_rank(i) for i in chosen]
    assert all(ranks.count(k) >= 6 for k in range(4)), ranks
    longest = max(range(len(served)), key=lambda i: (len(served[i].text.split()), -i))
    assert longest in chosen


def _rows_back_left_out(monkeypatch):
    """The other ranks' sequences never reach rank 0: zeros in their rows."""
    from gitax_torch.parallel import comm

    inner = comm.gather_rows

    def gather_rows(t, lo, total, group):
        full = inner(t, lo, total, group)
        if lo == 0:
            full[t.shape[0]:] = 0
        return full

    monkeypatch.setattr(comm, "gather_rows", gather_rows)


def test_the_exchange_between_ranks_left_out_reads_not_correct(bench, monkeypatch):
    """(Images sent to the other ranks out of place read nothing at this
    size: the tiny model's captions do not depend on the image.  At the
    cell's size `search_gap_nats` holds each served caption to the
    reference's own search on the right image.)"""
    r = _run(bench, fault=lambda program: _rows_back_left_out(monkeypatch))
    assert not r["correct"], r["checks"]
    assert r["checks"]["unmatched"]["value"] > 0


@pytest.mark.card
def test_followers_searching_other_images_read_not_correct_on_four_cards(monkeypatch):
    """At the cell's own size on four cards, ranks 1-3 search blank images
    in place of the rows rank 0 broadcast (`mesh_faults`).  Rank 0's own
    rows and the fingerprints of its host array are right, so the
    reference's search on the other ranks' sampled rows (`search_gap_nats`)
    is what has to see it."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards: the cell's NCCL ranks, one a card")
    mesh_faults.plant(monkeypatch)
    b = spec.load()
    log = []
    r = harness.run(b, spec.cell(b, CELL), SEED, 10.0, 0, "cuda", time.perf_counter(),
                    log.append)
    print(log[-1][-1500:], r["checks"], file=sys.stderr)
    gap = r["checks"]["search_gap_nats"]
    assert not r["correct"] and gap["value"] > gap["limit"], r["checks"]


def test_a_deadline_stops_the_spawned_ranks_and_ends_the_process(tmp_path):
    code = """
import multiprocessing, sys, time
sys.path.insert(0, {root!r})
from gitbench import spec

def sleeper():
    time.sleep(120)

if __name__ == "__main__":
    mesh = spec.module("kinds/caption_tsv_mesh")
    p = multiprocessing.get_context("spawn").Process(target=sleeper, daemon=True)
    p.start()
    print(p.pid, flush=True)
    with mesh.Deadline("a test's block", 1.0):
        time.sleep(60)
""".format(root=spec.ROOT)
    path = tmp_path / "deadline.py"
    path.write_text(code)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, str(path)], capture_output=True, text=True, timeout=60)
    assert p.returncode == 4 and time.perf_counter() - t0 < 40, p.stderr
    assert "passed its deadline" in p.stderr
    pid = int(p.stdout.split()[0])
    with pytest.raises(OSError):
        import os

        os.kill(pid, 0)


def test_the_tiny_mesh_traffic_fills_whole_batches():
    t = json.loads(json.dumps(tiny.TINY_TRAFFIC["coco_tsv_dp4"]))
    assert t["rows"] % (t["rows_per_rank"] * t["mesh_shape"][0]) == 0
