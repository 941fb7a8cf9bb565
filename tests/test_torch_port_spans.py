"""`runtime/profiling.py`, the port's recorder of spans and counters (CPU,
a tiny model): the span tree and its attributes for one `run_caption_tsv`
and one `run_vqa_tsv` pass, the feeding thread's top-level spans covering
each loop's wall time, real and padded rows equal to the batches', the
recorder switched off (no span, the counters still counting), the ring's
bound, threads that lose no count and no span, the frames an item
(one an image, F a clip) on the spans and the counters, `trace()`'s trace.json
holding the spans of its block on the profiler's clock, and the device
spans' stamps, counters, slot ring and placement on a trace, on stand-ins
for the card."""

import base64
import collections
import contextlib
import ctypes
import dataclasses
import io
import itertools
import json
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.io.tsv import TSVFile, tsv_writer
from gitax_torch.models.config import GitConfig, ViTConfig
from gitax_torch.models.git import GitModel, eos_gate_
from gitax_torch.preprocess.transforms import TestTransform
from gitax_torch.runtime import engine as pt_engine
from gitax_torch.runtime import profiling
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TINY = GitConfig(encoder=ViTConfig(16, 32, 1, 2, 32), visual_feature_size=32, vocab_size=30522,
                 hidden_size=32, num_layers=1, num_heads=2, feedforward_size=64,
                 max_caption_length=48)
WORDS = ["red", "dog", "what", "is", "the", "color", "of", "a", "big"]
# (width, height): 32 px crops, and MinMax grids 2x2, 2x3 and 3x2 at 32/48
SIZES = [(40, 50), (32, 32), (20, 60), (64, 48), (33, 31), (32, 40), (60, 20)]
TOP = {"tsv.pool_wait", "tsv.assemble", "engine.dispatch", "engine.resolve", "tsv.write"}
BATCH = 3


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    m = GitModel(TINY, device="cpu").init_params(torch.Generator().manual_seed(0))
    eos_gate_(m, gate=4)
    return m


def engine(model, **transform):
    return pt_engine.CaptionEngine(model, BertTokenizer(build_tiny_vocab(WORDS)),
                                   batch_size=BATCH,
                                   beam=BeamSearchConfig(num_beams=2, max_steps=6),
                                   dtype=torch.float32, max_text_len=8,
                                   transform=TestTransform(**transform), use_native=False)


def write_tsvs(tmp_path):
    """An image TSV (a corrupt row third) and its question TSV (one to three
    questions of two lengths an image)."""
    rows = []
    for i, (w, h) in enumerate(SIZES):
        img = Image.fromarray(np.random.RandomState(i).randint(0, 255, (h, w, 3), np.uint8))
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        rows.append(["k{}".format(i), base64.b64encode(buf.getvalue())])
    rows.insert(2, ["bad", b"!!!corrupt!!!"])
    questions = ["what is the color of the dog", "red"]
    qrows = [[k, json.dumps([{"question": questions[(i + j) % 2], "question_id": 10 * i + j}
                             for j in range(1 + i % 3)])] for i, (k, _) in enumerate(rows)]
    img_tsv, q_tsv = str(tmp_path / "img.tsv"), str(tmp_path / "q.tsv")
    tsv_writer(rows, img_tsv)
    tsv_writer(qrows, q_tsv)
    return img_tsv, q_tsv


def run_pass(fn):
    """fn() with the recorder cleared first: (records, host ns, counters'
    change)."""
    profiling.clear()
    c0 = profiling.counters()
    t0 = profiling._perf_ns()
    fn()
    t1 = profiling._perf_ns()
    c1 = profiling.counters()
    return profiling.spans(), (t0, t1), {k: c1[k] - c0[k] for k in c0}


def tree(records):
    by_id = {r.id: r for r in records}
    kids = collections.defaultdict(list)
    for r in records:
        kids[r.parent].append(r)
    return by_id, kids


def check_loop(records, window, counts, loop_rows):
    """What both loops share: the feeding thread's top-level spans (each of
    the five kinds, nothing else, covering 95% of the pass), the device
    batches' children and attributes, the chunks' ids, real and padded
    rows."""
    by_id, kids = tree(records)
    feed = threading.get_ident()
    top = [r for r in records if r.parent is None and r.thread == feed]
    assert {r.name for r in top} == TOP
    covered = sum(r.t1 - r.t0 for r in top)
    assert covered >= 0.95 * (window[1] - window[0]), (covered, window)
    # top-level spans of one thread do not overlap
    spans = sorted((r.t0, r.t1) for r in top)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))

    batches = [r for r in records if r.name == "engine.device_batch"]
    assert batches
    for b in batches:
        assert by_id[b.parent].name == "engine.dispatch"
        assert b.batch == b.id and b.attrs["rows"] == BATCH and 1 <= b.attrs["real"] <= BATCH
        names = [k.name for k in kids[b.id]]
        # float batches from the transform: cast on the host, then one upload
        assert names[:2] == ["engine.host_cast", "engine.upload"], names
        assert kids[b.id][1].attrs["bytes"] > 0
        # under generate: the encoder, then the prefill, each with its tokens
        model_spans = [r for r in records if r.batch == b.id and r.name.startswith("model.")]
        assert [r.name for r in model_spans] == ["model.encode", "model.prefill"]
        gy, gx = b.attrs["grid"]
        assert model_spans[0].attrs["tokens"] == gy * gx + 1
        assert model_spans[1].attrs["tokens"] == gy * gx + 1 + b.attrs["prefix"]
        # a CPU tensor: host times only
        assert all(r.device is None for r in model_spans)
    stacks = [r for r in records if r.name == "engine.stack"]
    assert sum(s.attrs["rows"] for s in stacks) == sum(b.attrs["rows"] for b in batches)
    real = sum(b.attrs["real"] for b in batches)
    assert real == sum(s.attrs["real"] for s in stacks) == loop_rows
    assert counts["rows"] == len(batches) * BATCH and counts["real_rows"] == real

    for r in (r for r in records if r.name == "engine.resolve"):
        assert {k.name for k in kids[r.id]} == {"engine.to_host", "engine.detokenize"}
    waits = {r.attrs["chunk"] for r in records if r.name == "tsv.pool_wait"}
    chunks = [r for r in records if r.name == "decode.chunk"]
    assert waits == {r.attrs["chunk"] for r in chunks}
    assert all(r.thread != feed and r.parent is None for r in chunks)
    assert sum(r.attrs["rows"] for r in chunks) == len(SIZES) + 1
    return batches


def test_caption_pass_span_tree(model, tmp_path):
    img_tsv, _ = write_tsvs(tmp_path)
    with engine(model, crop_size=32) as eng:
        records, window, counts = run_pass(
            lambda: eng.run_caption_tsv(img_tsv, str(tmp_path / "out.tsv")))
    batches = check_loop(records, window, counts, len(SIZES))
    # one grid at the fixed crop, [CLS] prefixes; the tail batch padded
    assert {b.attrs["grid"] for b in batches} == {(2, 2)}
    assert {b.attrs["prefix"] for b in batches} == {1}
    assert sorted(b.attrs["real"] for b in batches) == [2, 2, 3]  # the corrupt row is dropped
    written = [r for r in records if r.name == "tsv.write"]
    assert sum(r.attrs["rows"] for r in written) == len(TSVFile(str(tmp_path / "out.tsv")))


def test_vqa_pass_span_tree(model, tmp_path):
    img_tsv, q_tsv = write_tsvs(tmp_path)
    with engine(model, crop_size=32, respect_ratio_max=48) as eng:
        records, window, counts = run_pass(
            lambda: eng.run_vqa_tsv(img_tsv, q_tsv, str(tmp_path / "out.tsv")))
    pairs = sum(1 + i % 3 for i in range(len(SIZES) + 1)) - 3  # the corrupt row's 3
    batches = check_loop(records, window, counts, pairs)
    # MinMax grids, two prefix lengths, each bucket split by grid
    assert len({b.attrs["grid"] for b in batches}) > 1
    assert len({b.attrs["prefix"] for b in batches}) == 2
    assert [r.attrs["rows"] for r in records if r.name == "tsv.write"] == [pairs]


def test_off_records_no_span_and_still_counts(model, tmp_path, monkeypatch):
    assert not profiling.enabled_by({"GITAX_TORCH_SPANS": "0"})
    assert profiling.enabled_by({}) and profiling.enabled_by({"GITAX_TORCH_SPANS": "1"})
    img_tsv, _ = write_tsvs(tmp_path)
    monkeypatch.setattr(profiling, "ON", False)
    with engine(model, crop_size=32) as eng:
        records, _, counts = run_pass(
            lambda: eng.run_caption_tsv(img_tsv, str(tmp_path / "out.tsv")))
    assert records == [] and counts["records"] == 0
    assert counts["rows"] == 3 * BATCH and counts["real_rows"] == len(SIZES)
    with profiling.span("x", device=True, a=1) as s:
        s.set(b=2)
        s.counter("steps", torch.zeros((), dtype=torch.int64))
    profiling.mark("y")
    assert profiling.spans() == []


@pytest.mark.parametrize("loop", ["caption", "vqa"])
def test_image_passes_carry_one_frame(model, tmp_path, loop):
    """The image loops' spans and counters count one frame an image:
    `frames` on `decode.chunk` (its rows), `engine.device_batch` and
    `model.encode` (1), `images` on `model.encode` (the batch's rows), and
    the `frames` counter equal to the rows dispatched."""
    img_tsv, q_tsv = write_tsvs(tmp_path)
    out = str(tmp_path / "out.tsv")
    if loop == "caption":
        with engine(model, crop_size=32) as eng:
            records, _, counts = run_pass(lambda: eng.run_caption_tsv(img_tsv, out))
    else:
        with engine(model, crop_size=32, respect_ratio_max=48) as eng:
            records, _, counts = run_pass(lambda: eng.run_vqa_tsv(img_tsv, q_tsv, out))
    chunks = [r for r in records if r.name == "decode.chunk"]
    assert chunks and all(r.attrs["frames"] == r.attrs["rows"] for r in chunks)
    batches = [r for r in records if r.name == "engine.device_batch"]
    assert batches and all(b.attrs["frames"] == 1 for b in batches)
    encodes = [r for r in records if r.name == "model.encode"]
    assert len(encodes) == len(batches)
    assert all(e.attrs["frames"] == 1 and e.attrs["images"] == BATCH for e in encodes)
    assert counts["frames"] == counts["rows"] == len(batches) * BATCH


def test_a_clip_pass_carries_its_frames(tmp_path):
    """A video model's caption pass (2 frames a clip, 32 px): `frames` on
    `decode.chunk` (the frames of its clips), on `engine.device_batch` and
    `model.encode` (2), `images` on `model.encode` (rows x 2), the memory's
    `tokens` 2 x S, and the `frames` counter 2 a row dispatched."""
    cfg = dataclasses.replace(TINY, num_image_with_embedding=2)
    m = GitModel(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))
    eos_gate_(m, gate=4)
    rows = []
    for i in range(4):
        frames = []
        for j in range(2):
            buf = io.BytesIO()
            Image.fromarray(np.random.RandomState(10 * i + j).randint(0, 255, (40, 36, 3),
                                                                      np.uint8)).save(buf, "PNG")
            frames.append(base64.b64encode(buf.getvalue()).decode("ascii"))
        rows.append(["c{}".format(i), json.dumps(frames)])
    path = str(tmp_path / "clips.tsv")
    tsv_writer(rows, path)
    with engine(m, crop_size=32) as eng:
        records, _, counts = run_pass(lambda: eng.run_caption_tsv(path, str(tmp_path / "o.tsv")))
    chunks = [r for r in records if r.name == "decode.chunk"]
    assert sum(r.attrs["rows"] for r in chunks) == 4
    assert all(r.attrs["frames"] == 2 * r.attrs["rows"] for r in chunks)
    batches = [r for r in records if r.name == "engine.device_batch"]
    assert [(b.attrs["frames"], b.attrs["real"]) for b in batches] == [(2, 3), (2, 1)]
    encodes = [r for r in records if r.name == "model.encode"]
    assert [(e.attrs["frames"], e.attrs["images"], e.attrs["tokens"]) for e in encodes] \
        == [(2, 2 * BATCH, 2 * 5)] * 2
    assert counts["frames"] == 2 * counts["rows"] == 2 * 2 * BATCH


def test_the_ring_is_bounded():
    profiling.clear()
    c0 = profiling.counters()
    for i in range(profiling.RING + 10):
        with profiling.span("s", i=i):
            pass
    records = profiling.spans()
    assert len(records) == profiling.RING
    assert records[0].attrs["i"] == 10 and records[-1].attrs["i"] == profiling.RING + 9
    c1 = profiling.counters()
    assert c1["records"] - c0["records"] == profiling.RING + 10 and c1["dropped"] >= 10
    profiling.clear()


def test_threads_lose_no_count_and_no_span(monkeypatch):
    """Eight threads counting and nesting spans at once, the interpreter
    switching threads every microsecond: every count and every span is
    there, each span's parent on its own thread."""
    import sys

    profiling.clear()
    c0 = profiling.counters()["rows"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(2000):
            with profiling.span("outer"):
                profiling.count(rows=1)
                with profiling.span("inner"):
                    pass

    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert profiling.counters()["rows"] - c0 == 8 * 2000
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    inner = [r for r in records if r.name == "inner"]
    assert len(inner) == len(records) // 2 == 8 * 2000
    assert all(by_id[r.parent].name == "outer" and by_id[r.parent].thread == r.thread
               for r in inner)
    profiling.clear()


def test_trace_holds_the_spans_of_its_block(tmp_path):
    with profiling.span("before"):
        pass
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("outer", rows=4):
            with profiling.span("inner"):
                torch.ones(64, 64) @ torch.ones(64, 64)
        profiling.mark("instant")
    events = json.load(open(str(tmp_path / "t" / "trace.json")))["traceEvents"]
    mine = {e["name"]: e for e in events if e.get("pid") == profiling.TRACK_PID
            and e.get("ph") in ("X", "i")}
    assert set(mine) == {"outer", "inner", "instant"}
    assert mine["outer"]["args"]["rows"] == 4
    assert mine["inner"]["args"]["parent"] == mine["outer"]["args"]["id"]
    assert any(e.get("ph") == "M" and e["args"].get("name") == "gitax_torch" for e in events)
    # on the profiler's clock: the matmul the span encloses lies inside it
    mm = [e for e in events if e.get("name") == "aten::mm"]
    inner = mine["inner"]
    assert mm and all(inner["ts"] <= e["ts"] and e["ts"] + e["dur"] <= inner["ts"] + inner["dur"]
                      for e in mm)


class FakeStamps(object):
    """The stamp kernel on a hand-moved global timer (ns): a stamp writes the
    timer, the counter's value where it is given one, and its number into
    its slot, at once or, while `held`, when the card is synchronized."""

    def __init__(self):
        self.clock, self.held, self.queue = 10 ** 12, False, []

    def launch(self, stream, seq, counter):
        value = ctypes.c_int64.from_address(counter).value if counter else None
        self.queue.append((seq, self.clock, value))
        if not self.held:
            self.land()
        return 0

    def land(self):
        for seq, t, value in self.queue:
            at = 4 * (seq % profiling.SLOTS)
            profiling._slots[at] = t
            if value is not None:
                profiling._slots[at + 1] = value % 2 ** 64
            profiling._slots[at + 2] = seq
        self.queue = []


@pytest.fixture
def fake_card(monkeypatch):
    """The device side of the recorder on stand-ins, with 4 slots so that
    the ring comes round; `synchronize` lands the held stamps."""
    card = FakeStamps()
    slots = [0] * 16
    monkeypatch.setattr(torch.cuda, "synchronize", card.land)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    for name, value in (("_lib", object()), ("_launch", card.launch), ("_slots", slots),
                        ("SLOTS", 4), ("_owner", [None] * 4), ("_seq", itertools.count(1)),
                        ("_pending", {}), ("_raw_stream", lambda dev: 0),
                        ("_device", lambda: 0), ("_capturing", lambda: False)):
        monkeypatch.setattr(profiling, name, value)
    profiling.clear()
    yield card
    profiling.clear()


def searches(card, steps_list):
    """A device span a search, as device_loop's launch makes it: 1 ms in,
    the search's steps added, 2 ms a step, then 10 ms to the next."""
    steps = torch.zeros((), dtype=torch.int64)
    last = None
    for n in steps_list:
        with profiling.span("search.launch", device=True) as s:
            card.clock += 1_000_000
            steps += n
            s.counter("steps", steps, last)
            card.clock += 2_000_000 * n
        last = s
        card.clock += 10_000_000


def test_device_spans_read_the_global_timer_and_count_steps(fake_card):
    """Device spans read their stamps (ms on the global timer); a counter's
    copy less the last one's is each span's steps; `spans()` waits for the
    card where the stamps have not landed."""
    fake_card.held = True
    searches(fake_card, (3, 5))
    assert len(profiling._pending) == 2
    records = [r for r in profiling.spans() if r.name == "search.launch"]
    assert [r.attrs["steps"] for r in records] == [3, 5]
    assert [r.device_ms for r in records] == [7.0, 11.0]
    assert [r.device[0] - 1e6 for r in records] == [0.0, 17.0]
    assert [r.stamps for r in records] == [(1, 2), (3, 4)]
    assert profiling.counters()["lost"] == 0


def test_the_stamp_ring_comes_round_without_waiting(fake_card, monkeypatch):
    """Many device spans and no `spans()` call, a card that must not be
    waited for: where the ring of 4 slots comes round to a span not read
    yet, the span is read from its landed stamps; a span whose stamps have
    not landed by then loses its device times, counted, and nothing
    waits."""
    def refuse():
        raise AssertionError("the recorder waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    lost0 = profiling.counters()["lost"]
    searches(fake_card, range(1, 41))
    # the last span is read by spans() from its landed stamps, with no wait
    records = [r for r in profiling.spans() if r.name == "search.launch"]
    assert [r.attrs["steps"] for r in records] == list(range(1, 41))
    assert [r.device_ms for r in records] == [1.0 + 2 * n for n in range(1, 41)]
    assert profiling.counters()["lost"] == lost0 and not profiling._pending
    # chained pairs, three stamps each: the shared stamp's slot is read
    # with the second span, after the first
    profiling.clear()
    for n in range(1, 21):
        with profiling.span("model.encode", device=True):
            fake_card.clock += n * 1_000_000
        with profiling.span("model.prefill", device=True, chain=True):
            fake_card.clock += 500_000
    records = profiling.spans()
    assert [r.device_ms for r in records if r.name == "model.encode"] == [
        float(n) for n in range(1, 21)]
    assert [r.device_ms for r in records if r.name == "model.prefill"] == [0.5] * 20
    assert all(p.stamps[0] == e.stamps[1] for e, p in zip(records[::2], records[1::2]))
    assert profiling.counters()["lost"] == lost0 and not profiling._pending

    fake_card.held = True
    searches(fake_card, (1, 1, 1))  # the third's stamps reuse the first's slots
    assert profiling.counters()["lost"] == lost0 + 1 and len(profiling._pending) == 2
    monkeypatch.setattr(torch.cuda, "synchronize", fake_card.land)
    records = [r for r in profiling.spans() if r.name == "search.launch"][-3:]
    assert [r.device_ms for r in records] == [None, 3.0, 3.0]
    # the first's count is lost with it, so the second has no steps to give
    assert [r.attrs.get("steps") for r in records] == [None, None, 1]


def test_device_spans_off_under_capture(fake_card, monkeypatch):
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    with profiling.span("model.encode", device=True) as s:
        s.counter("steps", torch.zeros((), dtype=torch.int64))
    (r,) = profiling.spans()
    assert r.device is None and r.stamps is None and "steps" not in r.attrs and r.t1 >= r.t0


def test_device_spans_placed_by_their_stamp_kernels(fake_card):
    """`paired` matches the device spans' stamps, in the order they were
    launched, to a trace's stamp kernels in theirs; none where a kernel
    record is missing; `trace_events` puts each placed span on the device
    row from its start kernel's start to its end kernel's end."""
    with profiling.span("engine.device_batch"):
        with profiling.span("model.encode", device=True):
            fake_card.clock += 4_000_000
        with profiling.span("model.prefill", device=True, chain=True):
            fake_card.clock += 1_000_000
        with profiling.span("search.launch", device=True):
            fake_card.clock += 2_000_000
    records = profiling.spans()
    by_name = {r.name: r for r in records}
    assert [by_name[n].stamps for n in ("model.encode", "model.prefill", "search.launch")] == [
        (1, 2), (2, 3), (4, 5)]
    kernels = [{"ts": 100.0 + 10 * i, "dur": 2.0} for i in range(5)]
    pairs = profiling.paired(records, kernels)
    assert pairs == {by_name["model.encode"].id: (kernels[0], kernels[1]),
                     by_name["model.prefill"].id: (kernels[1], kernels[2]),
                     by_name["search.launch"].id: (kernels[3], kernels[4])}
    assert profiling.paired(records, kernels[1:]) is None
    placed = {i: (a["ts"], b["ts"] + b["dur"]) for i, (a, b) in pairs.items()}
    events = profiling.trace_events(records, 0, 0, placed)
    dev = {e["name"]: e for e in events if e.get("cat") == "gitax_torch_device"}
    assert set(dev) == {"model.encode", "model.prefill", "search.launch"}
    assert (dev["model.encode"]["ts"], dev["model.encode"]["dur"]) == (100.0, 12.0)
    assert (dev["model.prefill"]["ts"], dev["model.prefill"]["dur"]) == (110.0, 12.0)
    assert by_name["model.prefill"].device_ms == 1.0
