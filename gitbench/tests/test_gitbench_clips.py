"""The cell `vatex.clips` on the CPU at a tiny size (the same harness, driver
`kinds/caption_clips_tsv.py` and reference `reference_clips.py`): a run
reads correct; planted faults of the clip path read not correct (the
temporal embeddings dropped, frame 0 in every frame's place); a program
that reads a clip's row as one image fails the warm-up; and the three
readers the cell adds (`decode.chunk_ms_per_frame`, `model.encode_roofline`,
`flash_prefill_roofline`) on hand-made records, each None where it has
nothing to read."""

import json
import time
import types

import numpy as np
import pytest
import torch

from gitbench import harness, peaks, spec, weights
from gitbench import reference_clips as RC
from gitbench.tests import tiny
from gitbench.tests.test_gitbench_program_spans import Rec, ctx_of, read

CELL = "vatex.clips"
SEED = 2 ** 31 + 91
# 8 clips of 6 frames, each twice: 4 tiny device batches a pass
TRAFFIC = dict(clips=8, rows=16)


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.tiny_bench(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    import gitax_torch.runtime.engine as engine

    monkeypatch.setattr(engine, "resolve_use_native", lambda use_native: False)


def _run(bench, **kw):
    b, traffic = bench
    w = spec.cell(b, CELL)
    return harness.run(b, w, SEED, 2.0, 0, "cpu", time.perf_counter(), lambda m: None,
                       traffic=dict(traffic[w["traffic"]], **TRAFFIC), **kw)


def test_the_tiny_clip_cell_reads_correct_on_six_frame_batches(bench):
    seen = []

    def spy(program):
        inner = program.engine.dispatch_device_batch

        def dispatch(imgs, pref, **kw):
            seen.append(np.shape(imgs))
            return inner(imgs, pref, **kw)

        program.engine.dispatch_device_batch = dispatch

    r = _run(bench, fault=spy)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0, r["checks"]
    assert set(r["metrics"]) == {"items_per_s", "setup_s"}
    assert seen and {s[1:] for s in seen} == {(6, 28, 28, 3)}
    cfg = spec.config(bench[0], "git_large_vatex")
    assert cfg["num_image_with_embedding"] == 6 and spec.reference(cfg).__file__ == RC.__file__
    json.dumps(r)


def _no_embeddings(program):
    with torch.no_grad():
        for p in program.model.img_temperal_embedding:
            p.zero_()


def _frame_0_repeated(program):
    model = program.model
    encode = model.encode_images

    def encode_images(images, *a, **kw):
        if images.dim() == 5:
            images = images[:, :1].expand_as(images).contiguous()
        return encode(images, *a, **kw)

    model.encode_images = encode_images


@pytest.mark.parametrize("fault", [_no_embeddings, _frame_0_repeated])
def test_a_planted_clip_fault_reads_not_correct(bench, fault, monkeypatch):
    """At the tiny widths (decoder width 32) the decoder's value and output
    maps at std 0.02 carry too little of the memory for the clip to move
    the captions (both faults read correct there); they are scaled x20 on
    both sides, program and reference, so that the captions depend on the
    clip as at the published widths."""
    make = weights.make

    def sharpened(cfg, seed, device, dtype=None):
        sd = make(cfg, seed, device, dtype)
        for name in sd:
            if name.endswith(("attention.self.value.weight", "attention.output.dense.weight")):
                sd[name] = sd[name] * 20
        return sd

    monkeypatch.setattr(weights, "make", sharpened)
    assert _run(bench)["correct"]
    r = _run(bench, fault=fault)
    assert r["checks"]["score_gap_bf16"]["value"] > 2 * r["checks"]["score_gap_bf16"]["limit"]
    assert not r["correct"], r["checks"]


def test_a_program_that_reads_clip_rows_as_images_fails_the_warm_up(bench):
    """A loop that reads a clip row's payload as one base64 image."""
    import dataclasses

    def as_images(program):
        m = program.model
        m.cfg = dataclasses.replace(m.cfg, num_image_with_embedding=0)

    with pytest.raises(RuntimeError, match="did not caption the warm-up's rows as clips"):
        _run(bench, fault=as_images)


def test_the_clip_reference_loads_nothing_of_the_port_and_keeps_tf32_off():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, {!r}); import gitbench.reference_clips; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))").format(spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert not set(eval(out)) & {"jax", "jaxlib", "flax", "gitax", "gitax_torch"}
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        RC.Reference(CFG, {}, "cpu")
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True


# -- the readers -------------------------------------------------------------------
CFG = spec.config(spec.load(), "git_large_vatex")


def test_decode_chunk_ms_per_frame():
    recs = [Rec("decode.chunk", -30, 5, thread=2, chunk=1, rows=4, frames=24),  # ends after
            Rec("decode.chunk", -30, -20, thread=2, chunk=2, rows=4, frames=24),  # before
            Rec("decode.chunk", 10, 58, thread=3, chunk=3, rows=4, frames=23)]
    assert read("decode.chunk_ms_per_frame", ctx_of(recs)) == pytest.approx((35 + 48) / 47)
    old = [Rec("decode.chunk", 10, 58, thread=3, chunk=4, rows=4)]  # no `frames`
    assert read("decode.chunk_ms_per_frame", ctx_of(old)) is None
    assert read("decode.chunk_ms_per_frame", ctx_of([])) is None
    assert read("decode.chunk_ms_per_frame", ctx_of(None)) is None


def test_model_encode_roofline_prices_each_frame_at_its_tokens():
    mod = spec.module("metrics/model.encode_roofline")
    s = 257
    recs = [Rec("model.encode", 5, 300, device=(0.0, 100.0), tokens=6 * s, frames=6, images=192),
            Rec("model.encode", 400, 700, device=(0.0, 300.0), tokens=6 * s, frames=6,
                images=192),
            Rec("model.encode", -50, -10, device=(0.0, 50.0), tokens=s, frames=1, images=32)]
    want = 100.0 * 2 * 192 * mod.image_flops(CFG, s) / (0.4 * peaks.BF16_FLOPS)
    assert read("model.encode_roofline", ctx_of(recs, cfg=CFG)) == pytest.approx(want)
    # the FLOPs `peaks.model_flops` gives one frame's patch embedding and encoder
    # (they are all that an encoder of width 0 drops)
    no_encoder = peaks.model_flops(dict(CFG, encoder_width=0), s, 1, 0)
    assert mod.image_flops(CFG, s) == peaks.model_flops(CFG, s, 1, 0) - no_encoder
    lost = [Rec("model.encode", 5, 300, tokens=s, frames=1, images=32)]  # no device times
    old = [Rec("model.encode", 5, 300, device=(0.0, 100.0), tokens=s)]  # no frames, images
    for recs in (lost, old, [], None):
        assert read("model.encode_roofline", ctx_of(recs, cfg=CFG)) is None


def _traced(encode_tokens, launched, frames=6, s=257):
    """A traced span of two device batches of 32 clips with its kernel-2
    records, and the program's `model.encode` spans of the given tokens."""
    span = types.SimpleNamespace(t_open=100.0, t_close=100.5, steps=40,
                                 launched={"flash_attention": launched})
    batches = [dict(t=100.1 + 0.2 * i, rows=32, real=32, shape=(224, 224), frames=frames,
                    prefix=np.full((32, 1), 101, np.int64)) for i in range(2)]
    profile = {"kernels": {"flash_attention_kernel<bf16>": 0.012},
               "calls": {"flash_attention_kernel<bf16>": 12}, "window_s": 0.5}
    recs = [Rec("model.encode", 100 + 200 * i, 150 + 200 * i, device=(0.0, 40.0),
                tokens=encode_tokens, frames=frames, images=32 * frames) for i in range(2)]
    return ctx_of(recs, cfg=CFG, span=span, batches=batches, profile=profile, traffic={})


def test_flash_prefill_roofline_reads_the_prefills_of_the_span():
    ctx = _traced(6 * 257, 12)
    least = peaks.least_s(*peaks.flash_prefill(32, 12, 1542, 1, 64), peaks.BF16_FLOPS)
    assert read("flash_prefill_roofline", ctx) == pytest.approx(100.0 * 2 * 6 * least / 0.012)


@pytest.mark.parametrize("tokens,launched,why", [
    (6 * 901, 12, "the encoder's S = 901 takes kernel 2 too"),
    (6 * 640, 12, "S = 640: the encoder's first size on kernel 2"),
    (6 * 257, 10, "launches other than one a decoder layer a batch"),
    (6 * 257, 0, "no kernel 2 launched"),
])
def test_flash_prefill_roofline_refuses_what_is_not_the_prefills_alone(tokens, launched, why):
    assert read("flash_prefill_roofline", _traced(tokens, launched)) is None, why


def test_flash_prefill_roofline_needs_the_spans_frames():
    ctx = _traced(6 * 257, 12)
    for r in ctx.program_spans:
        del r.attrs["frames"]
    assert read("flash_prefill_roofline", ctx) is None
    assert read("flash_prefill_roofline", ctx_of(None, cfg=CFG)) is None
