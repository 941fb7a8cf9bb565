"""The seams through which a configuration, a traffic kind or a reference
comes as new files only, and what they must leave alone:

(a) a traffic kind and a reference that live in files of their own (here
    under tests/), named by the traffic file and the configuration, run
    through `harness.run` on a tiny two-frame clips configuration;
(b) the single-frame, single-card draws and counts equal to the ones the
    benchmark made before clips and meshes reached it (pinned);
(c) the batch records' fingerprints and the judge's matching on clips.
"""

import hashlib
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from gitbench import drivers, harness, judge, peaks, spec, weights
from gitbench.program import fingerprint, frames, port_config
from gitbench.tests import tiny

SEED = 2 ** 31 + 77
CLIPS = {"kind": "tests/clips_kind", "clips": 6, "frames": 2, "shapes": {"64x48": 1},
         "jpeg_quality": 90}


def clips_config():
    cfg = tiny.tiny_config("git_large_coco")
    cfg.update(num_image_with_embedding=2, reference="tests/clips_reference")
    return cfg


@pytest.fixture(autouse=True)
def _pil_decode(monkeypatch):
    import gitax_torch.runtime.engine as engine

    monkeypatch.setattr(engine, "resolve_use_native", lambda use_native: False)


# -- (a) ------------------------------------------------------------------------
def test_a_kind_and_a_reference_in_files_of_their_own_run_two_frame_clips(tmp_path):
    path = str(tmp_path / "tiny_clips.json")
    with open(path, "w") as f:
        json.dump(clips_config(), f)
    cell = {"name": "tiny.clips", "config": "tiny_clips", "traffic": "tiny_clips", "chips": 1}
    bench = dict(spec.load(), configs=[{"name": "tiny_clips", "file": path}], workloads=[cell])
    limits = {"sample": 8, "limits": {"unmatched": 0, "missing": 0, "score_gap_bf16": 40.0,
                                      "search_gap_nats": 1.0}}
    assert drivers.driver_class(CLIPS["kind"]).__module__.startswith("gitbench_file_tests")
    assert spec.reference(clips_config()).__name__.startswith("gitbench_file_tests")
    got = []
    r = harness.run(bench, cell, SEED, 2.0, 0, "cpu", time.perf_counter(), got.append,
                    traffic=dict(CLIPS), limits=limits)
    assert r["correct"], (r["checks"], got)
    c = r["checks"]
    assert c["unmatched"]["value"] == 0 and c["search_gap_nats"]["value"] is not None
    assert r["attempted"] >= 6 and r["failed"] == 0 and r["metrics"]["setup_s"]["value"] > 0
    assert "'unscored_rows': 0" in got[-1] and "'scored_rows': 0" not in got[-1], got[-1]


def test_a_the_clips_reference_tells_the_temporal_embedding():
    """The reference's memory of a clip moves with its temporal embedding,
    and is each frame's ViT tokens, offset, then projected."""
    from gitbench.tests import clips_reference as CR

    cfg = clips_config()
    sd = weights.make(cfg, SEED, "cpu", dtype=torch.float32)
    ref = CR.Reference(cfg, sd, "cpu")
    arr = np.random.default_rng(1).integers(0, 256, (2, 28, 28, 3), dtype=np.uint8)
    mem = ref.encode(arr)
    assert mem.shape == (1, 2 * ((28 // 14) ** 2 + 1), cfg["hidden_size"])
    sd2 = dict(sd, **{"img_temperal_embedding.1": sd["img_temperal_embedding.1"] + 1.0})
    mem2 = CR.Reference(cfg, sd2, "cpu").encode(arr)
    s = mem.shape[1] // 2
    assert torch.equal(mem[:, :s], mem2[:, :s]) and not torch.allclose(mem[:, s:], mem2[:, s:])
    first = ref.project(ref.vit(arr[0]) + ref.w["img_temperal_embedding.0"].reshape(1, 1, -1))
    assert torch.allclose(mem[:, :s], first)


def test_a_the_port_loads_the_clips_weights_by_key_and_shape():
    from gitax_torch.models.git import GitModel

    cfg = clips_config()
    model = GitModel(port_config(cfg), device="cpu", dtype=torch.bfloat16)
    sd = weights.make(cfg, SEED, "cpu")
    assert [n for n in sd if "temperal" in n] == ["img_temperal_embedding.0",
                                                  "img_temperal_embedding.1"]
    assert sorted(sd) == sorted(model.state_dict())
    model.load_state_dict(sd)
    assert torch.equal(model.img_temperal_embedding[1].data, sd["img_temperal_embedding.1"])


def test_a_port_config_builds_the_zoos_video_model():
    """GIT_LARGE_VATEX's sizes with its 6 frames are the zoo's."""
    from gitax_torch.models.config import config_from_param, get_model_param

    cfg = dict(spec.config(spec.load(), "git_large_coco"), model_name="GIT_LARGE_VATEX",
               num_image_with_embedding=6)
    port = port_config(cfg)
    assert port.num_image_with_embedding == 6
    assert port == config_from_param(dict(get_model_param("GIT_LARGE_VATEX"), fast_softmax=True))
    with pytest.raises(ValueError):
        port_config(dict(cfg, num_image_with_embedding=0))


# -- (b) ------------------------------------------------------------------------
# the benchmark's own numbers before the seams (gitbench of the commit before),
# on the CPU: the tiny configurations' weight draws at SEED, and the counts
PINNED_DIGEST = {
    "git_large_coco": "53ee3c4ebddeec8aaeec057adb895c8ac25dec2d6eebfcae07c73d116bfd181f",
    "git_large_vqav2": "3d09ff1869938d773e30014acb4900aec1b969c24e90699fb503d33225f4555e",
}
SHAPES = ((257, 1, 13), (1201, 8, 4), (881, 12, 7))
PINNED_MODEL_FLOPS = [192718832640, 1002470900736, 705401152512]
PINNED_FLASH = ["0.0005735084704477612", "0.005456734570386249", "0.0006713326584752274"]
PINNED_DECODE = ["0.0006889496453731344", "0.0008838556656716417"]
PINNED_SPAN_WORK = [(32, 32, 257, 1, 30.333333333333332), (32, 17, 1201, 7, 30.333333333333332),
                    (32, 30, 881, 3, 30.333333333333332)]


def digest(sd):
    h = hashlib.sha256()
    for k, t in sd.items():
        h.update(k.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(t.contiguous().view(torch.int16).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED_DIGEST))
def test_b_image_weights_draw_as_before(name):
    cfg = tiny.tiny_config(name)
    assert "num_image_with_embedding" not in cfg
    assert digest(weights.make(cfg, SEED, "cpu")) == PINNED_DIGEST[name]


@pytest.mark.parametrize("name", ["git_large_coco", "git_large_vqav2"])
def test_b_image_counts_as_before(name):
    cfg = spec.config(spec.load(), name)
    assert [peaks.model_flops(cfg, *s) for s in SHAPES] == PINNED_MODEL_FLOPS
    assert [peaks.model_flops(cfg, *s, frames=1) for s in SHAPES] == PINNED_MODEL_FLOPS
    flash = [peaks.least_flash_s(cfg, b, s, tp) for b, s, tp in
             ((32, 257, 1), (32, 1201, 12), (7, 901, 5))]
    assert [repr(x) for x in flash] == PINNED_FLASH
    dec = [peaks.least_decode_attention_s(cfg, b, m, tp, n) for b, m, tp, n in
           ((32, 257, 1, 13), (32, 1201, 8, 4))]
    assert [repr(x) for x in dec] == PINNED_DECODE
    span = types.SimpleNamespace(t_open=1.0, t_close=5.0, steps=91)
    batches = [dict(t=t, rows=32, real=real, shape=shape, prefix=np.zeros((32, tp), np.int64))
               for t, real, shape, tp in ((0.5, 32, (224, 224), 1), (1.5, 32, (224, 224), 1),
                                          (2.5, 17, (420, 560), 7), (4.9, 30, (308, 560), 3),
                                          (5.5, 32, (224, 224), 1))]
    work = peaks.span_work(types.SimpleNamespace(span=span, batches=batches, cfg=cfg))
    assert [w[:5] for w in work] == PINNED_SPAN_WORK and {w[5] for w in work} == {1}


def test_b_mfu_on_one_card_is_as_before_and_divides_by_the_cells_cards():
    cfg = spec.config(spec.load(), "git_large_coco")
    span = types.SimpleNamespace(t_open=1.0, t_close=5.0, steps=26)
    batches = [dict(t=t, rows=32, real=32, shape=(224, 224), prefix=np.zeros((32, 1), np.int64))
               for t in (1.5, 2.5)]
    ctx = types.SimpleNamespace(span=span, batches=batches, cfg=cfg, profile={"window_s": 3.0},
                                cell={"chips": 1})
    mfu = spec.reader("model.mfu")
    before = 100.0 * (32 * peaks.model_flops(cfg, 257, 1, 13) * 2) / (3.0 * peaks.BF16_FLOPS)
    assert mfu(ctx) == before
    ctx.cell = {"chips": 4}
    assert mfu(ctx) == pytest.approx(before / 4, rel=1e-15)


def test_b_a_meshs_rooflines_price_rank_0s_data_shard():
    """On a [4, 1] mesh's 128-row batches, `span_work(card=True)` is rank 0's
    32 rows (the real ones first), and kernel 1's roofline reads as on a
    card searching 32 rows; on one card `card` changes nothing."""
    cfg = spec.config(spec.load(), "git_large_coco")
    span = types.SimpleNamespace(t_open=1.0, t_close=5.0, steps=26, launched={})

    def ctx_of(rows, real, traffic):
        batches = [dict(t=t, rows=rows, real=real, shape=(224, 224),
                        prefix=np.zeros((rows, 1), np.int64)) for t in (1.5, 2.5)]
        return types.SimpleNamespace(span=span, batches=batches, cfg=cfg, traffic=traffic,
                                     profile={"window_s": 3.0, "calls": {"decode_attention_k": 6},
                                              "kernels": {"decode_attention_k": 0.01}})

    mesh = ctx_of(128, 128, {"mesh_shape": [4, 1]})
    card = ctx_of(32, 32, {})
    assert peaks.span_work(mesh, card=True) == peaks.span_work(card) == \
        peaks.span_work(card, card=True)
    assert peaks.span_work(mesh)[0][:2] == (128, 128)
    assert [w[:2] for w in peaks.span_work(ctx_of(128, 20, {"mesh_shape": [4, 1]}),
                                           card=True)] == [(32, 20), (32, 20)]
    roofline = spec.reader("decode_attention_roofline")
    assert roofline(mesh) == roofline(card) > 0


def test_b_clips_count_b_times_f_encoder_images_and_f_times_s_memory():
    cfg = spec.config(spec.load(), "git_large_coco")
    one = peaks.model_flops(cfg, 257, 1, 13)
    six = peaks.model_flops(cfg, 257, 1, 13, frames=6)
    enc = peaks.model_flops(cfg, 257, 1, 0) - peaks.model_flops(cfg, 1, 1, 0)
    assert six > 6 * (one - peaks.model_flops(cfg, 257, 1, 13) + enc) - 1
    assert peaks.least_flash_s(cfg, 32, 257, 1, frames=6) > peaks.least_flash_s(cfg, 192, 257, 1)
    he = cfg["encoder_heads"]
    nbytes, flops = peaks.flash_encoder(32 * 6, he, 257, cfg["encoder_width"] // he)
    assert flops == 6 * peaks.flash_encoder(32, he, 257, cfg["encoder_width"] // he)[1]
    assert peaks.least_decode_attention_s(cfg, 32, 257, 1, 13, frames=6) == \
        peaks.least_decode_attention_s(cfg, 32, 1542, 1, 13)
    span = types.SimpleNamespace(t_open=1.0, t_close=5.0, steps=10)
    b = dict(t=2.0, rows=32, real=32, shape=(224, 224), frames=6,
             prefix=np.zeros((32, 1), np.int64))
    work = peaks.span_work(types.SimpleNamespace(span=span, batches=[b], cfg=cfg))
    assert work == [(32, 32, 257, 1, 10.0, 6)]


# -- (c) ------------------------------------------------------------------------
def _clips(seed, b=3, f=2, h=28, w=28):
    return np.random.default_rng(seed).integers(0, 256, (b, f, h, w, 3), dtype=np.uint8)


def test_c_fingerprints_read_each_frame():
    clips = _clips(0)
    fp = fingerprint(clips)
    assert fp.shape == (3, 2, 4, 4, 3)
    for j in range(2):
        assert np.array_equal(fp[:, j], fingerprint(clips[:, j]))
    assert frames(clips) == 2 and frames(clips[:, 0]) == 1
    assert fingerprint(clips[:, 0]).shape == (3, 4, 4, 3)


def _record(imgs):
    return dict(frames=frames(imgs), shape=tuple(imgs.shape[-3:-1]), fp=fingerprint(imgs),
                prefix=np.full((len(imgs), 1), 101, np.int64))


def test_c_candidates_match_clips_and_tell_frames_apart():
    clips = _clips(1)
    batches = [_record(clips), _record(clips[:, 0])]
    assert judge.candidates(batches, clips[1], [101]) == [(0, 1)]
    assert judge.candidates(batches, clips[1, 0], [101]) == [(1, 1)]
    assert judge.candidates(batches, clips[1, ::-1], [101]) == []  # frames swapped
    other = clips[1].copy()
    other[1] = _clips(2)[0, 1]  # the second frame another clip's
    assert judge.candidates(batches, other, [101]) == []
    # the first frame alone: the image row, not the two-frame clip
    assert judge.candidates(batches, clips[1, :1], [101]) == [(1, 1)]
    assert judge.candidates(batches, clips[1], [101, 7]) == []


def test_c_records_hold_frames_and_one_frames_shape(monkeypatch):
    """Hooks record a clip batch's frames and one frame's (H, W)."""
    from gitbench.program import Hooks

    class Engine(object):
        def dispatch_device_batch(self, imgs, pref, **kw):
            return torch.zeros((len(imgs), 3), dtype=torch.int64)

        def resolve(self, handle):
            return []

    class Model(object):
        def generate(self, *a, **kw):
            return None, None

    prog = types.SimpleNamespace(engine=Engine(), model=Model())
    hooks = Hooks(prog, traced=False)
    hooks.recording = True
    clips = _clips(3, b=2, f=3, h=28, w=42)
    prog.engine.dispatch_device_batch(clips, np.full((2, 1), 101))
    prog.engine.dispatch_device_batch(clips[:, 0], np.full((2, 1), 101))
    hooks.remove()
    (a, b) = hooks.batches
    assert (a["frames"], a["shape"], a["fp"].shape) == (3, (28, 42), (2, 3, 4, 4, 3))
    assert (b["frames"], b["shape"], b["fp"].shape) == (1, (28, 42), (2, 4, 4, 3))


def test_kinds_and_references_name_files_under_gitbench_only():
    for bad in ("../x", "kinds/../../x", "/abs", "a b"):
        with pytest.raises(ValueError):
            spec.module(bad)
    with pytest.raises(ValueError):
        drivers.make({}, {"kind": "no_such_kind"}, 1, ".")
    assert spec.reference({}) is spec.reference({"reference": "reference"})
    assert os.path.isfile(os.path.join(spec.HERE, "kinds", "caption_tsv_mesh.py"))
