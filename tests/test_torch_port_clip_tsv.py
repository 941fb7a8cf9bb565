"""The port's clip TSV loop: `CaptionEngine.run_caption_tsv` on a video
model (`num_image_with_embedding` F > 0), each row `key \\t` a JSON list of
base64 frames, held to the plain reference `gitbench/reference_clips.py`
(CPU, f32, a tiny video configuration of F = 3 frames, weights drawn by
`gitbench.weights` from a seed): each batch's memory and the search's
scores of the sequences it served, the captions' TSV order and the
temporal embeddings (frames reversed, the embeddings dropped), grouping by
frames with a longer clip cut to F, bad rows, the decode pool spreading a
batch's frames over its threads, the image loop unchanged, and the CLI's
`-p`."""

import base64
import io
import json
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from gitax_torch import common
from gitax_torch import inference as pt_inf
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.io.tsv import TSVFile, tsv_writer
from gitax_torch.models import textual as T
from gitax_torch.preprocess.transforms import TestTransform
from gitax_torch.runtime import engine as pt_engine
from gitax_torch.runtime import profiling
from gitax_torch.tokenization import BertTokenizer
from gitbench import program, reference_clips, vocab, weights
from test_torch_port_tsv import assert_same_tsv, engines, write_image_tsv

F = 3
SEED = 2 ** 31 + 20
CFG = dict(model_name="TINY_VID", patch_size=14, encoder_width=32, encoder_layers=2,
           encoder_heads=2, test_crop_size=28, visual_feature_size=32,
           num_image_with_embedding=F, vocab_size=30522, hidden_size=32, num_layers=2,
           num_heads=2, feedforward_size=64, max_caption_length=1024, encoder_ln_eps=1e-5,
           projection_ln_eps=1e-5, embedding_ln_eps=1e-8, bert_ln_eps=1e-12, dtype="float32",
           int8=True, fast_softmax=False, num_beams=2, per_node_beam_size=2,
           length_penalty=0.6, max_steps=10, max_text_len=10, norm_max_length=1024,
           cls_id=101, eos_id=102, assumed=dict(eos_gate=5, query_key_scale=5))
BATCH = 4
# memory: f32 on both sides, the same operations in other orders and
# kernels (the port's fused qkv, its LayerNorm); ~1e-6 of tokens of unit scale
MEMORY_TOL = 1e-4


@pytest.fixture(scope="module")
def sd():
    return weights.make(CFG, SEED, "cpu")


@pytest.fixture(scope="module")
def ref(sd):
    return reference_clips.Reference(CFG, sd, "cpu")


def engine(sd, decode_workers=4, cfg=CFG):
    """The port's engine as the TSV CLI builds it (weight-only int8), f32."""
    model = program.build_model(cfg, sd, "cpu")
    return pt_engine.CaptionEngine(
        model, BertTokenizer(vocab.tokens(cfg["vocab_size"])), batch_size=BATCH,
        beam=BeamSearchConfig(num_beams=cfg["num_beams"], max_steps=cfg["max_steps"]),
        dtype=torch.float32, max_text_len=cfg["max_text_len"], int8=True,
        transform=TestTransform(crop_size=cfg["test_crop_size"]), use_native=False,
        decode_workers=decode_workers)


def frame(seed, size=(40, 30), fmt="JPEG"):
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, (3, 4, 3)).astype(np.uint8)
    img = Image.fromarray(coarse).resize(size, Image.BILINEAR)
    buf = io.BytesIO()
    img.save(buf, format=fmt, quality=95)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def clip(seed, n=F, size=(40, 30)):
    return [frame(seed * 100 + i, size) for i in range(n)]


def write_tsv(path, clips):
    """rows (key, frames list or a raw payload string)."""
    tsv_writer([[k, c if isinstance(c, str) else json.dumps(c)] for k, c in clips], str(path))
    return str(path)


def caption_rows(path):
    return [(k, json.loads(v)[0]["caption"]) for k, v in
            (line.rstrip("\n").split("\t") for line in open(path))]


class Recorder(object):
    """The model's encoder outputs and the searches' (sequences, scores),
    batch by batch."""

    def __init__(self, eng):
        self.feats, self.searches, self.shapes = [], [], []
        model = eng.model
        enc, gen, disp = model.encode_images, model.generate, eng.dispatch_device_batch

        def encode_images(images, *a, **kw):
            out = enc(images, *a, **kw)
            self.feats.append(out)
            return out

        def generate(*a, **kw):
            seqs, scores = gen(*a, **kw)
            self.searches.append((seqs, scores))
            return seqs, scores

        def dispatch(imgs, pref, **kw):
            self.shapes.append(np.shape(imgs))
            return disp(imgs, pref, **kw)

        model.encode_images, model.generate = encode_images, generate
        eng.dispatch_device_batch = dispatch


def held_to_reference(eng, rec, ref, clips):
    """Each real row's memory and served score against the reference's:
    (largest memory difference, largest score difference, rows)."""
    eos, alpha = CFG["eos_id"], CFG["length_penalty"]
    mem_err = score_err = 0.0
    rows = 0
    for b, (feats, (seqs, scores)) in enumerate(zip(rec.feats, rec.searches)):
        memory = T.project_visual(eng.model.textual, feats, eng.model.cfg)
        for r, frames in enumerate(clips[b * BATCH:(b + 1) * BATCH]):
            arr = reference_clips.pixels(frames, CFG)
            want = ref.encode(arr)
            mem_err = max(mem_err, float((memory[r] - want[0]).abs().max()))
            row = seqs[r].tolist()
            words = row[:row.index(eos)] if eos in row else None
            if words is None or len(words) + 1 >= CFG["max_steps"]:
                continue  # a forced end: its score holds a word not served
            ref_sum = float(ref.sequence(want, [CFG["cls_id"]], words, eos).sum())
            normed = ref_sum / reference_clips.length_norm(1 + len(words), alpha)
            score_err = max(score_err, abs(float(scores[r]) - normed))
            rows += 1
    return mem_err, score_err, rows


def test_a_memory_and_search_scores_match_the_reference(sd, ref, tmp_path):
    clips = [clip(i) for i in range(6)]
    keys = ["c{}".format(i) for i in range(6)]
    path = write_tsv(tmp_path / "clips.tsv", zip(keys, clips))
    with engine(sd) as eng:
        rec = Recorder(eng)
        eng.run_caption_tsv(path, str(tmp_path / "out.tsv"))
    assert [s[1:] for s in rec.shapes] == [(F, 28, 28, 3)] * 2  # 6 clips: 4, then 2 padded
    mem_err, score_err, rows = held_to_reference(eng, rec, ref, clips)
    assert mem_err < MEMORY_TOL, mem_err
    # scores: length-normed sums of log-probabilities; both sides dequantise
    # the same int8 weights in f32, the port scaling after the product and the
    # reference before: ~1e-6 a token (4e-6 read), summed over <= 10 tokens
    assert rows >= 4 and score_err < 1e-4, (rows, score_err)
    got = caption_rows(str(tmp_path / "out.tsv"))
    assert [k for k, _ in got] == keys
    tok = eng.tokenizer
    seqs = torch.cat([s for s, _ in rec.searches])[:6]
    assert [c for _, c in got] == [tok.decode(s.tolist(), skip_special_tokens=True)
                                   for s in seqs]


def test_b_order_reversed_frames_and_dropped_embeddings(sd, ref, tmp_path):
    """Captions in TSV order; a clip's frames reversed move its memory only
    by the temporal embeddings; a program that drops them fails (a)."""
    clips = [clip(7), clip(7)[::-1], clip(8)]
    keys = ["z", "a", "m"]
    path = write_tsv(tmp_path / "clips.tsv", zip(keys, clips))
    with engine(sd) as eng:
        rec = Recorder(eng)
        eng.run_caption_tsv(path, str(tmp_path / "out.tsv"))
    assert [k for k, _ in caption_rows(str(tmp_path / "out.tsv"))] == keys
    feats = rec.feats[0].reshape(-1, F, 5, 32)  # [B, F, S, Dv]: 28 px / 14 = 2 x 2 + 1
    emb = torch.cat([p.reshape(1, -1) for p in eng.model.img_temperal_embedding])
    for i in range(F):
        j = F - 1 - i
        # the same frame's tokens, each offset by its own position's embedding
        assert torch.allclose(feats[1, i] - feats[0, j], (emb[i] - emb[j])[None].expand(5, -1),
                              atol=1e-5)
    assert float((emb[0] - emb[-1]).abs().max()) > 0.1

    with engine(sd) as bad:
        with torch.no_grad():
            for p in bad.model.img_temperal_embedding:
                p.zero_()
        rec = Recorder(bad)
        bad.run_caption_tsv(path, str(tmp_path / "bad.tsv"))
    mem_err, _, _ = held_to_reference(bad, rec, ref, clips)
    assert mem_err > 100 * MEMORY_TOL, mem_err


def test_c_clips_group_by_frames_and_a_longer_clip_is_cut(sd, ref, tmp_path):
    clips = [clip(1), clip(2, 2), clip(3, 4), clip(4, 2), clip(5)]
    keys = ["k{}".format(i) for i in range(len(clips))]
    path = write_tsv(tmp_path / "clips.tsv", zip(keys, clips))
    with engine(sd) as eng:
        rec = Recorder(eng)
        eng.run_caption_tsv(path, str(tmp_path / "out.tsv"))
    # one chunk of 4 rows, then 1: per chunk, (frames, grid) groups in order
    assert [s[:2] for s in rec.shapes] == [(4, 2), (4, 3), (4, 3)]
    assert [k for k, _ in caption_rows(str(tmp_path / "out.tsv"))] == keys
    # the 4-frame clip (row 2) is its first 3 frames: the second 3-frame batch's row 1
    memory = T.project_visual(eng.model.textual, rec.feats[1], eng.model.cfg)
    want = ref.encode(reference_clips.pixels(clips[2], CFG))
    assert want.shape[1] == F * 5
    assert float((memory[1] - want[0]).abs().max()) < MEMORY_TOL


def test_d_a_row_that_is_not_a_clip_raises_and_a_bad_frame_drops_its_row(sd, tmp_path):
    broken = clip(2)
    broken[1] = base64.b64encode(b"!!!corrupt!!!").decode("ascii")
    path = write_tsv(tmp_path / "clips.tsv", [("ok0", clip(1)), ("bad", broken),
                                              ("ok2", clip(3))])
    with engine(sd) as eng:
        eng.run_caption_tsv(path, str(tmp_path / "out.tsv"))
        assert [k for k, _ in caption_rows(str(tmp_path / "out.tsv"))] == ["ok0", "ok2"]
        for payload in (frame(4), json.dumps({"frames": clip(4)}), "[]"):
            path = write_tsv(tmp_path / "image.tsv", [("ok", clip(1)), ("row7", payload)])
            with pytest.raises(ValueError, match="'row7'.*JSON list of base64 frames"):
                eng.run_caption_tsv(path, str(tmp_path / "out2.tsv"))


def test_e_a_batch_frames_decode_on_several_pool_threads(sd, tmp_path):
    path = write_tsv(tmp_path / "clips.tsv", [("k{}".format(i), clip(i)) for i in range(8)])
    with engine(sd) as eng:
        inner = eng._decode_frames

        def slow(payloads):
            time.sleep(0.05)  # each part outlasts the submits of its batch
            return inner(payloads)

        eng._decode_frames = slow
        batches = []
        dispatch = eng.dispatch_device_batch
        eng.dispatch_device_batch = lambda imgs, pref, **kw: (
            batches.append(imgs.dtype), dispatch(imgs, pref, **kw))[1]
        profiling.clear()
        eng.run_caption_tsv(path, str(tmp_path / "out.tsv"))
        records = profiling.spans()
        # PIL decodes in processes of the engine's own, to uint8 frames
        # that the card normalises
        assert len(eng._frame_procs) == 1 and batches == [np.uint8] * 2
    chunks = sorted((r for r in records if r.name == "decode.chunk"),
                    key=lambda r: r.attrs["chunk"])
    # two batches of 4 clips over 4 workers: a clip a part, each a chunk
    assert [(r.attrs["rows"], r.attrs["frames"]) for r in chunks] == [(1, F)] * 8
    # the first batch's parts, by chunk id (their spans end in any order)
    assert len({r.thread for r in chunks[:4]}) > 1
    assert threading.get_ident() not in {r.thread for r in chunks}
    waits = [r.attrs["chunk"] for r in records if r.name == "tsv.pool_wait"]
    assert sorted(waits) == sorted(r.attrs["chunk"] for r in chunks)


def test_f_the_image_loop_writes_todays_rows(tmp_path):
    """An image model through the same `run_caption_tsv`: gitax's engine's
    bytes (`test_torch_port_tsv`'s fixture), one decode chunk a batch."""
    write_image_tsv(str(tmp_path / "img.tsv"))
    gx, pt = engines({"crop_size": 32})
    profiling.clear()
    gx.run_caption_tsv(str(tmp_path / "img.tsv"), str(tmp_path / "gx.tsv"))
    pt.run_caption_tsv(str(tmp_path / "img.tsv"), str(tmp_path / "pt.tsv"))
    assert_same_tsv(str(tmp_path / "gx.tsv"), str(tmp_path / "pt.tsv"))
    chunks = sorted((r for r in profiling.spans() if r.name == "decode.chunk"),
                    key=lambda r: r.attrs["chunk"])
    rows = len(TSVFile(str(tmp_path / "img.tsv")))
    assert [r.attrs["rows"] for r in chunks] == [3] * (rows // 3) + [rows % 3] * (rows % 3 > 0)
    assert all(r.attrs["frames"] == r.attrs["rows"] for r in chunks)


def test_g_the_cli_captions_a_clip_tsv(sd, tmp_path, monkeypatch):
    """`python -m gitax_torch.inference -p` on a video model: one caption a
    clip (random weights: the checkpoint is absent)."""
    monkeypatch.chdir(tmp_path)
    aux = tmp_path / "aux_data" / "models" / "TINY_VID"
    aux.mkdir(parents=True)
    (aux / "parameter.yaml").write_text("test_crop_size: 28\n")
    monkeypatch.setattr(pt_inf, "config_from_param", lambda param=None: program.port_config(CFG))
    monkeypatch.setattr(common, "init_logging", lambda level=None: None)
    keys = ["v{}".format(i) for i in range(3)]
    write_tsv(tmp_path / "clips.tsv", zip(keys, [clip(i) for i in range(3)]))
    argv = ["-p", "{'type': 'test_git_inference_single_tsv', 'image_tsv': 'clips.tsv', "
                  "'model_name': 'TINY_VID', 'question_tsv': null, 'out_tsv': 'out.tsv', "
                  "'batch_size': 2, 'dtype': 'float32', 'use_native': false, 'device': 'cpu'}"]
    seen = []
    encode = pt_engine.GitModel.encode_images

    def encode_images(self, images, *a, **kw):
        seen.append(tuple(images.shape))
        return encode(self, images, *a, **kw)

    monkeypatch.setattr(pt_engine.GitModel, "encode_images", encode_images)
    common.dispatch_main(vars(pt_inf), argv)
    rows = caption_rows("out.tsv")
    assert [k for k, _ in rows] == keys and all(isinstance(c, str) for _, c in rows)
    assert seen == [(2, F, 28, 28, 3)] * 2
