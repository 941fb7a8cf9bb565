"""The port's TSV loops and their copies of gitax's framework-free code
against gitax (CPU, f32): `run_caption_tsv` and `run_vqa_tsv` write
byte-identical .tsv, .lineidx and .lineidx.8b files on the same weights
and the same image TSV (JPEG and PNG payloads at several sizes, a
corrupt row), with a center-crop and a MinMax transform, with a
non-CLIP transform on uint8 and on float input, and in three shards; the
copies (`json_dump`, `shard_range`, the env-var ranks, `load_list_file`,
the transforms) give gitax's outputs; the decoders give gitax's images,
and without PIL they and the TSV loop raise rather than drop rows."""

import base64
import filecmp
import functools
import io
import json
import sys

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

from gitax import common as gx_common
from gitax.decode import BeamSearchConfig as GxBeam
from gitax.io.tsv import tsv_writer as gx_tsv_writer
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.preprocess import transforms as gx_tf
from gitax.runtime import CaptionEngine as GxEngine
from gitax.runtime import pipeline as gx_pipeline
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt, common
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.io import image as pt_image
from gitax_torch.io.tsv import TSVFile
from gitax_torch.models.git import eos_gate_params
from gitax_torch.preprocess import transforms as pt_tf
from gitax_torch.runtime import engine as pt_engine
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

# gitax tests/test_pipeline.py's TINY, with a positional table past the
# engine's 41-token beam buffer
TINY = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 32),
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=48,
)
WORDS = ["red", "dog", "what", "is", "the", "color", "of", "a", "big"]
SIZES = [((40, 50), "JPEG"), ((32, 32), "PNG"), ((20, 60), "PNG"), ((64, 48), "JPEG"),
         ((33, 31), "PNG"), ((32, 40), "PNG")]
TRANSFORMS = {"crop": dict(crop_size=32), "minmax": dict(crop_size=32, respect_ratio_max=48)}


@functools.lru_cache(maxsize=None)
def tiny_params(seed=0):
    """gitax TINY params, sharpened so that captions depend on the image
    and end early: a stronger visual projection and attention, a sharper
    tied table and the EOS gate (numpy leaves)."""
    params = GitModel(TINY).init_params(jax.random.PRNGKey(seed))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    emb = tx["embedding"]
    emb["words"] = eos_gate_params(np.asarray(emb["words"]) * 3.0, np.asarray(emb["positions"]),
                                   gate=6)
    return jax.tree_util.tree_map(np.asarray, params)


def image_bytes(seed, size, fmt, mode="RGB"):
    rng = np.random.RandomState(seed)
    channels = {"L": None, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    shape = (size[1], size[0]) + ((channels,) if channels else ())
    img = Image.fromarray(rng.randint(0, 255, shape, dtype=np.uint8), mode=mode)
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return buf.getvalue()


def write_image_tsv(path, sizes=SIZES, corrupt=True):
    rows = [["k{}".format(i), base64.b64encode(image_bytes(i, s, f))]
            for i, (s, f) in enumerate(sizes)]
    if corrupt:
        rows.insert(2, ["bad", b"!!!corrupt!!!"])
    gx_tsv_writer(rows, path)
    return [r[0] for r in rows]


def write_question_tsv(path, keys):
    """Two question lengths, one to three questions an image."""
    qs = ["what is the color of the dog", "red"]
    rows, qid = [], 100
    for i, k in enumerate(keys):
        items = []
        for j in range(1 + i % 3):
            items.append({"question": qs[(i + j) % 2], "question_id": qid})
            qid += 1
        rows.append([k, gx_common.json_dump(items)])
    gx_tsv_writer(rows, path)


_GX_ENGINES = {}


def engines(transform_kw, gx_transform=None, pt_transform=None, batch_size=3):
    """gitax's engine and the port's (use_native=False on both: exact PIL)
    on the same f32 weights and tiny vocab.  gitax's engine is kept per transform
    setting, with its compiled programs, across the tests of this file."""
    params = tiny_params()
    kw = dict(batch_size=batch_size, max_text_len=40)
    key = (repr(sorted(transform_kw.items())), repr(gx_transform and vars(gx_transform)))
    if key not in _GX_ENGINES:
        _GX_ENGINES[key] = GxEngine(GitModel(TINY), jax.tree_util.tree_map(jnp.asarray, params),
                                    GxTokenizer(gx_tiny_vocab(WORDS)),
                                    gx_transform or gx_tf.TestTransform(**transform_kw),
                                    beam=GxBeam(num_beams=2, max_steps=40), dtype=jnp.float32,
                                    use_native=False, **kw)
    gx = _GX_ENGINES[key]
    pt = pt_engine.CaptionEngine(ckpt.params_from_gitax(params, TINY, device="cpu"),
                                 BertTokenizer(build_tiny_vocab(WORDS)),
                                 beam=BeamSearchConfig(num_beams=2, max_steps=40),
                                 dtype=torch.float32,
                                 transform=pt_transform or pt_tf.TestTransform(**transform_kw),
                                 use_native=False, **kw)
    return gx, pt


def assert_same_tsv(a, b):
    for ext in (".tsv", ".lineidx", ".lineidx.8b"):
        fa, fb = a[:-4] + ext if ext != ".tsv" else a, b[:-4] + ext if ext != ".tsv" else b
        assert filecmp.cmp(fa, fb, shallow=False), (fa, open(fa, "rb").read(),
                                                    open(fb, "rb").read())


# ---------------------------------------------------------------------------
# the TSV loops, byte for byte
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_caption_tsv_matches_gitax_bytes(kind, tmp_path):
    img_tsv = str(tmp_path / "img.tsv")
    write_image_tsv(img_tsv)
    gx, pt = engines(TRANSFORMS[kind])
    gx.run_caption_tsv(img_tsv, str(tmp_path / "gx.tsv"))
    with pt:
        pt.run_caption_tsv(img_tsv, str(tmp_path / "pt.tsv"))
    assert_same_tsv(str(tmp_path / "gx.tsv"), str(tmp_path / "pt.tsv"))
    out = TSVFile(str(tmp_path / "pt.tsv"))
    # the corrupt row is dropped; every other row keeps its key, in order
    assert [out.get_key(i) for i in range(len(out))] == ["k{}".format(i) for i in range(len(SIZES))]
    caps = [json.loads(out[i][1])[0]["caption"] for i in range(len(out))]
    assert len(set(caps)) > 1, caps  # image-dependent captions


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_vqa_tsv_matches_gitax_bytes(kind, tmp_path):
    img_tsv, q_tsv = str(tmp_path / "img.tsv"), str(tmp_path / "q.tsv")
    keys = write_image_tsv(img_tsv)
    write_question_tsv(q_tsv, keys)
    gx, pt = engines(TRANSFORMS[kind])
    gx.run_vqa_tsv(img_tsv, q_tsv, str(tmp_path / "gx.tsv"))
    with pt:
        pt.run_vqa_tsv(img_tsv, q_tsv, str(tmp_path / "pt.tsv"))
    assert_same_tsv(str(tmp_path / "gx.tsv"), str(tmp_path / "pt.tsv"))
    rows = [json.loads(r[0]) for r in TSVFile(str(tmp_path / "pt.tsv"))]
    # the corrupt image's questions are skipped; each other one is answered
    # once, in the reference's row order
    asked = {r[0]: [q["question_id"] for q in json.loads(r[1])] for r in TSVFile(q_tsv)}
    want = [qid for k in keys if k != "bad" for qid in asked[k]]
    assert [r["question_id"] for r in rows] == want


class Uint8Crop(object):
    """A transform that stops before normalising: uint8 crops by `mod`'s
    steps, with the constants the engine then normalises with on the
    device."""

    def __init__(self, tf, mod):
        self.tf, self.mod, self.mean, self.std = tf, mod, tf.mean, tf.std

    def __call__(self, img):
        c = self.tf.crop_size
        return np.asarray(self.mod.center_crop(self.mod.resize_shorter(img, c), c), np.uint8)


@pytest.mark.parametrize("inputs", ["uint8", "float"])
def test_imagenet_transform_matches_gitax_bytes(inputs, tmp_path):
    """A transform with ImageNet's mean and std: the engines normalise
    uint8 batches with its constants on the device, and take its float
    output as it is; the port's TSV equals gitax's either way and differs
    from the CLIP-normalised one (an engine that ignored the transform's
    constants would fail here)."""
    img_tsv = str(tmp_path / "img.tsv")
    write_image_tsv(img_tsv)
    kw = dict(crop_size=32, mean=gx_tf.IMAGENET_MEAN, std=gx_tf.IMAGENET_STD)
    gx_t = gx_tf.TestTransform(**kw)
    pt_t = pt_tf.TestTransform(crop_size=32, mean=pt_tf.IMAGENET_MEAN, std=pt_tf.IMAGENET_STD)
    if inputs == "uint8":
        gx_t, pt_t = Uint8Crop(gx_t, gx_tf), Uint8Crop(pt_t, pt_tf)
    gx, pt = engines({}, gx_transform=gx_t, pt_transform=pt_t)
    gx.run_caption_tsv(img_tsv, str(tmp_path / "gx.tsv"))
    with pt:
        pt.run_caption_tsv(img_tsv, str(tmp_path / "pt.tsv"))
    assert_same_tsv(str(tmp_path / "gx.tsv"), str(tmp_path / "pt.tsv"))
    _, clip = engines({}, pt_transform=pt_tf.TestTransform(crop_size=32))
    with clip:
        clip.run_caption_tsv(img_tsv, str(tmp_path / "clip.tsv"))
    assert open(str(tmp_path / "clip.tsv"), "rb").read() != open(str(tmp_path / "pt.tsv"),
                                                                 "rb").read()


def test_engine_normalises_uint8_with_the_transform_constants():
    _, pt = engines({}, pt_transform=pt_tf.TestTransform(mean=pt_tf.IMAGENET_MEAN,
                                                         std=pt_tf.IMAGENET_STD))
    assert torch.equal(pt.mean, torch.from_numpy(pt_tf.IMAGENET_MEAN))
    assert torch.equal(pt.std, torch.from_numpy(pt_tf.IMAGENET_STD))
    bare = pt_engine.CaptionEngine(pt.model, pt.tokenizer)
    assert torch.equal(bare.mean, torch.from_numpy(pt_tf.CLIP_MEAN))
    with pytest.raises(ValueError, match="transform"):
        bare.run_caption_tsv("unused.tsv", "unused_out.tsv")
    pt.close()
    bare.close()
    assert pt.pool._shutdown and bare.pool._shutdown


@pytest.mark.parametrize("loop", ["caption", "vqa"])
def test_sharded_tsv_matches_gitax_bytes(loop, tmp_path):
    """world_size 3, ranks run one after another (rank 0 last: it
    concatenates, through the file-system barrier): every shard and the
    concatenation equal gitax's."""
    img_tsv, q_tsv = str(tmp_path / "img.tsv"), str(tmp_path / "q.tsv")
    keys = write_image_tsv(img_tsv)
    write_question_tsv(q_tsv, keys)
    gx, pt = engines(TRANSFORMS["crop"])
    for name, eng in (("gx", gx), ("pt", pt)):
        for rank in (1, 2, 0):
            out = str(tmp_path / (name + ".tsv"))
            if loop == "caption":
                eng.run_caption_tsv(img_tsv, out, rank=rank, world_size=3)
            else:
                eng.run_vqa_tsv(img_tsv, q_tsv, out, rank=rank, world_size=3)
    pt.close()
    for rank in range(3):
        assert_same_tsv(str(tmp_path / "gx.tsv.{}.3.tsv".format(rank)),
                        str(tmp_path / "pt.tsv.{}.3.tsv".format(rank)))
    assert_same_tsv(str(tmp_path / "gx.tsv"), str(tmp_path / "pt.tsv"))


def test_wait_and_concat_times_out(tmp_path):
    with pytest.raises(TimeoutError):
        pt_engine.wait_and_concat_shards(str(tmp_path / "o.tsv"), 2, poll_s=0.05, timeout_s=0.2)


def test_caption_tsv_without_pil_raises(tmp_path, monkeypatch):
    """Without PIL the loop raises, naming it, instead of counting every
    row as undecodable and writing an empty TSV."""
    img_tsv = str(tmp_path / "img.tsv")
    write_image_tsv(img_tsv, sizes=SIZES[:2], corrupt=False)
    _, pt = engines(TRANSFORMS["crop"])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pt, pytest.raises(ImportError, match="PIL"):
        pt.run_caption_tsv(img_tsv, str(tmp_path / "pt.tsv"))


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def test_json_dump_and_shard_range_match_gitax():
    for obj in ([{"caption": "a b", "z": 1, "a": [1, 2.5]}], {"answer": "x", "question_id": 7},
                {"k": "é\t\"q\""}):
        assert common.json_dump(obj) == gx_common.json_dump(obj)
    for total in (0, 1, 2, 7, 10, 101):
        for world in (1, 2, 3, 4, 8):
            for rank in range(world):
                assert pt_engine.shard_range(total, rank, world) == \
                    gx_pipeline.shard_range(total, rank, world)


@pytest.mark.parametrize("env", [{}, {"RANK": "2", "WORLD_SIZE": "5"},
                                 {"OMPI_COMM_WORLD_RANK": "1", "OMPI_COMM_WORLD_SIZE": "3",
                                  "OMPI_COMM_WORLD_LOCAL_RANK": "1"},
                                 {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "3"}])
def test_env_ranks_match_gitax(env, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert common.get_mpi_rank() == gx_common.get_mpi_rank()
    assert common.get_mpi_size() == gx_common.get_mpi_size()
    assert common.get_mpi_local_rank() == gx_common.get_mpi_local_rank()


def test_list_file_yaml_and_args_match_gitax(tmp_path):
    p = tmp_path / "names.txt"
    p.write_text("hot dog\n  red fox \n\ndog\n")
    assert common.load_list_file(str(p)) == gx_common.load_list_file(str(p))
    (tmp_path / "base.yaml").write_text("a: 1\nb: {c: 2, d: 3}\n")
    (tmp_path / "child.yaml").write_text("_base_: base.yaml\nb: {c: 5}\n")
    assert common.load_from_yaml_file(str(tmp_path / "child.yaml")) == \
        gx_common.load_from_yaml_file(str(tmp_path / "child.yaml"))
    argv = ["-c", str(tmp_path / "base.yaml"), "-p",
            "{'type': 'f', 'a': 4, 'x$y': 5, 'image_path': 'a.png'}",
            "-bp", base64.b64encode(b"b: 9\n").decode()]
    assert common.parse_general_args(argv) == gx_common.parse_general_args(argv)
    common.write_to_file("x\ty", str(tmp_path / "d" / "o.txt"))
    assert (tmp_path / "d" / "o.txt").read_bytes() == b"x\ty"


# sizes above, at and below the crop, both orientations
CROP_SIZES = [(50, 40), (40, 50), (32, 32), (32, 45), (45, 32), (20, 25), (25, 20), (10, 40),
              (40, 10)]


@pytest.mark.parametrize("size", CROP_SIZES)
def test_transforms_match_gitax(size):
    """resize_shorter, center_crop (with its zero pad), min_max_resize and
    TestTransform equal gitax's."""
    pil = Image.fromarray(np.random.RandomState(size[0] * 7 + size[1]).randint(
        0, 255, (size[1], size[0], 3), dtype=np.uint8))
    crop = 32
    assert np.array_equal(np.asarray(pt_tf.resize_shorter(pil, crop)),
                          np.asarray(gx_tf.resize_shorter(pil, crop)))
    for c in (crop, 16, 48):
        assert np.array_equal(np.asarray(pt_tf.center_crop(pil, c)),
                              np.asarray(gx_tf.center_crop(pil, c)))
    for lo, hi in ((32, 48), (24, 30), (40, 64)):
        assert np.array_equal(np.asarray(pt_tf.min_max_resize(pil, lo, hi)),
                              np.asarray(gx_tf.min_max_resize(pil, lo, hi)))
    for kw in (dict(crop_size=crop), dict(crop_size=crop, respect_ratio_max=48),
               dict(crop_size=crop, mean=gx_tf.IMAGENET_MEAN, std=gx_tf.IMAGENET_STD)):
        assert np.array_equal(pt_tf.TestTransform(**kw)(pil), gx_tf.TestTransform(**kw)(pil))
    assert np.array_equal(pt_tf.to_normalized_array(pil), gx_tf.to_normalized_array(pil))


@pytest.mark.parametrize("case", ["load_bytes", "load_path", "base64_jpeg", "base64_png",
                                  "base64_corrupt", "transform"])
def test_without_pil_decoders_raise(case, tmp_path, monkeypatch):
    """Without PIL every decode and resize raises an ImportError naming
    it; none gives None, which the TSV loops would count as a bad row."""
    png = image_bytes(0, (16, 16), "PNG")
    path = tmp_path / "x.png"
    path.write_bytes(png)
    pil = Image.open(io.BytesIO(png)).convert("RGB")
    calls = {"load_bytes": lambda: pt_image.load_image(png),
             "load_path": lambda: pt_image.load_image(str(path)),
             "base64_jpeg": lambda: pt_image.image_from_base64(
                 base64.b64encode(image_bytes(0, (16, 16), "JPEG"))),
             "base64_png": lambda: pt_image.image_from_base64(base64.b64encode(png)),
             "base64_corrupt": lambda: pt_image.image_from_base64(b"!!!corrupt!!!"),
             "transform": lambda: pt_tf.TestTransform(crop_size=24)(pil)}
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="PIL"):
        calls[case]()


# ---------------------------------------------------------------------------
# the decoders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,mode", [("JPEG", "RGB"), ("JPEG", "L"), ("PNG", "RGB"),
                                      ("PNG", "L"), ("PNG", "LA"), ("PNG", "RGBA"),
                                      ("corrupt", None)])
def test_with_pil_decodes_as_gitax(fmt, mode, tmp_path):
    """load_image (bytes and path) and image_from_base64 give gitax's RGB
    images; a corrupt payload gives None from both."""
    from gitax.io.image import image_from_base64 as gx_from_base64
    from gitax.io.image import load_image as gx_load_image

    if fmt == "corrupt":
        assert pt_image.image_from_base64(b"!!!corrupt!!!") is None
        assert gx_from_base64(b"!!!corrupt!!!") is None
        with pytest.raises(TypeError):
            pt_image.load_image(3)
        return
    data = image_bytes(5, (21, 17), fmt, mode=mode)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    b64 = base64.b64encode(data)
    got = [pt_image.load_image(data), pt_image.load_image(str(path)),
           pt_image.image_from_base64(b64)]
    want = np.asarray(gx_load_image(data))
    assert want.shape == (17, 21, 3)
    for img in got:
        assert img.mode == "RGB" and np.array_equal(np.asarray(img), want)
    assert np.array_equal(np.asarray(got[2]), np.asarray(gx_from_base64(b64)))


_RANK_SCRIPT = """
import sys
from gitax_torch.common import get_mpi_rank, get_mpi_size
from gitax_torch.io.tsv import tsv_writer
from gitax_torch.runtime import distributed, engine
assert distributed.initialize() and distributed.is_active()
rank, world = get_mpi_rank(), get_mpi_size()
out = sys.argv[1]
tsv_writer([["r{}k{}".format(rank, i), "v"] for i in range(rank + 2)],
           "{}.{}.{}.tsv".format(out, rank, world))
engine.finish_shards(out, rank, world)
"""


def test_finish_shards_meets_at_a_process_group(tmp_path):
    """Two processes joined by torch.distributed (gloo, from RANK,
    WORLD_SIZE and COORDINATOR_ADDRESS): each writes its shard, both meet
    at the barrier, and rank 0 concatenates without polling."""
    import os
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = str(tmp_path / "o.tsv")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, out], cwd=repo,
                              env=dict(os.environ, PYTHONPATH=repo, RANK=str(r), WORLD_SIZE="2",
                                       COORDINATOR_ADDRESS="localhost:{}".format(port),
                                       GITAX_SHARD_POLL_S="1000"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (1, 0)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert [TSVFile(out).get_key(i) for i in range(5)] == ["r0k0", "r0k1", "r1k0", "r1k1", "r1k2"]
