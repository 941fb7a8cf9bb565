"""The port's native loader (`gitax_torch/native`) and the engine's
`use_native` against gitax's (CPU): the C++ source is gitax's but for the
module's init name; its outputs are byte-equal to gitax's loader (fixed
crop and MinMax, fast_scale on and off, corrupt rows, raw JPEG,
`b64_decode`); the caption and VQA TSVs of `CaptionEngine(use_native=True)`
are byte-identical to gitax's engine with `use_native=True`; and the
rule for None, True and False, with the build's reason where it did not
build.  Skipped only where a loader did not build, as gitax's
tests/test_native_loader.py skips."""

import base64
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax import native as gx_native
from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitModel
from gitax.preprocess import transforms as gx_tf
from gitax.runtime import CaptionEngine as GxEngine
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt, native
from gitax_torch import inference as pt_inf
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.preprocess import transforms as pt_tf
from gitax_torch.runtime import engine as pt_engine
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
from test_torch_port_tsv import (SIZES, TINY, TRANSFORMS, WORDS, assert_same_tsv, image_bytes,
                                 tiny_params, write_image_tsv, write_question_tsv)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
built = pytest.mark.skipif(not (native.available() and gx_native.available()),
                           reason="native toolchain/libjpeg unavailable")


def test_source_is_gitax_s_but_for_the_init_name():
    ours = open(os.path.join(REPO, "gitax_torch", "native", "dataloader.cpp")).read()
    theirs = open(os.path.join(REPO, "gitax", "native", "dataloader.cpp")).read()
    assert '"_gitax_torch_native"' in ours and "PyInit__gitax_torch_native" in ours
    assert ours.replace("_gitax_torch_native", "_gitax_native") == theirs


def test_builds_outside_the_package():
    """The object goes to build/gitax_torch/ (gitignored), keyed by the
    source's hash; nothing is written beside the source."""
    assert native.so_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "gitax_torch")
    if native.available():
        assert native.so_path().is_file()
    assert sorted(os.listdir(os.path.join(REPO, "gitax_torch", "native"))) in (
        ["__init__.py", "dataloader.cpp"], ["__init__.py", "__pycache__", "dataloader.cpp"])


def payloads():
    """JPEGs of several sizes (one large enough for the reduced-scale
    IDCT), a PNG (libjpeg refuses it) and a corrupt row, base64."""
    raw = [image_bytes(i, s, f) for i, (s, f) in enumerate(SIZES)]
    raw.append(image_bytes(9, (900, 700), "JPEG"))
    out = [base64.b64encode(r) for r in raw]
    out.insert(2, b"!!!corrupt!!!")
    return out


@built
@pytest.mark.parametrize("fast_scale", [True, False])
@pytest.mark.parametrize("threads", [1, 3])
def test_fixed_crop_equals_gitax_bytes(fast_scale, threads):
    rows = payloads()
    a, ok = native.decode_resize_crop_batch(rows, 32, threads=threads, fast_scale=fast_scale)
    b, gx_ok = gx_native.decode_resize_crop_batch(rows, 32, threads=threads,
                                                  fast_scale=fast_scale)
    assert a.dtype == np.uint8 and a.shape == (len(rows), 32, 32, 3)
    assert np.array_equal(a, b) and np.array_equal(ok, gx_ok)
    assert not ok[2] and ok.sum() == len(rows) - 1 - sum(f == "PNG" for _, f in SIZES)
    assert not a[2].any()  # a failed row stays zero


@built
@pytest.mark.parametrize("fast_scale", [True, False])
def test_minmax_equals_gitax_bytes(fast_scale):
    rows = payloads()
    got = native.decode_minmax_batch(rows, 32, 48, fast_scale=fast_scale)
    want = gx_native.decode_minmax_batch(rows, 32, 48, fast_scale=fast_scale)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g.dtype == np.uint8 and g.shape == w.shape and np.array_equal(g, w)
    sizes = [g.shape[:2] for g in got if g is not None]
    assert len(set(sizes)) > 1  # each image at its own MinMax size


@built
def test_raw_jpeg_and_b64_decode_equal_gitax():
    raw = [image_bytes(0, (40, 50), "JPEG"), image_bytes(1, (64, 48), "JPEG"), b"not a jpeg"]
    a, ok = native.decode_resize_crop_batch(raw, 24, is_base64=False)
    b, gx_ok = gx_native.decode_resize_crop_batch(raw, 24, is_base64=False)
    assert np.array_equal(a, b) and ok.tolist() == gx_ok.tolist() == [True, True, False]
    for payload in (base64.b64encode(b"hello native world"), b"!!!", b"", base64.b64encode(
            raw[0])):
        assert native.b64_decode(payload) == gx_native.b64_decode(payload)
    assert native.b64_decode(base64.b64encode(raw[1])) == raw[1]


# ---------------------------------------------------------------------------
# the engine's use_native
# ---------------------------------------------------------------------------


def engines(kind, batch_size=3):
    """gitax's engine and the port's on the same f32 weights, both with
    the native loader."""
    params = tiny_params()
    kw = dict(batch_size=batch_size, max_text_len=40)
    gx = GxEngine(GitModel(TINY), jax.tree_util.tree_map(jnp.asarray, params),
                  GxTokenizer(gx_tiny_vocab(WORDS)), gx_tf.TestTransform(**TRANSFORMS[kind]),
                  beam=GxBeam(num_beams=2, max_steps=40), dtype=jnp.float32, use_native=True,
                  **kw)
    pt = pt_engine.CaptionEngine(ckpt.params_from_gitax(params, TINY, device="cpu"),
                                 BertTokenizer(build_tiny_vocab(WORDS)),
                                 beam=BeamSearchConfig(num_beams=2, max_steps=40),
                                 dtype=torch.float32,
                                 transform=pt_tf.TestTransform(**TRANSFORMS[kind]),
                                 use_native=True, **kw)
    return gx, pt


def big_sizes():
    """SIZES plus a large JPEG, where fast_scale's reduced IDCT applies."""
    return SIZES + [((400, 300), "JPEG")]


@built
@pytest.mark.parametrize("loop", ["caption", "vqa"])
@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_native_tsv_matches_gitax_bytes(kind, loop, tmp_path):
    """use_native=True on both sides: uint8 batches from the native
    decode (PIL for the PNG rows, the corrupt row dropped), normalised on
    the device; byte-identical TSVs, and other bytes than the PIL path's
    (the loader's pixels are not PIL's)."""
    img_tsv, q_tsv = str(tmp_path / "img.tsv"), str(tmp_path / "q.tsv")
    keys = write_image_tsv(img_tsv, sizes=big_sizes())
    write_question_tsv(q_tsv, keys)
    gx, pt = engines(kind)
    assert gx.use_native and pt.use_native
    decoded = pt._decode_chunk([b"!!!corrupt!!!", base64.b64encode(image_bytes(1, (32, 32),
                                                                               "PNG"))])
    assert decoded[0] is None and decoded[1].dtype == np.uint8
    out = {}
    for name, eng in (("gx", gx), ("pt", pt)):
        out[name] = str(tmp_path / (name + ".tsv"))
        if loop == "caption":
            eng.run_caption_tsv(img_tsv, out[name])
        else:
            eng.run_vqa_tsv(img_tsv, q_tsv, out[name])
    pt.close()
    assert_same_tsv(out["gx"], out["pt"])
    assert len(open(out["pt"]).read().splitlines()) > 1


@built
def test_native_and_pil_decode_differ():
    """The loader's uint8 pixels are close to PIL's but not PIL's, which is
    why the PIL path's byte tests pass use_native=False on both sides."""
    _, pt = engines("crop")
    rows = [base64.b64encode(image_bytes(0, (40, 50), "JPEG"))]
    nat = pt._decode_chunk(rows)[0]
    pt.use_native = False
    pil = pt._decode_chunk(rows)[0]
    pt.close()
    back = (pil * pt_tf.CLIP_STD + pt_tf.CLIP_MEAN) * 255.0
    diff = np.abs(nat.astype(np.float64) - back)
    assert nat.shape == pil.shape and diff.max() <= 3 and diff.max() > 0.5


def test_use_native_rule(monkeypatch):
    """None: the loader where it built, else PIL; True: the loader, or an
    error naming the build's reason; False: PIL, without building."""
    assert pt_engine.resolve_use_native(False) is False
    assert pt_engine.resolve_use_native(None) is native.available()
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: g++ exit 1: fatal error: jpeglib.h: "
                                          "No such file or directory")
    assert native.available() is False and "jpeglib.h" in native.unavailable_reason()
    assert pt_engine.resolve_use_native(None) is False
    with pytest.raises(RuntimeError, match="native loader did not build.*jpeglib.h"):
        pt_engine.resolve_use_native(True)
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        native.decode_resize_crop_batch([b""], 8)
    params = tiny_params()
    model = ckpt.params_from_gitax(params, TINY, device="cpu")
    eng = pt_engine.CaptionEngine(model, None, use_native=None)
    assert eng.use_native is False
    eng.close()
    with pytest.raises(RuntimeError, match="jpeglib.h"):
        pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "o.tsv",
                                             use_native=True, device="cpu")


def test_a_failed_build_names_its_reason(monkeypatch, tmp_path):
    """A compiler that fails leaves available() False and the reason
    readable; nothing half-written stays in the build directory."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "g++").write_text("#!/bin/sh\necho 'dataloader.cpp:22: fatal error: jpeglib.h: No "
                              "such file or directory' >&2\nexit 1\n")
    (fake / "g++").chmod(0o755)
    monkeypatch.setenv("PATH", str(fake) + os.pathsep + os.environ["PATH"])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_error", None)
    assert native.available() is False
    assert "g++ exit 1" in native.unavailable_reason()
    assert "jpeglib.h" in native.unavailable_reason()
    assert os.listdir(tmp_path / "build") == []
