"""The port's `-p` CLI (gitax_torch/inference.py) against gitax's
(gitax/inference.py) on the same f32 checkpoint (CPU): a reference-style
`output/{model}/snapshot/model.pt` written from gitax params with
`export_git_state_dict`, both CLIs' configs monkeypatched to gitax
tests/test_pipeline.py's TINY as tests/test_integration_workflow.py does.
`test_git_inference_single_tsv` writes identical TSVs (caption and VQA),
`test_git_inference_single_image` returns identical strings (one PNG, a
clip of 2 frames, trie classification), the converters write identical
files, the checkpoint helpers equal gitax's, and the refusals raise
(`use_native=True` where the native loader did not build, a launch that
is not a multiple of the mesh)."""

import base64
import dataclasses
import filecmp
import functools
import io
import json
import logging

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

import gitax.inference as gx_inf
from gitax.ckpt import torch_convert as gx_convert
from gitax.io.tsv import tsv_writer
from gitax.models import GitConfig as GxConfig
from gitax.models import GitModel as GxModel
from gitax.models import ViTConfig as GxViT
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt, common
from gitax_torch import inference as pt_inf
from gitax_torch.models.config import GitConfig, ViTConfig
from gitax_torch.models.git import eos_gate_params
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TINY_KW = dict(visual_feature_size=64, vocab_size=30522, hidden_size=48, num_layers=2,
               num_heads=4, feedforward_size=96, max_caption_length=1024)
WORDS = ["dog", "cat", "truck", "red", "what", "is", "the", "color"]


def configs(frames=0):
    """(gitax config, port config) of the same TINY model."""
    return (GxConfig(encoder=GxViT(16, 64, 2, 2, 32), num_image_with_embedding=frames, **TINY_KW),
            GitConfig(encoder=ViTConfig(16, 64, 2, 2, 32), num_image_with_embedding=frames,
                      **TINY_KW))


@functools.lru_cache(maxsize=None)
def state_dict(frames=0):
    """A reference-style state dict ('module.' prefixes, as published
    checkpoints have them) of sharpened, EOS-gated TINY weights."""
    gx_cfg, _ = configs(frames)
    params = GxModel(gx_cfg).init_params(jax.random.PRNGKey(2))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    emb = tx["embedding"]
    emb["words"] = jnp.asarray(eos_gate_params(np.asarray(emb["words"]) * 3.0,
                                               np.asarray(emb["positions"]), gate=6))
    if frames:
        params["img_temporal_embedding"] = jnp.asarray(
            np.random.RandomState(5).randn(frames, 64).astype(np.float32) * 0.5)
    return {"module." + k: torch.from_numpy(np.array(v))
            for k, v in gx_convert.export_git_state_dict(params, gx_cfg).items()}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """cwd with output/M/snapshot/model.pt and aux_data/models/M/parameter.yaml
    (32 px) for M in TINY_CAP and TINY_VID; both CLIs' configs patched."""
    monkeypatch.chdir(tmp_path)
    for name, frames in (("TINY_CAP", 0), ("TINY_VID", 2)):
        snap = tmp_path / "output" / name / "snapshot"
        snap.mkdir(parents=True)
        torch.save({"model": state_dict(frames)}, str(snap / "model.pt"))
        aux = tmp_path / "aux_data" / "models" / name
        aux.mkdir(parents=True)
        (aux / "parameter.yaml").write_text("test_crop_size: 32\nframes: {}\n".format(frames))
    monkeypatch.setattr("gitax.models.git.config_from_param",
                        lambda param=None: configs((param or {}).get("frames", 0))[0])
    monkeypatch.setattr(pt_inf, "config_from_param",
                        lambda param=None: configs((param or {}).get("frames", 0))[1])
    return tmp_path


def png_file(path, seed, size=(40, 36)):
    Image.fromarray(np.random.RandomState(seed).randint(0, 255, (size[1], size[0], 3),
                                                         dtype=np.uint8)).save(path)
    return str(path)


def image_tsv(path, n=5, flat=False):
    """n rows, JPEG and PNG in turn; noise images, or (flat) one colour
    each plus a little noise."""
    rows = []
    for i in range(n):
        rng = np.random.RandomState(i)
        shape = (36 + 4 * i, 40, 3)
        if flat:
            pix = rng.randint(0, 256, 3) + rng.randint(-8, 9, shape)
        else:
            pix = rng.randint(0, 255, shape)
        buf = io.BytesIO()
        Image.fromarray(np.clip(pix, 0, 255).astype(np.uint8)).save(
            buf, format="PNG" if i % 2 else "JPEG")
        rows.append(["im{}".format(i), base64.b64encode(buf.getvalue())])
    tsv_writer(rows, path)
    return [r[0] for r in rows]


def same_files(a, b):
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("loop", ["caption", "vqa", "caption_flat"])
def test_single_tsv_matches_gitax_bytes(loop, workdir, caplog):
    """caption_flat: images of one colour plus a little noise, on which
    the search can end at its first step (EOS first: an empty caption, as
    on the card): gitax writes the same rows, empty captions included."""
    keys = image_tsv("img.tsv", n=16 if loop == "caption_flat" else 5,
                     flat=loop == "caption_flat")
    q_tsv = None
    if loop == "vqa":
        q_tsv = "q.tsv"
        tsv_writer([[k, json.dumps([{"question": "what is the color", "question_id": 2 * i},
                                    {"question": "red", "question_id": 2 * i + 1}])]
                    for i, k in enumerate(keys)], q_tsv)
    gx_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", q_tsv, "gx.tsv", batch_size=2,
                                         dtype="float32", use_native=False)
    caplog.set_level(logging.INFO)
    pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", q_tsv, "pt.tsv", batch_size=2,
                                         dtype="float32", use_native=False, device="cpu")
    # the checkpoint was loaded, not a random init
    assert any("loading output/TINY_CAP/snapshot/model.pt" in r.getMessage()
               for r in caplog.records)
    for ext in (".tsv", ".lineidx", ".lineidx.8b"):
        assert same_files("gx" + ext, "pt" + ext), ext
    rows = open("pt.tsv").read().splitlines()
    assert len(rows) == (2 * len(keys) if loop == "vqa" else len(keys))
    if loop == "caption_flat":
        caps = [json.loads(r.split("\t")[1])[0]["caption"] for r in rows]
        assert "" in caps and len(set(caps)) > 2, caps


@pytest.mark.parametrize("case", ["image", "frames", "trie"])
def test_single_image_matches_gitax(case, workdir, monkeypatch):
    frames = [png_file(workdir / "f{}.png".format(i), i) for i in range(2)]
    model, path, kw = "TINY_CAP", frames[0], {}
    if case == "frames":
        model, path = "TINY_VID", frames
    if case == "trie":
        (workdir / "names.txt").write_text("dog\ncat\ntruck\nred truck\n")
        kw = dict(vocab_file="names.txt")
        monkeypatch.setattr(gx_inf, "_load_tokenizer",
                            lambda: GxTokenizer(gx_tiny_vocab(WORDS)))
        monkeypatch.setattr(pt_inf, "_load_tokenizer",
                            lambda: BertTokenizer(build_tiny_vocab(WORDS)))
    want = gx_inf.test_git_inference_single_image(path, model, "", **kw)
    got = pt_inf.test_git_inference_single_image(path, model, "", device="cpu", **kw)
    assert isinstance(got, str) and got == want
    if case == "trie":
        assert got in ("dog", "cat", "truck", "red truck")


def test_dispatch_main_runs_the_port(workdir, monkeypatch):
    """`python -m gitax_torch.inference -p ...`'s body, in process: the
    -p YAML names the function and its arguments."""
    path = png_file(workdir / "x.png", 7)
    monkeypatch.setattr(common, "init_logging", lambda level=None: None)
    argv = ["-p", "{{'type': 'test_git_inference_single_image', 'image_path': '{}', "
                  "'model_name': 'TINY_CAP', 'prefix': 'what is', 'device': 'cpu'}}".format(path)]
    got = common.dispatch_main(vars(pt_inf), argv)
    assert got == gx_inf.test_git_inference_single_image(path, "TINY_CAP", "what is")


def test_converters_match_gitax(tmp_path):
    pred = str(tmp_path / "pred.tsv")
    tsv_writer([["a", json.dumps([{"caption": "x y"}])], ["b", json.dumps([])],
                ["c", json.dumps([{"caption": "é z"}])]], pred)
    ans = str(tmp_path / "ans.tsv")
    tsv_writer([[json.dumps({"answer": "red", "question_id": 3})],
                [json.dumps({"answer": "", "question_id": 1})]], ans)
    gt = [("a", json.dumps([{"caption": "p q"}, {"caption": "r"}])), ("b", json.dumps([]))]
    for mod, tag in ((gx_inf, "gx"), (pt_inf, "pt")):
        mod.convert_tsv_to_vqa_json(ans, str(tmp_path / (tag + ".vqa.json")))
        mod.convert_tsv_to_coco_format(pred, str(tmp_path / (tag + ".coco.json")))
        mod.iter_caption_to_json(iter(gt), str(tmp_path / (tag + ".gt.json")))
    for name in ("vqa", "coco", "gt"):
        assert same_files(str(tmp_path / "gx.{}.json".format(name)),
                          str(tmp_path / "pt.{}.json".format(name))), name


def test_checkpoint_helpers_match_gitax(tmp_path):
    sd = state_dict()
    path = str(tmp_path / "model.pt")
    torch.save({"model": sd}, path)
    ours, theirs = ckpt.load_torch_checkpoint(path), gx_convert.load_torch_checkpoint(path)
    assert sorted(ours) == sorted(theirs) and not any(k.startswith("module.") for k in ours)
    torch.save({k[len("module."):]: v for k, v in sd.items()}, path)  # a bare state dict
    assert sorted(ckpt.load_torch_checkpoint(path)) == sorted(ours)
    (kind, enc), (gx_kind, gx_enc) = (ckpt.infer_visual_config(ours, "image_encoder."),
                                      gx_convert.infer_visual_config(theirs, "image_encoder."))
    assert kind == gx_kind == "vit" and dataclasses.asdict(enc) == dataclasses.asdict(gx_enc)
    _, cfg = configs()
    expected = list(pt_inf.GitModel(cfg, device="cpu").state_dict())
    wrapped = {"wrap." + k: v for k, v in ours.items()}
    got = ckpt.align_by_suffix(expected, wrapped)
    want = gx_convert.align_by_suffix(expected, wrapped)
    assert sorted(got) == sorted(want) == sorted(expected)
    assert all(got[k] is want[k] for k in got)
    # neither a ViT nor a whole ResNet: both read the ResNet's keys and miss
    partial = {"visual.conv1.weight": torch.zeros(1)}
    for infer in (ckpt.infer_visual_config, gx_convert.infer_visual_config):
        with pytest.raises(KeyError, match="layer1.0.conv1.weight"):
            infer(partial)


def test_build_model_loads_the_checkpoint_or_falls_back(workdir, caplog):
    _, cfg = configs()
    model = pt_inf._build_model("TINY_CAP", {}, device="cpu")
    ref = ckpt.load_git_state_dict(pt_inf.GitModel(cfg, device="cpu"),
                                   {k[len("module."):]: v for k, v in state_dict().items()})
    for (k, a), (_, b) in zip(model.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k
    bf16 = pt_inf._build_model("TINY_CAP", {}, dtype=torch.bfloat16, device="cpu")
    assert bf16.textual.output.bias.dtype == torch.bfloat16
    caplog.set_level(logging.WARNING)
    a = pt_inf._build_model("NO_SUCH_MODEL", {}, device="cpu")
    b = pt_inf._build_model("NO_SUCH_MODEL", {}, device="cpu")
    assert any("random init" in r.getMessage() for r in caplog.records)
    assert torch.equal(a.textual.embedding.words.weight, b.textual.embedding.words.weight)


def test_cli_runs_on_the_card_unless_told_otherwise(workdir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_inf._build_model("TINY_CAP", {})
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "o.tsv")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt_inf.test_git_inference_single_image(png_file(workdir / "y.png", 1), "TINY_CAP")


def test_cli_refuses_what_is_not_ported(workdir, monkeypatch):
    """use_native=True where the native loader did not build raises,
    naming the build's reason; so does mesh_shape under a launch that is
    not a multiple of its data x model ranks (row shards over hosts take
    hosts of data x model ranks each), before any rank starts."""
    from gitax_torch import native

    with monkeypatch.context() as mp:
        mp.setattr(native, "_module", None)
        mp.setattr(native, "_error", "RuntimeError: g++ exit 1: jpeglib.h missing")
        with pytest.raises(RuntimeError, match="use_native=True: the native loader did not "
                                               "build.*jpeglib.h"):
            pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "o.tsv",
                                                 use_native=True, device="cpu")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="row shards over hosts"):
        pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "o.tsv",
                                             mesh_shape=2, device="cpu")
    with pytest.raises(ValueError, match="row shards over hosts"):
        pt_inf.test_git_inference_single_image(png_file(workdir / "x.png", 1), "TINY_CAP",
                                               mesh_shape=[1, 2], device="cpu")


def test_cli_imports_without_pil_or_yaml():
    """The CLI, the engine and the decoders import without PIL and PyYAML
    (each is imported only where a call needs it); a decode without PIL
    raises an ImportError naming it."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\nsys.modules['PIL'] = None\nsys.modules['yaml'] = None\n"
            "import gitax_torch.inference, gitax_torch.runtime.engine\n"
            "from gitax_torch.io import image\ntry:\n    image.load_image(b'')\n"
            "except ImportError as e:\n    assert 'PIL' in str(e)\nelse:\n    raise SystemExit(1)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ, PYTHONPATH=repo))
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("env,device,want", [
    ({}, None, "cuda"),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, None, "cuda:1"),
    ({"OMPI_COMM_WORLD_RANK": "5", "OMPI_COMM_WORLD_SIZE": "8",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1"}, None, "cuda:1"),
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cpu", "cpu")])
def test_cli_process_owns_its_local_card(env, device, want, monkeypatch):
    """Under RANK/WORLD_SIZE row sharding each process takes the card of
    its local rank and makes it current (CUDA mocked); a named device
    wins."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    made_current = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", made_current.append)
    assert pt_inf._process_device(device) == torch.device(want)
    assert made_current == ([torch.device(want)] if ":" in want else [])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if device is None:
        with pytest.raises(RuntimeError, match="CUDA"):
            pt_inf._process_device(device)
