"""The reference-checkpoint writer: `ckpt.torch_convert.export_git_state_dict`
and `ckpt.save_reference_checkpoint` against gitax's (CPU, f32).

* the export of a port model equals gitax's `export_git_state_dict` of
  the same weights, names and values bit for bit, the video's temporal
  embedding included;
* gitax's `convert_git_state_dict` reads the port's file back to the
  params it started from;
* a port fine-tune written with `save_reference_checkpoint` as
  output/{model}/snapshot/model.pt is served by the port's `-p` CLI with
  the in-memory model's captions;
* an int8 model (weight-only or w8a8) refuses, naming its layers.
"""

import os

import jax
import numpy as np
import pytest
import torch

from gitax.ckpt.torch_convert import convert_git_state_dict as gx_convert_git_state_dict
from gitax.ckpt.torch_convert import export_git_state_dict as gx_export_git_state_dict
from gitax.ckpt.torch_convert import load_torch_checkpoint as gx_load_torch_checkpoint
from gitax.models import GitModel
from gitax_torch import ckpt
from gitax_torch import inference as pt_inf
from gitax_torch.ckpt.torch_convert import export_git_state_dict
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.ops.quant import quantize_git_model_
from gitax_torch.preprocess.transforms import get_image_transform
from gitax_torch.runtime.engine import CaptionEngine
from gitax_torch.training import run_finetune
from test_torch_port_cli import configs, image_tsv, state_dict, workdir  # noqa: F401
from test_torch_port_finetune import fixture_tsvs


def gitax_params(frames):
    """gitax's TINY params; the video's temporal embedding non-zero."""
    params = jax.tree_util.tree_map(np.asarray, GitModel(configs(frames)[0]).init_params(
        jax.random.PRNGKey(7)))
    if frames:
        params["img_temporal_embedding"] = np.random.RandomState(8).randn(
            frames, 64).astype(np.float32)
    return params


@pytest.mark.parametrize("frames", [0, 2], ids=["image", "video"])
def test_export_equals_gitax_bit_for_bit(frames):
    params = gitax_params(frames)
    want = gx_export_git_state_dict(params, configs(frames)[0])
    got = export_git_state_dict(ckpt.params_from_gitax(params, configs(frames)[1], device="cpu"))
    assert list(got) == list(want) or sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint32), v.view(np.uint32), err_msg=k)
    if frames:
        assert got["img_temperal_embedding.1"].shape == (1, 1, 64)
    # the tied head is a copy: writing the export does not touch the model
    assert not np.shares_memory(got["textual.output.weight"],
                                got["textual.embedding.words.weight"])


@pytest.mark.parametrize("frames", [0, 2], ids=["image", "video"])
def test_gitax_reads_the_ports_file_back(tmp_path, frames):
    params = gitax_params(frames)
    model = ckpt.params_from_gitax(params, configs(frames)[1], device="cpu")
    path = ckpt.save_reference_checkpoint(str(tmp_path / "out" / "model.pt"), model)
    assert os.listdir(str(tmp_path / "out")) == ["model.pt"]  # no temporary left
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert set(blob) == {"model"}
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in blob["model"].values())
    back = gx_convert_git_state_dict(gx_load_torch_checkpoint(path), configs(frames)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat_back) == len(flat)
    for key, leaf in flat:
        np.testing.assert_array_equal(np.asarray(flat_back[key]), np.asarray(leaf),
                                      err_msg=str(key))


def test_finetune_then_cli_gives_the_in_memory_captions(workdir, tmp_path_factory):  # noqa: F811
    """Fine-tune the CLI's TINY_CAP model with the port for 2 steps, write
    it with save_reference_checkpoint over output/TINY_CAP/snapshot/
    model.pt, then the `-p` CLI's TSV holds the in-memory model's
    captions, byte for byte."""
    model = ckpt.load_git_state_dict(
        pt_inf.GitModel(configs()[1], device="cpu"),
        {k[len("module."):]: v for k, v in state_dict().items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tok = pt_inf._load_tokenizer()
    img_tsv, cap_tsv = fixture_tsvs(tmp_path_factory.mktemp("train"))
    state = run_finetune(img_tsv, cap_tsv, model, num_steps=2, batch_size=2, multi_scale=False,
                         train_crop_size=32, dtype=torch.float32, tokenizer=tok, warmup_steps=1,
                         learning_rate=1e-3, log_every=1)
    tuned = state.model.trainable_(False)
    assert not torch.equal(tuned.state_dict()["textual.output.bias"], before["textual.output.bias"])
    ckpt.save_reference_checkpoint("output/TINY_CAP/snapshot/model.pt", tuned)
    image_tsv("img.tsv")
    pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "cli.tsv", batch_size=2,
                                         dtype="float32", device="cpu")
    engine = CaptionEngine(tuned, tok, batch_size=2, dtype=torch.float32,
                           beam=BeamSearchConfig(num_beams=4, max_steps=40),
                           transform=get_image_transform(pt_inf._load_param("TINY_CAP")))
    with engine:
        engine.run_caption_tsv("img.tsv", "mem.tsv")
    assert open("cli.tsv", "rb").read() == open("mem.tsv", "rb").read()
    assert len(open("cli.tsv").read().splitlines()) == 5


@pytest.mark.parametrize("encoder", [False, True], ids=["int8", "w8a8"])
def test_quantized_models_refuse(tmp_path, encoder):
    model = quantize_git_model_(ckpt.params_from_gitax(gitax_params(0), configs()[1],
                                                       device="cpu"), encoder=encoder)
    named = "image_encoder.transformer.resblocks.0.attn" if encoder else "textual.output"
    with pytest.raises(ValueError, match=named.replace(".", r"\.")):
        export_git_state_dict(model)
    with pytest.raises(ValueError, match="int8 model"):
        ckpt.save_reference_checkpoint(str(tmp_path / "model.pt"), model)
    assert not os.path.exists(str(tmp_path / "model.pt"))
