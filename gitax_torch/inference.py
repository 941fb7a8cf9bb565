"""Inference CLI of the port, the counterpart of `gitax.inference` and
through it of the reference's entry points (reference inference.py): the
`-p "{'type': <function>, ...}"` YAML dispatch and the same function
names, so reference commands run with the module swapped:

    python -m gitax_torch.inference -p "{'type': 'test_git_inference_single_image',
        'image_path': 'aux_data/images/1.jpg', 'model_name': 'GIT_BASE',
        'prefix': ''}"

The functions run on the CUDA card and raise without one unless the
caller passes device='cpu' (Python callers; the tests do).  The model
comes from `output/{model}/snapshot/model.pt` when it exists (the port's
parameters carry the reference's names), else from a random init with a
warning.  `evaluate_on_coco_caption` scores a result TSV with the port's
copy of gitax's `evalcap/`.

mesh_shape (an int N is [N, 1], else [data, model]) runs the search on a
mesh of data x model ranks, one process a rank
(`runtime.engine.open_mesh_engine`): this process is rank 0 and spawns
the others, or, under a launch of exactly data x model processes
(torchrun), each process is its launcher's rank and ranks 1.. return
None.  One card a rank over NCCL; share_card=True puts every rank on
card 0 over gloo (a rehearsal); device='cpu': gloo CPU ranks.  Rank 0
loads or draws the weights and broadcasts them.  A launch of H x data x
model processes is H hosts, each with its own mesh (gitax's
`make_mesh_from_shape`): each host's rank 0 runs the TSV loop on its row
shard, and host 0 joins the shards; a launch of another size raises.
use_native: gitax's native loader for the TSV loops
(`runtime.engine.resolve_use_native`: None where it built, else PIL).

A model fine-tuned with the port is served by writing it with
`ckpt.save_reference_checkpoint('output/{model}/snapshot/model.pt',
model)`, which this CLI and `serve.py` load.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os.path as op

import numpy as np
import torch

from .common import (
    dispatch_main,
    get_mpi_local_rank,
    get_mpi_rank,
    get_mpi_size,
    json_dump,
    load_from_yaml_file,
    load_list_file,
    write_to_file,
)
from .io.image import load_image
from .io.tsv import tsv_reader
from .models.config import MODEL_ZOO, config_from_param, get_model_param
from .models.git import GitModel, resolve_device
from .preprocess.transforms import get_image_transform
from .tokenization import BertTokenizer, build_tiny_vocab, encode_prefix


def _process_device(device=None):
    """`device` when the caller names one; else the card this process
    owns: cuda:{local rank} (made current) when RANK/WORLD_SIZE shard the
    rows over several processes, one per card, as gitax's processes each
    own their local devices; else the current card."""
    if device is not None or get_mpi_size() == 1:
        return resolve_device(device)
    resolve_device()  # raises without CUDA
    card = torch.device("cuda", get_mpi_local_rank())
    torch.cuda.set_device(card)
    return card


def _load_param(model_name):
    """parameter.yaml for a model: from aux_data/ if present, else the
    built-in zoo table (reference inference.py:68-70)."""
    yaml_path = "aux_data/models/{}/parameter.yaml".format(model_name)
    if op.isfile(yaml_path):
        return load_from_yaml_file(yaml_path)
    if model_name in MODEL_ZOO:
        return get_model_param(model_name)
    return {}


def _load_tokenizer():
    try:
        return BertTokenizer.bert_base_uncased()
    except FileNotFoundError:
        logging.warning(
            "bert-base-uncased vocab.txt not found; falling back to the built-in test "
            "vocabulary — decoded text will NOT match the published checkpoints")
        return BertTokenizer(build_tiny_vocab())


def _build_model(model_name, param, dtype=torch.float32, device=None):
    """The model on `device` (default: this process's card,
    `_process_device`) in `dtype`: the reference checkpoint
    output/{model}/snapshot/model.pt when it exists (reference
    inference.py:84-86), its encoder architecture taken from
    its shapes, else random init with a warning."""
    from . import ckpt

    device = _process_device(device)
    cfg = config_from_param(param)
    ckpt_path = "output/{}/snapshot/model.pt".format(model_name)
    if op.isfile(ckpt_path):
        logging.info("loading %s", ckpt_path)
        sd = ckpt.load_torch_checkpoint(ckpt_path)
        # the checkpoint defines the encoder (the reference derives it
        # from the CLIP archive's shapes, CLIP/model.py:402-425)
        if any(k.startswith("image_encoder.conv1.") for k in sd):
            _, enc = ckpt.infer_visual_config(sd, prefix="image_encoder.")
            enc = dataclasses.replace(enc, fast_softmax=cfg.encoder.fast_softmax)
            if enc != cfg.encoder:
                logging.info("encoder config from checkpoint: %s (param said %s)",
                             enc, cfg.encoder)
                cfg = dataclasses.replace(cfg, encoder=enc)
        model = GitModel(cfg, device=device, dtype=dtype)
        return ckpt.load_git_state_dict(model, sd)
    logging.warning("checkpoint %s not found; using random init (outputs are mechanically "
                    "valid but not meaningful)", ckpt_path)
    model = GitModel(cfg, device=device, dtype=dtype)
    return model.init_params(torch.Generator().manual_seed(0))


def test_git_inference_single_image(image_path, model_name, prefix="", vocab_file=None,
                                    mesh_shape=None, device=None, share_card=False):
    """Single image or video caption or QA (reference inference.py:67-109):
    image_path is a path or a list of frame paths (a clip); beam 4 with a
    1024-token buffer, or with vocab_file (a class-name list, one per
    line) trie-constrained classification decoding (the reference's
    commented-in option, model.py:42-48).  f32, on the card unless
    device='cpu'.  mesh_shape: the search on a mesh (module docstring),
    the one row repeated into each data rank's slot as gitax does
    (inference.py:171-178); the caption is row 0's."""
    from .decode.beam import BeamSearchConfig
    from .decode.trie import build_vocab_trie

    param = _load_param(model_name)
    tokenizer = _load_tokenizer()
    if isinstance(image_path, str):
        image_path = [image_path]
    transform = get_image_transform(param)
    imgs = np.stack([transform(load_image(p)) for p in image_path])

    if vocab_file:
        search = dict(mode="trie", trie=build_vocab_trie(tokenizer, load_list_file(vocab_file)))
    else:
        search = dict(beam=BeamSearchConfig(num_beams=4, max_steps=1024))
    input_ids = encode_prefix(tokenizer, prefix, max_text_len=40)

    def cut(model):
        # MinMax sizes need not be whole patches; the reference's strided
        # patchify drops the remainder pixels (CLIP/model.py:221)
        p = model.cfg.encoder.patch_size
        h, w = (imgs.shape[1] // p) * p, (imgs.shape[2] // p) * p
        x = np.ascontiguousarray(imgs[:, :h, :w])
        return x[None] if len(image_path) > 1 else x  # [1, F, H, W, 3] video frames

    if mesh_shape is None:
        model = _build_model(model_name, param, device=device)
        dev = model.textual.output.bias.device
        images = torch.from_numpy(cut(model)).to(dev)
        prefix_ids = torch.tensor([input_ids], dtype=torch.long, device=dev)
        seqs, _ = model.generate(images, prefix_ids, **search)
    else:
        from .parallel.mesh import mesh_dims
        from .runtime.engine import open_mesh_engine

        data = mesh_dims(mesh_shape)[0]
        engine = open_mesh_engine(lambda dev: _build_model(model_name, param, device=dev),
                                  tokenizer, mesh_shape, device=device, share_card=share_card,
                                  batch_size=data, dtype=torch.float32)
        if engine is None:  # a rank 1.. under a launcher
            return None
        with engine:
            images = np.repeat(cut(engine.model), data, axis=0)
            seqs = engine.dispatch_device_batch(images, np.asarray([input_ids] * data), **search)
    cap = tokenizer.decode(seqs[0].cpu().tolist(), skip_special_tokens=True)
    logging.info("output: %s", cap)
    return cap


def test_git_inference_single_tsv(image_tsv, model_name, question_tsv, out_tsv, batch_size=32,
                                  dtype="bfloat16", use_native=None, int8=False,
                                  mesh_shape=None, device=None, share_card=False):
    """Sharded batch inference over a base64-image TSV (reference
    inference.py:134-225), batched on the card: captions, or answers when
    question_tsv is given.  dtype: 'bfloat16' (production) or 'float32'
    (parity with gitax); int8: weight-only int8 decoder and head,
    quantised in place after the load.  Without a mesh, rows shard by
    RANK/WORLD_SIZE (or an initialised torch.distributed group); each
    rank writes out.{rank}.{world}.tsv and rank 0 concatenates.
    mesh_shape: every row through one engine on a mesh (module
    docstring), rank 0 writing out_tsv (on several hosts: each host its
    row shard, host 0 joining them); batch_size must divide over its data
    axis.  use_native: the native loader (libjpeg, C++) where it built
    (None), always (True: raises where it did not build, naming the
    reason) or never (False: PIL)."""
    from .decode.beam import BeamSearchConfig
    from .runtime.engine import CaptionEngine, open_mesh_engine, resolve_use_native

    use_native = resolve_use_native(use_native)  # before any rank starts
    yaml_path = "output/{}/parameter.yaml".format(model_name)
    param = load_from_yaml_file(yaml_path) if op.isfile(yaml_path) else _load_param(model_name)
    tdtype = getattr(torch, dtype)
    tokenizer = _load_tokenizer()
    kwargs = dict(batch_size=batch_size, beam=BeamSearchConfig(num_beams=4, max_steps=40),
                  dtype=tdtype, int8=int8, transform=get_image_transform(param),
                  use_native=use_native)
    if mesh_shape is None:
        engine = CaptionEngine(_build_model(model_name, param, dtype=tdtype, device=device),
                               tokenizer, **kwargs)
        rank, world = get_mpi_rank(), get_mpi_size()
    else:
        engine = open_mesh_engine(
            lambda dev: _build_model(model_name, param, dtype=tdtype, device=dev), tokenizer,
            mesh_shape, device=device, share_card=share_card, **kwargs)
        if engine is None:  # a rank 1.. under a launcher
            return
        rank, world = engine.mesh.host, engine.mesh.hosts  # a row shard a host
    with engine:
        if question_tsv:
            engine.run_vqa_tsv(image_tsv, question_tsv, out_tsv, rank, world)
        else:
            engine.run_caption_tsv(image_tsv, out_tsv, rank, world)


def convert_tsv_to_vqa_json(predict_file, out_json):
    """(reference inference.py:227-229)"""
    result = [json.loads(row[0]) for row in tsv_reader(predict_file)]
    write_to_file(json_dump(result), out_json)


def convert_tsv_to_coco_format(res_tsv, outfile, sep="\t", key_col=0, cap_col=1):
    """(reference inference.py:231-252)"""
    results = []
    with open(res_tsv) as fp:
        for line in fp:
            parts = line.strip().split(sep)
            key = parts[key_col]
            if cap_col < len(parts):
                caps = json.loads(parts[cap_col]) or [{"caption": ""}]
                assert len(caps) == 1, "cannot evaluate multiple captions per image"
                cap = caps[0]["caption"]
            else:
                cap = ""
            results.append({"image_id": key, "caption": cap})
    with open(outfile, "w") as fp:
        json.dump(results, fp)


def iter_caption_to_json(iter_caption, json_file):
    """gt caption TSV rows -> COCO annotation json (reference
    inference.py:254-275)."""
    key_captions = [(key, json.loads(p)) for key, p in iter_caption]
    info = {
        "info": "dummy",
        "licenses": "dummy",
        "type": "captions",
        "images": [{"file_name": k, "id": k} for k, _ in key_captions],
    }
    annotations = []
    for k, caps in key_captions:
        for cap in caps:
            annotations.append({"image_id": k, "caption": cap["caption"], "id": len(annotations)})
    info["annotations"] = annotations
    write_to_file(json.dumps(info), json_file)


def evaluate_on_coco_caption(res_file, label_file, outfile=None):
    """COCO caption metrics (reference inference.py:277-313): pycocoevalcap
    where installed, else the native BLEU, METEOR, ROUGE-L and CIDEr-D
    (`evalcap.evaluate`)."""
    from .evalcap import evaluate_on_coco_caption as evaluate

    return evaluate(res_file, label_file, outfile)


if __name__ == "__main__":
    dispatch_main(globals())
