"""Offline `clip.load`: a published CLIP torchscript archive -> the
port's modules, with sha256 pin verification; the counterpart of
`gitax.ckpt.clip_archive`.

The reference downloads an OpenAI CLIP archive, checks its sha256 against
a pinned value and rebuilds an eager model from the archive's state dict
(reference CLIP/clip.py:16-57,64-86 -> CLIP/model.py:402-439).  Here the
archive is found locally (the reference's `./output/clip` download root
first), its bytes are checked against the same published pins before
`torch.jit.load` deserialises anything, and the state dict fills the
port's modules: the visual tower (`VisualTransformer` with its `proj`, or
`ModifiedResNet`) and the text tower (`TextTransformer`).  The pins and
the roots are copies of gitax's (a test holds them equal).
"""

from __future__ import annotations

import hashlib
import logging
import os.path as op

import torch

# sha256 pins of the published OpenAI CLIP archives: the leading path
# component of each download URL (reference CLIP/clip.py:16-25)
CLIP_ARCHIVE_SHA256 = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa",
    "RN50x64": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c",
    "ViT-B/32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af",
    "ViT-B/16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f",
    "ViT-L/14": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836",
}

DEFAULT_ROOTS = ("output/clip", op.expanduser("~/.cache/clip"))


def _sha256(path):
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def resolve_archive(name_or_path, roots=DEFAULT_ROOTS):
    """The local archive of a published model name ('ViT-B/16' ->
    <root>/ViT-B-16.pt, the reference's download layout, the first root
    that holds it), or a path passed through.  Returns (path, the pinned
    sha256 or None)."""
    if op.isfile(name_or_path):
        base = op.basename(name_or_path)
        pin = None
        for name, sha in CLIP_ARCHIVE_SHA256.items():
            if name.replace("/", "-") + ".pt" == base:
                pin = sha
        return name_or_path, pin
    if name_or_path not in CLIP_ARCHIVE_SHA256:
        raise FileNotFoundError("{!r} is neither a file nor a known CLIP model name {}".format(
            name_or_path, sorted(CLIP_ARCHIVE_SHA256)))
    fname = name_or_path.replace("/", "-") + ".pt"
    for root in roots:
        cand = op.join(root, fname)
        if op.isfile(cand):
            return cand, CLIP_ARCHIVE_SHA256[name_or_path]
    raise FileNotFoundError(
        "CLIP archive {} not found under {}: download it once on a connected machine "
        "(reference CLIP/clip.py:28-57) and place it there".format(fname, roots))


def _verify(path, pin, verify):
    """gitax's rules: 'strict' raises on an unpinned file or a mismatch,
    'warn' logs them, False skips the hash.  Returns whether the bytes
    matched their pin."""
    if not verify:
        return False
    if pin is None:
        # never deserialise unverified pickle bytes silently
        msg = ("no published sha256 pin for {}: cannot verify (pass verify='warn' for "
               "synthetic or test archives)".format(path))
        if verify == "strict":
            raise ValueError(msg)
        logging.warning(msg)
        return False
    digest = _sha256(path)
    if digest == pin:
        return True
    msg = "sha256 mismatch for {}: got {}, pinned {} (reference CLIP/clip.py:39-42)".format(
        path, digest, pin)
    if verify == "strict":
        raise ValueError(msg)
    logging.warning(msg)
    return False


def load_clip_archive(name_or_path, roots=DEFAULT_ROOTS, verify="strict", device=None,
                      dtype=torch.float32):
    """A torchscript CLIP archive -> the port's towers on `device`
    (default: the CUDA card) in `dtype`, under gitax's keys:
    {'visual_kind': 'vit' | 'resnet', 'visual_config', 'visual' (the
    module), 'text_config', 'text' (the module), 'input_resolution',
    'sha256_verified'}.

    verify: 'strict' (default) raises on an unpinned file or a pin
    mismatch before `torch.jit.load` reads a byte of it, as the reference
    refuses unverified bytes (CLIP/clip.py:39-42; it downloads again,
    which an offline host cannot); 'warn' logs and loads (synthetic or
    test archives); False skips the hash."""
    from . import load_clip_text_state_dict, load_clip_visual, text_config_from_state_dict
    from ..models.clip import TextTransformer
    from ..models.git import resolve_device

    device = resolve_device(device)
    path, pin = resolve_archive(name_or_path, roots)
    verified = _verify(path, pin, verify)
    jit_mod = torch.jit.load(path, map_location="cpu").eval()
    input_resolution = int(jit_mod.input_resolution.item())
    sd = dict(jit_mod.state_dict())
    # the archives carry these as int buffers; build_model drops them too
    # (CLIP/model.py:433-434)
    for k in ("input_resolution", "context_length", "vocab_size"):
        sd.pop(k, None)
    kind, vcfg, visual = load_clip_visual(sd, "visual.", device, dtype)
    text_cfg, embed_dim = text_config_from_state_dict(sd)
    text = load_clip_text_state_dict(TextTransformer(text_cfg, embed_dim, device, dtype), sd)
    return {"visual_kind": kind, "visual_config": vcfg, "visual": visual,
            "text_config": text_cfg, "text": text, "input_resolution": input_resolution,
            "sha256_verified": verified}


def load_image_encoder_from_archive(name_or_path, input_resolution=None, roots=DEFAULT_ROOTS,
                                    verify="strict", device=None, dtype=torch.float32):
    """The reference's get_image_encoder (model.py:63-91) offline: the
    archive's ViT on `device` (default: the CUDA card) in `dtype`, its
    positional table resized once to `input_resolution` where that
    differs from the archive's (torch's bicubic on the archive's f32
    table, computed in float64 on the CPU, as gitax's
    `ops/interp.py::resize_pos_embed_grid` does in numpy;
    torch_common.py:19-39).  Returns (ViTConfig, VisualTransformer)."""
    from ..models.git import resolve_device
    from ..models.vit import VisualTransformer, resize_pos_embed

    device = resolve_device(device)
    loaded = load_clip_archive(name_or_path, roots, verify, "cpu", torch.float32)
    if loaded["visual_kind"] != "vit":
        raise ValueError("the positional-table resize applies to ViT encoders "
                         "(reference model.py:76-88), not {}".format(loaded["visual_kind"]))
    cfg, sd = loaded["visual_config"], loaded["visual"].state_dict()
    if input_resolution and input_resolution != cfg.input_resolution:
        grid = cfg.grid
        cfg = cfg.with_resolution(input_resolution)
        sd["positional_embedding"] = resize_pos_embed(
            sd["positional_embedding"].double(), grid, cfg.grid, cfg.grid).float()
    proj = sd.get("proj")
    vit = VisualTransformer(cfg, device, dtype, output_dim=None if proj is None else proj.shape[1])
    with torch.no_grad():
        vit.load_state_dict(sd, strict=True)
    return cfg, vit


def save_clip_archive(path, state_dict, input_resolution, context_length, vocab_size):
    """Write a CLIP state dict as a torchscript archive in the published
    layout that `load_clip_archive` reads: a scripted module tree whose
    state dict is `state_dict` plus the int buffers `input_resolution`,
    `context_length` and `vocab_size`.  It carries no forward (the
    published archives also hold the model's code): for tests and offline
    tools that need an archive without the reference's CLIP class."""
    from torch import nn

    root = nn.Module()
    for key, value in state_dict.items():
        *path_, leaf = key.split(".")
        m = root
        for name in path_:
            if not hasattr(m, name):
                m.add_module(name, nn.Module())
            m = getattr(m, name)
        value = torch.as_tensor(value).detach().cpu()
        if value.is_floating_point():
            m.register_parameter(leaf, nn.Parameter(value.clone(), requires_grad=False))
        else:
            m.register_buffer(leaf, value.clone())
    for name, n in (("input_resolution", input_resolution), ("context_length", context_length),
                    ("vocab_size", vocab_size)):
        root.register_buffer(name, torch.tensor(int(n)))
    torch.jit.save(torch.jit.script(root), path)
    return path
