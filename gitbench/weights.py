"""Random GIT weights from a seed, drawn on the device in a few large calls.

Frozen copies of gitax_torch's init scales (`models/vit.py`,
`VisualTransformer.init_params`: normal std 0.02 for matmul weights, width**-0.5
for the class and positional embeddings, LayerNorm ones and zeros, zero
biases; `models/textual.py`, `TextualHead.init_params`: std 0.02 for matmul
weights and both embedding tables) and of its EOS gate (`models/git.py`,
`eos_gate_params`: the EOS row of the tied word table points along the
late-position direction of the positional table, so that captions end near
text position `gate`).  The configuration's `assumed.query_key_scale` scales
the decoder's query and key weights (chip_smoke.py's `sharpen_` scales
those and the value and output maps), so that each text position attends
to a few memory tokens and captions depend on the image; the value and
output maps keep their scale, so the positional signal the EOS gate reads
survives the residual stream.

A video configuration (`num_image_with_embedding` F > 0) adds the F temporal
embeddings `img_temperal_embedding.{i}` [1, 1, Dv] (the port's and the
reference checkpoint's spelling and shape), drawn last in the 'emb' group,
so that no other parameter's draw moves; a file without the key has none.

The names are the reference checkpoint's, which `GitModel.state_dict()` uses;
the same dict is what the plain reference reads.
"""

from __future__ import annotations

import torch

EOS_ID = 102


def widths(cfg):
    """The sizes of a configuration file, under short names."""
    res = cfg["test_crop_size"]
    p = cfg["patch_size"]
    return dict(W=cfg["encoder_width"], Le=cfg["encoder_layers"], He=cfg["encoder_heads"], p=p,
                S=(res // p) ** 2 + 1, Dv=cfg["visual_feature_size"], D=cfg["hidden_size"],
                Ld=cfg["num_layers"], H=cfg["num_heads"], F=cfg["feedforward_size"],
                V=cfg["vocab_size"], P=cfg["max_caption_length"])


def param_specs(cfg):
    """[(name, shape, init)], init one of 'w' (std 0.02), 'emb' (std
    width**-0.5), 'one', 'zero', in a fixed order."""
    w = widths(cfg)
    W, D = w["W"], w["D"]
    specs = [("image_encoder.class_embedding", (W,), "emb"),
             ("image_encoder.positional_embedding", (w["S"], W), "emb"),
             ("image_encoder.conv1.weight", (W, 3, w["p"], w["p"]), "w"),
             ("image_encoder.ln_pre.weight", (W,), "one"),
             ("image_encoder.ln_pre.bias", (W,), "zero")]
    for i in range(w["Le"]):
        b = "image_encoder.transformer.resblocks.{}.".format(i)
        specs += [(b + "ln_1.weight", (W,), "one"), (b + "ln_1.bias", (W,), "zero"),
                  (b + "attn.in_proj_weight", (3 * W, W), "w"),
                  (b + "attn.in_proj_bias", (3 * W,), "zero"),
                  (b + "attn.out_proj.weight", (W, W), "w"), (b + "attn.out_proj.bias", (W,), "zero"),
                  (b + "ln_2.weight", (W,), "one"), (b + "ln_2.bias", (W,), "zero"),
                  (b + "mlp.c_fc.weight", (4 * W, W), "w"), (b + "mlp.c_fc.bias", (4 * W,), "zero"),
                  (b + "mlp.c_proj.weight", (W, 4 * W), "w"), (b + "mlp.c_proj.bias", (W,), "zero")]
    specs += [("image_encoder.ln_post.weight", (W,), "one"),
              ("image_encoder.ln_post.bias", (W,), "zero"),
              ("textual.visual_projection.0.weight", (D, w["Dv"]), "w"),
              ("textual.visual_projection.0.bias", (D,), "zero"),
              ("textual.visual_projection.1.weight", (D,), "one"),
              ("textual.visual_projection.1.bias", (D,), "zero"),
              ("textual.embedding.words.weight", (w["V"], D), "w"),
              ("textual.embedding.positions.weight", (w["P"], D), "w"),
              ("textual.embedding.layer_norm.weight", (D,), "one"),
              ("textual.embedding.layer_norm.bias", (D,), "zero")]
    for i in range(w["Ld"]):
        b = "textual.transformer.encoder.layer.{}.".format(i)
        for lin in ("attention.self.query", "attention.self.key", "attention.self.value",
                    "attention.output.dense"):
            specs += [(b + lin + ".weight", (D, D), "w"), (b + lin + ".bias", (D,), "zero")]
        specs += [(b + "attention.output.LayerNorm.weight", (D,), "one"),
                  (b + "attention.output.LayerNorm.bias", (D,), "zero"),
                  (b + "intermediate.dense.weight", (w["F"], D), "w"),
                  (b + "intermediate.dense.bias", (w["F"],), "zero"),
                  (b + "output.dense.weight", (D, w["F"]), "w"),
                  (b + "output.dense.bias", (D,), "zero"),
                  (b + "output.LayerNorm.weight", (D,), "one"),
                  (b + "output.LayerNorm.bias", (D,), "zero")]
    specs.append(("textual.output.bias", (w["V"],), "zero"))
    specs += [("img_temperal_embedding.{}".format(i), (1, 1, w["Dv"]), "emb")
              for i in range(int(cfg.get("num_image_with_embedding", 0)))]
    return specs


QUERY_KEY = (".attention.self.query.weight", ".attention.self.key.weight")


def eos_gate_(words, positions, gate, eos_id=EOS_ID):
    """In place on f32 tables: words[eos] = 10 * d / |d|, d the mean of
    positions[gate:gate+8] less the mean of positions[:gate]."""
    d = positions[gate:gate + 8].mean(0) - positions[:gate].mean(0)
    words[eos_id] = 10.0 * d / d.norm()


@torch.no_grad()
def make(cfg, seed, device, dtype=None):
    """{name: tensor} in the configuration's dtype on `device`, drawn from
    `seed` with a torch.Generator on that device: one normal draw a scale
    group, sliced.  'textual.output.weight' is the word table itself."""
    dtype = dtype or getattr(torch, cfg["dtype"])
    specs = param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    scale = {"w": 0.02, "emb": cfg["encoder_width"] ** -0.5}
    out = {}
    for group in ("w", "emb"):
        members = [(n, s) for n, s, init in specs if init == group]
        total = sum(torch.Size(s).numel() for _, s in members)
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        flat.mul_(scale[group])
        at = 0
        for name, shape in members:
            n = torch.Size(shape).numel()
            out[name] = flat[at:at + n].view(shape)
            at += n
    for name, shape, init in specs:
        if init in ("one", "zero"):
            out[name] = torch.full(shape, 1.0 if init == "one" else 0.0, device=device)
    assumed = cfg["assumed"]
    for name in out:
        if name.endswith(QUERY_KEY):
            out[name].mul_(float(assumed["query_key_scale"]))
    eos_gate_(out["textual.embedding.words.weight"], out["textual.embedding.positions.weight"],
              int(assumed["eos_gate"]))
    served = {name: t.to(dtype) for name, t in out.items()}
    del out
    served["textual.output.weight"] = served["textual.embedding.words.weight"]
    return {name: served[name] for name, _, _ in specs + [("textual.output.weight", (), "")]}
