"""The plain reference: GIT's forward pass in plain PyTorch, float32, with no
kernel, cache or batching, and what the program's host stage does to a
payload before it.  It imports nothing of gitax_torch (nor jax, nor gitax).

Frozen copies, each from the place named:
- the test transforms, gitax_torch/preprocess/transforms.py (reference
  inference.py:29-64, 111-132): shorter side to the crop, bicubic, centre
  crop; or MinMaxResizeForTest; then [0, 1] and CLIP's mean and std; the
  engine's cut to whole patches (runtime/engine.py, dispatch_varshape);
- the weight-only int8 rule, gitax_torch/ops/quant.py (gitax ops/quant.py):
  s = max(max|w| over the input axis / 127, 1e-12), q = round(w / s) in
  [-127, 127], per output channel, for the decoder's six Linears a layer and
  the tied head, from the served (bf16) weights;
- the forward pass, gitax_torch/models (vit.py, textual.py): ViT-L/14 with
  pre-norm blocks and QuickGELU, ln_post over all tokens, positional table
  interpolated bicubically for other grids; 'linearLn' projection; the
  unified decoder over [memory; text] with post-norm BERT layers, exact gelu,
  text->text causal, memory->text blocked; the tied head;
- OpenNMT's length norm, gitax_torch/decode/beam.py: ((5 + len) / 6) ** 0.6;
- the beam search's semantics, gitax_torch/decode/beam.py (`beam_step`), in
  plain Python over this pass (`Reference.beam_search`).

precision='bf16' rounds every activation operand of a product to bf16, the
configuration's precision (the weights are the served ones): the unit of
rounding the judge states the program's gap in.  precision='lowp' is the
control: the same pass one step below what the configuration states: every
operand of a product that runs in bf16 rounded to fp8 (e4m3, a scale a row
or a channel), and the int8 weights cut to int4 (s = max|w| / 7).
"""

from __future__ import annotations

import base64
import io
import math

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
NEG = -1e9
FP8_MAX = 448.0


# -- the host stage -----------------------------------------------------------
def decode(b64):
    """A base64 JPEG -> RGB PIL image."""
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def resize_shorter(img, size):
    from PIL import Image

    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    ow, oh = (size, int(size * h / w)) if w < h else (int(size * w / h), size)
    return img.resize((ow, oh), Image.BICUBIC)


def center_crop(img, size):
    from PIL import Image

    w, h = img.size
    if w < size or h < size:
        padded = Image.new("RGB", (max(w, size), max(h, size)))
        padded.paste(img, ((padded.size[0] - w) // 2, (padded.size[1] - h) // 2))
        img, (w, h) = padded, padded.size
    left, top = int(round((w - size) / 2.0)), int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def min_max_size(w, h, min_size, max_size):
    """(h, w) of MinMaxResizeForTest for a (w, h) source."""
    size = min_size
    lo, hi = float(min(w, h)), float(max(w, h))
    if hi / lo * size > max_size:
        size = int(round(max_size * lo / hi))
    if (w <= h and w == size) or (h <= w and h == size):
        return h, w
    return (int(size * h / w), size) if w < h else (size, int(size * w / h))


def pixels(b64, cfg):
    """The uint8 [H, W, 3] the encoder sees: decoded, resized, cropped or
    MinMax-resized, cut to whole patches."""
    from PIL import Image

    img = decode(b64)
    crop, ratio_max = cfg["test_crop_size"], cfg.get("test_respect_ratio_max")
    if ratio_max:
        oh, ow = min_max_size(img.size[0], img.size[1], crop, ratio_max)
        img = img.resize((ow, oh), Image.BICUBIC)
    else:
        img = center_crop(resize_shorter(img, crop), crop)
    arr = np.asarray(img, np.uint8)
    p = cfg["patch_size"]
    return arr[:(arr.shape[0] // p) * p, :(arr.shape[1] // p) * p]


def normalized(arr):
    return ((arr.astype(np.float32) / 255.0) - CLIP_MEAN) / CLIP_STD


def length_norm(length, alpha=0.6):
    return ((5.0 + length) / 6.0) ** alpha


# -- precision ---------------------------------------------------------------
def int8_dequant(w):
    """The int8 rule, dequantised: [out, in] -> q * s in f32."""
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / s), -127, 127) * s


def int4_dequant(w):
    w = w.float()
    s = torch.clamp(w.abs().amax(dim=1, keepdim=True) / 7.0, min=1e-12)
    return torch.clamp(torch.round(w / s), -7, 7) * s


def fp8(x):
    """x rounded to e4m3 with a scale a row (the last axis), back in f32."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True) / FP8_MAX, min=1e-30)
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Reference(object):
    """GIT in plain float32 on `device` from the served state dict `sd`
    (name -> tensor), precision 'f32' (the reference), 'bf16' (its
    products' activation operands rounded to bf16) or 'lowp' (the control).  Takes nothing the program made: `sd` is the benchmark's own
    draw (`weights.make`)."""

    DECODER_LINEARS = ("attention.self.query", "attention.self.key", "attention.self.value",
                       "attention.output.dense", "intermediate.dense", "output.dense")

    def __init__(self, cfg, sd, device, precision="f32"):
        if precision not in ("f32", "bf16", "lowp"):
            raise ValueError("precision {!r}: 'f32', 'bf16' or 'lowp'".format(precision))
        self.cfg, self.device, self.lowp = cfg, device, precision == "lowp"
        self.bf16 = precision == "bf16"
        self.w = {}
        for name, t in sd.items():
            t = t.to(device)
            if name == "textual.output.weight" or self._is_decoder_linear(name):
                self.w[name] = int4_dequant(t) if self.lowp else int8_dequant(t)
            elif self.lowp and name.endswith("weight") and t.dim() >= 2 \
                    and "embedding" not in name:
                self.w[name] = fp8(t.float().reshape(t.shape[0], -1)).reshape(t.shape)
            else:
                self.w[name] = t.float()

    def _is_decoder_linear(self, name):
        return name.startswith("textual.transformer.") and name.endswith(".weight") \
            and any("." + lin + ".weight" in name for lin in self.DECODER_LINEARS)

    def _in(self, x):
        if self.bf16:
            return x.to(torch.bfloat16).to(torch.float32)
        return fp8(x) if self.lowp else x

    def linear(self, x, name):
        y = self._in(x) @ self.w[name + ".weight"].t()
        return y + self.w[name + ".bias"]

    def ln(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[name + ".weight"], self.w[name + ".bias"],
                            eps)

    def attend(self, q, k, v, mask=None):
        """q, k, v [B, H, T, Dh]."""
        scores = self._in(q) @ self._in(k).transpose(-1, -2) / math.sqrt(q.shape[-1])
        if mask is not None:
            scores = scores + mask
        probs = torch.softmax(scores, dim=-1)
        return self._in(probs) @ self._in(v.transpose(-1, -2)).transpose(-1, -2)

    @staticmethod
    def heads(x, n):
        b, t, d = x.shape
        return x.reshape(b, t, n, d // n).transpose(1, 2)

    @staticmethod
    def merge(x):
        b, h, t, dh = x.shape
        return x.transpose(1, 2).reshape(b, t, h * dh)

    # -- the encoder -----------------------------------------------------------
    @torch.no_grad()
    def encode(self, arr):
        """uint8 [H, W, 3] -> the projected memory [1, S, D]."""
        return self.project(self.vit(arr))

    @torch.no_grad()
    def vit(self, arr):
        """uint8 [H, W, 3] -> the ViT's tokens after ln_post [1, S, W]."""
        cfg, w = self.cfg, self.w
        p, width, n_heads = cfg["patch_size"], cfg["encoder_width"], cfg["encoder_heads"]
        x = torch.from_numpy(normalized(arr)).to(self.device).permute(2, 0, 1)[None]
        gh, gw = x.shape[2] // p, x.shape[3] // p
        x = F.conv2d(self._in(x.reshape(1, 3, -1)).reshape(x.shape), w["image_encoder.conv1.weight"],
                     stride=p)
        x = x.flatten(2).transpose(1, 2)  # [1, gh*gw, W]
        pos = w["image_encoder.positional_embedding"]
        g = cfg["test_crop_size"] // p
        if (gh, gw) != (g, g):
            grid = pos[1:].reshape(g, g, width).permute(2, 0, 1)[None]
            grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
            pos = torch.cat([pos[:1], grid[0].permute(1, 2, 0).reshape(gh * gw, width)], 0)
        cls = w["image_encoder.class_embedding"].reshape(1, 1, width)
        x = torch.cat([cls, x], 1) + pos
        eps = cfg["encoder_ln_eps"]
        x = self.ln(x, "image_encoder.ln_pre", eps)
        for i in range(cfg["encoder_layers"]):
            b = "image_encoder.transformer.resblocks.{}.".format(i)
            h = self.ln(x, b + "ln_1", eps)
            qkv = self._in(h) @ w[b + "attn.in_proj_weight"].t() + w[b + "attn.in_proj_bias"]
            q, k, v = (self.heads(t, n_heads) for t in qkv.chunk(3, dim=-1))
            x = x + self.linear(self.merge(self.attend(q, k, v)), b + "attn.out_proj")
            h = self.linear(self.ln(x, b + "ln_2", eps), b + "mlp.c_fc")
            x = x + self.linear(h * torch.sigmoid(1.702 * h), b + "mlp.c_proj")
        return self.ln(x, "image_encoder.ln_post", eps)

    @torch.no_grad()
    def project(self, x):
        """The visual projection ('linearLn'): tokens [1, M, Dv] -> [1, M, D]."""
        x = self.linear(x, "textual.visual_projection.0")
        return self.ln(x, "textual.visual_projection.1", self.cfg["projection_ln_eps"])

    # -- the decoder -----------------------------------------------------------
    @torch.no_grad()
    def text_hidden(self, memory, ids):
        """memory [1, M, D], ids [N, T] (the text fed: prefix then words) ->
        the decoder's output at the N rows' text positions [N, T, D]."""
        cfg, w = self.cfg, self.w
        n, t = ids.shape
        m = memory.shape[1]
        e = w["textual.embedding.words.weight"][ids] \
            + w["textual.embedding.positions.weight"][:t][None]
        e = self.ln(e, "textual.embedding.layer_norm", cfg["embedding_ln_eps"])
        x = torch.cat([memory.expand(n, -1, -1), e], 1)
        s = m + t
        row = torch.arange(s, device=self.device)[:, None]
        col = torch.arange(s, device=self.device)[None, :]
        blocked = (col >= m) & ((row < m) | (col > row))
        mask = torch.where(blocked, NEG, 0.0)
        eps, n_heads = cfg["bert_ln_eps"], cfg["num_heads"]
        for i in range(cfg["num_layers"]):
            b = "textual.transformer.encoder.layer.{}.".format(i)
            q, k, v = (self.heads(self.linear(x, b + "attention.self." + nm), n_heads)
                       for nm in ("query", "key", "value"))
            a = self.linear(self.merge(self.attend(q, k, v, mask)), b + "attention.output.dense")
            x = self.ln(a + x, b + "attention.output.LayerNorm", eps)
            h = self.linear(x, b + "intermediate.dense")
            h = h * 0.5 * (1.0 + torch.erf(h / math.sqrt(2.0)))
            x = self.ln(self.linear(h, b + "output.dense") + x, b + "output.LayerNorm", eps)
        return x[:, m:]

    def head(self, x):
        """The tied head: hidden [..., D] -> logits [..., V], f32."""
        return self._in(x) @ self.w["textual.output.weight"].t() + self.w["textual.output.bias"]

    def sequence(self, memory, prefix, words, eos):
        """The log-probabilities this model gives each token of words +
        [EOS], with the prefix and the words fed: [n+1]."""
        ids = torch.tensor([list(prefix) + list(words)], device=self.device)
        logits = self.head(self.text_hidden(memory, ids)[0, len(prefix) - 1:])
        target = torch.tensor(list(words) + [eos], device=self.device)
        return torch.log_softmax(logits, dim=-1).gather(1, target[:, None])[:, 0]

    @torch.no_grad()
    def beam_search(self, memory, prefix, cfg):
        """This model's own beam search from `prefix`, written plainly, one
        image at a time: (the best hypothesis's length-normed score, its
        words).  The semantics are the program's (gitax_torch/decode/
        beam.py, from the reference's GeneratorWithBeamSearch): each beam's
        top C = num_beams x per_node_beam_size words by log-probability
        (ties to the lower id), merged over the beams (ties to the earlier
        beam); in that order an EOS candidate (every candidate at the last
        position) becomes a hypothesis, scored over the OpenNMT norm of
        its length with the prefix, while fewer than num_beams non-EOS
        candidates precede it, and the first num_beams non-EOS candidates
        are the next beams; one hypothesis kept, an earlier one winning
        ties; done once it scores at least the best candidate over the
        norm of norm_max_length - 1."""
        k = cfg["num_beams"]
        c = k * cfg["per_node_beam_size"]
        alpha, eos, tp = cfg["length_penalty"], cfg["eos_id"], len(prefix)
        max_len = max(cfg["max_steps"], tp + cfg["max_text_len"])
        done_norm = length_norm(cfg["norm_max_length"] - 1, alpha)
        beams = [list(prefix)]
        scores = torch.zeros(1, device=self.device)
        best = None
        for cur in range(tp, max_len):
            ids = torch.tensor(beams, device=self.device)
            lp = torch.log_softmax(self.head(self.text_hidden(memory, ids)[:, -1]), dim=-1)
            vals, words = torch.sort(lp, dim=-1, descending=True, stable=True)
            cand = (vals[:, :c] + scores[:, None]).reshape(-1)
            top, sel = torch.sort(cand, descending=True, stable=True)
            top, sel = top[:c].tolist(), sel[:c]
            words = words[:, :c].reshape(-1)[sel].tolist()
            parents = (sel // c).tolist()
            if best is not None and best[0] >= top[0] / done_norm:
                break
            last = cur + 1 == max_len
            nxt, nxt_scores = [], []
            for score, j, w in zip(top, parents, words):
                if w == eos or last:
                    if len(nxt) < k:
                        normed = score / length_norm(cur, alpha)
                        if best is None or normed > best[0]:
                            best = (normed, beams[j][tp:])
                elif len(nxt) < k:
                    nxt.append(beams[j] + [w])
                    nxt_scores.append(score)
            if last:
                break
            beams, scores = nxt, torch.tensor(nxt_scores, device=self.device)
        return best
