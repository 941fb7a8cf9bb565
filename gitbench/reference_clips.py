"""The plain reference of a video configuration (`"reference":
"reference_clips"`): GIT on a clip of F frames, as the reference model's
video path runs it (generativeimage2text/layers/decoder.py:831-853): each
frame through the ViT alone, offset by its temporal embedding
(`img_temperal_embedding.{i}`, added to every token of frame i), the
frames' tokens concatenated on the token axis, then the visual projection;
the decoder and the beam search are `gitbench.reference`'s.  Plain float32
torch with TF32 off; it imports nothing of gitax_torch (nor jax, nor
gitax).  A clip's payload is the JSON list of its frames' base64 JPEGs in
time order (or that list itself), of which the first F are kept, as the
reference's zip over the temporal embeddings keeps them.

No departure from the published model beyond those `gitbench.reference`
states (the benchmark's synthetic vocabulary, weights drawn from the seed).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from gitbench import reference as base

length_norm = base.length_norm


def frames_of(payload, cfg):
    """The base64 frames of a payload (a JSON list or a list), the first
    num_image_with_embedding of them."""
    frames = json.loads(payload) if isinstance(payload, (str, bytes)) else list(payload)
    return frames[:int(cfg["num_image_with_embedding"])]


def pixels(payload, cfg):
    """The uint8 [F, H, W, 3] the encoder sees, a frame at a time."""
    return np.stack([base.pixels(b64, cfg) for b64 in frames_of(payload, cfg)])


class Reference(base.Reference):

    def __init__(self, cfg, sd, device, precision="f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super(Reference, self).__init__(cfg, sd, device, precision)

    @torch.no_grad()
    def frame_tokens(self, arr):
        """uint8 [F, H, W, 3] -> each frame's ViT tokens plus its temporal
        embedding, concatenated: [1, F * S, Dv], before the projection."""
        return torch.cat([self.vit(frame)
                          + self.w["img_temperal_embedding.{}".format(i)].reshape(1, 1, -1)
                          for i, frame in enumerate(arr)], 1)

    @torch.no_grad()
    def encode(self, arr):
        """uint8 [F, H, W, 3] (or an image [H, W, 3]) -> the projected
        memory [1, F * S, D]."""
        if arr.ndim == 3:
            return super(Reference, self).encode(arr)
        return self.project(self.frame_tokens(arr))
