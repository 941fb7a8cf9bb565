"""A plain reference that lives in a file of its own, for the tests: the
configuration names it (`"reference": "tests/clips_reference"`).  GIT on a
clip of F frames, as the reference model's video path runs it: each frame
through the ViT alone, offset by its temporal embedding
(`img_temperal_embedding.{i}`), the frames' tokens concatenated, then the
visual projection; an image as `gitbench.reference`.  A clip's payload is
the list of its frames' base64 JPEGs."""

from __future__ import annotations

import numpy as np
import torch

from gitbench import reference as base

length_norm = base.length_norm


def pixels(payload, cfg):
    """The uint8 [F, H, W, 3] the encoder sees, a frame at a time."""
    return np.stack([base.pixels(b64, cfg) for b64 in payload])


class Reference(base.Reference):

    @torch.no_grad()
    def encode(self, arr):
        """uint8 [F, H, W, 3] (or an image [H, W, 3]) -> the projected
        memory [1, F * S, D]."""
        if arr.ndim == 3:
            return super(Reference, self).encode(arr)
        tokens = [self.vit(frame) + self.w["img_temperal_embedding.{}".format(i)].reshape(1, 1, -1)
                  for i, frame in enumerate(arr)]
        return self.project(torch.cat(tokens, 1))
