"""A port `GitModel` as the reference's torch state dict, the counterpart
of gitax's `ckpt/torch_convert.py::export_git_state_dict` (:246-325).

gitax exports its params tree under the reference's names so that a model
fine-tuned in gitax runs in the PyTorch reference.  The port's parameters
already carry those names (`image_encoder.*`, `textual.*`, the split
query/key/value, the tied `textual.output.weight`, the video's
`img_temperal_embedding.{i}` [1, 1, Dv] in the reference's spelling), so
the export is the one-card state dict as f32 numpy arrays: gitax's names
and values, bit for bit, for the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def export_git_state_dict(model) -> Dict[str, np.ndarray]:
    """A port GitModel -> {reference name: f32 numpy array}, as gitax's
    `export_git_state_dict(params, cfg)` gives for the same weights.

    A model on a mesh is gathered first (`parallel.mesh.gather_params`):
    every rank of its model group calls this.  An int8 model (weight-only
    or w8a8) raises, naming its quantized layers: gitax's export reads
    `kernel`, which a quantized tree no longer has."""
    from ..models.git import quantized_modules
    from ..parallel.mesh import gather_params

    quantized = quantized_modules(model)
    if quantized:
        raise ValueError("an int8 model has no reference state dict (export the fp weights "
                         "before quantizing); quantized: {}".format(", ".join(quantized)))
    # copies: the tied head and the word table are one tensor in the model
    return {name: np.array(t.detach().to("cpu", torch.float32).numpy())
            for name, t in gather_params(model).items()}
