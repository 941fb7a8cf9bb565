"""Model configurations and the published GIT model zoo.

A copy of `gitax.models.config`: that module cannot be imported without
jax (the `gitax.models` package imports its JAX towers eagerly), and the
port must run where jax is absent.  `tests/test_torch_port_ops.py`
holds every zoo entry equal to gitax's, field for field.

The decoder hyper-parameters are fixed by the reference factory
(model.py:14-26): vocab 30522, hidden 768, 6 layers, 12 heads, FFN 3072,
max caption length 1024, 'linearLn' visual projection, post-norm BERT
blocks with exact-erf gelu.  Per-model overrides come from each
checkpoint's parameter.yaml.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """CLIP-style ViT image encoder (reference CLIP/model.py:215-274)."""

    patch_size: int
    width: int
    layers: int
    heads: int
    input_resolution: int = 224
    ln_eps: float = 1e-5
    # attention scores and softmax in the activation dtype instead of
    # f32; encoder-only (the decoder's score math stays f32)
    fast_softmax: bool = False

    @property
    def grid(self):
        return self.input_resolution // self.patch_size

    @property
    def num_tokens(self):
        return self.grid * self.grid + 1

    def with_resolution(self, resolution):
        return dataclasses.replace(self, input_resolution=resolution)


VIT_B_16 = ViTConfig(patch_size=16, width=768, layers=12, heads=12)
VIT_L_14 = ViTConfig(patch_size=14, width=1024, layers=24, heads=16)

ENCODERS = {
    "CLIPViT_B_16": VIT_B_16,
    "CLIPViT_L_14": VIT_L_14,
}


@dataclasses.dataclass(frozen=True)
class GitConfig:
    """Full GIT model: ViT encoder + unified text decoder."""

    encoder: ViTConfig = VIT_B_16
    visual_feature_size: int = 768
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 6
    num_heads: int = 12
    feedforward_size: int = 3072
    max_caption_length: int = 1024
    padding_idx: int = 0
    num_image_with_embedding: int = 0  # >0: video frames w/ temporal embs
    # None: token-axis concat of frames; 'avg': mean-pool frames
    pooling_images: Optional[str] = None
    # layer-norm epsilons (parity-relevant)
    bert_ln_eps: float = 1e-12
    embedding_ln_eps: float = 1e-8
    projection_ln_eps: float = 1e-5

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


# name -> parameter.yaml contents (values from the reference's
# aux_data/models/*/parameter.yaml)
_LARGE = {"visual_feature_size": 1024, "image_encoder_type": "CLIPViT_L_14"}
MODEL_ZOO = {
    "GIT_BASE": {},
    "GIT_BASE_COCO": {},
    "GIT_BASE_TEXTCAPS": {},
    "GIT_BASE_VQAv2": {"test_crop_size": 480, "test_respect_ratio_max": 640},
    "GIT_BASE_TEXTVQA": {"test_crop_size": 480, "test_respect_ratio_max": 640},
    "GIT_BASE_VATEX": {"num_image_with_embedding": 6},
    "GIT_BASE_MSRVTT": {"num_image_with_embedding": 6},
    "GIT_BASE_MSRVTT_QA": {"num_image_with_embedding": 6},
    "GIT_LARGE": dict(_LARGE),
    "GIT_LARGE_COCO": dict(_LARGE),
    "GIT_LARGE_TEXTCAPS": dict(_LARGE),
    "GIT_LARGE_VQAv2": dict(_LARGE, test_crop_size=420, test_respect_ratio_max=560),
    "GIT_LARGE_TEXTVQA": dict(_LARGE, test_crop_size=420, test_respect_ratio_max=560),
    "GIT_LARGE_VATEX": dict(_LARGE, num_image_with_embedding=6),
    "GIT_LARGE_MSRVTT": dict(_LARGE, num_image_with_embedding=6),
    "GIT_LARGE_MSRVTT_QA": dict(_LARGE, num_image_with_embedding=6),
    "GIT_LARGE_R": dict(_LARGE),
    "GIT_LARGE_R_COCO": dict(_LARGE),
    "GIT_LARGE_R_TEXTCAPS": dict(_LARGE),
}


def get_model_param(model_name: str) -> dict:
    """parameter.yaml-equivalent dict for a zoo model name."""
    if model_name not in MODEL_ZOO:
        raise KeyError(
            "unknown model {!r}; known: {}".format(model_name, sorted(MODEL_ZOO))
        )
    return dict(MODEL_ZOO[model_name])


def config_from_param(param: Optional[dict] = None) -> GitConfig:
    """Build a GitConfig the way the reference factory consumes a param
    dict (model.py:9-61)."""
    param = param or {}
    encoder = ENCODERS[param.get("image_encoder_type", "CLIPViT_B_16")]
    encoder = encoder.with_resolution(param.get("test_crop_size", 224))
    if param.get("fast_softmax"):
        encoder = dataclasses.replace(encoder, fast_softmax=True)
    return GitConfig(
        encoder=encoder,
        visual_feature_size=param.get("visual_feature_size", 768),
        num_image_with_embedding=param.get("num_image_with_embedding") or 0,
    )
