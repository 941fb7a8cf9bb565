"""Train-time augmentation, a copy of `gitax.preprocess.train_transforms`:
inception-style random resized crop with multi-scale crop sizes.

The reference protocol (data_layer/transform.py:61-107,
train.py:143-207): RandomResizedCrop(scale=(0.8, 1.0), ratio=(1, 1),
bicubic), no jitter or flip in GIT's fine-tuning recipe, CLIP
normalization, and crop sizes range(min, max + patch - 1, patch) picked
by `iteration % n`, so every data-parallel worker takes the same shape
each step.  Framework-free (PIL, numpy, `random`).  The one change from
gitax: PIL is imported where a crop needs it (`io.image.pil_image`), as
everywhere in the port, so `inception_crop`'s default interpolation is
None, which means BILINEAR, gitax's default.
`tests/test_torch_port_finetune.py` holds it to gitax's: the same crop
parameters and pixels for the same seed.
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

from ..io.image import pil_image
from .transforms import CLIP_MEAN, CLIP_STD, to_normalized_array


def random_resized_crop_params(
    width, height, scale=(0.8, 1.0), ratio=(1.0, 1.0), rng: Optional[random.Random] = None
):
    """Sample (left, top, w, h) like torchvision RandomResizedCrop:
    10 attempts of area*scale and log-uniform aspect, then center-crop
    fallback."""
    rng = rng or random
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(*log_ratio))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            left = rng.randint(0, width - w)
            top = rng.randint(0, height - h)
            return left, top, w, h
    # fallback: largest center crop within ratio bounds
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w = width
        h = int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        h = height
        w = int(round(h * ratio[1]))
    else:
        w, h = width, height
    left = (width - w) // 2
    top = (height - h) // 2
    return left, top, w, h


def _resolve_interpolation(interpolation):
    """Reference semantics (data_layer/transform.py:73-76): None ->
    BILINEAR, 'bicubic' -> BICUBIC, else pass through a PIL constant."""
    if interpolation is None:
        return pil_image().BILINEAR
    if interpolation == "bicubic":
        return pil_image().BICUBIC
    return interpolation


def inception_crop(img, crop_size: int, small_scale=0.8, no_aspect_dist=True, rng=None,
                   interpolation=None):
    ratio = (1.0, 1.0) if no_aspect_dist else (3.0 / 4.0, 4.0 / 3.0)
    left, top, w, h = random_resized_crop_params(
        img.size[0], img.size[1], scale=(small_scale, 1.0), ratio=ratio, rng=rng
    )
    return img.crop((left, top, left + w, top + h)).resize(
        (crop_size, crop_size), _resolve_interpolation(interpolation)
    )


class TrainTransform(object):
    """dict-in/dict-out transform: {'image': PIL, 'iteration': int} ->
    {'image': HWC f32}.  Multi-scale crop sizes follow the reference
    (train.py:186-207): sizes = range(min, max+patch-1, patch), index =
    iteration % n (train.py:143-156)."""

    def __init__(
        self,
        train_crop_size=224,
        min_size_range32=(160, 224),
        patch_size=16,
        small_scale=0.8,
        no_aspect_dist=True,
        mean=CLIP_MEAN,
        std=CLIP_STD,
        seed: Optional[int] = None,
        interpolation="bicubic",
    ):
        # default 'bicubic' = the reference training example recipe
        # (train.py:220,260); the reference function default is BILINEAR
        # (data_layer/transform.py:71) — pass interpolation=None for that
        if min_size_range32 is None:
            self.crop_sizes = [train_crop_size]
        else:
            self.crop_sizes = list(
                range(min_size_range32[0], min_size_range32[1] + patch_size - 1,
                      patch_size)
            )
        self.small_scale = small_scale
        self.no_aspect_dist = no_aspect_dist
        self.mean, self.std = mean, std
        self.interpolation = interpolation
        self.rng = random.Random(seed) if seed is not None else random

    def crop_size_for(self, iteration: int) -> int:
        return self.crop_sizes[iteration % len(self.crop_sizes)]

    def __call__(self, data: dict) -> dict:
        out = dict(data)
        size = self.crop_size_for(data.get("iteration", 0))
        img = inception_crop(
            data["image"], size, self.small_scale, self.no_aspect_dist, self.rng,
            interpolation=self.interpolation,
        )
        out["image"] = to_normalized_array(img, self.mean, self.std)
        return out


def make_caption_sample(tokenizer, image, prefix: str, target: str,
                        transform: TrainTransform, iteration=0, max_text_len=40):
    """Tokenized training sample (reference train.py:38-73):
    [CLS] + prefix + target + [SEP]; need_predict marks target + [SEP];
    tail-truncate to max_text_len keeping the last (max_text_len-2)."""
    penc = tokenizer(prefix, padding="do_not_pad", add_special_tokens=False,
                     truncation=True, max_length=max_text_len)["input_ids"]
    tenc = tokenizer(target, padding="do_not_pad", add_special_tokens=False,
                     truncation=True, max_length=max_text_len)["input_ids"]
    need_predict = [0] * len(penc) + [1] * len(tenc)
    payload = penc + tenc
    if len(payload) > max_text_len:
        payload = payload[-(max_text_len - 2):]
        need_predict = need_predict[-(max_text_len - 2):]
    input_ids = [tokenizer.cls_token_id] + payload + [tokenizer.sep_token_id]
    need_predict = [0] + need_predict + [1]
    data = transform({"image": image, "iteration": iteration})
    return {
        "image": data["image"],
        "caption_tokens": np.asarray(input_ids, np.int32),
        "need_predict": np.asarray(need_predict, np.int32),
    }


def collate_samples(samples):
    """Zero-pad each tensor field to the per-batch max shape and stack
    (reference data_layer/builder.py:5-34 semantics for dict batches)."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            max_shape = tuple(
                max(v.shape[d] for v in vals) for d in range(vals[0].ndim)
            )
            padded = []
            for v in vals:
                if v.shape != max_shape:
                    buf = np.zeros(max_shape, v.dtype)
                    buf[tuple(slice(0, s) for s in v.shape)] = v
                    v = buf
                padded.append(v)
            out[key] = np.stack(padded)
        else:
            out[key] = np.asarray(vals)
    return out
