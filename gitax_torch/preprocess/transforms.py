"""Test-time image preprocessing, the counterpart of
`gitax.preprocess.transforms` (reference inference.py:111-132):

  default models:  Resize(short side -> crop, bicubic) -> CenterCrop ->
                   RGB -> [0,1] -> Normalize(CLIP mean/std)
  high-res models: MinMaxResizeForTest(min, max) aspect-preserving resize
                   (inference.py:29-64), non-square output, no crop.

Each step takes an RGB PIL image and makes gitax's exact PIL calls; PIL
is imported where a step needs it (`io.image.pil_image`).  The output is
HWC float32, normalised on the host; the engine's on-device
normalisation of uint8 batches reads the transform's `mean` and `std`.
"""

from __future__ import annotations

import numpy as np

from ..io.image import image_from_base64, pil_image

CLIP_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], dtype=np.float32)


def resize_shorter(img, size: int):
    """Resize so the shorter side equals `size`, preserving aspect ratio
    (torchvision Resize(int) semantics)."""
    w, h = img.size
    if (w <= h and w == size) or (h <= w and h == size):
        return img
    if w < h:
        ow, oh = size, int(size * h / w)
    else:
        oh, ow = size, int(size * w / h)
    return img.resize((ow, oh), pil_image().BICUBIC)


def center_crop(img, size: int):
    """torchvision CenterCrop semantics, including zero-padding when the
    image is smaller than the crop."""
    w, h = img.size
    if w < size or h < size:
        padded = pil_image().new("RGB", (max(w, size), max(h, size)))
        padded.paste(img, ((padded.size[0] - w) // 2, (padded.size[1] - h) // 2))
        img, (w, h) = padded, padded.size
    left = int(round((w - size) / 2.0))
    top = int(round((h - size) / 2.0))
    return img.crop((left, top, left + size, top + size))


def min_max_resize_size(image_size, min_size, max_size):
    """Target (h, w) for a source of `image_size` = (w, h): the shorter
    side to `min_size`, unless the longer would then pass `max_size`, in
    which case the longer side goes to about `max_size` (inference.py:34-54)."""
    w, h = image_size
    size = min_size
    min_orig, max_orig = float(min(w, h)), float(max(w, h))
    if max_orig / min_orig * size > max_size:
        size = int(round(max_size * min_orig / max_orig))
    if (w <= h and w == size) or (h <= w and h == size):
        return (h, w)
    if w < h:
        return (int(size * h / w), size)
    return (size, int(size * w / h))


def min_max_resize(img, min_size: int, max_size: int):
    oh, ow = min_max_resize_size(img.size, min_size, max_size)
    return img.resize((ow, oh), pil_image().BICUBIC)


def to_normalized_array(img, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """PIL RGB -> HWC float32, scaled to [0,1] then normalized."""
    arr = np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0
    return (arr - mean) / std


class TestTransform(object):
    """Callable image -> HWC float32 array, configured like the reference's
    get_image_transform(param) (inference.py:111-132)."""

    def __init__(self, crop_size=224, respect_ratio_max=None, mean=CLIP_MEAN, std=CLIP_STD):
        self.crop_size = crop_size
        self.respect_ratio_max = respect_ratio_max
        self.mean, self.std = mean, std

    def __call__(self, img) -> np.ndarray:
        if self.respect_ratio_max is not None:
            img = min_max_resize(img, self.crop_size, self.respect_ratio_max)
        else:
            img = center_crop(resize_shorter(img, self.crop_size), self.crop_size)
        return to_normalized_array(img, self.mean, self.std)

    def __repr__(self):
        return "TestTransform(crop_size={}, respect_ratio_max={})".format(
            self.crop_size, self.respect_ratio_max
        )


def uint8_frame(img, crop_size: int, respect_ratio_max=None) -> np.ndarray:
    """PIL image -> the uint8 HWC array `TestTransform` would normalise: the
    MinMax size when `respect_ratio_max` is set, else the shorter side to
    `crop_size` and the centre crop."""
    if respect_ratio_max is not None:
        img = min_max_resize(img, crop_size, respect_ratio_max)
    else:
        img = center_crop(resize_shorter(img, crop_size), crop_size)
    return np.asarray(img, np.uint8)


def decode_uint8(payloads, crop_size: int, respect_ratio_max=None):
    """base64 payloads -> `uint8_frame` arrays, None for each that does not
    decode.  A module-level function, so that a process pool can run it."""
    out = []
    for p in payloads:
        img = image_from_base64(p)
        out.append(None if img is None else uint8_frame(img, crop_size, respect_ratio_max))
    return out


def get_image_transform(param):
    """Build the test transform from a model `param` dict
    (keys: test_crop_size, test_respect_ratio_max)."""
    return TestTransform(
        crop_size=param.get("test_crop_size", 224),
        respect_ratio_max=param.get("test_respect_ratio_max"),
    )
