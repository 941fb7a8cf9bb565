"""Test-time image sizing, the counterpart of `gitax.preprocess.transforms`.

Only the host arithmetic is ported: `min_max_resize_size`, the target
size of the reference's MinMaxResizeForTest (inference.py:29-64) that
the high-res models (GIT_*_VQAv2, GIT_*_TEXTVQA) use.  The resize itself
and JPEG decode (PIL in gitax) are not ported: the port's engine takes
uint8 HWC arrays already at their size.
"""

from __future__ import annotations


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
