"""Host-side image decoding, the counterpart of `gitax.io.image`
(reference process_image.py:4-13, common.py:213-221): PIL decodes, as in
gitax.  PIL is imported where a decode needs it, so that the rest of the
port imports without it; a decode without PIL raises an ImportError that
names it, never None: the TSV loops drop a row whose decode gives None,
so a missing decoder must not look like a bad row.
"""

from __future__ import annotations

import base64
import io


def pil_image():
    """PIL's Image module; an ImportError naming PIL where it is not
    installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("image decoding and resizing need PIL (Pillow), which is not "
                          "installed") from e
    return Image


def load_image(source):
    """Open an image from a path or raw bytes as RGB PIL."""
    if not isinstance(source, (str, bytes)):
        raise TypeError("expected path or bytes, got {}".format(type(source)))
    Image = pil_image()
    if isinstance(source, str):
        return Image.open(source).convert("RGB")
    return Image.open(io.BytesIO(source)).convert("RGB")


def image_from_base64(b64string):
    """Decode a base64 jpeg/png payload to RGB PIL; None on a corrupt
    payload (reference common.py:213-221 semantics, which the TSV loops
    rely on).  Without PIL it raises."""
    pil_image()
    try:
        return load_image(base64.b64decode(b64string))
    except Exception:
        return None
