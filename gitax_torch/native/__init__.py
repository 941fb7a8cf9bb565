"""The native host data path, the counterpart of `gitax.native`: threaded
base64 + libjpeg decode + PIL-kernel resize + center crop (or MinMax),
uint8 out, in `dataloader.cpp` (gitax's source; only the module's init
name differs, and a test holds the rest equal).

It is built with g++ against libjpeg at first use, never at import, into
`build/gitax_torch/` at the root of the checkout (the kernels' build
directory), under a name keyed by the source's and the flags' hash; the
object is compiled to a temporary name and renamed into place, so that
processes that race on a missing object never load a half-written one.

Where the toolchain or libjpeg is missing the build fails once per
process: `available()` is then False and `unavailable_reason()` holds the
build log's last lines.  That is gitax's rule for a host library (its
engine's `use_native=None` decodes with PIL there), not a device or
kernel fallback: the machine with the H100 has no `jpeglib.h`.
"""

from __future__ import annotations

import hashlib
import importlib.util
import logging
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

SRC = Path(__file__).resolve().with_name("dataloader.cpp")
MODULE = "_gitax_torch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_module = None
_error = None  # the reason the build failed, once it has


def so_path() -> Path:
    """The object for this source, flags and interpreter."""
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS + LIBS).encode()).hexdigest()[:16]
    tag = sysconfig.get_config_var("SOABI") or "cpython"
    return BUILD_DIR / "{}.{}.{}.so".format(MODULE, key, tag)


def _build() -> Path:
    so = so_path()
    if so.is_file():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("{}.tmp.{}".format(so.name, os.getpid()))
    cmd = (["g++"] + list(FLAGS) + ["-I", sysconfig.get_paths()["include"], str(SRC)]
           + list(LIBS) + ["-o", str(tmp)])
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++
        raise RuntimeError("g++ could not run: {}".format(e)) from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = (r.stderr + r.stdout).strip().splitlines()
        errors = [line for line in lines if "error" in line.lower()] or lines[-3:]
        raise RuntimeError("g++ exit {}: {}".format(r.returncode, " | ".join(
            line.strip() for line in errors[:3])))
    os.replace(tmp, so)
    return so


def _load():
    global _module, _error
    if _module is not None or _error is not None:
        return _module
    try:
        so = _build()
        spec = importlib.util.spec_from_file_location(MODULE, so)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _module = mod
    except Exception as e:  # toolchain or libjpeg missing
        _error = "{}: {}".format(type(e).__name__, e)
        logging.info("gitax_torch native loader unavailable (%s); images decode with PIL",
                     _error)
    return _module


def available() -> bool:
    """Whether the loader built (building it at the first call)."""
    return _load() is not None


def unavailable_reason():
    """Why the loader did not build (the build log's error lines), or None
    where it built."""
    _load()
    return _error


def _require():
    mod = _load()
    if mod is None:
        raise RuntimeError("the native loader did not build: {}".format(_error))
    return mod


def decode_resize_crop_batch(payloads, crop_size, is_base64=True, threads=None,
                             fast_scale=True):
    """payloads: list[bytes] -> (images uint8 [N, crop, crop, 3], ok
    bool [N]); a failed decode leaves a zeroed row with ok False.
    fast_scale: libjpeg's reduced-scale IDCT (the short side kept >= the
    crop), much faster on large photos with small pixel differences
    against the full decode; False for PIL-parity pixels."""
    mod = _require()
    threads = threads or min(16, os.cpu_count() or 4)
    buf, ok = mod.decode_resize_crop_batch(list(payloads), int(crop_size), bool(is_base64),
                                           int(threads), bool(fast_scale))
    arr = np.frombuffer(buf, np.uint8).reshape(len(payloads), crop_size, crop_size, 3)
    return arr, np.asarray(ok, bool)


def decode_minmax_batch(payloads, min_size, max_size, is_base64=True, threads=None,
                        fast_scale=True):
    """payloads: list[bytes] -> list of uint8 [h, w, 3] arrays (None for a
    failed decode) at each image's own MinMax size
    (`preprocess.transforms.min_max_resize_size`: aspect kept, no crop),
    the high-res family's transform."""
    mod = _require()
    threads = threads or min(16, os.cpu_count() or 4)
    rows = mod.decode_minmax_batch(list(payloads), int(min_size), int(max_size),
                                   bool(is_base64), int(threads), bool(fast_scale))
    out = []
    for row in rows:
        if row is None:
            out.append(None)
        else:
            buf, h, w = row
            out.append(np.frombuffer(buf, np.uint8).reshape(h, w, 3))
    return out


def b64_decode(payload: bytes):
    """The loader's base64 decoder: bytes, or None on a malformed payload."""
    return _require().b64_decode(payload)
