"""Build the port's CUDA kernels from `gitax_torch/csrc` at first use.

Each kernel is one `.cu` file with a plain C entry point, compiled by
`nvcc` for `sm_90a` into a shared library and loaded with ctypes.  The
library is keyed by a hash of the source and the flags and written to
`build/gitax_torch/` at the root of the checkout, so a changed source
rebuilds and an unchanged one loads in milliseconds.  Nothing is built
when a module is imported, and there is no fallback: a missing `nvcc` or
a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gitax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# name -> (loaded library, seconds the build took, 0.0 if it was cached)
_LOADED = {}


def find_nvcc() -> str:
    """Path of nvcc from $CUDA_HOME, $PATH or /usr/local/cuda; raises if
    there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        DEFAULT_NVCC,
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (checked $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the gitax_torch CUDA kernels are compiled from gitax_torch/csrc at "
        "first use and have no fallback on a CUDA device"
    )


def library_path(name: str) -> Path:
    src = (CSRC_DIR / (name + ".cu")).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / "lib{}-{}.so".format(name, digest)


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists.
    The compiler's report (registers, shared memory, spills) is kept
    beside the library as `<lib>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".{}.tmp".format(os.getpid()))
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / (name + ".cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "nvcc failed on {} (exit {}):\n{}{}".format(
                name, proc.returncode, proc.stdout, proc.stderr
            )
        )
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _LOADED:
        t0 = time.perf_counter()
        existed = library_path(name).exists()
        lib = ctypes.CDLL(str(build(name)))
        _LOADED[name] = (lib, 0.0 if existed else time.perf_counter() - t0)
    return _LOADED[name][0]


def build_seconds(name: str) -> float:
    """Seconds the first `load(name)` of this process spent compiling."""
    return _LOADED[name][1]


def build_log(name: str) -> str:
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""
