"""Build the port's CUDA kernels from `gitax_torch/csrc` at first use.

Each kernel is one `.cu` file with a plain C entry point, compiled by
`nvcc` for `sm_90a` into a shared library and loaded with ctypes;
`build_all` compiles several sources at once, one nvcc each.  The
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

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gitax_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"

# name -> loaded library
_LOADED = {}
# name -> seconds its compile took in this process
_BUILT = {}


def refuse_autograd(module: str, *tensors) -> None:
    """Raise when autograd would record a kernel call: grad mode on and an
    input that requires grad.  The kernels have no backward, as gitax's
    Pallas kernels have no VJP, and an output written through raw
    pointers carries no grad_fn: training through one would get a zero
    gradient and no error.  There is no fallback to the plain version."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "{}: the CUDA kernel has no backward; call it under torch.no_grad() or "
            "torch.inference_mode(), or take the plain path (training's forward_logits "
            "passes flash=False, as gitax's does)".format(module))


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


def build_all(names) -> None:
    """Compile each csrc/<name>.cu whose library for this source does not
    exist yet: one nvcc per source, all started together.  The compiler's
    report (registers, shared memory, spills) is kept beside each library
    as `<lib>.log`.  Raises, naming every source that failed."""
    pending = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not pending:
        return
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in pending:
        out = library_path(name)
        tmp = out.with_name(out.name + ".{}.tmp".format(os.getpid()))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / (name + ".cu"))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            errors.append("nvcc failed on {} (exit {}):\n{}{}".format(
                name, proc.returncode, stdout, stderr))
            continue
        out.with_name(out.name + ".log").write_text(stdout + stderr)
        os.replace(tmp, out)
        _BUILT[name] = time.perf_counter() - t0
    if errors:
        raise RuntimeError("\n".join(errors))


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless the library for this source exists."""
    build_all([name])
    return library_path(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]


def build_seconds(name: str) -> float:
    """Seconds from the start of this process's compile of `name` (with
    the sources built beside it) to its end; 0.0 if it was not compiled
    here."""
    return _BUILT.get(name, 0.0)


def build_log(name: str) -> str:
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""
