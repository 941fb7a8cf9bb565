"""Pluggable file-opener seam (the azfuse role, reference tsv_io.py:8):
a copy of `gitax.io.fileio`, which the port's TSV, checkpoint and config
readers go through.

The reference routes every file open through `azfuse.File`, which
transparently materializes blobs from cloud storage.  gitax runs
zero-egress, so the default backend is the local filesystem — but the
seam exists so a remote/cached backend can be installed process-wide
without touching the IO call sites (C34 in SURVEY.md §2):

    from gitax_torch.io import fileio
    fileio.set_backend(MyBlobBackend())

A backend supplies open/isfile/getsize/makedirs/replace.  TSV readers
and writers, checkpoint loading, and config reads all go through this
module.
"""

from __future__ import annotations

import os
import os.path as op


class LocalBackend(object):
    """Plain local filesystem (the default)."""

    @staticmethod
    def open(path, mode="r"):
        d = op.dirname(path)
        if d and ("w" in mode or "a" in mode or "x" in mode):
            os.makedirs(d, exist_ok=True)
        return open(path, mode)

    @staticmethod
    def isfile(path):
        return op.isfile(path)

    @staticmethod
    def getsize(path):
        return op.getsize(path)

    @staticmethod
    def makedirs(path):
        if path:
            os.makedirs(path, exist_ok=True)

    @staticmethod
    def replace(src, dst):
        os.replace(src, dst)

    @staticmethod
    def remove(path):
        os.remove(path)

    @staticmethod
    def prepare(path):
        """Materialize `path` locally and return the local path (remote
        backends download-to-cache here, like azfuse File.prepare;
        needed before mmap access)."""
        return path


_backend = LocalBackend()


def set_backend(backend):
    """Install a process-wide file backend (azfuse-style remote layer).
    Passing None restores the default local-filesystem backend."""
    global _backend
    _backend = LocalBackend() if backend is None else backend


def get_backend():
    return _backend


def open_file(path, mode="r"):
    return _backend.open(path, mode)


def isfile(path):
    return _backend.isfile(path)


def getsize(path):
    return _backend.getsize(path)


def makedirs(path):
    return _backend.makedirs(path)


def replace(src, dst):
    return _backend.replace(src, dst)


def remove(path):
    # default for custom backends that predate this method: best effort
    fn = getattr(_backend, "remove", None)
    if fn is None:
        return os.remove(path)
    return fn(path)


def prepare(path):
    return _backend.prepare(path)
