"""Content-addressed caching file backend (the azfuse role, implemented),
a copy of gitax's `io/cache_backend.py` for the port's `io.fileio`
(`fileio.set_backend(CachingBackend(...))`).

The reference routes all IO through `azfuse.File`, whose contract is
download-to-local-cache: `File.prepare(path)` materializes the blob from
remote storage into a local cache and subsequent opens read the cached
copy (reference tsv_io.py:8, torch_common.py:5, aux_data/configs/
azfuse.yaml).  `CachingBackend` implements those semantics against a
pluggable fetch hook so any blob store can sit behind it:

  * fetch hook: a directory path (files addressed by relative path —
    the stand-in for a blob container) or a callable
    ``fetch(path) -> bytes | None``;
  * content-addressed cache: blobs land in ``cache_dir/objects/<sha256
    of content>`` (identical content cached once, however many paths
    point at it) with a per-path pointer file mapping path -> object;
  * eviction-free reuse: a path already materialized is NEVER re-fetched
    (azfuse's behavior for its read cache); `invalidate()` drops a
    pointer when a test/caller wants a re-fetch;
  * atomic materialization: object + pointer writes go through
    ``.tmp`` + rename, so concurrent ranks racing the same blob (the
    reference's normal mpirun mode) see either nothing or a complete
    file;
  * write-through: local writes also publish to the store on close /
    replace, so rank-0's barrier poll (`isfile` through the backend)
    sees shards written by other processes even when "local" disks are
    private (azfuse's upload side).

Local files always win: a path that exists on the local filesystem is
served from it directly, which keeps this backend a transparent overlay
(exactly how azfuse behaves under its fuse mount when the file is
already cached).
"""

from __future__ import annotations

import hashlib
import io
import os
import os.path as op
from typing import Callable, Optional, Union


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    """tmp + rename publication: concurrent readers (other ranks racing
    the same blob) see either nothing or the complete file."""
    tmp = path + ".tmp.{}".format(os.getpid())
    with open(tmp, "wb") as fp:
        fp.write(data)
    os.replace(tmp, path)


def _path_key(path: str) -> str:
    # normalize so "a/b", "./a/b" address the same blob
    return _sha256(op.normpath(path).encode("utf-8"))


class DirectoryStore(object):
    """Blob store backed by a plain directory (relative-path addressed)."""

    def __init__(self, root: str):
        self.root = root

    def _local(self, path: str) -> str:
        rel = op.normpath(path).lstrip(os.sep)
        return op.join(self.root, rel)

    def fetch(self, path: str) -> Optional[bytes]:
        p = self._local(path)
        if not op.isfile(p):
            return None
        with open(p, "rb") as fp:
            return fp.read()

    def exists(self, path: str) -> bool:
        return op.isfile(self._local(path))

    def put(self, path: str, data: bytes) -> None:
        p = self._local(path)
        d = op.dirname(p)
        if d:
            os.makedirs(d, exist_ok=True)
        _atomic_write(p, data)

    def delete(self, path: str) -> None:
        p = self._local(path)
        if op.isfile(p):
            os.remove(p)


class _WriteThroughFile(io.FileIO):
    """Local file that publishes its bytes to the store when closed —
    but only if the content actually changed: a read-only 'r+' handle
    must NOT re-publish (possibly stale) bytes over a concurrent
    update another rank pushed to the store."""

    def __init__(self, local_path, mode, publish):
        super().__init__(local_path, mode)
        self._publish = publish
        self._local_path = local_path
        # 'w'/'x' truncate on open: the content changed even if nothing
        # is ever written.  'a'/'r+' start clean until a write happens.
        self._dirty = ("w" in mode) or ("x" in mode)

    def write(self, data):
        self._dirty = True
        return super().write(data)

    def truncate(self, size=None):
        self._dirty = True
        return super().truncate(size)

    def close(self):
        was_open = not self.closed
        super().close()
        if was_open and self._dirty and self._publish is not None:
            with open(self._local_path, "rb") as fp:
                self._publish(fp.read())
            self._publish = None


class CachingBackend(object):
    """azfuse-semantics backend: reads materialize through a
    content-addressed local cache; writes go local + write-through."""

    def __init__(
        self,
        fetch: Union[str, Callable[[str], Optional[bytes]], DirectoryStore],
        cache_dir: str,
        write_through: bool = True,
    ):
        if isinstance(fetch, str):
            fetch = DirectoryStore(fetch)
        self.store = fetch if isinstance(fetch, DirectoryStore) else None
        self._fetch = fetch.fetch if isinstance(fetch, DirectoryStore) else fetch
        self.cache_dir = cache_dir
        self.write_through = write_through and self.store is not None
        self._objects = op.join(cache_dir, "objects")
        self._paths = op.join(cache_dir, "paths")
        os.makedirs(self._objects, exist_ok=True)
        os.makedirs(self._paths, exist_ok=True)
        self.fetch_count = 0  # observability: cache-reuse tests read this

    # -- cache internals ---------------------------------------------------
    def _pointer(self, path: str) -> str:
        return op.join(self._paths, _path_key(path))

    def _cached_object(self, path: str) -> Optional[str]:
        ptr = self._pointer(path)
        if not op.isfile(ptr):
            return None
        with open(ptr, "r") as fp:
            obj = op.join(self._objects, fp.read().strip())
        return obj if op.isfile(obj) else None

    def _materialize(self, path: str) -> Optional[str]:
        """Local path for `path`: the file itself if it exists locally,
        else the cached object, else fetch + cache (atomic)."""
        if op.isfile(path):
            return path
        cached = self._cached_object(path)
        if cached is not None:
            return cached
        data = self._fetch(path)
        if data is None:
            return None
        self.fetch_count += 1
        digest = _sha256(data)
        obj = op.join(self._objects, digest)
        if not op.isfile(obj):
            _atomic_write(obj, data)
        _atomic_write(self._pointer(path), digest.encode("ascii"))
        return obj

    def invalidate(self, path: str) -> None:
        """Drop the path->object pointer so the next read re-fetches."""
        ptr = self._pointer(path)
        if op.isfile(ptr):
            os.remove(ptr)

    def _publish_and_repoint(self, path: str, data: bytes) -> None:
        """Write-through publish + refresh the content-address pointer:
        after an update the old pointer names the PRE-update object, and
        a lost local copy would silently serve stale bytes."""
        self.store.put(path, data)
        digest = _sha256(data)
        obj = op.join(self._objects, digest)
        if not op.isfile(obj):
            _atomic_write(obj, data)
        _atomic_write(self._pointer(path), digest.encode("ascii"))

    # -- backend interface (gitax_torch.io.fileio) -------------------------
    def open(self, path: str, mode: str = "r"):
        writing = any(m in mode for m in "wax+")
        if writing:
            d = op.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            # update/append modes build on existing content: materialize a
            # PRIVATE local copy first — never hand out a writable handle
            # on the shared content-addressed object ('r+' on the dedup
            # object would corrupt every path mapped to the same digest).
            preserves = ("a" in mode) or ("r" in mode and "+" in mode)
            if preserves and not op.isfile(path):
                local = self._materialize(path)
                if local is None and "r" in mode:
                    raise FileNotFoundError(path)
                if local is not None and local != path:
                    with open(local, "rb") as fp:
                        _atomic_write(path, fp.read())
            if self.write_through:
                publish = lambda data: self._publish_and_repoint(path, data)  # noqa: E731
            else:
                # local-only write: the pointer (if any) now names stale
                # content — drop it so a lost local copy re-fetches
                # rather than resurrecting the pre-write object
                publish = lambda data: self.invalidate(path)  # noqa: E731
            raw = _WriteThroughFile(path, mode.replace("b", ""), publish)
            return raw if "b" in mode else io.TextIOWrapper(raw)
        local = self._materialize(path)
        if local is None:
            raise FileNotFoundError(path)
        return open(local, mode)

    def isfile(self, path: str) -> bool:
        if op.isfile(path) or self._cached_object(path) is not None:
            return True
        if self.store is not None:
            return self.store.exists(path)
        # callable hook with no exists(): materialize-and-cache on the
        # probe so a barrier polling isfile() doesn't re-download the
        # blob every cycle just to discard it
        return self._materialize(path) is not None

    def getsize(self, path: str) -> int:
        local = self._materialize(path)
        if local is None:
            raise FileNotFoundError(path)
        return op.getsize(local)

    def makedirs(self, path: str) -> None:
        if path:
            os.makedirs(path, exist_ok=True)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)
        if self.write_through:
            with open(dst, "rb") as fp:
                self.store.put(dst, fp.read())
            # src no longer exists locally; retract its published copy
            # (atomic-rename publication: only dst must be visible)
            self.store.delete(src)

    def remove(self, path: str) -> None:
        if op.isfile(path):
            os.remove(path)
        if self.write_through:
            self.store.delete(path)
        self.invalidate(path)

    def prepare(self, path: str) -> str:
        """azfuse File.prepare: materialize and return a LOCAL path
        (mmap-able — the TSV reader maps it directly)."""
        local = self._materialize(path)
        if local is None:
            raise FileNotFoundError(path)
        return local
