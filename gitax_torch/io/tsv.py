"""Random-access TSV storage, wire-compatible with the reference format:
a copy of `gitax.io.tsv` (framework-free; the port imports nothing of
gitax).

A dataset is three files (reference tsv_io.py:121-374):
  * ``x.tsv``          — tab-separated rows, one record per line
  * ``x.lineidx``      — ascii byte offset of each row (legacy)
  * ``x.lineidx.8b``   — little-endian int64 offsets (preferred, random access)

This implementation memory-maps both the data file and the int64 offset
table with numpy, giving O(1) row access with no per-row file seeks, and
re-opens handles transparently after ``fork`` (the reference's pid check,
tsv_io.py:339-353) so DataLoader-style worker processes are safe.
"""

from __future__ import annotations

import os
import os.path as op
import shutil

import numpy as np

from . import fileio


def _sibling(tsv_path, ext):
    return op.splitext(tsv_path)[0] + ext


class TSVFile(object):
    def __init__(self, tsv_file):
        self.tsv_file = tsv_file
        self.lineidx = _sibling(tsv_file, ".lineidx")
        self.lineidx_8b = self.lineidx + ".8b"
        self._pid = None
        self._data = None
        self._offsets = None
        self._len = None

    # -- lazy, fork-safe mmaps -------------------------------------------
    def _ensure_open(self):
        pid = os.getpid()
        if self._data is None or self._pid != pid:
            # mmap needs a real local file; remote backends materialize
            # it here (the azfuse role, io/fileio.py)
            self._data = np.memmap(
                fileio.prepare(self.tsv_file), dtype=np.uint8, mode="r"
            )
            if fileio.isfile(self.lineidx_8b):
                self._offsets = np.memmap(
                    fileio.prepare(self.lineidx_8b), dtype="<i8", mode="r"
                )
            else:
                with fileio.open_file(self.lineidx, "r") as fp:
                    self._offsets = np.asarray(
                        [int(line) for line in fp if line.strip()], dtype=np.int64
                    )
            self._pid = pid
            self._len = len(self._offsets)

    def num_rows(self):
        if self._len is None:
            if fileio.isfile(self.lineidx_8b):
                self._len = fileio.getsize(self.lineidx_8b) // 8
            else:
                self._ensure_open()
        return self._len

    def __len__(self):
        return self.num_rows()

    def get_offset(self, idx):
        self._ensure_open()
        return int(self._offsets[idx])

    def row_bytes(self, idx):
        """Raw row bytes without the trailing newline.  Negative indices
        work list-like (numpy would silently pair row[-1]'s offset with
        row 0's end otherwise — an empty row, not an error)."""
        self._ensure_open()
        if idx < 0:
            idx += self._len
        if not 0 <= idx < self._len:
            raise IndexError(idx)
        start = self.get_offset(idx)
        end = (
            self.get_offset(idx + 1) if idx < self._len - 1 else self._data.shape[0]
        )
        row = self._data[start:end].tobytes()
        return row.rstrip(b"\n")

    def seek(self, idx):
        return [c.strip() for c in self.row_bytes(idx).decode("utf-8").split("\t")]

    def __getitem__(self, idx):
        return self.seek(idx)

    def get_key(self, idx):
        """First column only — avoids decoding the (often large) payload."""
        row = self.row_bytes(idx)
        tab = row.find(b"\t")
        return (row if tab < 0 else row[:tab]).decode("utf-8").strip()

    def __iter__(self):
        for i in range(len(self)):
            yield self.seek(i)

    def release(self):
        self._data = None
        self._offsets = None
        self._pid = None


def tsv_reader(tsv_file, sep="\t"):
    with fileio.open_file(tsv_file, "r") as fp:
        for line in fp:
            yield [x.strip() for x in line.split(sep)]


def tsv_writer(rows, tsv_file, sep="\t"):
    """Write rows plus both offset indices (reference tsv_io.py:356-374).

    All three files are written to ``*.tmp`` paths and atomically renamed
    into place at the end — index files first, data file LAST — so a
    concurrent reader polling ``isfile(x.tsv)`` (the rank-0 shard barrier,
    reference inference.py:214-225) never observes a partially written
    shard or a data file without its offset tables.  The reference got
    the same guarantee implicitly from azfuse close-time upload.
    """
    fileio.makedirs(op.dirname(tsv_file))
    lineidx = _sibling(tsv_file, ".lineidx")
    lineidx_8b = lineidx + ".8b"
    sep_b = sep.encode()
    offset = 0
    with fileio.open_file(tsv_file + ".tmp", "wb") as fp, fileio.open_file(
        lineidx + ".tmp", "w"
    ) as fpidx, fileio.open_file(lineidx_8b + ".tmp", "wb") as fp8b:
        for row in rows:
            assert row is not None
            cells = [v if isinstance(v, bytes) else str(v).encode() for v in row]
            line = sep_b.join(cells) + b"\n"
            fp.write(line)
            fpidx.write(str(offset) + "\n")
            fp8b.write(offset.to_bytes(8, "little"))
            offset += len(line)
    fileio.replace(lineidx + ".tmp", lineidx)
    fileio.replace(lineidx_8b + ".tmp", lineidx_8b)
    fileio.replace(tsv_file + ".tmp", tsv_file)


def concat_tsv_files(tsvs, out_tsv):
    """Concatenate shards and rebase their offset tables (tsv_io.py:22-31).

    Atomic like tsv_writer: everything lands under .tmp names and the
    renames publish the offset tables BEFORE the data file — consumers
    poll for the data file's existence (the reference's file barrier,
    inference.py:214-225), so it must appear last and never be visible
    half-written.  A STALE data file from a previous run at the same
    path is removed up front: with it present, the barrier contract is
    already broken and any rename order would let a poller pair old
    data with new offsets."""
    if len(tsvs) == 1 and tsvs[0] == out_tsv:
        return
    if fileio.isfile(out_tsv):
        fileio.remove(out_tsv)
    sizes = [fileio.getsize(t) for t in tsvs]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    with fileio.open_file(out_tsv + ".tmp", "wb") as fp_out:
        for t in tsvs:
            with fileio.open_file(t, "rb") as fp_in:
                shutil.copyfileobj(fp_in, fp_out, 10 * 1024 * 1024)
    out8b = _sibling(out_tsv, ".lineidx.8b")
    outidx = _sibling(out_tsv, ".lineidx")
    with fileio.open_file(out8b + ".tmp", "wb") as fp8b, fileio.open_file(
        outidx + ".tmp", "w"
    ) as fpidx:
        for t, base in zip(tsvs, starts):
            offs = (
                np.fromfile(fileio.prepare(_sibling(t, ".lineidx.8b")), dtype="<i8")
                + base
            )
            offs.astype("<i8").tofile(fp8b)
            fpidx.writelines(str(int(o)) + "\n" for o in offs)
    fileio.replace(outidx + ".tmp", outidx)
    fileio.replace(out8b + ".tmp", out8b)
    fileio.replace(out_tsv + ".tmp", out_tsv)
