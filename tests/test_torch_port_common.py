"""The port's copies of gitax's framework-free helpers held to gitax's:
`common` (the `$`-path helpers, `Config`, the locked and retried reads,
`progress`), `runtime/profiling.py` (`StepLogger`, `ThroughputMeter`;
`trace` records torch.profiler where gitax records jax.profiler) and
`io/cache_backend.py`.  Each copy's code equals gitax's by AST (docstrings
aside), and gitax's own cases of tests/test_common.py and
tests/test_cache_backend.py that apply run here against the port's
modules (gitax's test files stay as they are)."""

import ast
import inspect
import json
import logging
import os
import os.path as op
import shutil

import numpy as np
import pytest
import torch

import gitax.common as gx_common
import gitax.io.cache_backend as gx_cache_backend
import gitax.runtime.profiling as gx_profiling
from gitax_torch import common
from gitax_torch.io import cache_backend, fileio
from gitax_torch.io.cache_backend import CachingBackend
from gitax_torch.io.tsv import TSVFile, _sibling, concat_tsv_files, tsv_writer
from gitax_torch.runtime import profiling


def code_of(obj):
    """ast.dump of a function, class or module with its docstrings and
    those of its members dropped."""
    tree = ast.parse(inspect.getsource(obj))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", ["dict_remove_path", "Config", "release_lock",
                                  "limited_retry_agent", "progress"])
def test_common_copies_equal_gitax_by_ast(name):
    assert code_of(getattr(common, name)) == code_of(getattr(gx_common, name))


@pytest.mark.parametrize("name", ["StepLogger", "ThroughputMeter"])
def test_profiling_copies_equal_gitax_by_ast(name):
    assert code_of(getattr(profiling, name)) == code_of(getattr(gx_profiling, name))


def test_cache_backend_equals_gitax_by_ast():
    assert code_of(cache_backend) == code_of(gx_cache_backend)


# ---------------------------------------------------------------------------
# gitax tests/test_common.py's cases that apply to the copies
# ---------------------------------------------------------------------------


def test_dict_path_helpers():
    d = {"a": {"b": {"c": 1}}, "l": [10, {"x": 2}]}
    assert common.dict_has_path(d, "a$b$c")
    assert common.dict_get_path_value(d, "a$b$c") == 1
    assert common.dict_get_path_value(d, "l$1$x") == 2
    assert not common.dict_has_path(d, "a$b$missing")
    common.dict_update_path_value(d, "a$b$d", 5)
    assert d["a"]["b"]["d"] == 5
    common.dict_update_path_value(d, "new$nested", 7)
    assert d["new"]["nested"] == 7
    common.dict_remove_path(d, "a$b$c")
    assert d["a"]["b"] == {"d": 5}


def test_config_missing_returns_none():
    cfg = common.Config({"x": 1, "nested": {"y": 2}}, {"x": 3})
    assert cfg.x == 3
    assert cfg.get("nested$y") == 2
    assert cfg.not_there is None


def test_config_dict_merge():
    cfg = common.Config({"d": {"a": 1, "b": 2}}, {"d": {"b": 3}})
    assert cfg.d == {"a": 1, "b": 3}
    assert cfg.get_dict() == {"d": {"a": 1, "b": 3}}


def test_exclusive_open_to_read_locks_in_the_port_prefix(tmp_path, monkeypatch):
    """The read takes the port's lock file in the temporary directory,
    unless gitax's env var switches the lock off; a failing open is
    retried, then raises."""
    (tmp_path / "tmp").mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    path = tmp_path / "data.txt"
    path.write_text("payload")
    monkeypatch.delenv("GITAX_DISABLE_EXCLUSIVE_READ", raising=False)
    monkeypatch.delenv("QD_DISABLE_EXCLUSIVE_READ_BY_LOCK", raising=False)
    with common.exclusive_open_to_read(str(path)) as fp:
        assert fp.read() == "payload"
    locks = os.listdir(str(tmp_path / "tmp"))
    assert locks == ["gitax_torch_lock_" + common.hash_sha1(str(path))]
    monkeypatch.setenv("GITAX_DISABLE_EXCLUSIVE_READ", "1")
    with common.exclusive_open_to_read(str(path)) as fp:
        assert fp.read() == "payload"
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("transient")
        return "ok"

    monkeypatch.setattr("random.random", lambda: 0.0)
    assert common.limited_retry_agent(3, flaky) == "ok" and len(calls) == 2
    with pytest.raises(OSError):
        common.limited_retry_agent(2, lambda: (_ for _ in ()).throw(OSError("down")))


def test_progress_stamps_the_callers_line():
    bar = common.progress(range(3), desc="rows")
    assert list(bar) == [0, 1, 2]
    assert bar.desc.startswith("test_torch_port_common.py:") and bar.desc.endswith(" rows")


def test_step_logger_logs_window_extremes(caplog):
    caplog.set_level(logging.INFO)
    log = profiling.StepLogger(log_every=2)
    log.update(1, {"loss": 3.0})
    log.update(2, {"loss": 1.0, "lr": 0.5})
    assert "step=2 loss=1.0000 window_min=1.0000 window_max=3.0000 {'lr': 0.5}" in caplog.text


def test_trace_writes_a_chrome_trace(tmp_path):
    """`trace` records the block with torch.profiler (its kernels too where
    a card is present) and writes a Chrome trace under logdir."""
    with profiling.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.load(open(str(tmp_path / "t" / "trace.json")))["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    assert any("aten::mm" in e.key for e in prof.key_averages())


# ---------------------------------------------------------------------------
# gitax tests/test_cache_backend.py's cases against the port's io
# ---------------------------------------------------------------------------


@pytest.fixture
def backend(tmp_path):
    store = str(tmp_path / "blobstore")
    cache = str(tmp_path / "cache")
    os.makedirs(store)
    b = CachingBackend(store, cache)
    fileio.set_backend(b)
    yield b
    fileio.set_backend(fileio.LocalBackend())


def _put_tsv_in_store(store_root, rel, rows):
    tmp = op.join(store_root, "_stage")
    local = op.join(tmp, op.basename(rel))
    tsv_writer(rows, local)
    for src in (local, _sibling(local, ".lineidx"), _sibling(local, ".lineidx") + ".8b"):
        dst = op.join(store_root, op.dirname(rel), op.basename(src))
        os.makedirs(op.dirname(dst), exist_ok=True)
        shutil.move(src, dst)
    shutil.rmtree(tmp)


def test_tsv_read_materializes_and_reuses(backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rows = [("k{}".format(i), json.dumps([{"caption": "c{}".format(i)}])) for i in range(5)]
    _put_tsv_in_store(backend.store.root, "data/img.tsv", rows)
    assert not op.exists(op.join(str(tmp_path), "data/img.tsv"))
    t = TSVFile("data/img.tsv")
    assert len(t) == 5 and tuple(t[3]) == rows[3]
    n_after_first = backend.fetch_count
    assert n_after_first >= 1
    t2 = TSVFile("data/img.tsv")
    assert tuple(t2[0]) == rows[0]
    assert backend.fetch_count == n_after_first
    for p in ("data/img.tsv", "data/img.lineidx.8b", "data/img.lineidx"):
        backend.invalidate(p)
    assert tuple(TSVFile("data/img.tsv")[4]) == rows[4]
    assert backend.fetch_count > n_after_first


def test_content_dedup_across_paths(backend):
    backend.store.put("a/one.bin", b"same-bytes")
    backend.store.put("b/two.bin", b"same-bytes")
    assert fileio.prepare("a/one.bin") == fileio.prepare("b/two.bin")
    with fileio.open_file("a/one.bin", "rb") as fp:
        assert fp.read() == b"same-bytes"


def test_checkpoint_load_through_backend(backend, tmp_path, monkeypatch):
    from gitax_torch.ckpt import load_torch_checkpoint

    monkeypatch.chdir(tmp_path)
    stage = str(tmp_path / "model.pt")
    torch.save({"model": {"module.layer.weight": torch.arange(6.0).view(2, 3)}}, stage)
    with open(stage, "rb") as fp:
        backend.store.put("output/M/snapshot/model.pt", fp.read())
    os.remove(stage)
    loaded = load_torch_checkpoint("output/M/snapshot/model.pt")
    assert set(loaded) == {"layer.weight"}
    np.testing.assert_array_equal(loaded["layer.weight"].numpy(),
                                  np.arange(6, dtype=np.float32).reshape(2, 3))
    n = backend.fetch_count
    load_torch_checkpoint("output/M/snapshot/model.pt")
    assert backend.fetch_count == n


def test_write_through_and_barrier_visibility(backend, tmp_path, monkeypatch):
    from gitax_torch.runtime.engine import wait_and_concat_shards

    a, b = tmp_path / "machineA", tmp_path / "machineB"
    a.mkdir(), b.mkdir()
    monkeypatch.chdir(a)
    tsv_writer([("k0", "x")], "out.tsv.0.2.tsv")
    tsv_writer([("k1", "y")], "out.tsv.1.2.tsv")
    assert backend.store.exists("out.tsv.0.2.tsv")
    assert not backend.store.exists("out.tsv.0.2.tsv.tmp")
    monkeypatch.chdir(b)
    assert not op.isfile("out.tsv.0.2.tsv")
    wait_and_concat_shards("out.tsv", 2, poll_s=0.05, timeout_s=5)
    t = TSVFile("out.tsv")
    assert [tuple(t[i]) for i in range(2)] == [("k0", "x"), ("k1", "y")]


def test_concat_through_backend(backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tsv_writer([("a", "1"), ("b", "2")], "s0.tsv")
    tsv_writer([("c", "3")], "s1.tsv")
    concat_tsv_files(["s0.tsv", "s1.tsv"], "merged.tsv")
    t = TSVFile("merged.tsv")
    assert [t.get_key(i) for i in range(3)] == ["a", "b", "c"]
    assert backend.store.exists("merged.tsv")


def test_missing_file_raises(backend):
    assert not fileio.isfile("never/written.tsv")
    with pytest.raises(FileNotFoundError):
        fileio.prepare("never/written.tsv")
    with pytest.raises(FileNotFoundError):
        fileio.open_file("never/written.tsv", "rb")


def test_callable_fetch_hook(tmp_path):
    calls = []

    def fetch(path):
        calls.append(path)
        return b"payload" if path == "x.bin" else None

    b = CachingBackend(fetch, str(tmp_path / "cache"), write_through=False)
    assert b.isfile("x.bin")
    for _ in range(2):
        with b.open("x.bin", "rb") as fp:
            assert fp.read() == b"payload"
    assert calls.count("x.bin") == 1
    assert not b.isfile("y.bin")


def test_update_modes_never_touch_shared_objects(backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    backend.store.put("blob/a.txt", b"hello")
    backend.store.put("blob/b.txt", b"hello")
    with backend.open("blob/a.txt", "rb+") as fp:
        assert fp.read() == b"hello"
        fp.seek(0)
        fp.write(b"HELLO")
    with backend.open("blob/a.txt", "rb") as fp:
        assert fp.read() == b"HELLO"
    backend.invalidate("blob/b.txt")
    with backend.open("blob/b.txt", "rb") as fp:
        assert fp.read() == b"hello"
    backend.store.put("blob/log.txt", b"line1\n")
    with backend.open("blob/log.txt", "ab") as fp:
        fp.write(b"line2\n")
    with backend.open("blob/log.txt", "rb") as fp:
        assert fp.read() == b"line1\nline2\n"
    with pytest.raises(FileNotFoundError):
        backend.open("blob/missing.txt", "rb+")


def test_readonly_update_handle_does_not_republish(backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    backend.store.put("blob/cfg.txt", b"v1")
    with backend.open("blob/cfg.txt", "rb+") as fp:
        assert fp.read() == b"v1"
        backend.store.put("blob/cfg.txt", b"v2")
    assert backend.store.fetch("blob/cfg.txt") == b"v2"
    with backend.open("blob/cfg.txt", "rb+") as fp:
        fp.write(b"v3")
    assert backend.store.fetch("blob/cfg.txt") == b"v3"


def test_pointer_refreshed_after_update(backend, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    backend.store.put("blob/state.bin", b"old")
    with backend.open("blob/state.bin", "rb") as fp:
        assert fp.read() == b"old"
    with backend.open("blob/state.bin", "ab") as fp:
        fp.write(b"+new")
    os.remove(op.join(str(tmp_path), "blob", "state.bin"))
    with backend.open("blob/state.bin", "rb") as fp:
        assert fp.read() == b"old+new"
