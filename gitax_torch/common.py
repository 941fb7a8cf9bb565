"""Config, CLI dispatch, logging, file and process-rank helpers: the part
of `gitax.common` that the port's CLI uses, copied (that module imports
PyYAML at module level, and the port must import where PyYAML is absent).
`tests/test_torch_port_tsv.py` holds each copy equal to gitax's.

Copied: the `$`-path dict helpers (`dict_remove_path` too) and the
two-layer `Config`, the `-c/-p/-bp` YAML CLI convention and
`dispatch_main`, `init_logging`, `json_dump` (its separators and key
order fix the bytes of every output TSV), `hash_sha1`, `write_to_file`,
`read_to_buffer`, `ensure_directory`, `load_list_file`, the env-var rank
discovery, the locked and retried reads (`acquire_lock`, `release_lock`,
`limited_retry_agent`, `exclusive_open_to_read`, which reads gitax's env
vars GITAX_DISABLE_EXCLUSIVE_READ and QD_DISABLE_EXCLUSIVE_READ_BY_LOCK)
and `progress`.  Changed: PyYAML is imported inside the two YAML readers
(only a `parameter.yaml` or a `-p` string needs it), an initialised
`torch.distributed` process group wins over the env vars where gitax
asks `jax.distributed`, and the lock files carry the port's prefix
(`gitax_torch_lock...`) in the temporary directory (gitax's /tmp).
"""

from __future__ import annotations

import argparse
import base64
import copy
import hashlib
import json
import logging
import os
import os.path as op
import sys


def _as_index(key):
    try:
        return int(key)
    except (TypeError, ValueError):
        return None


def dict_has_path(d, path):
    cur = d
    for part in path.split("$"):
        if isinstance(cur, dict) and part in cur:
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            idx = _as_index(part)
            if idx is None or not (-len(cur) <= idx < len(cur)):
                return False
            cur = cur[idx]
        else:
            return False
    return True


def dict_get_path_value(d, path):
    cur = d
    for part in path.split("$"):
        if isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            cur = cur[part]
    return cur


def dict_update_path_value(d, path, value):
    parts = path.split("$")
    cur = d
    for part in parts[:-1]:
        if part not in cur:
            cur[part] = {}
        cur = cur[part]
    cur[parts[-1]] = value


def dict_remove_path(d, path):
    parts = path.split("$")
    cur = d
    for part in parts[:-1]:
        cur = cur[part]
    del cur[parts[-1]]


def get_all_path(d, with_list=True, leaf_only=True):
    """Enumerate '$'-joined paths to the leaves of a nested structure."""
    paths = []
    if isinstance(d, dict):
        items = d.items()
    elif isinstance(d, (list, tuple)) and with_list:
        items = ((str(i), v) for i, v in enumerate(d))
    else:
        return paths
    for k, v in items:
        sub = get_all_path(v, with_list=with_list, leaf_only=leaf_only)
        paths.extend("{}${}".format(k, p) for p in sub)
        if not leaf_only or not sub:
            paths.append(str(k))
    return paths


def dict_update_nested_dict(a, b, overwrite=True):
    for k, v in b.items():
        if k not in a:
            dict_update_path_value(a, k, v)
        elif isinstance(a.get(k), dict) and isinstance(v, dict):
            dict_update_nested_dict(a[k], v, overwrite)
        elif overwrite:
            a[k] = v


def dict_ensure_path_key_converted(d):
    """Expand '$'-containing keys into nested dicts, in place."""
    for k in list(d.keys()):
        v = d[k]
        if isinstance(v, dict):
            dict_ensure_path_key_converted(v)
        if "$" in k:
            del d[k]
            expanded = {}
            dict_update_path_value(expanded, k, v)
            dict_update_nested_dict(d, expanded)


class Config(object):
    """Two-layer config: ``overwrite`` shadows ``default``.

    Attribute access for a missing key returns ``None`` (mirrors
    reference common.py:15-50), which lets call sites probe optional
    keys without try/except.
    """

    def __init__(self, default, overwrite=None):
        object.__setattr__(self, "default", default or {})
        object.__setattr__(self, "overwrite", overwrite or {})

    def get(self, key):
        base = (
            dict_get_path_value(self.default, key)
            if dict_has_path(self.default, key)
            else None
        )
        if dict_has_path(self.overwrite, key):
            over = dict_get_path_value(self.overwrite, key)
            if isinstance(base, dict) and isinstance(over, dict):
                base = dict(base)
                base.update(over)
            else:
                base = over
        return base

    def __getattr__(self, key):
        return self.get(key)

    def get_dict(self):
        merged = copy.deepcopy(self.default)
        for p in get_all_path(self.overwrite, with_list=False):
            dict_update_path_value(merged, p, dict_get_path_value(self.overwrite, p))
        return merged


def load_from_yaml_str(s):
    import yaml

    return yaml.load(s, Loader=yaml.SafeLoader)


def load_from_yaml_file(file_name):
    """Load YAML; a `_base_` key recursively includes a parent file whose
    values are overridden by the child's '$'-path leaves (reference
    common.py:322-337)."""
    from .io import fileio

    with fileio.open_file(file_name, "r") as fp:
        data = load_from_yaml_str(fp.read())
    while isinstance(data, dict) and "_base_" in data:
        parent = load_from_yaml_file(op.join(op.dirname(file_name), data.pop("_base_")))
        assert isinstance(parent, dict)
        for p in get_all_path(data, with_list=False):
            dict_update_path_value(parent, p, dict_get_path_value(data, p))
        data = parent
    return data


def parse_general_args(argv=None):
    """-c yaml file < -bp base64 yaml < -p inline yaml; `type` names the
    function to dispatch (reference common.py:339-377)."""
    parser = argparse.ArgumentParser(description="General Parser")
    parser.add_argument("-c", "--config_file", type=str, help="yaml config file")
    parser.add_argument("-p", "--param", type=str, help="inline yaml parameter string")
    parser.add_argument("-bp", "--base64_param", type=str, help="base64-encoded yaml")
    args = parser.parse_args(argv)
    kwargs = {}
    if args.config_file:
        kwargs.update(load_from_yaml_file(args.config_file))
    # a key is SET when absent (even to None) and overwritten when
    # different (reference common.py:354-376)
    if args.base64_param:
        for k, v in load_from_yaml_str(base64.b64decode(args.base64_param)).items():
            if k not in kwargs or kwargs[k] != v:
                kwargs[k] = v
    if args.param:
        configs = load_from_yaml_str(args.param)
        dict_ensure_path_key_converted(configs)
        for k, v in configs.items():
            if k not in kwargs or kwargs[k] != v:
                kwargs[k] = v
    return kwargs


def dispatch_main(module_globals, argv=None):
    """Shared `__main__` body: parse args, look up `type`, call it.  A
    launch that exports COORDINATOR_ADDRESS (or MASTER_ADDR) joins one
    torch.distributed process group first, so the TSV shards meet at a
    collective barrier; bare RANK/WORLD_SIZE keep the reference's env-var
    row sharding with its file-system barrier."""
    init_logging()
    if os.environ.get("COORDINATOR_ADDRESS") or os.environ.get("MASTER_ADDR"):
        from .runtime.distributed import initialize

        initialize()
    kwargs = parse_general_args(argv)
    logging.info("param:\n%s", json.dumps(kwargs, indent=2, default=str))
    function_name = kwargs.pop("type")
    return module_globals[function_name](**kwargs)


def init_logging(level=logging.INFO):
    handler = logging.StreamHandler(stream=sys.stdout)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s.%(msecs)03d %(process)d:%(filename)s:%(lineno)s"
            " %(funcName)10s(): %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    root = logging.getLogger()
    root.handlers = []
    root.addHandler(handler)
    root.setLevel(level)


def _torch_distributed_initialized():
    try:
        import torch.distributed as dist

        return dist.is_available() and dist.is_initialized()
    except ImportError:
        return False


def get_mpi_rank():
    # an initialised process group is the actual communicator and wins
    # over env vars a launcher may export with other meanings
    if _torch_distributed_initialized():
        import torch.distributed as dist

        return dist.get_rank()
    rank = os.environ.get("RANK", os.environ.get("OMPI_COMM_WORLD_RANK"))
    return int(rank) if rank is not None else 0


def get_mpi_size():
    if _torch_distributed_initialized():
        import torch.distributed as dist

        return dist.get_world_size()
    size = os.environ.get("WORLD_SIZE", os.environ.get("OMPI_COMM_WORLD_SIZE"))
    return int(size) if size is not None else 1


def get_mpi_local_rank():
    return int(os.environ.get("LOCAL_RANK", os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))


def json_dump(obj):
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def hash_sha1(s):
    if not isinstance(s, str):
        s = repr(s)
    return hashlib.sha1(s.encode("utf-8")).hexdigest()


def ensure_directory(path):
    if path and not op.isdir(path):
        os.makedirs(path, exist_ok=True)


def write_to_file(content, file_name, append=False):
    ensure_directory(op.dirname(file_name))
    if isinstance(content, str):
        content = content.encode()
    with open(file_name, "ab" if append else "wb") as fp:
        fp.write(content)


def read_to_buffer(file_name):
    with open(file_name, "rb") as fp:
        return fp.read()


def load_list_file(fname):
    with open(fname, "r") as fp:
        lines = [line.strip() for line in fp.readlines()]
    if lines and lines[-1] == "":
        lines.pop()
    return lines


# ---------------------------------------------------------------------------
# file-lock + retry IO helpers (reference common.py:228-270): exclusive
# locks around reads guard against concurrent-mount (blobfuse-style)
# races; retry-with-jitter absorbs transient storage failures.
# ---------------------------------------------------------------------------


def _lock_path(name):
    import tempfile

    return op.join(tempfile.gettempdir(), name)


def acquire_lock(lock_file=None):
    """Hold an exclusive lock on `lock_file` (default: the port's lock file
    in the temporary directory); returns the open file to release."""
    import fcntl

    lock_file = lock_file or _lock_path("gitax_torch_lockfile.LOCK")
    ensure_directory(op.dirname(lock_file))
    fd = open(lock_file, "w+")
    fcntl.lockf(fd, fcntl.LOCK_EX)
    return fd


def release_lock(fd):
    fd.close()


def limited_retry_agent(num, func, *args, **kwargs):
    """Call func, retrying up to num times with random sleep
    (reference common.py:239-254)."""
    import random
    import time

    for i in range(num):
        try:
            return func(*args, **kwargs)
        except Exception as e:
            logging.warning("attempt %d/%d failed: %s", i + 1, num, e)
            if i == num - 1:
                raise
            time.sleep(random.random() * 5)


def exclusive_open_to_read(fname, mode="r"):
    """Open under an exclusive per-file lock unless
    GITAX_DISABLE_EXCLUSIVE_READ is set (reference common.py:256-270)."""
    disable = os.environ.get(
        "GITAX_DISABLE_EXCLUSIVE_READ", os.environ.get("QD_DISABLE_EXCLUSIVE_READ_BY_LOCK")
    )
    lock_fd = None
    if not (disable and int(disable)):
        lock_fd = acquire_lock(_lock_path("gitax_torch_lock_{}".format(hash_sha1(fname))))
    try:
        return limited_retry_agent(10, open, fname, mode)
    finally:
        if lock_fd is not None:
            release_lock(lock_fd)


def progress(iterable, desc="", mininterval=2):
    """tqdm wrapper stamping the caller's file:line into the description
    (reference qd_tqdm, common.py:379-398)."""
    import inspect

    from tqdm import tqdm

    frame = inspect.currentframe().f_back
    message = "{}:{}".format(op.basename(frame.f_code.co_filename), frame.f_lineno)
    return tqdm(
        iterable,
        desc="{} {}".format(message, desc).strip(),
        mininterval=mininterval,
    )
