"""Save and restore for training, the counterpart of gitax's Orbax
`ckpt/serialization.py`: the model's weights, the optimizer's state, the
schedule's fields and the step, one directory per step
(`step_{:08d}`), with a latest-step resolver for resume.

The format is `torch.save` (a `state.pt` or `params.pt` in the step's
directory).  A step is written into a temporary directory beside its
final one and renamed into place, so a run cut mid-write leaves no
half-written step for `latest_step` to find.  gitax's Orbax directories
are not read here: that needs jax (carry gitax weights across with
`ckpt.params_from_gitax` instead).

A training state on a mesh (`parallel.mesh`) is saved in the same
one-card format: the weights gathered over the model group, ZeRO-1's
moments consolidated over the data group, written by global rank 0 while
the others wait; restoring onto a mesh loads the one-card state and keeps
this rank's shards.  So a checkpoint from any mesh resumes on one card,
and the reverse.
"""

from __future__ import annotations

import os
import os.path as op
import re
import shutil
from typing import Optional

import torch

from ..parallel import comm
from ..parallel import mesh as pmesh

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _step_dir(directory: str, step: Optional[int]) -> str:
    path = op.abspath(directory)
    return path if step is None else op.join(path, "step_{:08d}".format(step))


def _save_atomic(path: str, filename: str, obj) -> str:
    """torch.save `obj` as path/filename, written into a temporary
    directory beside `path` and renamed into place (replacing an earlier
    `path`)."""
    parent = op.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = op.join(parent, ".{}.tmp-{}".format(op.basename(path), os.getpid()))
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, op.join(tmp, filename))
    if op.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def save_params(directory: str, model, step: Optional[int] = None) -> str:
    """Save a model's state dict under directory[/step_N]."""
    return _save_atomic(_step_dir(directory, step), PARAMS_FILE, model.state_dict())


def restore_params(directory: str, model, step: Optional[int] = None):
    """Load directory[/step_N]'s weights into `model` (strict names and
    shapes, values copied to its device and dtype); returns the model."""
    path = op.join(_step_dir(directory, step), PARAMS_FILE)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model


def latest_step(directory: str) -> Optional[int]:
    if not op.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for name in os.listdir(directory)
        if (m := re.match(r"step_(\d+)$", name))
    ]
    return max(steps) if steps else None


def save_train_state(directory: str, state, step: Optional[int] = None) -> str:
    """Save a `training.trainer.TrainState` as directory/step_N (N: the
    state's step unless given).  For a model on a mesh every rank calls
    it: the one-card state is gathered, global rank 0 writes it, and all
    return once it is written."""
    step = state.step if step is None else step
    path = _step_dir(directory, step)
    mesh = state.model.mesh
    if mesh is None:
        model, optimizer = state.model.state_dict(), state.optimizer.state_dict()
    else:
        model = pmesh.gather_params(state.model)
        optimizer = pmesh.gather_optimizer_state(state.optimizer, state.model)
    if mesh is None or mesh.rank == 0:
        _save_atomic(path, STATE_FILE, {
            "step": state.step,
            "model": model,
            "optimizer": optimizer,
            "schedule": state.schedule.state_dict(),
        })
    if mesh is not None:
        comm.barrier(mesh.device)
    return path


def restore_train_state(directory: str, state, step: Optional[int] = None):
    """Load directory/step_N (default: the latest) into `state`'s model,
    optimizer and schedule in place, and set its step; returns it.  A
    model on a mesh takes its shards of the weights and of the moments
    (each rank reads the file)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError("no checkpoints in {}".format(directory))
    blob = torch.load(op.join(_step_dir(directory, step), STATE_FILE), map_location="cpu",
                      weights_only=True)
    if state.model.mesh is None:
        state.model.load_state_dict(blob["model"], strict=True)
        state.optimizer.load_state_dict(blob["optimizer"])
    else:
        pmesh.load_sharded(state.model, blob["model"])
        state.optimizer.load_state_dict(pmesh.shard_optimizer_state(blob["optimizer"],
                                                                    state.model))
    state.schedule.load_state_dict(blob["schedule"])
    state.step = int(blob["step"])
    return state
