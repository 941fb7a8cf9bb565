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
"""

from __future__ import annotations

import os
import os.path as op
import re
import shutil
from typing import Optional

import torch

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
    state's step unless given)."""
    step = state.step if step is None else step
    return _save_atomic(_step_dir(directory, step), STATE_FILE, {
        "step": state.step,
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "schedule": state.schedule.state_dict(),
    })


def restore_train_state(directory: str, state, step: Optional[int] = None):
    """Load directory/step_N (default: the latest) into `state`'s model,
    optimizer and schedule in place, and set its step; returns it."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError("no checkpoints in {}".format(directory))
    blob = torch.load(op.join(_step_dir(directory, step), STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(blob["model"], strict=True)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.schedule.load_state_dict(blob["schedule"])
    state.step = int(blob["step"])
    return state
