"""The training step, the counterpart of `gitax.training.trainer`:
label-smoothed cross-entropy forward and backward, AdamW.

gitax's step is a pure jitted function of (params, opt_state); here the
model holds the f32 master weights and `torch.optim.AdamW` its moments,
so the step updates them in place and returns the same `TrainState` with
its count advanced.  The learning rate follows optax's
`warmup_cosine_decay_schedule`, evaluated at the update count before the
update, as optax's `scale_by_schedule` does (the first update's rate is
0).  Decoupled weight decay applies to every parameter, as
`optax.adamw`'s unmasked decay does, and a trainable parameter the loss
does not reach gets a zero gradient, so the decay and the moments still
move it, as optax's zero leaves do.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from ..models.git import GitModel
from .loss import caption_loss


class _Schedule(object):
    """A learning rate as a function of the update count; its fields are
    its whole state."""

    def state_dict(self) -> dict:
        return dict(vars(self))

    def load_state_dict(self, state: dict) -> None:
        vars(self).update(state)


class WarmupCosineSchedule(_Schedule):
    """optax.warmup_cosine_decay_schedule(0.0, peak_value, warmup_steps,
    decay_steps): linear from 0 to peak over the warmup, then cosine from
    peak to 0 over decay_steps - warmup_steps counts (decay_steps
    includes the warmup), then 0.  Computed in float32 with optax's
    operations in optax's order (its polynomial and cosine schedules), so
    the rates are optax's: in f64 they would differ from optax's by up to
    1e-5 relative in the warmup's first counts and more near the decay's
    end, where optax's f32 cancels."""

    def __init__(self, peak_value, warmup_steps, decay_steps):
        if decay_steps - warmup_steps <= 0:
            raise ValueError("decay_steps {} must exceed warmup_steps {}".format(
                decay_steps, warmup_steps))
        self.peak_value, self.warmup_steps, self.decay_steps = peak_value, warmup_steps, decay_steps

    def __call__(self, count: int) -> float:
        f32 = functools.partial(torch.tensor, dtype=torch.float32)
        peak, warmup = self.peak_value, self.warmup_steps
        if count < warmup:  # optax's polynomial_schedule from 0, power 1
            frac = 1 - f32(float(min(max(count, 0), warmup))) / f32(float(warmup))
            return float(f32(-peak) * frac + f32(peak))
        decay = self.decay_steps - warmup  # optax's cosine_decay_schedule, alpha 0
        t = f32(float(min(count - warmup, decay)))
        return float(f32(peak) * (0.5 * (1 + torch.cos(f32(math.pi) * t / f32(float(decay))))))


class ConstantSchedule(_Schedule):
    """A constant learning rate (optax.adamw(value)'s)."""

    def __init__(self, value):
        self.value = value

    def __call__(self, count: int) -> float:
        return self.value


def adamw(model: GitModel, schedule, weight_decay=1e-4):
    """torch.optim.AdamW over the model's parameters with optax.adamw's
    settings: betas (0.9, 0.999), eps 1e-8, and `weight_decay` (optax's
    default 1e-4, not torch's 1e-2) on every parameter; the tied head is
    one Parameter, counted once.  The rate is set from `schedule` before
    each update.  Returns (optimizer, schedule)."""
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    return opt, schedule


def default_optimizer(model: GitModel, learning_rate=1e-5, weight_decay=0.2, warmup_steps=500,
                      total_steps=100_000):
    """gitax's default: AdamW under a linear warmup from 0 and a cosine
    decay to 0 at max(total_steps, warmup_steps + 1).  Returns
    (optimizer, schedule)."""
    schedule = WarmupCosineSchedule(learning_rate, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    return adamw(model, schedule, weight_decay)


@dataclasses.dataclass
class TrainState:
    """step: updates taken; model: the f32 master weights, trainable;
    optimizer and schedule: from `default_optimizer` or `adamw`."""

    step: int
    model: GitModel
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]


def init_train_state(model: GitModel, optimizer=None, schedule=None) -> TrainState:
    """Make the model trainable (`GitModel.trainable_`) and pair it with
    an optimizer: `default_optimizer(model)` unless both are given."""
    model.trainable_(True)
    if optimizer is None or schedule is None:
        optimizer, schedule = default_optimizer(model)
    return TrainState(step=0, model=model, optimizer=optimizer, schedule=schedule)


def apply_gradients(state: TrainState) -> torch.Tensor:
    """One AdamW update from the gradients the backward left in the
    parameters, at the schedule's rate for the current count; a trainable
    parameter with no gradient gets zeros.  Returns the global L2 norm of
    the gradients before the update (optax.global_norm), and advances the
    count."""
    params = [p for p in state.model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    gnorm = torch.nn.utils.get_total_norm([p.grad for p in params])
    lr = state.schedule(state.step)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    state.optimizer.step()
    state.optimizer.zero_grad(set_to_none=True)
    state.step += 1
    return gnorm


def make_train_step(model: GitModel, dtype=torch.float32, label_smoothing=0.1, remat=False,
                    fast_softmax=False):
    """Returns step(state, batch) -> (state, {'loss', 'grad_norm'}), both
    0-dim tensors on the model's device (read them when the host needs
    them).  The optimizer and its schedule travel in the state.

    batch: {'image': [B, H, W, 3] or [B, F, H, W, 3], 'caption_tokens'
    [B, T], 'need_predict' [B, T]} tensors on the model's device
    (reference train.py:38-73), optional 'bi_valid_mask' [B, T] and
    'context_tokens' [B, Tc] with 'context_lengths' [B] (gitax
    trainer.py:56-62).

    remat=True checkpoints each encoder block (`vit_forward`).
    fast_softmax=True keeps the attention score math in the activation
    dtype in both towers, the bf16 counterpart of the reference's fp16
    speed protocol (train.py:270); unset, the encoder keeps its config's
    `fast_softmax`."""

    def step(state: TrainState, batch):
        logits = state.model.forward_logits(
            batch["image"], batch["caption_tokens"],
            bi_valid_mask=batch.get("bi_valid_mask"),
            context_tokens=batch.get("context_tokens"),
            context_lengths=batch.get("context_lengths"),
            dtype=dtype, fast=True if fast_softmax else None, remat=remat,
        )
        loss = caption_loss(logits, batch["caption_tokens"], batch["need_predict"],
                            eps=label_smoothing, padding_idx=model.cfg.padding_idx)
        loss.backward()
        gnorm = apply_gradients(state)
        return state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def to_device(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on `device`: integer fields
    as int64, images as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out
