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

On a mesh (a model sharded by `parallel.mesh.shard_params`) the step is
gitax's SPMD step spelled out: each rank runs its data rank's rows on its
model shard, the loss is divided by the global count of predicted tokens,
the gradients are summed over the data group, the grad norm counts each
split gradient once per model rank and each replicated one once, and
with ZeRO-1 (`zero1`) `torch.distributed.optim.ZeroRedundancyOptimizer`
keeps each parameter's AdamW moments on one data rank, which updates it
and broadcasts it.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from ..models.git import GitModel
from ..parallel import comm
from ..parallel.mesh import split_rule
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


def adamw(model: GitModel, schedule, weight_decay=1e-4, zero1=False):
    """torch.optim.AdamW over the model's parameters with optax.adamw's
    settings: betas (0.9, 0.999), eps 1e-8, and `weight_decay` (optax's
    default 1e-4, not torch's 1e-2) on every parameter; the tied head is
    one Parameter, counted once.  The rate is set from `schedule` before
    each update.  zero1=True on a model on a mesh of more than one data
    rank: the same AdamW inside a ZeroRedundancyOptimizer over the data
    group (ZeRO-1).  Returns (optimizer, schedule)."""
    settings = dict(lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    mesh = model.mesh
    if zero1 and mesh is not None and mesh.data > 1:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        # ZeRO partitions the trainable parameters: thaw them first, as
        # init_train_state does
        model.trainable_(True)
        opt = ZeroRedundancyOptimizer(model.parameters(), torch.optim.AdamW,
                                      process_group=mesh.data_group, **settings)
    else:
        opt = torch.optim.AdamW(model.parameters(), **settings)
    return opt, schedule


def default_optimizer(model: GitModel, learning_rate=1e-5, weight_decay=0.2, warmup_steps=500,
                      total_steps=100_000, zero1=False):
    """gitax's default: AdamW under a linear warmup from 0 and a cosine
    decay to 0 at max(total_steps, warmup_steps + 1); zero1: see `adamw`.
    Returns (optimizer, schedule)."""
    schedule = WarmupCosineSchedule(learning_rate, warmup_steps,
                                    max(total_steps, warmup_steps + 1))
    return adamw(model, schedule, weight_decay, zero1)


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


def global_grad_norm(model: GitModel, named) -> torch.Tensor:
    """optax.global_norm of the gradients of `named` ((name, parameter)
    pairs): on a tensor-parallel mesh the squares of the split gradients
    are summed over the model group, the replicated ones counted once."""
    mesh = model.mesh
    if mesh is None or mesh.model == 1:
        return torch.nn.utils.get_total_norm([p.grad for _, p in named])
    sq = [torch.zeros((), device=mesh.device) for _ in range(2)]  # replicated, split
    for n, p in named:
        sq[split_rule(n) is not None] += p.grad.float().square().sum()
    return (sq[0] + comm.all_reduce(sq[1], mesh.model_group)).sqrt()


def apply_gradients(state: TrainState) -> torch.Tensor:
    """One AdamW update from the gradients the backward left in the
    parameters, at the schedule's rate for the current count; a trainable
    parameter with no gradient gets zeros.  On a mesh the gradients are
    first summed over the data group.  Returns the global L2 norm of the
    gradients before the update (optax.global_norm), and advances the
    count."""
    named = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    for _, p in named:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh = state.model.mesh
    if mesh is not None:
        comm.all_reduce_coalesced([p.grad for _, p in named], mesh.data_group)
    gnorm = global_grad_norm(state.model, named)
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
    them).  The optimizer and its schedule travel in the state.  On a
    model on a mesh (`model.mesh`) every rank calls the step with its
    data rank's rows (`Mesh.local_batch`); the loss and grad_norm are
    those of the global batch, on every rank.

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
        group = model.mesh.data_group if model.mesh is not None else None
        loss = caption_loss(logits, batch["caption_tokens"], batch["need_predict"],
                            eps=label_smoothing, padding_idx=model.cfg.padding_idx, group=group)
        loss.backward()
        gnorm = apply_gradients(state)
        # this rank's share of the global mean, summed over the data ranks
        return state, {"loss": comm.all_reduce(loss.detach().clone(), group),
                       "grad_norm": gnorm}

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
