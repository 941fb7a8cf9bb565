"""The collectives of multi-card training, the ones gitax leaves to XLA's
SPMD partitioner (gitax `parallel/mesh.py:1-17`).

Every collective of the port's training goes through this module, and
each is an `all_reduce` (a sum) or a `broadcast`: NCCL takes both across
cards, and gloo takes both for CUDA tensors too, so the same code runs
over NCCL one card per rank, over gloo in CPU processes (the tests), and
over gloo with ranks that share one card (`chip_smoke.py`).  A group of
None is a group of one rank: every helper is then the identity and
issues nothing.

Tensor parallelism uses Megatron's pair of autograd functions:
`copy_to_model` ("f": identity forward, all-reduce of the gradient
backward) before each column-parallel product, and `reduce_from_model`
("g": all-reduce forward, identity backward) after each row-parallel
product.  With both in place the gradient of every replicated parameter
is the full one on every rank of the model group.
"""

from __future__ import annotations

import torch


def _dist():
    import torch.distributed as dist

    return dist


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` in place; returns it.  The identity for
    group=None."""
    if group is not None:
        _dist().all_reduce(t, group=group)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Copy global rank `src`'s `t` into every rank's `t` over `group`
    (None: the default group); returns it."""
    _dist().broadcast(t, src=src, group=group)
    return t


BUCKET_BYTES = 64 << 20


def all_reduce_coalesced(tensors, group):
    """Sum each tensor of `tensors` over `group` in place, packed into flat
    buckets of at most BUCKET_BYTES (one collective per bucket, not per
    tensor).  Tensors of one bucket share a dtype."""
    if group is None:
        return
    bucket, size = [], 0

    def flush():
        if bucket:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            all_reduce(flat, group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            bucket.clear()

    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (size + nbytes > BUCKET_BYTES or t.dtype != bucket[0].dtype):
            flush()
            size = 0
        bucket.append(t)
        size += nbytes
    flush()


def barrier(device, group=None):
    """Wait for every rank of `group` (None: all ranks): an all-reduce of
    one element on `device`."""
    if _dist().is_initialized():
        _dist().all_reduce(torch.zeros(1, device=device), group=group)


class _CopyToModel(torch.autograd.Function):
    """f: identity forward, gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        # a copy: the incoming gradient may be a buffer autograd shares
        return all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """g: the partial products summed over the model group forward,
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        # a copy: an input of a Function is not summed in place
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x, group):
    """Megatron's f before a column-parallel product; x itself when group
    is None."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Megatron's g after a row-parallel product; x itself when group is
    None."""
    return x if group is None else _ReduceFromModel.apply(x, group)
