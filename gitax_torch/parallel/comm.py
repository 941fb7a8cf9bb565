"""The collectives of multi-card training and inference, the ones gitax
leaves to XLA's SPMD partitioner (gitax `parallel/mesh.py:1-17`).

Every collective of the port's mesh goes through this module, and
each is an `all_reduce` (a sum, or a max: the w8a8 encoder's row
amax) or a `broadcast`: NCCL takes both across
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


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `t` over `group`, in place; returns it.  The
    identity for group=None."""
    if group is not None:
        dist = _dist()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
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


def broadcast_object(obj, src: int, group=None, device="cpu"):
    """Rank `src`'s picklable `obj` on every rank of `group`: its length,
    then its pickled bytes, as two broadcasts of tensors on `device` (the
    other ranks pass obj=None)."""
    import pickle

    mine = _dist().get_rank() == src
    data = pickle.dumps(obj) if mine else b""
    n = broadcast(torch.tensor([len(data)], dtype=torch.int64, device=device), src, group)
    buf = (torch.frombuffer(bytearray(data), dtype=torch.uint8).to(device) if mine
           else torch.empty(int(n.item()), dtype=torch.uint8, device=device))
    broadcast(buf, src, group)
    return obj if mine else pickle.loads(buf.cpu().numpy().tobytes())


def gather_rows(t: torch.Tensor, lo: int, total: int, group) -> torch.Tensor:
    """A [total, ...] tensor holding every rank's `t` at its row offset
    `lo` (the ranks' rows partition [0, total)): an all-reduce of
    zero-padded copies over `group`."""
    full = torch.zeros((total,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    full[lo:lo + t.shape[0]] = t
    return all_reduce(full, group)


def count_unequal(t: torch.Tensor, group, size: int) -> int:
    """How many elements of the integer tensor `t` differ between the
    `size` ranks of `group`: with s1 and s2 the sums of t and t^2 over the
    ranks, an element is equal on all of them iff size * s2 == s1^2."""
    t = t.to(torch.int64)
    s1 = all_reduce(t.clone(), group)
    s2 = all_reduce(t * t, group)
    return int((size * s2 != s1 * s1).sum().item())


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
