"""The (data, model) mesh of multi-card training and inference and its
tensor-parallel split, the counterpart of gitax `parallel/mesh.py`.

gitax runs one SPMD program over a `jax.sharding.Mesh` and lets XLA place
the collectives from its partition specs.  The port runs one process per
rank in a `torch.distributed` group of data x model ranks, laid out as
gitax's `np.reshape(devices, (data, model))`: global rank r sits at data
index r // model and model index r % model.

- `data`: the batch is split by rows (`Mesh.batch_rows`); the gradients
  are summed over the data group (`training.trainer`), and with ZeRO-1
  the Adam moments are split over it.
- `model`: Megatron tensor parallelism over attention heads and FFN
  columns in both towers (`split_rule`): q, k, v and the FFN's first
  product are column-parallel, the attention's output map and the FFN's
  second product row-parallel, everything else replicated.  The ViT's
  fused `in_proj` [3D, D] is q | k | v, so rank m takes its heads' rows
  of each third (`QKV`), where gitax's spec shards the fused kernel's
  last axis contiguously and GSPMD reshards.

Inference may run one mesh per host (`make_mesh_from_shape`, gitax
mesh.py:36-48): a launch of H x data x model ranks is H hosts, host h
holding ranks h*d*m .. (h+1)*d*m - 1, each with its own mesh, and the
TSV loops split the rows over the hosts (`Mesh.host`, `Mesh.hosts`,
`Mesh.hosts_group`).  Every group the mesh makes carries the timeout its
caller gives (`make_mesh`'s timeout_s), so that a rank that hangs makes
the others' collectives raise.

`shard_params` replaces a full model's parameters by this rank's shards
(`shard_for_inference` also its int8 buffers, for generation);
`gather_params` and `load_sharded` go back and forth between shards and
the one-card state dict, and `gather_optimizer_state` /
`shard_optimizer_state` do the same for AdamW's state, so a checkpoint
written on any mesh is a one-card checkpoint.  Every collective is an
all-reduce or a broadcast (`parallel/comm.py`).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Optional

import torch
from torch import nn

from . import comm

COLUMN, ROW, QKV = "column", "row", "qkv"

# the block-local parameter name -> how it splits over the model axis
# (gitax mesh.py:63-80: qkv, c_fc, intermediate column; attn/out, c_proj,
# mlp/output row; row-parallel biases replicated, added after the sum)
_RULES = {
    "attn.in_proj_weight": QKV,
    "attn.in_proj_bias": QKV,
    "attn.out_proj.weight": ROW,
    "mlp.c_fc.weight": COLUMN,
    "mlp.c_fc.bias": COLUMN,
    "mlp.c_proj.weight": ROW,
    "attention.self.query.weight": COLUMN,
    "attention.self.query.bias": COLUMN,
    "attention.self.key.weight": COLUMN,
    "attention.self.key.bias": COLUMN,
    "attention.self.value.weight": COLUMN,
    "attention.self.value.bias": COLUMN,
    "attention.output.dense.weight": ROW,
    "intermediate.dense.weight": COLUMN,
    "intermediate.dense.bias": COLUMN,
    "output.dense.weight": ROW,
    # the w8a8 fused qkv (models/vit.py::MultiheadSelfAttention.set_int8)
    "attn.in_proj_q8_t": QKV,
    "attn.in_proj_scale": QKV,
}
_BLOCK = re.compile(r"(?:image_encoder\.transformer\.resblocks|textual\.transformer\.encoder\.layer)"
                    r"\.\d+\.(.+)$")


def split_rule(name: str) -> Optional[str]:
    """How the parameter or buffer `name` (a `GitModel` state-dict name)
    splits over the model axis: COLUMN (its output rows), ROW (its input
    columns), QKV (each third's rows by heads) or None (replicated).

    An int8 layer's leaves (`models/nn.py::Linear.set_int8`) are matched
    by their exact leaf name, as gitax's rule does (mesh.py:63-83: a
    substring match would take `weight_scale` for a weight): `weight_q8_t`
    splits as the layer's `weight`; `weight_scale`, one per output
    channel, with the columns of a column-parallel layer and replicated
    for a row-parallel one, whose outputs are full width.  The rule holds
    for weight-only int8 and w8a8 (`dynamic`) layers alike, as gitax's
    holds for `kernel_q8` and `kernel_q8_dyn`; the ViT's w8a8 fused qkv
    splits its `in_proj_q8_t` and `in_proj_scale` by heads (`QKV`)."""
    m = _BLOCK.match(name)
    if not m:
        return None
    local = m.group(1)
    module, _, leaf = local.rpartition(".")
    if leaf == "weight_q8_t":
        return _RULES.get(module + ".weight")
    if leaf == "weight_scale":
        kind = _RULES.get(module + ".weight")
        return kind if kind == COLUMN else None
    return _RULES.get(local)


def _block(t, kind, model):
    """`t` seen with a model-rank axis: index it by rank to get a shard."""
    if kind == COLUMN:
        return t.view(model, t.shape[0] // model, *t.shape[1:])
    if kind == ROW:
        return t.view(t.shape[0], model, t.shape[1] // model).transpose(0, 1)
    return t.view(3, model, t.shape[0] // (3 * model), *t.shape[1:]).transpose(0, 1)


def shard_tensor(kind, full, model, rank):
    """Rank `rank`'s shard of `full` under split `kind` (None: `full`)."""
    if kind is None or model == 1:
        return full
    shard = _block(full, kind, model)[rank]
    return shard.reshape(-1, *shard.shape[2:]) if kind == QKV else shard.contiguous()


def _full_shape(kind, shape, model):
    if kind == ROW:
        return (shape[0], shape[1] * model)
    return (shape[0] * model,) + tuple(shape[1:])


def unshard_tensor(kind, shard, mesh: "Mesh"):
    """The full tensor from each model rank's `shard` (an all-reduce of
    zero-padded copies over the model group); `shard` when unsplit."""
    if kind is None or mesh.model == 1:
        return shard
    full = torch.zeros(_full_shape(kind, shard.shape, mesh.model), dtype=shard.dtype,
                       device=mesh.device)
    view = _block(full, kind, mesh.model)[mesh.model_rank]
    view.copy_(shard.reshape(view.shape))
    return comm.all_reduce(full, mesh.model_group)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a (data, model) mesh: the axis sizes, its
    coordinates, its device and the process groups of its row (model
    group) and column (data group); a group of one rank is None.  `rank`
    is the rank within the mesh; a launch of several hosts runs one mesh
    per host, whose rank 0 is global rank `base`."""

    data: int
    model: int
    rank: int
    device: torch.device
    data_group: object = None
    model_group: object = None
    # NCCL, m > 1: a second group over the model group's ranks, which only
    # a captured search step uses (`make_mesh`)
    graph_group: object = None
    backend: Optional[str] = None  # the backend of its groups
    timeout_s: Optional[float] = None  # the timeout of its groups
    base: int = 0  # the global rank of this mesh's rank 0
    hosts: int = 1  # meshes in the launch, one a host
    hosts_group: object = None  # gloo, the hosts' rank 0s, when hosts > 1

    @property
    def host(self):
        """This mesh's host index: its row shard of a TSV."""
        return self.base // (self.data * self.model)

    @property
    def data_rank(self):
        return self.rank // self.model

    @property
    def model_rank(self):
        return self.rank % self.model

    def batch_rows(self, batch_size: int):
        """The rows [lo, hi) of a global batch this data rank takes
        (gitax's `batch_partition_specs`: the batch axis split evenly)."""
        if batch_size % self.data:
            raise ValueError("batch {} does not split over {} data ranks".format(
                batch_size, self.data))
        n = batch_size // self.data
        return self.data_rank * n, (self.data_rank + 1) * n

    def local_batch(self, batch: dict) -> dict:
        """This data rank's rows of every field of a global batch."""
        lo, hi = self.batch_rows(len(batch["caption_tokens"]))
        return {k: v[lo:hi] for k, v in batch.items()}


def local_device(device=None) -> torch.device:
    """A rank's device: `device` when given, else cuda:LOCAL_RANK (the
    global rank when LOCAL_RANK is unset); raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a rank runs on the card unless the caller passes "
                           "device='cpu'")
    import torch.distributed as dist

    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", dist.get_rank())))


def make_mesh(data: Optional[int] = None, model: int = 1, device=None, backend=None,
              timeout_s: Optional[float] = None, hosts: int = 1) -> Mesh:
    """The mesh of an initialised process group of hosts x data x model
    ranks (data None: world // (hosts * model)); any other product raises,
    as gitax's assert does.  Every rank calls it: it creates every host's
    groups, in the same order.  device: this rank's (default
    `local_device()`); backend: the groups' (default the process
    group's); timeout_s: the groups' (default the process group's as
    `runtime.distributed.init_training_group` set it: a group made with
    no timeout would take torch's default, 30 min for gloo and 10 for
    NCCL, whatever its caller asked).

    Under NCCL the timeout is kept by the watchdog: torch documents that a
    collective past it is aborted and the process brought down, unless
    TORCH_NCCL_BLOCKING_WAIT=1, with which the waiting call raises
    instead.  Under gloo the waiting call raises.

    Under NCCL with model > 1 each model group has a twin over the same
    ranks, made right after it (`Mesh.graph_group`): the communicator of
    the search step that `decode.device_loop` captures.  With NCCL's
    graph mixing off (`runtime.distributed.init_training_group`) a
    communicator must never take an eager call while one of its graph
    launches is outstanding, and the mesh's eager collectives (the next
    batch's encoder and prefill, `share_generator`, the engine's checks)
    run on the model group while the last search's launches are still
    queued; the twin takes graph launches only, and the step's warm-up,
    which runs after the host has waited for the stream."""
    import torch.distributed as dist

    from ..runtime.distributed import group_timeout_s

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(runtime.distributed.init_training_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if data is None:
        data = world // (hosts * model)
    per = data * model
    if hosts * per != world:
        raise ValueError("mesh {} x {}{} != world size {}".format(
            data, model, " on {} hosts".format(hosts) if hosts > 1 else "", world))
    timeout_s = group_timeout_s() if timeout_s is None else timeout_s
    timeout = datetime.timedelta(seconds=timeout_s)
    mesh = Mesh(data=data, model=model, rank=rank % per, device=local_device(device),
                backend=backend or dist.get_backend(), timeout_s=timeout_s,
                base=rank - rank % per, hosts=hosts)
    for base in range(0, world, per):
        mine = base == mesh.base
        if model > 1:
            for d in range(data):
                ranks = [base + d * model + m for m in range(model)]
                group = dist.new_group(ranks, backend=backend, timeout=timeout)
                twin = (dist.new_group(ranks, backend=backend, timeout=timeout)
                        if mesh.backend == "nccl" else None)
                if mine and d == mesh.data_rank:
                    mesh.model_group, mesh.graph_group = group, twin
        if data > 1:
            for m in range(model):
                group = dist.new_group([base + d * model + m for d in range(data)],
                                       backend=backend, timeout=timeout)
                if mine and m == mesh.model_rank:
                    mesh.data_group = group
    return mesh


def mesh_dims(mesh_shape):
    """gitax's `mesh_shape`: an int N is (N, 1), else [data, model]."""
    dims = (mesh_shape, 1) if isinstance(mesh_shape, int) else tuple(mesh_shape)
    if len(dims) != 2 or not all(isinstance(n, int) and n >= 1 for n in dims):
        raise ValueError("mesh_shape {!r}: an int N or [data, model]".format(mesh_shape))
    return dims


# a host's rank 0 waits at the shards' barrier for the other hosts as long
# as their rows take, as the reference's file-system poll waits
_HOSTS_TIMEOUT = datetime.timedelta(days=30)


def make_mesh_from_shape(mesh_shape, device=None, backend=None,
                         timeout_s: Optional[float] = None) -> Mesh:
    """The CLI's mesh (`mesh_dims`), as gitax's docstring defines it: the
    mesh of ONE host.  A launch of H x data x model ranks is H hosts of
    data x model ranks each, host h holding global ranks h*d*m to
    (h+1)*d*m - 1; each host runs its own mesh, and the TSV loops split
    the rows over the hosts (`Mesh.host` of `Mesh.hosts`).  With more than
    one host, every rank also makes `hosts_group`, a gloo group of the
    hosts' rank 0s for the shards' barrier.  A launch that is not a
    multiple of data x model raises."""
    import torch.distributed as dist

    data, model = mesh_dims(mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % (data * model):
        raise ValueError("mesh_shape {} needs a multiple of {} ranks (hosts of data x model "
                         "ranks), and the process group has {}".format(
                             [data, model], data * model, world))
    hosts = world // (data * model)
    mesh = make_mesh(data=data, model=model, device=device, backend=backend,
                     timeout_s=timeout_s, hosts=hosts)
    if hosts > 1:
        mesh.hosts_group = dist.new_group(list(range(0, world, data * model)), backend="gloo",
                                          timeout=_HOSTS_TIMEOUT)
    return mesh


def _owner(model, name):
    *path, leaf = name.split(".")
    return model.get_submodule(".".join(path)), leaf


def check_divides(cfg, model: int):
    """Raise unless `model` divides both towers' head counts (and so every
    split width)."""
    for label, heads in (("encoder", cfg.encoder.heads), ("decoder", cfg.num_heads)):
        if heads % model:
            raise ValueError("the {}'s {} heads do not split over {} model ranks".format(
                label, heads, model))


def broadcast_params(model, src=0, group=None):
    """Every rank's weights and buffers from global rank `src` over `group`
    (None: the default group): identical starting weights."""
    with torch.no_grad():
        for t in model.state_dict().values():
            comm.broadcast(t, src, group)


def _shard_(model, mesh: Mesh):
    """Replace every split parameter and int8 buffer of a full model by
    this rank's shard, in place, and hand the towers the model group."""
    check_divides(model.cfg, mesh.model)
    if mesh.model > 1:
        for name, p in list(model.named_parameters()):
            kind = split_rule(name)
            if kind is not None:
                module, leaf = _owner(model, name)
                shard = shard_tensor(kind, p.detach(), mesh.model, mesh.model_rank).clone()
                setattr(module, leaf, nn.Parameter(shard, requires_grad=p.requires_grad))
        for name, b in list(model.named_buffers()):
            kind = split_rule(name)
            if kind is not None:
                module, leaf = _owner(model, name)
                if leaf.endswith("_q8_t"):  # [in, out] out-major: split its [out, in] storage
                    shard = shard_tensor(kind, b.t(), mesh.model, mesh.model_rank).t()
                else:
                    shard = shard_tensor(kind, b, mesh.model, mesh.model_rank)
                module.register_buffer(leaf, shard.clone(memory_format=torch.preserve_format))
        model.image_encoder.tp_group = mesh.model_group
        model.textual.tp_group = mesh.model_group
        model.textual.graph_group = mesh.graph_group
    model.mesh = mesh
    return model


def shard_params(model, mesh: Mesh):
    """Replace a full `GitModel`'s split parameters by this rank's shards
    (new Parameters, same requires_grad), in place, and hand the towers
    the model group; returns the model.  Build the optimizer after it.
    Raises on int8 Linears, which cannot train (`shard_for_inference`
    takes them)."""
    if model.mesh is not None:
        raise ValueError("the model is already on a mesh")
    from ..models.git import quantized_modules

    quantized = quantized_modules(model)
    if quantized:
        raise ValueError("int8 Linears cannot be sharded for training: {}".format(
            ", ".join(quantized)))
    return _shard_(model, mesh)


@torch.no_grad()
def shard_for_inference(model, mesh: Mesh):
    """`shard_params` for generation: a full model, int8 or not, cut to
    this rank's shards in place.  Quantize the full model first
    (`ops.quant.quantize_git_model_`), as gitax quantizes before
    `shard_params`, so that the int8 values and scales are the one-card
    ones; the tied head stays whole on every rank."""
    if model.mesh is not None:
        raise ValueError("the model is already on a mesh")
    return _shard_(model, mesh)


@torch.no_grad()
def gather_params(model) -> dict:
    """The one-card state dict of a model on a mesh (of the model itself
    off a mesh), on every rank of its model group: split tensors are
    summed from zero-padded shards.  Every rank of the group calls it."""
    mesh = model.mesh
    sd = model.state_dict()
    if mesh is None:
        return sd
    return {n: unshard_tensor(split_rule(n), t, mesh) for n, t in sd.items()}


@torch.no_grad()
def load_sharded(model, full_sd: dict):
    """Load a one-card state dict into a model on a mesh: each rank takes
    its shards (strict names and shapes)."""
    mesh = model.mesh
    model.load_state_dict({n: shard_tensor(split_rule(n), t, mesh.model, mesh.model_rank)
                           for n, t in full_sd.items()}, strict=True)
    return model


def _moments_by_owner(local, named, mesh: Mesh) -> dict:
    """ZeRO-1's AdamW state of every parameter (index -> state, on the
    mesh's device) on every rank of the data group: each parameter's state
    lives on one data rank, found by an all-reduce of a claim per
    parameter, which broadcasts it (tensors only: no pickling)."""
    claims = torch.zeros(len(named), device=mesh.device)
    for i, (_, p) in enumerate(named):
        if p in local.state and local.state[p]:
            claims[i] = mesh.data_rank + 1
    comm.all_reduce(claims, mesh.data_group)
    state = {}
    for i, (_, p) in enumerate(named):
        owner = int(claims[i].item()) - 1
        if owner < 0:  # no update yet
            continue
        mine = local.state[p] if owner == mesh.data_rank else None
        st = {}
        for k, like in (("step", torch.zeros((), device=mesh.device)), ("exp_avg", p),
                        ("exp_avg_sq", p)):
            t = (mine[k].to(device=mesh.device, dtype=like.dtype).clone() if mine is not None
                 else torch.empty_like(like, device=mesh.device))
            st[k] = comm.broadcast(t, mesh.base + owner * mesh.model + mesh.model_rank,
                                   mesh.data_group)
        st["step"] = st["step"].cpu()
        state[i] = st
    return state


def gather_optimizer_state(optimizer, model) -> Optional[dict]:
    """AdamW's one-card state dict (state by parameter index in
    `model.parameters()` order, one param group with AdamW's settings)
    from a model on a mesh: ZeRO-1's moments brought to every data rank
    (`_moments_by_owner`), then the split ones summed over the model
    group.  Every rank calls it; returns the dict on data rank 0, None
    elsewhere."""
    mesh = model.mesh
    local = getattr(optimizer, "optim", optimizer)  # the AdamW inside ZeRO-1, or itself
    named = list(model.named_parameters())
    if local is not optimizer and mesh.data > 1:
        state = _moments_by_owner(local, named, mesh)
    else:
        state = {i: dict(local.state[p]) for i, (_, p) in enumerate(named) if local.state[p]}
    if mesh.data_rank != 0:
        return None
    for i, st in state.items():
        kind = split_rule(named[i][0])
        state[i] = {k: unshard_tensor(kind, v.to(mesh.device), mesh) if v.dim() else v
                    for k, v in st.items()}
    group = {k: v for k, v in local.param_groups[0].items() if k != "params"}
    return {"state": state, "param_groups": [dict(group, params=list(range(len(named))))]}


def shard_optimizer_state(full: dict, model) -> dict:
    """A one-card AdamW state dict cut to this rank's shards of a model on
    a mesh (what `load_state_dict` of its AdamW or ZeRO-1 takes)."""
    mesh = model.mesh
    names = [n for n, _ in model.named_parameters()]
    state = {}
    for i, st in full["state"].items():
        kind = split_rule(names[i])
        state[i] = {k: shard_tensor(kind, v, mesh.model, mesh.model_rank) if v.dim() else v
                    for k, v in st.items()}
    return {"state": state, "param_groups": [dict(g) for g in full["param_groups"]]}
