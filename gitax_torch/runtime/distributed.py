"""Multi-process setup for the TSV loops, the counterpart of
`gitax.runtime.distributed` with torch.distributed where gitax uses
jax.distributed.

The reference's "distributed" layer is mpirun env vars plus a file-system
barrier (common.py:106-119, inference.py:214-225).  The port keeps that
rank/world contract for row sharding (runtime/engine.py) and, when a
launch names a coordinator, joins one process group so that the shard
barrier is a collective.  The group only synchronises hosts (no tensor
crosses it), so it is gloo's and never touches the card.

Training on several cards (`parallel/mesh.py`) starts its own group with
`init_training_group`: NCCL for ranks on cards, one card each; gloo for
CPU ranks (device='cpu', the tests); gloo for ranks that share one card
only when the caller asks (share_card=True, a rehearsal of a mesh on one
card).  `spawn_ranks` starts the ranks of one command (train.py's
`data_parallel`); a `torchrun` launch starts them instead.

Inference on several cards (`mesh_shape` in the CLI and the server,
`runtime.engine.CaptionEngine(mesh=...)`) joins its group with
`open_inference_group`: under a launch of H x data x model ranks
(torchrun) each process is a rank and each host of data x model ranks
runs its own mesh on its row shard of a TSV; otherwise this process is
rank 0 and `SpawnedRanks` starts ranks 1.. , which serve rank 0's
batches until it closes the engine.  The timeout of the group and of
every group its mesh makes is minutes (MESH_TIMEOUT_S), so a rank that
fails or hangs ends the others' collectives with an error.
"""

from __future__ import annotations

import datetime
import importlib
import logging
import os
import tempfile


def _int_env(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join a torch.distributed process group from args or the standard
    env vars: COORDINATOR_ADDRESS (host:port; else MASTER_ADDR and
    MASTER_PORT), WORLD_SIZE and RANK or their OMPI_COMM_WORLD_*
    equivalents.  Returns False, doing nothing, for a single process."""
    import torch.distributed as dist

    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = "{}:{}".format(os.environ["MASTER_ADDR"],
                                                 os.environ.get("MASTER_PORT", "29500"))
    if num_processes is None:
        num_processes = _int_env("WORLD_SIZE") or _int_env("OMPI_COMM_WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("RANK")
        if process_id is None:
            process_id = _int_env("OMPI_COMM_WORLD_RANK")
    if num_processes in (None, 1):
        logging.info("single-process run; no process group")
        return False
    if process_id is None:
        raise ValueError("world size {} given but no rank (set RANK or "
                         "OMPI_COMM_WORLD_RANK)".format(num_processes))
    if coordinator_address is None:
        raise ValueError("world size {} given but no coordinator (set COORDINATOR_ADDRESS, "
                         "or MASTER_ADDR and MASTER_PORT)".format(num_processes))
    dist.init_process_group("gloo", init_method="tcp://" + coordinator_address,
                            world_size=num_processes, rank=process_id)
    logging.info("torch.distributed up: process %d/%d", dist.get_rank(), dist.get_world_size())
    return True


def is_active():
    """True iff a process group of more than one process is initialised,
    so that `barrier` is a real collective."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def barrier(name="gitax_barrier"):
    """Cross-process sync, in place of the reference's file-system poll."""
    import torch.distributed as dist

    if not is_active():
        return
    logging.info("barrier %s", name)
    dist.barrier()


def check_data_parallel(n: int, device=None, label=None):
    """Raise unless `n` ranks fit this machine: on the card (device None
    or CUDA) one card each, so n <= torch.cuda.device_count(); CPU ranks
    (device='cpu') are not counted.  `label` names the setting in the
    message (default "data_parallel=n")."""
    import torch

    label = label or "data_parallel={}".format(n)
    if n < 1:
        raise ValueError("{}: at least 1 rank".format(label))
    if device is not None and torch.device(device).type == "cpu":
        return
    cards = torch.cuda.device_count()
    if n > cards:
        raise ValueError("{} needs {} cards, one per rank; this machine has {} (share_card=True "
                         "puts every rank on card 0 over gloo)".format(label, n, cards))


# the timeout of the training group unless its caller gives one
TRAIN_TIMEOUT_S = 1800
# the timeout init_training_group gave the process group, the default of
# the mesh's groups (`group_timeout_s`)
_GROUP_TIMEOUT_S = None


def group_timeout_s():
    """The timeout, in seconds, of the process group as
    `init_training_group` made it (TRAIN_TIMEOUT_S for a group made
    elsewhere): the groups a mesh makes take it unless told otherwise."""
    return _GROUP_TIMEOUT_S if _GROUP_TIMEOUT_S is not None else TRAIN_TIMEOUT_S


def init_training_group(rank=None, world_size=None, init_method=None, device=None,
                        share_card=False, timeout_s=TRAIN_TIMEOUT_S):
    """Join the process group of multi-card training; returns (this rank's
    device, the backend for the mesh's groups: `parallel.mesh.make_mesh`'s
    `backend`).  rank, world_size and init_method default to the env://
    launch of torchrun (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT;
    LOCAL_RANK picks the card).  device='cpu': gloo on the CPU.  Otherwise
    NCCL with one card per rank (cuda:LOCAL_RANK), raising without enough
    cards; share_card=True puts every rank on `device` (default cuda:0)
    over gloo, which NCCL refuses.  A group the launcher already made (the
    CLI's gloo group under torchrun, `common.dispatch_main`) is kept; the
    mesh's groups then take the backend returned.

    The group is not bound to a device (no `device_id`): each NCCL group
    then makes its communicator among its own ranks at its first
    collective.  Bound, torch makes every later group by splitting the
    default communicator (`ncclCommSplit`, a collective of every rank),
    and a rank outside a new group of any backend takes part with a
    no-colour split while the members of a gloo group make none: a gloo
    group of some ranks only (the hosts' `hosts_group`, an engine's
    header group on a launch of several hosts) leaves the ranks' splits
    unpaired, and the next NCCL group waits forever (four cards, 2 hosts
    x [2, 1]).

    NCCL ranks set NCCL_GRAPH_MIXING_SUPPORT=0 unless the environment
    sets it: with NCCL's default (1) a captured collective brings event
    record and wait nodes into the graph, which the body of a
    conditional node cannot hold, so a model group's search could not
    run on the card (`decode.device_loop`); with 0 it is kernels and
    copies only.  With 0, NCCL documents correctness only for a
    communicator that never has two graph launches outstanding on
    unordered streams, nor an outstanding graph launch followed by an
    eager call, whatever the streams' dependencies.  The port keeps both
    rules by giving captured collectives communicators of their own:
    each model group has a twin over the same ranks, `Mesh.graph_group`
    (`parallel.mesh.make_mesh`), on which only the search's captured
    step runs.  Its graphs are launched on one stream under one lock,
    and its one eager use, the step's warm-up before a capture, comes
    after the host has waited for that stream.  Every eager collective
    (encoder, prefill, `share_generator`, the engine's) stays on the
    model group, which no graph holds."""
    import torch
    import torch.distributed as dist

    if rank is None:
        rank = int(os.environ["RANK"])
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if device is not None and torch.device(device).type == "cpu":
        backend, dev = "gloo", torch.device("cpu")
    elif share_card:
        if not torch.cuda.is_available():
            raise RuntimeError("share_card: no CUDA device")
        backend, dev = "gloo", torch.device(device or "cuda:0")
    else:
        local = int(os.environ.get("LOCAL_RANK", rank))
        check_data_parallel(local + 1)
        backend, dev = "nccl", torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # before NCCL makes a communicator: see the docstring
        os.environ.setdefault("NCCL_GRAPH_MIXING_SUPPORT", "0")
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
            raise ValueError("the process group is rank {} of {}, not {} of {}".format(
                dist.get_rank(), dist.get_world_size(), rank, world_size))
        return dev, backend
    global _GROUP_TIMEOUT_S
    dist.init_process_group(backend=backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _GROUP_TIMEOUT_S = timeout_s
    logging.info("training group: rank %d/%d, %s on %s", rank, world_size, backend, dev)
    return dev, backend


def _spawned_rank(target, rank, world_size, init_method, args):
    module, name = target.split(":")
    getattr(importlib.import_module(module), name)(rank, world_size, init_method, *args)


JOIN_TIMEOUT_S = 600


class SpawnedRanks(object):
    """Ranks 1..world_size-1 of a group whose rank 0 is this process:
    `target` ("module:function", called as fn(rank, world_size,
    init_method, *args)) in spawned interpreters (a fresh one each: they
    import `module`, nothing of the caller's), meeting rank 0 through a
    file:// rendezvous (`init_method`) in a temporary directory that
    lives until `join`."""

    def __init__(self, target: str, world_size: int, args=()):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="gitax_ranks_")
        self.init_method = "file://" + os.path.join(self._tmp.name, "rendezvous")
        self.procs = [ctx.Process(target=_spawned_rank, args=(target, r, world_size,
                                                             self.init_method, tuple(args)),
                                  daemon=True)
                      for r in range(1, world_size)]
        for p in self.procs:
            p.start()

    def exited(self):
        """[(rank, exit code)] of the ranks that have ended."""
        return [(r + 1, p.exitcode) for r, p in enumerate(self.procs) if p.exitcode is not None]

    def join(self, ok=True, timeout_s=JOIN_TIMEOUT_S):
        """Wait for the ranks (stopping them at once when not `ok`: rank 0
        failed), kill those still running after timeout_s, and raise if a
        rank failed."""
        for p in self.procs:
            if not ok:
                p.terminate()
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()
        failed = [(r, code) for r, code in self.exited() if code != 0]
        if failed and ok:
            raise RuntimeError("spawned ranks failed (rank, exit code): {}".format(failed))


def spawn_ranks(target: str, world_size: int, args=()):
    """Run `target` ("module:function", called as fn(rank, world_size,
    init_method, *args)) on `world_size` ranks: rank 0 in this process,
    whose result it returns, ranks 1.. in spawned processes
    (`SpawnedRanks`).  Raises if a spawned rank fails or is still running
    JOIN_TIMEOUT_S after rank 0 returned; if rank 0 fails the others are
    stopped."""
    ranks = SpawnedRanks(target, world_size, args)
    ok = False
    try:
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(0, world_size, ranks.init_method,
                                                                *args)
        ok = True
    finally:
        ranks.join(ok)
    return result


# the group timeout of inference on a mesh: a rank left waiting on a rank
# that failed raises after this, and so does every rank after it
MESH_TIMEOUT_S = 300


def launched_world():
    """(rank, world size) of this process under a launcher: the
    initialised process group's, else RANK/WORLD_SIZE (or OMPI_*); (0, 1)
    for a single process."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = _int_env("WORLD_SIZE") or _int_env("OMPI_COMM_WORLD_SIZE") or 1
    rank = _int_env("RANK")
    if rank is None:
        rank = _int_env("OMPI_COMM_WORLD_RANK") or 0
    return rank, world


class InferenceGroup(object):
    """This rank's part of an inference mesh: `mesh` (a
    `parallel.mesh.Mesh`, its host's), the spawned ranks when this
    process started them (`ranks`), and whether it initialised the
    process group."""

    def __init__(self, mesh, ranks=None, owns_group=False):
        self.mesh, self.ranks, self.owns_group = mesh, ranks, owns_group

    @property
    def rank(self):
        """The rank within this host's mesh: 0 drives the engine."""
        return self.mesh.rank

    def close(self, ok=True):
        """Leave the group: destroy the process group if this rank made it,
        then wait for the spawned ranks (`SpawnedRanks.join`)."""
        import torch.distributed as dist

        try:
            if self.owns_group and dist.is_initialized():
                dist.destroy_process_group()
        finally:
            if self.ranks is not None:
                ranks, self.ranks = self.ranks, None
                ranks.join(ok)


def join_inference_group(rank, world_size, init_method, mesh_shape, device=None,
                         share_card=False, timeout_s=MESH_TIMEOUT_S, ranks=None):
    """Join the group of an inference mesh as `rank` (the placement rules
    of `init_training_group`) and make its host's (data, model) mesh, its
    groups on `timeout_s`; returns an `InferenceGroup`."""
    import torch.distributed as dist

    from ..parallel.mesh import make_mesh_from_shape

    owns = not dist.is_initialized()
    dev, backend = init_training_group(rank, world_size, init_method, device=device,
                                       share_card=share_card, timeout_s=timeout_s)
    return InferenceGroup(make_mesh_from_shape(mesh_shape, device=dev, backend=backend,
                                               timeout_s=timeout_s), ranks, owns)


def open_inference_group(mesh_shape, follower: str, device=None, share_card=False,
                         timeout_s=MESH_TIMEOUT_S) -> InferenceGroup:
    """The group of an entry point's `mesh_shape` (data x model ranks a
    host).  Under a launch of several processes (torchrun, or an
    initialised group) this process is its launcher's rank, and a launch
    of H x data x model processes is H hosts, each running its own mesh
    over its own ranks (gitax mesh.py:36-48; the TSV loops split the rows
    over the hosts).  Otherwise this process is rank 0 and ranks 1.. are
    spawned running `follower` ("module:function", called as fn(rank,
    world, init_method, mesh_shape, device, share_card, timeout_s)).
    device='cpu': gloo on the CPU; else NCCL with one card a rank
    (cuda:LOCAL_RANK), raising before anything starts when the machine
    has fewer cards than ranks, unless share_card puts every rank on card
    0 over gloo.  Before anything starts, a launch that is not a multiple
    of data x model raises, and so does a LOCAL_WORLD_SIZE (torchrun's
    processes a machine) other than data x model: a host's mesh never
    spans machines."""
    import torch

    from ..parallel.mesh import mesh_dims

    data, model = mesh_dims(mesh_shape)
    world = data * model
    rank, launched = launched_world()
    if launched > 1:
        if launched % world:
            raise ValueError(
                "mesh_shape {} takes hosts of {} ranks, and this launch has {} processes: row "
                "shards over hosts need a multiple of data x model".format(
                    list((data, model)), world, launched))
        local = _int_env("LOCAL_WORLD_SIZE")
        if local is not None and local != world:
            raise ValueError(
                "mesh_shape {} is one host's mesh of {} ranks, and LOCAL_WORLD_SIZE is {}: a "
                "host's mesh never spans machines (launch data x model processes a "
                "machine)".format(list((data, model)), world, local))
        return join_inference_group(rank, launched, None, mesh_shape, device, share_card,
                                    timeout_s)
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if share_card:
            if not torch.cuda.is_available():
                raise RuntimeError("share_card: no CUDA device")
        else:
            check_data_parallel(world, device, label="mesh_shape {}".format([data, model]))
    ranks = SpawnedRanks(follower, world, (mesh_shape, device, share_card, timeout_s))
    try:
        return join_inference_group(0, world, ranks.init_method, mesh_shape, device, share_card,
                                    timeout_s, ranks)
    except BaseException:
        ranks.join(ok=False)
        raise
