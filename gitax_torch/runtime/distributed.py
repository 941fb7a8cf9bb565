"""Multi-process setup for the TSV loops, the counterpart of
`gitax.runtime.distributed` with torch.distributed where gitax uses
jax.distributed.

The reference's "distributed" layer is mpirun env vars plus a file-system
barrier (common.py:106-119, inference.py:214-225).  The port keeps that
rank/world contract for row sharding (runtime/engine.py) and, when a
launch names a coordinator, joins one process group so that the shard
barrier is a collective.  The group only synchronises hosts (no tensor
crosses it), so it is gloo's and never touches the card.
"""

from __future__ import annotations

import logging
import os


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

