"""Multi-card training and inference, the counterpart of `gitax.parallel`:
the (data, model) mesh over torch.distributed process groups, the
tensor-parallel split and its collectives."""

from .mesh import (
    Mesh,
    broadcast_params,
    gather_optimizer_state,
    gather_params,
    load_sharded,
    make_mesh,
    make_mesh_from_shape,
    shard_optimizer_state,
    shard_for_inference,
    shard_params,
    split_rule,
)
