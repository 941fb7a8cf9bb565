"""One-off checks of what the CUDA stack under the port does on cards,
each run as a module on a machine with enough cards: `nccl_if` (can a
conditional graph node's body hold NCCL's captured collectives) and
`group_split` (the groups of row shards over hosts, with and without the
process group bound to a card), over NCCL, where each rank meets the
others through a file:// rendezvous in a temporary directory, so no port
is fixed and two runs never collide; and `span_cost` (the host cost of
`runtime/profiling.py`'s spans a device batch, on and off, on one card)."""
