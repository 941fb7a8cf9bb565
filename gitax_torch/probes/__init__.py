"""One-off checks of what the CUDA stack under the port does on cards
over NCCL, each run as a module on a machine with enough cards:
`nccl_if` (can a conditional graph node's body hold NCCL's captured
collectives) and `group_split` (the groups of row shards over hosts,
with and without the process group bound to a card).  Each rank meets
the others through a file:// rendezvous in a temporary directory, so
no port is fixed and two runs never collide."""
