"""gitax_torch: the PyTorch and CUDA port of gitax for NVIDIA Hopper.

It imports torch and never jax.  Subpackages mirror gitax's: `models/`,
`ops/` (with the CUDA kernels' sources in `csrc/`), `decode/` (beam,
greedy, trie), `runtime/` (the batch engine and its TSV loops), `io/`
and `preprocess/`; `ckpt.py` carries gitax weights and reference
checkpoints across, and `inference.py` is the `-p` CLI.
"""
