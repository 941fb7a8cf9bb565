"""gitax_torch: the PyTorch and CUDA port of gitax for NVIDIA Hopper.

It imports torch and never jax.  Subpackages mirror gitax's: `models/`,
`ops/` (with the CUDA kernels' sources in `csrc/`), `decode/`,
`runtime/`, and `ckpt.py` to carry gitax weights across.
"""
