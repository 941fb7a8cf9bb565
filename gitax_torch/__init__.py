"""gitax_torch: the PyTorch and CUDA port of gitax for NVIDIA Hopper.

It imports torch and never jax.  Subpackages mirror gitax's: `models/`,
`ops/` (with the CUDA kernels' sources in `csrc/`), `decode/` (beam,
greedy, trie), `runtime/` (the batch engine and its TSV loops), `io/`,
`preprocess/`, `training/` (the loss, the AdamW step, the fine-tune and
SCST loops), `evalcap/` and `native/` (gitax's C++ JPEG loader, built
with g++ at first use); `models/` also holds CLIP's towers (`resnet.py`,
`clip.py`); `ckpt/` carries gitax weights, reference checkpoints and
CLIP archives across and saves training state, `inference.py` and
`train.py` are the `-p` CLIs.
"""
