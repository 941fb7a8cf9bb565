"""gitbench: the benchmark of gitax_torch, the PyTorch and CUDA port of gitax.

`python3 gitbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints one JSON line.  Everything a
cell needs is found by name: its configuration under `configs/` (and the
reference module it names), its traffic under `traffic/` (and the driver of
its kind under `kinds/` where `drivers.py` has none), its correctness limits
under `workloads/` and each per-layer metric's reader under `metrics/`.  See
README.md.

Nothing here imports jax or the gitax package; the plain reference
(`reference.py`) imports nothing of gitax_torch either.
"""
