"""Run one cell of BENCHMARK.json once, on the machine it is started on:

    python3 gitbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device and, traced,
breakdown; `checks` last, each number compared beside its limit, which also
end standard error.  Exits non-zero with no result when CUDA is missing or
has fewer cards than the cell asks for, when the program is not beside
BENCHMARK.json, or when jax, jaxlib, flax or gitax is loaded once the window
has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "gitax")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (gitax_torch is not gitax)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def cache_dirs(root):
    """Fixed build and kernel cache directories inside the checkout, so that
    only a checkout's first run builds (the port's own nvcc builds go to
    build/gitax_torch/ in the checkout)."""
    base = os.path.join(root, "build", "gitbench")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    cache_dirs(ROOT)
    from gitbench import harness, spec

    bench = spec.load(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log("gitbench: {} needs {} CUDA device(s); this machine has {}".format(
            cell["name"], cell["chips"],
            torch.cuda.device_count() if torch.cuda.is_available() else "none"))
        return 2
    try:
        import gitax_torch  # noqa: F401
    except ImportError as e:
        log("gitbench: the program gitax_torch is not importable beside BENCHMARK.json: "
            "{}".format(e))
        return 2
    log("card: {} ({} visible)".format(harness.card_line(), torch.cuda.device_count()))
    result = harness.run(bench, cell, args.seed, args.seconds, args.trace, "cuda", T_START, log)
    bad = forbidden_modules()
    if bad:
        log("gitbench: the run loaded {}; the benchmark and the port may not".format(
            ", ".join(bad)))
        return 3
    for name, c in result["checks"].items():
        log("check {}: {} (limit {})".format(name, c["value"], c["limit"]))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
