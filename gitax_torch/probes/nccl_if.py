"""Whether the body of a conditional IF node (`csrc/graph_if.cu`) can hold
NCCL's captured collectives:

    python3 -m gitax_torch.probes.nccl_if

from the repository's root, on a machine with two cards or more.  For
NCCL_GRAPH_MIXING_SUPPORT unset (NCCL's default) and 0, two ranks (NCCL,
a card each, spawned with a bound of BOUND_S seconds) each capture a step
that all-reduces a [128, 768] tensor (f32 and bf16), counts itself and
rewrites the predicate, print the captured graph's node types
(`device_loop.node_types`), build the IF graph (`device_loop.IfGraph`:
it raises naming the node types a conditional body refuses), launch it 6
times (the body must run 3 times and add the sum over the ranks each
time) and time 200 launches under a true predicate (CUDA events).  A
rank leaves with os._exit once it has printed (tearing the communicator
down can wait on it); one still running at the bound is killed.  Exits
non-zero unless, with mixing off, every rank built the IF graph, ran the
body 3 times and summed right."""

import os
import subprocess
import sys
import tempfile
import time

BOUND_S = 90


def rank_main(rank, world, init_method, label):
    import collections

    import torch
    import torch.distributed as dist

    from gitax_torch.decode import device_loop

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=init_method, world_size=world, rank=rank)
    dev = torch.device("cuda", rank)
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.arange(128 * 768, device=dev, dtype=torch.float32).reshape(128, 768) % 7
             + rank).to(dtype)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        pred = torch.ones((), dtype=torch.bool, device=dev)
        acc = torch.zeros(128, 768, dtype=dtype, device=dev)
        side = torch.cuda.Stream(dev)

        def body():
            y = x.clone()
            dist.all_reduce(y)
            acc.add_(y)
            count.add_(1)
            pred.copy_(count < 3)

        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            body()  # the warm-up: the communicator and the first collective
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        count.zero_()
        acc.zero_()
        pred.fill_(True)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
            body()
        types = device_loop.node_types(graph)
        print("[{}] rank {} {}: the captured step's nodes {}".format(
            label, rank, dtype, dict(collections.Counter(types))), flush=True)
        try:
            cond = device_loop.IfGraph(graph, pred)
        except RuntimeError as e:
            print("[{}] rank {} {}: {}".format(label, rank, dtype, e), flush=True)
            continue
        for _ in range(6):
            cond.launch()
        torch.cuda.synchronize(dev)
        # the sum over the two ranks is 2 (x - rank) + 1; three bodies ran
        want = ((x.float() - rank) * 2 + 1).to(dtype) * 3
        ran, ok = int(count), torch.equal(acc, want)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(200):
            pred.fill_(True)
            cond.launch()
        end.record()
        torch.cuda.synchronize(dev)
        print("[{}] rank {} {}: the IF graph ran its body {} times of 3 and summed right: {}; "
              "a launch under a true predicate {:.4f} ms (200 launches, CUDA events)".format(
                  label, rank, dtype, ran, ok, start.elapsed_time(end) / 200), flush=True)
        print("RESULT {} {} {} {}".format(label == "mixing off", rank, dtype,
                                          ran == 3 and ok), flush=True)
    sys.stdout.flush()
    os._exit(0)


def main():
    import torch

    from gitax_torch.ops import cuda_build

    if torch.cuda.device_count() < 2:
        print("nccl_if: needs two cards, found {}".format(torch.cuda.device_count()))
        return 1
    cuda_build.build_all(["graph_if"])
    print("torch {} cuda {} nccl {}; {} cards".format(
        torch.__version__, torch.version.cuda, torch.cuda.nccl.version(),
        torch.cuda.device_count()), flush=True)
    env = dict(os.environ)
    env.pop("NCCL_GRAPH_MIXING_SUPPORT", None)
    passed = 0
    for label, extra in (("NCCL's default", {}),
                         ("mixing off", {"NCCL_GRAPH_MIXING_SUPPORT": "0"})):
        with tempfile.TemporaryDirectory(prefix="gitax_nccl_if_") as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            procs = [subprocess.Popen([sys.executable, "-m", "gitax_torch.probes.nccl_if",
                                       str(r), "2", init, label],
                                      env=dict(env, **extra), stdout=subprocess.PIPE, text=True)
                     for r in range(2)]
            t0 = time.time()
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, BOUND_S - (time.time() - t0)))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
            for p in procs:
                for line in p.stdout.read().splitlines():
                    print(line, flush=True)
                    parts = line.split()
                    passed += parts[:2] == ["RESULT", "True"] and parts[-1] == "True"
        print("[{}] exit codes {} ({:.1f} s)".format(label, [p.returncode for p in procs],
                                                     time.time() - t0), flush=True)
    # mixing off: two ranks, two dtypes
    print("nccl_if: with mixing off {} of 4 rank-dtype cases ran 3 bodies and summed right".format(
        passed), flush=True)
    return 0 if passed == 4 else 1


if __name__ == "__main__":
    if len(sys.argv) == 5:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        sys.exit(main())
