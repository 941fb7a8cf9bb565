"""The groups of row shards over 2 hosts x [2, 1] on 4 NCCL ranks, made
with and without the process group bound to a card (`device_id`):

    python3 -m gitax_torch.probes.group_split

from the repository's root, on a machine with four cards.  Each rank
(spawned, a card each) makes, in the port's order, the hosts' data
groups (NCCL [0, 1], [2, 3]), their barrier group (gloo [0, 2]) and each
host's engine groups (gloo header group and NCCL batch group, [0, 1]
then [2, 3]), printing each as it is made, then all-reduces a ones
tensor over each group it is in.  A rank still running after 40 s prints
its Python stack and exits 1.  Bound, torch makes each group by
splitting the default communicator, with a no-colour split on the ranks
outside it, which a gloo group's members never make: the ranks stop in
different group creations."""

import datetime
import faulthandler
import os
import subprocess
import sys
import tempfile
import time

GROUPS = [([0, 1], "nccl"), ([2, 3], "nccl"), ([0, 2], "gloo"), ([0, 1], "gloo"),
          ([0, 1], "nccl"), ([2, 3], "gloo"), ([2, 3], "nccl")]


def rank_main(rank, init_method, bind):
    import torch
    import torch.distributed as dist

    faulthandler.dump_traceback_later(40, exit=True, file=sys.stdout)
    torch.cuda.set_device(rank)
    kw = dict(device_id=torch.device("cuda", rank)) if bind else {}
    dist.init_process_group("nccl", init_method=init_method, world_size=4, rank=rank,
                            timeout=datetime.timedelta(seconds=60), **kw)
    made = []
    for i, (ranks, backend) in enumerate(GROUPS):
        made.append(dist.new_group(ranks, backend=backend))
        print("bound={} rank {} made group {} {} {}".format(bind, rank, i, ranks, backend),
              flush=True)
    for (ranks, backend), group in zip(GROUPS, made):
        if rank in ranks:
            t = torch.ones(4, device="cuda" if backend == "nccl" else "cpu")
            dist.all_reduce(t, group=group)
            print("bound={} rank {} all-reduce over {} {}: {}".format(
                bind, rank, ranks, backend, float(t[0])), flush=True)
    dist.destroy_process_group()


def main():
    for bind in (1, 0):
        with tempfile.TemporaryDirectory(prefix="gitax_group_split_") as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            procs = [subprocess.Popen([sys.executable, "-m", "gitax_torch.probes.group_split",
                                       str(r), init, str(bind)]) for r in range(4)]
            t0 = time.time()
            for p in procs:
                try:
                    p.wait(timeout=max(1.0, 75 - (time.time() - t0)))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        print("bound={}: exit codes {} ({:.1f} s)".format(
            bind, [p.returncode for p in procs], time.time() - t0), flush=True)


if __name__ == "__main__":
    if len(sys.argv) == 4:
        rank_main(int(sys.argv[1]), sys.argv[2], int(sys.argv[3]))
    else:
        main()
