"""The traffic kind 'caption_tsv_mesh': the caption TSV loop of
'caption_tsv' (`drivers.CaptionTSV`: its passes, warm-up and outputs) on a
mesh of data x model ranks, as the TSV CLI runs it with `mesh_shape`
(`python -m gitax_torch.inference -p` on `[4, 1]`).

The program is built by `gitax_torch.runtime.engine.open_mesh_engine`: this
process is rank 0 and spawns ranks 1.., one card a rank over NCCL (gloo CPU
ranks with device 'cpu'); rank 0 draws nothing twice: its `model_fn` loads
the benchmark's weights, which the engine broadcasts.  Rank 0 decodes every
row of the TSV and broadcasts each device batch of `rows_per_rank` x data
rows; each data rank searches its rows and the sequences come back to rank
0.  The mesh's start and close each have a deadline: past it the followers
are stopped and this process ends, so that a failed run never holds the
cards.

The traffic file's keys: those of 'caption_tsv', `mesh_shape` ([data,
model]) and `rows_per_rank`.  The judge's sample is drawn from each data
rank's rows alike (`Driver.pick`): the mesh returns scores for rank 0's
own rows only, and the other ranks' rows are held to the search's choices.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import threading

import numpy as np

from gitbench import traffic as T
from gitbench.drivers import CaptionTSV
from gitbench.program import build_model, engine_settings

START_S = 900  # the mesh's start: spawn, join, the weights broadcast (a first run builds)
CLOSE_S = 120  # the mesh's close: the followers stopped and joined
EXIT_CODE = 4


def stop_children():
    """Terminate this process's spawned ranks, kill those still alive after
    10 s, and wait for each."""
    procs = multiprocessing.active_children()
    for p in procs:
        p.terminate()
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join()


class Deadline(object):
    """A block that has `seconds` to end: past that the mesh's followers are
    stopped and this process exits with EXIT_CODE (rank 0 may be blocked in
    a collective that nothing else ends)."""

    def __init__(self, what, seconds):
        self.what, self.seconds = what, seconds
        self._timer = None

    def _fire(self):
        print("gitbench: {} passed its deadline of {} s; stopping the mesh's ranks".format(
            self.what, self.seconds), file=sys.stderr, flush=True)
        stop_children()
        os._exit(EXIT_CODE)

    def __enter__(self):
        self._timer = threading.Timer(self.seconds, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, *exc):
        self._timer.cancel()


class MeshProgram(object):
    """The port's engine on a mesh, rank 0's side: `.engine` (its
    `CaptionEngine`, batch `rows_per_rank` x data), `.model` (rank 0's
    model, its own data shard's), `close()` (the followers stopped and
    joined, the group left)."""

    def __init__(self, cfg, sd, device, mesh_shape, rows_per_rank):
        from gitax_torch.parallel.mesh import mesh_dims
        from gitax_torch.runtime.engine import open_mesh_engine

        tokenizer, kwargs = engine_settings(cfg)
        kwargs["batch_size"] = rows_per_rank * mesh_dims(mesh_shape)[0]
        self.engine = None
        try:
            with Deadline("the mesh's start", START_S):
                self.engine = open_mesh_engine(lambda dev: build_model(cfg, sd, dev), tokenizer,
                                               mesh_shape, device=device, **kwargs)
        finally:
            if self.engine is None:
                stop_children()
        self.model = self.engine.model

    def close(self):
        engine, self.engine = self.engine, None
        if engine is not None:
            with Deadline("the mesh's close", CLOSE_S):
                engine.close()


class Driver(CaptionTSV):
    """'caption_tsv' through a mesh engine; the warm-up TSV holds one device
    batch of the mesh's rows."""

    def __init__(self, cfg, spec, seed, work):
        super(Driver, self).__init__(cfg, spec, seed, work)
        shape = spec["mesh_shape"]
        self.data = int(shape) if isinstance(shape, int) else int(shape[0])
        self.per = int(spec["rows_per_rank"])
        self.batch = self.per * self.data
        if spec["rows"] % self.batch:
            raise ValueError("rows {} must fill whole device batches of {}".format(
                spec["rows"], self.batch))

    def build(self, cfg, sd, device):
        return MeshProgram(cfg, sd, device, self.spec["mesh_shape"], self.per)

    def prepare(self):
        super(Driver, self).prepare()
        T.write_image_tsv(self.warm_tsv, [(k, self.payloads[int(k.split("_")[1])][2])
                                          for k in self.keys[:self.batch]])

    def data_rank(self, i):
        """The data rank that searched served output i: its TSV row's place
        in its device batch (every pass starts at a batch's first row)."""
        return (i % self.spec["rows"]) % self.batch // self.per

    def pick(self, served, n, seed):
        """n / data of the outputs served from each data rank's rows, drawn
        from the seed, with the longest text in it (in place of the last
        drawn of its data rank)."""
        came = [i for i, s in enumerate(served) if s.text is not None]
        if not came:
            return []
        rng = np.random.default_rng([int(seed), 0x5A3])
        chosen = []
        for d in range(self.data):
            group = [i for i in came if self.data_rank(i) == d]
            k = min(n // self.data, len(group))
            chosen.append([int(i) for i in rng.choice(group, size=k, replace=False)] if k else [])
        longest = max(came, key=lambda i: (len(served[i].text.split()), -i))
        mine = chosen[self.data_rank(longest)]
        if longest not in mine and mine:
            mine[-1] = longest
        return sorted(i for group in chosen for i in group)
