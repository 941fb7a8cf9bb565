"""The ranks of tests/test_torch_port_parallel.py: gloo CPU processes
started by `gitax_torch.runtime.distributed.spawn_ranks`.

A spawned rank imports this module and through it torch, numpy and
gitax_torch only (never jax or gitax: the card's machine has no jax), and
records whether jax reached its interpreter.  The test process writes
the job (configs, weights, batches, TSV paths) to `job.pt`; rank 0
writes each scenario's result, or its traceback, to `results{world}.pt`.
A scenario that fails on every rank at the same point is recorded and the
next one runs; the group's timeout bounds a rank left waiting.
"""

import os
import shutil
import sys
import traceback

import torch
import torch.distributed as dist

from gitax_torch.models.git import GitModel
from gitax_torch.parallel import comm
from gitax_torch.parallel.mesh import (
    gather_optimizer_state,
    gather_params,
    make_mesh,
    make_mesh_from_shape,
    shard_params,
)
from gitax_torch.runtime.distributed import init_training_group
from gitax_torch.training import run_finetune
from gitax_torch.training.trainer import (
    ConstantSchedule,
    adamw,
    default_optimizer,
    init_train_state,
    make_train_step,
)

TIMEOUT_S = 120


def model_from(cfg, weights):
    model = GitModel(cfg, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


def per_rank(value, mesh_world):
    """[world] tensor of every rank's `value` (a zero-padded all-reduce)."""
    t = torch.zeros(mesh_world, dtype=torch.float64)
    t[dist.get_rank()] = float(value)
    dist.all_reduce(t)
    return t.tolist()


def train_steps(job, shape, zero1=False, remat=False, case="tiny"):
    """`steps` train steps on a `shape` mesh from the job's weights and
    global batch: per-step loss and grad norm, the first step's reduced
    gradients and the final weights (one-card layout), and each rank's
    count of moment elements."""
    spec = job[case]
    mesh = make_mesh(*shape, device="cpu")
    model = shard_params(model_from(spec["cfg"], spec["weights"]), mesh)
    if spec["schedule"] == "constant":
        opt = adamw(model, ConstantSchedule(spec["lr"]), zero1=zero1)
    else:
        opt = default_optimizer(model, learning_rate=spec["lr"], weight_decay=0.2,
                                warmup_steps=2, total_steps=10, zero1=zero1)
    state = init_train_state(model, *opt)
    step = make_train_step(model, remat=remat)
    first = {}
    real_step = state.optimizer.step

    def spy(*a, **kw):
        if not first:
            for n, p in model.named_parameters():
                first[n] = p.grad.detach().clone()
        return real_step(*a, **kw)

    state.optimizer.step = spy
    batch = mesh.local_batch(spec["batch"])
    metrics = []
    for _ in range(spec["steps"]):
        state, m = step(state, batch)
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    grads = gather_grads(model, first)
    local = sum(st["exp_avg"].numel() for st in getattr(state.optimizer, "optim",
                                                         state.optimizer).state.values())
    return {"metrics": metrics, "grads": grads, "weights": gather_params(model),
            "moments": per_rank(local, dist.get_world_size())}


def gather_grads(model, grads):
    from gitax_torch.parallel.mesh import split_rule, unshard_tensor

    return {n: unshard_tensor(split_rule(n), g, model.mesh) for n, g in grads.items()}


def refusals(job):
    out = {}
    try:
        make_mesh(data=2, model=2, device="cpu")
    except ValueError as e:
        out["mesh"] = str(e)
    mesh = make_mesh_from_shape([1, dist.get_world_size()], device="cpu")
    model = shard_params(model_from(job["tiny"]["cfg"], job["tiny"]["weights"]), mesh)
    try:
        model.generate(torch.zeros(1, 32, 32, 3), mode="greedy", max_steps=3)
    except ValueError as e:
        out["generate"] = str(e)
    return out


def finetune_state(state):
    """The run's one-card weights and AdamW state (on rank 0)."""
    return {"weights": gather_params(state.model),
            "optimizer": gather_optimizer_state(state.optimizer, state.model),
            "step": state.step}


def finetunes(job):
    """run_finetune on a [2, 1] mesh: the continuous run saving steps 2
    and 4, and a run resumed from the one-card run's step 2."""
    ft = job["finetune"]
    out = {}
    for label in ("continuous", "resumed"):
        save_dir = os.path.join(job["dir"], "mesh_" + label)
        if label == "resumed" and dist.get_rank() == 0:
            shutil.copytree(os.path.join(job["dir"], "one_continuous", "step_00000002"),
                            os.path.join(save_dir, "step_00000002"))
        comm.barrier("cpu")
        mesh = make_mesh(data=2, model=1, device="cpu")
        model = model_from(ft["cfg"], ft["weights"] if dist.get_rank() == 0 else ft["other"])
        state = run_finetune(job["img_tsv"], job["cap_tsv"], model, mesh=mesh, **ft["kwargs"],
                             save_dir=save_dir)
        out[label] = finetune_state(state)
        out[label]["files"] = sorted(os.path.relpath(os.path.join(d, f), save_dir)
                                     for d, _, fs in os.walk(save_dir) for f in fs)
    return out


def validate_tp(job):
    """run_finetune on a [1, 2] mesh with validation at its end: rank 0
    scores a one-card copy of the gathered weights, the other rank waits;
    the validation lines each rank logged."""
    import logging

    ft = job["finetune"]
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    try:
        mesh = make_mesh_from_shape([1, 2], device="cpu")
        run_finetune(job["img_tsv"], job["cap_tsv"], model_from(ft["cfg"], ft["weights"]),
                     mesh=mesh, **dict(ft["kwargs"], num_steps=1), val_image_tsv=job["img_tsv"],
                     val_caption_tsv=job["cap_tsv"],
                     val_kwargs={"crop_size": 32, "num_beams": 2, "max_steps": 6,
                                 "batch_size": 2})
    finally:
        root.removeHandler(handler)
        root.setLevel(level)
    validations = [m for m in lines if m.startswith("validation @")]
    return {"validations": validations, "counts": per_rank(len(validations),
                                                           dist.get_world_size())}


SCENARIOS = {
    2: [("dp", lambda job: train_steps(job, (2, 1))),
        ("dp_zero1", lambda job: train_steps(job, (2, 1), zero1=True)),
        ("tp", lambda job: train_steps(job, (1, 2))),
        ("tp_remat", lambda job: train_steps(job, (1, 2), remat=True)),
        ("refusals", refusals),
        ("finetune", finetunes),
        ("validate_tp", validate_tp)],
    4: [("dpxtp", lambda job: train_steps(job, (2, 2), zero1=True)),
        ("zero1_gitax", lambda job: train_steps(job, (2, 2), zero1=True, case="zero1"))],
}


def main(rank, world, init_method, job_dir):
    init_training_group(rank, world, init_method, device="cpu", timeout_s=TIMEOUT_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the ranks share the test machine's cores
    try:
        job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
        job["dir"] = job_dir
        results = {"jax_imported": per_rank("jax" in sys.modules, world)}
        for name, fn in SCENARIOS[world]:
            try:
                results[name] = fn(job)
            except Exception:  # recorded for the test of this scenario to report
                results[name] = {"error": traceback.format_exc()}
        if rank == 0:
            torch.save(results, os.path.join(job_dir, "results{}.pt".format(world)))
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()
