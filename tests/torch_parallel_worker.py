"""The ranks of tests/test_torch_port_parallel.py (`main`) and
tests/test_torch_port_mesh_engine.py (`infer_main`, `faulty_follower`):
gloo CPU processes started by `gitax_torch.runtime.distributed`.

A spawned rank imports this module and through it torch, numpy and
gitax_torch only (never jax or gitax: the card's machine has no jax), and
records whether jax reached its interpreter.  The test process writes
the job (configs, weights, batches, TSV paths) to `job.pt` (inference:
`infer_job.pt`); rank 0 writes each scenario's result, or its traceback,
to `results{world}.pt` (`infer{world}.pt`).
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
        from gitax_torch.decode.beam import BeamSearchConfig

        # sampling on a model group of 2 runs with a generator (the mesh
        # engine's TP sampling cases); without one it raises on every rank
        model.generate(torch.zeros(1, 32, 32, 3), beam=BeamSearchConfig(do_sample=True))
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


# ---------------------------------------------------------------------------
# inference on a mesh: the ranks of tests/test_torch_port_mesh_engine.py
# ---------------------------------------------------------------------------


def mesh_engine(job, shape, case="engine", **kw):
    """The engine of a `shape` mesh on this group: rank 0's
    (`CaptionEngine(mesh=...)` on the case's weights), or, on ranks 1..,
    None after following rank 0's batches until it closed its engine."""
    from gitax_torch.runtime.engine import CaptionEngine, follow_mesh
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    mesh = make_mesh(*shape, device="cpu")
    if dist.get_rank() != 0:
        follow_mesh(mesh)
        return None
    spec = job[case]
    return CaptionEngine(model_from(spec["cfg"], spec["weights"]),
                         BertTokenizer(build_tiny_vocab(job["words"])), mesh=mesh,
                         check_groups=True, **dict(job["engine_kw"], **kw))


def mesh_tokens(job, shape, case="engine", items="images", prefix=(101,), **kw):
    """The search's tokens for the job's items on a `shape` mesh, the
    elements that differed within a model group, and the batch rows
    (rank 0; None elsewhere)."""
    import numpy as np

    engine = mesh_engine(job, shape, case, **kw)
    if engine is None:
        return None
    with engine:
        inputs = job[items]
        n, [(_, seqs)] = engine.dispatch(inputs, [list(prefix)] * len(inputs))
        rows = [engine.to_host(s) for s in seqs]
        return {"tokens": np.concatenate(rows)[:n], "rows": [len(r) for r in rows],
                "unequal": engine.group_mismatches}


def mesh_tsv(job, shape, kind, loop):
    """The engine's TSV loop (`loop`: caption or vqa) with the job's
    `kind` transform on a `shape` mesh: the output path (rank 0)."""
    from gitax_torch.preprocess import transforms

    engine = mesh_engine(job, shape, transform=transforms.TestTransform(
        **job["transforms"][kind]))
    if engine is None:
        return None
    out = os.path.join(job["dir"], "mesh_{}_{}.tsv".format(kind, loop))
    with engine:
        if loop == "vqa":
            engine.run_vqa_tsv(job["img_tsv"], job["q_tsv"], out)
        else:
            engine.run_caption_tsv(job["img_tsv"], out)
    return {"path": out, "unequal": engine.group_mismatches}


def in_cli_dir(job, fn):
    """fn() with the working directory at the CLI's (output/, aux_data/)
    and the CLI's config and tokenizer set to the job's TINY ones."""
    from gitax_torch import inference
    from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

    cli = job["cli"]
    saved = (os.getcwd(), inference.config_from_param, inference._load_tokenizer)
    os.chdir(cli["dir"])
    inference.config_from_param = lambda param=None: cli["cfg"]
    inference._load_tokenizer = lambda: BertTokenizer(build_tiny_vocab(cli["words"]))
    try:
        return fn()
    finally:
        os.chdir(saved[0])
        inference.config_from_param, inference._load_tokenizer = saved[1:]


def cli_tsv(job, loop, mesh_shape):
    """test_git_inference_single_tsv with mesh_shape on this group."""
    from gitax_torch import inference

    out = "mesh_{}.tsv".format(loop)
    q_tsv = "q.tsv" if loop == "vqa" else None

    def run():
        inference.test_git_inference_single_tsv("img.tsv", "TINY_CAP", q_tsv, out, batch_size=2,
                                                dtype="float32", mesh_shape=mesh_shape,
                                                use_native=False, device="cpu")
        return os.path.join(job["cli"]["dir"], out) if dist.get_rank() == 0 else None

    return in_cli_dir(job, run)


def cli_image(job, trie, mesh_shape):
    """test_git_inference_single_image (beam, or trie over names.txt) with
    mesh_shape on this group: the caption on rank 0."""
    from gitax_torch import inference

    kw = dict(vocab_file="names.txt") if trie else {}
    return in_cli_dir(job, lambda: inference.test_git_inference_single_image(
        "f0.png", "TINY_CAP", "", mesh_shape=mesh_shape, device="cpu", **kw))


def served(job):
    """build_serving_stack(mesh_shape=2): each payload alone (a batch of
    1, padded to 2 by the mesh), then /stats (rank 0)."""
    from gitax_torch import serve
    from gitax_torch.runtime.serving import DynamicBatcher

    def run():
        engine, batcher = serve.build_serving_stack("TINY_CAP", batch_size=2, dtype="float32",
                                                    max_steps=8, max_text_len=8, mesh_shape=2,
                                                    device="cpu")
        if engine is None:
            return None
        batcher.close()  # the stack's own, with the default buckets
        batcher = DynamicBatcher(engine, max_wait_ms=10.0, buckets=(1, 2))
        try:
            replies = [batcher.caption(p, timeout=120) for p in job["payloads"]]
            question = batcher.caption(job["payloads"][0], question="what is the color",
                                       timeout=120)
        finally:
            batcher.close()
            engine.close()
        return {"replies": replies, "question": question, "stats": batcher.stats.snapshot()}

    return in_cli_dir(job, run)


# the sampled search of test_torch_port_mesh_engine.py's TP cases: the
# repetition penalty, top-k and two return sequences an input
SAMPLE_BEAM = dict(num_beams=2, max_steps=12, do_sample=True, temperature=1.3, top_k=20,
                   repetition_penalty=1.4)
SAMPLE_SEED = 11


def sample_images(job):
    """The first 3 job images normalised with CLIP's constants, [3, 32, 32,
    3] f32."""
    import numpy as np

    from gitax_torch.preprocess.transforms import CLIP_MEAN, CLIP_STD

    x = np.stack(job["images"][:3]).astype(np.float32) / 255.0
    return torch.from_numpy((x - CLIP_MEAN) / CLIP_STD)


def sampled_1x2(job):
    """generate(do_sample) on a model sharded over [1, 2], each rank's
    caller seeding its generator differently (rank 0 SAMPLE_SEED): rank
    0's tokens, the elements that differ between the ranks, and whether
    every rank's generator ends in rank 0's state."""
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.parallel.mesh import shard_for_inference

    spec = job["engine"]
    mesh = make_mesh(1, 2, device="cpu")
    model = shard_for_inference(model_from(spec["cfg"], spec["weights"]), mesh)
    rng = torch.Generator().manual_seed(SAMPLE_SEED if dist.get_rank() == 0 else 1000 + dist.get_rank())
    seqs, logprobs = model.generate(sample_images(job), beam=BeamSearchConfig(**SAMPLE_BEAM),
                                    num_return_sequences=2, rng=rng)
    unequal = comm.count_unequal(seqs, mesh.model_group, 2)
    state = rng.get_state().to(torch.int64)
    states_unequal = comm.count_unequal(state, mesh.model_group, 2)
    return {"tokens": seqs.numpy(), "logprobs": logprobs.numpy(), "unequal": unequal,
            "states_unequal": states_unequal}


def sampled_engine_1x2(job):
    """The same search through the [1, 2] engine's `dispatch_device_batch`
    (rank 0's generator pickled to the follower, two sequences a row
    gathered): the tokens on rank 0."""
    from gitax_torch.decode.beam import BeamSearchConfig

    engine = mesh_engine(job, (1, 2))
    if engine is None:
        return None
    import numpy as np

    with engine:
        seqs = engine.dispatch_device_batch(
            np.stack(job["images"][:3]), [[101]] * 3, beam=BeamSearchConfig(**SAMPLE_BEAM),
            num_return_sequences=2, rng=torch.Generator().manual_seed(SAMPLE_SEED))
        return {"tokens": engine.to_host(seqs), "unequal": engine.group_mismatches}


def mesh_refusals(job):
    """What a mesh still refuses, on every rank: sampling with no
    generator on a model sharded over 2 model ranks, a batch size that
    does not split over the data axis."""
    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.parallel.mesh import shard_for_inference
    from gitax_torch.runtime.engine import CaptionEngine

    out = {}
    spec = job["engine"]
    model = shard_for_inference(model_from(spec["cfg"], spec["weights"]),
                                make_mesh(1, 2, device="cpu"))
    try:
        model.generate(torch.zeros(1, 32, 32, 3), beam=BeamSearchConfig(do_sample=True))
    except ValueError as e:
        out["sample"] = str(e)
    try:
        CaptionEngine(model_from(spec["cfg"], spec["weights"]), None, batch_size=3,
                      mesh=make_mesh(2, 1, device="cpu"))
    except ValueError as e:
        out["batch"] = str(e)
    return out


INFER_SCENARIOS = {
    2: [("tsv_caption_crop", lambda job: mesh_tsv(job, (2, 1), "crop", "caption")),
        ("tsv_vqa_crop", lambda job: mesh_tsv(job, (2, 1), "crop", "vqa")),
        ("tsv_caption_minmax", lambda job: mesh_tsv(job, (2, 1), "minmax", "caption")),
        ("tsv_vqa_minmax_tp", lambda job: mesh_tsv(job, (1, 2), "minmax", "vqa")),
        ("cli_caption", lambda job: cli_tsv(job, "caption", 2)),
        ("cli_vqa", lambda job: cli_tsv(job, "vqa", [2, 1])),
        ("tokens_2x1", lambda job: mesh_tokens(job, (2, 1))),
        ("tokens_1x2", lambda job: mesh_tokens(job, (1, 2))),
        ("int8_1x2", lambda job: mesh_tokens(job, (1, 2), int8=True)),
        ("video_1x2", lambda job: mesh_tokens(job, (1, 2), case="video", items="clips",
                                              prefix=(101, 7, 9))),
        ("serving", served),
        ("sample_1x2", sampled_1x2),
        ("sample_engine_1x2", sampled_engine_1x2),
        ("refusals", mesh_refusals)],
    4: [("tokens_2x2", lambda job: mesh_tokens(job, (2, 2))),
        ("int8_2x2", lambda job: mesh_tokens(job, (2, 2), int8=True)),
        ("video_2x2", lambda job: mesh_tokens(job, (2, 2), case="video", items="clips",
                                              prefix=(101, 7, 9))),
        ("cli_beam_2x2", lambda job: cli_image(job, False, [2, 2])),
        ("cli_trie_2x2", lambda job: cli_image(job, True, [2, 2]))],
}


def infer_main(rank, world, init_method, job_dir):
    """A rank of the inference group of `world` ranks: every scenario of
    INFER_SCENARIOS[world] in order, rank 0 writing each one's result, or
    its traceback, to infer{world}.pt."""
    init_training_group(rank, world, init_method, device="cpu", timeout_s=TIMEOUT_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        job = torch.load(os.path.join(job_dir, "infer_job.pt"), weights_only=False)
        job["dir"] = job_dir
        results = {"jax_imported": per_rank("jax" in sys.modules, world)}
        for name, fn in INFER_SCENARIOS[world]:
            try:
                results[name] = fn(job)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
        if rank == 0:
            torch.save(results, os.path.join(job_dir, "infer{}.pt".format(world)))
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()


def faulty_follower(rank, world, init_method, mesh_shape, device, share_card, timeout_s):
    """A follower rank whose search raises at rank 0's first batch: the
    process ends with the error, and rank 0's next collective must
    raise."""
    from gitax_torch.runtime import distributed
    from gitax_torch.runtime.engine import CaptionEngine

    group = distributed.join_inference_group(rank, world, init_method, mesh_shape, device,
                                             share_card, timeout_s)
    engine = CaptionEngine.follower(group.mesh)

    def fail(*a, **kw):
        raise RuntimeError("planted failure on rank {}".format(rank))

    engine.model.generate = fail
    engine.follow()


# ---------------------------------------------------------------------------
# row shards over hosts, w8a8 on a mesh, the groups' timeouts: the ranks
# of tests/test_torch_port_hosts.py
# ---------------------------------------------------------------------------


def hosts_tsv(job, loop, mesh_shape):
    """test_git_inference_single_tsv with mesh_shape on this launch (H
    hosts of data x model ranks): the joined TSV's path on global rank 0."""
    from gitax_torch import inference

    out = "hosts_{}_{}.tsv".format(loop, "x".join(map(str, mesh_shape)))
    q_tsv = "q.tsv" if loop == "vqa" else None

    def run():
        inference.test_git_inference_single_tsv("img.tsv", "TINY_CAP", q_tsv, out, batch_size=2,
                                                dtype="float32", mesh_shape=mesh_shape,
                                                device="cpu")
        return os.path.join(job["cli"]["dir"], out) if dist.get_rank() == 0 else None

    return in_cli_dir(job, run)


def w8a8_tokens(job, mesh_shape):
    """The w8a8 model (`quantize_git_model_(encoder=True)`, then split)
    searching the job's images on this launch's `mesh_shape` meshes, one a
    host: each data rank its rows; the [B, L] tokens on every host's rank
    0 ({host: tokens} on global rank 0, through the hosts' group)."""
    import numpy as np

    from gitax_torch.decode.beam import BeamSearchConfig
    from gitax_torch.ops.quant import quantize_git_model_
    from gitax_torch.parallel.mesh import shard_for_inference

    spec = job["w8a8"]
    mesh = make_mesh_from_shape(mesh_shape, device="cpu")
    model = shard_for_inference(quantize_git_model_(model_from(spec["cfg"], spec["weights"]),
                                                    encoder=True), mesh)
    images = torch.from_numpy(spec["images"])
    lo, hi = mesh.batch_rows(len(images))
    with torch.no_grad():
        seqs, _ = model.generate(images[lo:hi], beam=BeamSearchConfig(**spec["beam"]))
    if mesh.model_rank != 0:
        return None
    full = comm.gather_rows(seqs, lo, len(images), mesh.data_group)
    if mesh.rank != 0:
        return None
    hosts = [None] * mesh.hosts
    if mesh.hosts > 1:
        dist.all_gather_object(hosts, full.numpy(), group=mesh.hosts_group)
    else:
        hosts[0] = full.numpy()
    return {h: np.asarray(t) for h, t in enumerate(hosts)} if dist.get_rank() == 0 else None


def w8a8_row_parallel(job):
    """A w8a8 row-parallel layer on a [1, 2] mesh a host: each model rank
    holds half of K (the job's planted rows keep their amax on one rank or
    the other); the output on global rank 0."""
    from gitax_torch.ops.int8_dynamic import int8_dynamic_matmul

    spec = job["row"]
    mesh = make_mesh_from_shape([1, 2], device="cpu")
    k = spec["x"].shape[1] // 2
    part = slice(mesh.model_rank * k, (mesh.model_rank + 1) * k)
    y = int8_dynamic_matmul(spec["x"][:, part], spec["w_q8_t"][part], spec["scale"], spec["bias"],
                            mesh.model_group)
    return y if dist.get_rank() == 0 else None


HOSTS_SCENARIOS = [
    ("hosts_caption_2x1", lambda job: hosts_tsv(job, "caption", [2, 1])),
    ("hosts_vqa_2x1", lambda job: hosts_tsv(job, "vqa", [2, 1])),
    ("hosts_caption_1x2", lambda job: hosts_tsv(job, "caption", [1, 2])),
    ("hosts_vqa_1x2", lambda job: hosts_tsv(job, "vqa", [1, 2])),
    ("w8a8_1x2", lambda job: w8a8_tokens(job, [1, 2])),
    ("w8a8_2x2", lambda job: w8a8_tokens(job, [2, 2])),
    ("w8a8_row", w8a8_row_parallel),
]


def hosts_main(rank, world, init_method, job_dir):
    """A rank of a launch of `world` gloo CPU ranks: every scenario of
    HOSTS_SCENARIOS in order, rank 0 writing each one's result, or its
    traceback, to hosts.pt."""
    init_training_group(rank, world, init_method, device="cpu", timeout_s=TIMEOUT_S)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        job = torch.load(os.path.join(job_dir, "hosts_job.pt"), weights_only=False)
        job["dir"] = job_dir
        results = {"jax_imported": per_rank("jax" in sys.modules, world)}
        for name, fn in HOSTS_SCENARIOS:
            try:
                results[name] = fn(job)
            except Exception:
                results[name] = {"error": traceback.format_exc()}
        if rank == 0:
            torch.save(results, os.path.join(job_dir, "hosts.pt"))
    finally:
        torch.set_num_threads(threads)
        dist.destroy_process_group()


def sleeping_follower(rank, world, init_method, timeout_s, sleep_s):
    """A rank that joins the group (on TIMEOUT_S: a loaded machine may start
    it late), makes the groups rank 0 makes on `timeout_s` (a [1, 2]
    mesh's model group, a [2, 1] mesh's data group, an engine channel on
    the [1, 2] mesh) and then hangs: it sleeps instead of joining rank 0's
    collectives."""
    import time

    from gitax_torch.runtime.engine import _Channel

    init_training_group(rank, world, init_method, device="cpu", timeout_s=TIMEOUT_S)
    dist.barrier()
    mesh = make_mesh(1, 2, device="cpu", timeout_s=timeout_s)
    make_mesh(2, 1, device="cpu", timeout_s=timeout_s)
    _Channel(mesh)
    time.sleep(sleep_s)
