"""Training CLI of the port, the counterpart of `gitax.train` and through
it of the reference's entry surface (train.py):

    python -m gitax_torch.train -p "{'type': 'forward_backward_example',
        'image_files': [...], 'captions': [...]}"
    python -m gitax_torch.train -p "{'type': 'speed_test_forward_backward',
        'duplicate': 16, 'iterations': 20, 'model_name': 'GIT_LARGE_COCO'}"

The functions run on the CUDA card and raise without one unless the
caller passes device='cpu' (Python callers; the tests do).  Models start
from a seeded random init; `finetune` and `scst_finetune` then load
`checkpoint`: a reference `model.pt`, or a directory the port wrote
(`ckpt.serialization`).  `finetune` with `data_parallel=N` trains on N
cards, one rank each, with ZeRO-1 moments: it spawns the ranks itself,
or, under `torchrun --nproc_per_node N -m gitax_torch.train -p ...`, each
process is one rank.
"""

from __future__ import annotations

import logging
import os
import os.path as op
import time

import numpy as np
import torch

from .common import dispatch_main
from .io.image import load_image, pil_image
from .models.config import config_from_param, get_model_param
from .models.git import GitModel, resolve_device
from .preprocess.train_transforms import (
    TrainTransform,
    collate_samples,
    make_caption_sample,
)

SPEED_CAPTIONS = ("a couple of boats in a large body of water.",
                  "a view of a mountain with a tree")


def _tokenizer():
    from .inference import _load_tokenizer

    return _load_tokenizer()


def _build_batch(images, captions, prefixs, tokenizer, iteration=0, seed=0, transform=None):
    """Collated training samples of images (paths or PIL images), with
    gitax's default TrainTransform unless one is given."""
    transform = transform or TrainTransform(seed=seed)
    samples = [
        make_caption_sample(
            tokenizer, load_image(f) if isinstance(f, str) else f, p, t, transform,
            iteration=iteration,
        )
        for f, p, t in zip(images, prefixs, captions)
    ]
    return collate_samples(samples)


def _random_model(param, device, seed=0):
    """The config of `param` on `device`, random weights from a CPU
    generator seeded with `seed`."""
    return _random_model_of(config_from_param(param), device, seed)


def _random_model_of(cfg, device, seed=0):
    model = GitModel(cfg, device=resolve_device(device))
    return model.init_params(torch.Generator().manual_seed(seed))


def forward_backward_example(image_files, captions, prefixs=None, device=None):
    """One forward and backward step with the GIT_BASE recipe (reference
    train.py:209-244): f32, AdamW(1e-5) with optax.adamw's weight decay
    1e-4.  Returns the loss."""
    from .training.trainer import ConstantSchedule, adamw, init_train_state, make_train_step
    from .training.trainer import to_device

    prefixs = prefixs or [""] * len(captions)
    tokenizer = _tokenizer()
    model = _random_model({}, device)
    batch = to_device(_build_batch(image_files, captions, prefixs, tokenizer),
                      model.textual.output.bias.device)
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-5), weight_decay=1e-4))
    state, metrics = make_train_step(model)(state, batch)
    loss = float(metrics["loss"])
    logging.info("loss = %s", loss)
    return loss


def _speed_images(images):
    """The speed test's two images: `images` when given, else
    aux_data/images/{1,2}.jpg when present, else two synthesized 480x360
    images (seeded: a smooth gradient plus noise, so crops differ)."""
    if images is not None:
        return list(images)
    if op.isfile("aux_data/images/1.jpg") and op.isfile("aux_data/images/2.jpg"):
        return ["aux_data/images/1.jpg", "aux_data/images/2.jpg"]
    Image = pil_image()
    rng = np.random.RandomState(0)
    out = []
    for i in range(2):
        yy, xx = np.mgrid[0:360, 0:480]
        base = np.stack([xx / 480.0, yy / 360.0, np.full_like(xx, i, dtype=float)], -1) * 200
        arr = np.clip(base + rng.randint(0, 56, base.shape), 0, 255).astype(np.uint8)
        out.append(Image.fromarray(arr))
    return out


def speed_test_forward_backward(duplicate=32, iterations=1000, dtype="bfloat16",
                                fast_softmax=None, model_name=None, remat=False,
                                images=None, device=None):
    """Throughput of the train step at batch 2*duplicate (reference
    train.py:246-303, which ran fp16 on a GPU; here bf16 activations with
    f32 masters and AdamW(1e-5, weight decay 1e-4), gitax's protocol).
    fast_softmax defaults to on for bf16.  model_name picks a zoo config
    (default GIT_BASE); remat=True checkpoints the encoder blocks.

    The batch is built at the model's input resolution (gitax builds it
    at the multi-scale schedule's first size, 160 px, which is not whole
    14-px patches for GIT_LARGE).  images: the two images to repeat
    (paths or PIL), see `_speed_images`.  The step is timed in windows of
    10 that end in torch.cuda.synchronize on the card.  Returns a dict:
    batch, images_per_s and ms_per_step over all timed steps, the loss of
    every step (warm-up included), the peak device memory in bytes on the
    card (None on the CPU) and the device."""
    from .training.trainer import ConstantSchedule, adamw, init_train_state, make_train_step
    from .training.trainer import to_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    model = _random_model(get_model_param(model_name) if model_name else {}, dev)
    enc = model.cfg.encoder
    transform = TrainTransform(train_crop_size=enc.input_resolution, min_size_range32=None,
                               patch_size=enc.patch_size, seed=0)
    tokenizer = _tokenizer()
    pics = _speed_images(images)
    n = len(pics)
    batch = _build_batch(pics * duplicate, list(SPEED_CAPTIONS[:n]) * duplicate,
                         [""] * (n * duplicate), tokenizer, transform=transform)
    compute_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    batch = to_device(batch, dev)
    batch["image"] = batch["image"].to(compute_dtype)
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-5), weight_decay=1e-4))
    if fast_softmax is None:
        fast_softmax = dtype == "bfloat16"
    step = make_train_step(model, dtype=compute_dtype, fast_softmax=fast_softmax, remat=remat)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    losses = []
    for _ in range(2):  # warm-up: cuBLAS plans, the allocator's pools
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])
    sync()
    bsz = batch["image"].shape[0]
    timed, total = 0, 0.0
    while timed < iterations:
        window = min(10, iterations - timed)
        start = time.perf_counter()
        for _ in range(window):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"])
        sync()
        dt = time.perf_counter() - start
        timed += window
        total += dt
        logging.info("speed = %.1f images/s (loss %.4f)", bsz * window / dt,
                     float(losses[-1]))
    losses = [float(x) for x in losses]
    logging.info("final loss %s", losses[-1])
    return {
        "batch": bsz,
        "images_per_s": bsz * timed / total if total else None,
        "ms_per_step": total / timed * 1e3 if timed else None,
        "losses": losses,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if cuda else None,
        "device": str(dev),
    }


def _load_checkpoint_params(checkpoint, model):
    """Checkpoint dispatch shared by the finetune and SCST CLIs: a
    reference torch `model.pt` (names matched by suffix), or a directory
    the port wrote: `ckpt.serialization.save_params`'s, or a fine-tune's
    save_dir, whose latest step's weights load.  gitax's Orbax
    directories are not read (they need jax)."""
    if not checkpoint:
        return model
    from . import ckpt
    from .ckpt import serialization

    if checkpoint.endswith(".pt"):
        return ckpt.load_git_state_dict(model, ckpt.load_torch_checkpoint(checkpoint))
    if op.isfile(op.join(checkpoint, serialization.PARAMS_FILE)):
        return serialization.restore_params(checkpoint, model)
    step = serialization.latest_step(checkpoint)
    if step is None:
        raise FileNotFoundError("{}: neither a model.pt, nor {}, nor step directories".format(
            checkpoint, serialization.PARAMS_FILE))
    sd = torch.load(op.join(checkpoint, "step_{:08d}".format(step), serialization.STATE_FILE),
                    map_location="cpu", weights_only=True)["model"]
    model.load_state_dict(sd, strict=True)
    return model


def finetune(
    image_tsv,
    caption_tsv,
    model_name="GIT_BASE",
    checkpoint=None,
    num_steps=1000,
    batch_size=8,
    learning_rate=1e-5,
    save_dir=None,
    save_every=500,
    resume=True,
    dtype="bfloat16",
    remat=False,
    data_parallel=None,
    device=None,
    **kwargs,
):
    """Fine-tune a zoo model on a TSV caption dataset (the reference
    leaves the trainer to the user, README.md:235-237).

        python -m gitax_torch.train -p "{'type': 'finetune',
            'image_tsv': 'data/coco/train.img.tsv',
            'caption_tsv': 'data/coco/train.caption.tsv',
            'model_name': 'GIT_BASE_COCO', 'checkpoint':
            'output/GIT_BASE_COCO/snapshot/model.pt', 'num_steps': 10000,
            'save_dir': 'output/ft'}"

    checkpoint: see `_load_checkpoint_params`.

    data_parallel=N shards the batch over N ranks, one card each (gitax:
    "over the first N local devices (ZeRO-1 moments included)"), each
    rank taking its rows of the one-card batch: N above the card count
    raises.  Without a launcher this process is rank 0 and spawns ranks
    1..N-1 (device='cpu': N gloo CPU processes); under torchrun (WORLD_SIZE
    set) each process is one rank and WORLD_SIZE must be N.  Every rank
    starts from rank 0's weights.  Returns the TrainState (rank 0's on a
    mesh: with ZeRO-1 its optimizer holds rank 0's share of the
    moments)."""
    from .runtime import distributed

    cfg = config_from_param(get_model_param(model_name) if model_name else {})
    run_kwargs = dict(num_steps=num_steps, batch_size=batch_size, learning_rate=learning_rate,
                      save_dir=save_dir, save_every=save_every, resume=resume,
                      dtype=torch.bfloat16 if dtype == "bfloat16" else torch.float32,
                      remat=remat, **kwargs)
    args = (image_tsv, caption_tsv, cfg, checkpoint, run_kwargs, device)
    if not data_parallel:
        state = _finetune_on(None, *args)
    else:
        n = int(data_parallel)
        distributed.check_data_parallel(n, device)
        if os.environ.get("WORLD_SIZE"):
            state = _finetune_rank(None, None, None, n, *args)
        else:
            state = distributed.spawn_ranks("gitax_torch.train:_finetune_rank", n, (n,) + args)
    logging.info("finetune done at step %d", state.step)
    return state


def _finetune_on(mesh, image_tsv, caption_tsv, cfg, checkpoint, run_kwargs, device):
    """The fine-tune of one process: the seeded model (on the mesh's
    device), the checkpoint, `run_finetune`."""
    from .training.finetune import run_finetune

    model = _random_model_of(cfg, mesh.device if mesh else device, run_kwargs.get("seed", 0))
    _load_checkpoint_params(checkpoint, model)
    return run_finetune(image_tsv, caption_tsv, model, mesh=mesh, **run_kwargs)


def _finetune_rank(rank, world_size, init_method, n, *args):
    """One rank of `finetune(data_parallel=n)`: joins the training group
    (NCCL on the cards, gloo for device='cpu'; rank, world and rendezvous
    from torchrun's env when None), runs the fine-tune on an (n, 1) mesh,
    and leaves the group it made."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh
    from .runtime import distributed

    own_group = not dist.is_initialized()
    dev, backend = distributed.init_training_group(rank, world_size, init_method,
                                                   device=args[-1])
    try:
        if dist.get_world_size() != n:
            raise ValueError("data_parallel={} in a launch of {} processes".format(
                n, dist.get_world_size()))
        return _finetune_on(make_mesh(data=n, model=1, device=dev, backend=backend), *args)
    finally:
        if own_group:
            dist.destroy_process_group()


def scst_finetune(
    image_tsv,
    caption_tsv,
    model_name="GIT_BASE",
    checkpoint=None,
    num_steps=1000,
    batch_size=8,
    learning_rate=2e-6,
    save_dir=None,
    device=None,
    **kwargs,
):
    """Self-critical (CIDEr-reward) fine-tuning CLI (the reference's SCST
    path raises NotImplementedError, decoder.py:804-813).

        python -m gitax_torch.train -p "{'type': 'scst_finetune',
            'image_tsv': 'data/coco/train.img.tsv',
            'caption_tsv': 'data/coco/train.caption.tsv',
            'model_name': 'GIT_BASE_COCO',
            'checkpoint': 'output/ft', 'num_steps': 4000,
            'save_dir': 'output/scst'}"
    """
    from .training.finetune import run_scst

    param = get_model_param(model_name) if model_name else {}
    model = _random_model(param, device, kwargs.get("seed", 0))
    _load_checkpoint_params(checkpoint, model)
    state = run_scst(
        image_tsv,
        caption_tsv,
        model,
        num_steps=num_steps,
        batch_size=batch_size,
        learning_rate=learning_rate,
        save_dir=save_dir,
        **kwargs,
    )
    logging.info("scst_finetune done at step %d", state.step)
    return state


if __name__ == "__main__":
    dispatch_main(globals())
