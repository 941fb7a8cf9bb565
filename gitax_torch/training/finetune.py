"""The fine-tuning loop over TSV datasets, the counterpart of
`gitax.training.finetune`.

The reference ships only a one-step `forward_backward_example` and says
"GIT can be plugged into any trainer" (reference README.md:235-237,
train.py:209-244).  As gitax, the port provides the trainer: a
TSV-backed dataset (the `image.tsv` + `caption.tsv` pair that
`data_prepare.prepare_coco_test` writes), a host producer thread, the
multi-scale inception-crop recipe (train.py:143-207), caption tokens
padded to one fixed length, checkpoints with resume
(`ckpt.serialization`), validation through the port's `CaptionEngine`,
and SCST (`run_scst`).

The model passed in holds the weights (gitax passes a params tree
beside it); the loops make it trainable and update it in place.
`run_finetune(mesh=...)` trains on gitax's (data, model) mesh
(`parallel.mesh`), one process per rank, with ZeRO-1 Adam moments; SCST
runs on one card, as gitax's `run_scst` does.
"""

from __future__ import annotations

import copy
import json
import logging
import queue
import random
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..io.image import image_from_base64
from ..io.tsv import TSVFile
from ..preprocess.train_transforms import (
    TrainTransform,
    collate_samples,
    make_caption_sample,
)


class TSVCaptionDataset(object):
    """(image_tsv, caption_tsv) -> (image_row_idx, caption) sample pairs.

    Row i of the caption TSV annotates row i of the image TSV (same key,
    reference inference.py:171-176 alignment contract); its second column
    is a json list of {'caption': ...} and every caption becomes one
    training sample (standard COCO fine-tuning epoch).
    """

    def __init__(self, image_tsv: str, caption_tsv: str):
        self.images = TSVFile(image_tsv)
        self.pairs: list = []  # (image_row, caption_text)
        captions = TSVFile(caption_tsv)
        assert len(captions) == len(self.images), (
            len(captions), len(self.images))
        for i in range(len(captions)):
            key, payload = captions[i][0], captions[i][1]
            assert key == self.images.get_key(i), (key, i)
            for cap in json.loads(payload):
                self.pairs.append((i, cap["caption"]))

    def __len__(self):
        return len(self.pairs)

    def epoch_order(self, epoch: int, seed: int = 0) -> np.ndarray:
        return np.random.RandomState(seed + epoch).permutation(len(self.pairs))

    def sample(self, pair_idx: int) -> Tuple[object, str]:
        row, caption = self.pairs[pair_idx]
        img = image_from_base64(self.images[row][1])
        return img, caption


def _pad_tokens(batch: dict, max_text_len: int) -> dict:
    """Pad caption_tokens/need_predict to a fixed length (static shapes).

    The fixed length is max_text_len + 2: make_caption_sample replicates
    the reference's double-truncation quirk (train.py:52-57 — payloads
    of max_text_len-1 or max_text_len escape the truncation branch and
    gain [CLS]/[SEP] on top), so real samples can be up to
    max_text_len + 2 long.  Slicing to max_text_len here would cut the
    trailing [SEP] and its need_predict=1 — the EOS supervision — on
    near-max-length captions."""
    pad_to = max_text_len + 2
    out = dict(batch)
    for key in ("caption_tokens", "need_predict"):
        v = batch[key]
        assert v.shape[1] <= pad_to, (v.shape, pad_to)
        if v.shape[1] < pad_to:
            buf = np.zeros((v.shape[0], pad_to), v.dtype)
            buf[:, : v.shape[1]] = v
            out[key] = buf
    return out


def batch_iterator(
    dataset: TSVCaptionDataset,
    tokenizer,
    transform: TrainTransform,
    batch_size: int,
    num_steps: int,
    start_step: int = 0,
    max_text_len: int = 40,
    seed: int = 0,
    prefetch: int = 2,
    rows: Optional[Tuple[int, int]] = None,
) -> Iterator[dict]:
    """Host-side batch producer: epoch-shuffled, multi-scale by step,
    fixed token padding, prefetched on a background thread.  The
    permutation stream is read continuously across epochs, and each
    step's crop draws come from random.Random((seed << 40) + step), so a
    resumed run reproduces the continuous run's batches.  A producer
    failure raises.

    rows=(lo, hi): only rows [lo, hi) of each global batch (a data rank's,
    `parallel.mesh.Mesh.batch_rows`), equal to those rows of the one-card
    batch: the rows before lo are still drawn, since the crops of a step
    come from one sequential stream."""
    # private copy: the producer thread re-seeds transform.rng per step,
    # which must not clobber the caller's object (or race a second
    # iterator sharing the same transform)
    transform = copy.copy(transform)

    def produce(q: queue.Queue):
        step = start_step
        pos = step * batch_size
        cached_epoch, order = -1, None
        n = len(dataset)
        try:
            while step < num_steps:
                # a tail batch spans the end of one epoch's order and the
                # start of the next (wrapping modulo the current
                # permutation would duplicate its head and skip the next
                # epoch's first pos % n entries)
                transform.rng = random.Random((seed << 40) + step)
                idxs = []
                for j in range(batch_size):
                    gpos = pos + j
                    epoch = gpos // n
                    if epoch != cached_epoch:
                        # one permutation per epoch, not per step
                        order = dataset.epoch_order(epoch, seed)
                        cached_epoch = epoch
                    idxs.append(int(order[gpos % n]))
                lo, hi = rows or (0, batch_size)
                samples = []
                for j in idxs[:hi]:
                    img, cap = dataset.sample(j)
                    samples.append(
                        make_caption_sample(
                            tokenizer, img, "", cap, transform,
                            iteration=step, max_text_len=max_text_len,
                        )
                    )
                samples = samples[lo:]
                q.put(_pad_tokens(collate_samples(samples), max_text_len))
                step += 1
                pos += batch_size
        except BaseException as exc:  # handed to the consumer, which raises
            q.put(exc)
        else:
            q.put(None)

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    t = threading.Thread(target=produce, args=(q,), daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            # a corrupt row or a transform failure fails the run, rather
            # than end it early as if the data were exhausted
            raise RuntimeError("finetune batch producer failed") from item
        yield item


def _caption_engine(model, tokenizer, crop_size, batch_size, num_beams, max_steps, dtype):
    from ..decode.beam import BeamSearchConfig
    from ..preprocess.transforms import TestTransform
    from ..runtime.engine import CaptionEngine

    return CaptionEngine(model, tokenizer, batch_size=batch_size,
                         beam=BeamSearchConfig(num_beams=num_beams, max_steps=max_steps),
                         dtype=dtype, transform=TestTransform(crop_size=crop_size))


def evaluate_model_on_tsv(
    model,
    tokenizer,
    image_tsv: str,
    caption_tsv: str,
    *,
    batch_size: Optional[int] = None,
    crop_size: Optional[int] = None,
    num_beams: Optional[int] = None,
    max_steps: Optional[int] = None,
    dtype=None,
    engine=None,
) -> dict:
    """Caption a val image TSV with the model's current weights and score
    against the gt caption TSV with the native metric set (BLEU-4,
    METEOR, ROUGE-L, CIDEr-D): the in-training counterpart of the
    reference's offline `evaluate_on_coco_caption` (inference.py:277-313).

    Pass `engine` (a `CaptionEngine` around the same model) to reuse it
    across validations; its decode settings then apply, and an explicit
    value that conflicts with them raises rather than being ignored."""
    from ..evalcap.evaluate import score_captions

    if engine is None:
        engine = _caption_engine(
            model, tokenizer, crop_size if crop_size is not None else 224,
            batch_size if batch_size is not None else 8,
            num_beams if num_beams is not None else 4,
            max_steps if max_steps is not None else 40, dtype or torch.bfloat16)
    else:
        for name, passed, actual in (
            ("batch_size", batch_size, engine.batch_size),
            ("crop_size", crop_size, getattr(engine.transform, "crop_size", None)),
            ("num_beams", num_beams, engine.beam.num_beams),
            ("max_steps", max_steps, engine.beam.max_steps),
            ("dtype", dtype, engine.dtype),
        ):
            # actual None = unknowable (e.g. a custom transform without
            # .crop_size): skip rather than raise a spurious conflict
            if passed is not None and actual is not None and passed != actual:
                raise ValueError(
                    "evaluate_model_on_tsv: {}={} conflicts with the "
                    "passed engine's {} (engine settings are fixed at "
                    "creation)".format(name, passed, actual)
                )
    batch_size = engine.batch_size
    images = TSVFile(image_tsv)
    gts = TSVFile(caption_tsv)
    assert len(images) == len(gts), (len(images), len(gts))
    candidates, references = {}, {}
    for start in range(0, len(images), batch_size):
        idxs = list(range(start, min(start + batch_size, len(images))))
        arrs, keep = [], []
        for i in idxs:
            arr = engine._decode_row(images[i][1])
            if arr is not None:
                arrs.append(arr)
                keep.append(i)
        if not arrs:
            continue
        caps = engine.generate_batch(arrs, [[tokenizer.cls_token_id]] * len(arrs))
        for i, cap in zip(keep, caps):
            key = images.get_key(i)
            candidates[key] = cap
            references[key] = [c["caption"] for c in json.loads(gts[i][1])]
    return score_captions(candidates, references)


def _resume(state, save_dir, resume):
    """Restore the latest step under save_dir into state (weights, AdamW's
    moments and count, the step); returns the step to start from.  The
    schedule stays this run's, built from its arguments, as gitax's
    resume rebuilds its optax schedule: a run resumed with a larger
    num_steps decays over the new length."""
    from ..ckpt.serialization import latest_step, restore_train_state

    if save_dir and resume:
        last = latest_step(save_dir)
        if last is not None:
            schedule = state.schedule.state_dict()
            restore_train_state(save_dir, state, step=last)
            state.schedule.load_state_dict(schedule)
            logging.info("resumed from %s at step %d", save_dir, state.step)
    return state.step


def _model_device(model):
    return model.textual.output.bias.device


def _one_card_copy(model, held):
    """On global rank 0, `held` (a one-card GitModel on the device of
    `model`, made when None) loaded with the gathered weights of `model`,
    which is on a mesh; None on the other ranks.  Every rank calls it (a
    collective over each model group)."""
    from ..models.git import GitModel
    from ..parallel.mesh import gather_params

    full = gather_params(model)
    if model.mesh.rank != 0:
        return None
    if held is None:
        held = GitModel(model.cfg, device=_model_device(model))
    held.load_state_dict(full, strict=True)
    return held


def run_finetune(
    image_tsv: str,
    caption_tsv: str,
    model,
    *,
    num_steps: int = 1000,
    batch_size: int = 8,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.2,
    warmup_steps: int = 500,
    max_text_len: int = 40,
    train_crop_size: int = 224,
    multi_scale: bool = True,
    dtype=None,
    remat: bool = False,
    save_dir: Optional[str] = None,
    save_every: int = 500,
    resume: bool = True,
    mesh=None,
    zero1: bool = True,
    tokenizer=None,
    log_every: int = 10,
    seed: int = 0,
    val_image_tsv: Optional[str] = None,
    val_caption_tsv: Optional[str] = None,
    validate_every: int = 0,
    val_kwargs: Optional[dict] = None,
):
    """Fine-tune `model` (its weights, on its device) on a TSV caption
    dataset; returns the final TrainState.

    save_dir enables checkpoints every `save_every` steps and at the end
    and, with resume=True, picks up from the latest step found there.
    dtype: the activation dtype (default bf16); the weights and AdamW
    stay f32.

    mesh (a `parallel.mesh.Mesh`; every rank calls run_finetune with its
    own): rank 0's weights are broadcast, then sharded
    (`shard_params`); each data rank trains on its rows of the one-card
    batches; zero1 splits the AdamW moments over the data ranks.  The
    checkpoints are one-card checkpoints (`ckpt.serialization`), so a
    run resumes from any mesh's.  Rank 0 logs and validates (on a
    one-card copy of the weights under tensor parallelism) while the
    others wait.  The returned state holds this rank's shards."""
    from ..ckpt.serialization import save_train_state
    from ..parallel import comm
    from ..parallel.mesh import broadcast_params, shard_params
    from .trainer import default_optimizer, init_train_state, make_train_step, to_device

    if tokenizer is None:
        from ..inference import _load_tokenizer

        tokenizer = _load_tokenizer()
    dtype = dtype or torch.bfloat16
    device = _model_device(model)

    dataset = TSVCaptionDataset(image_tsv, caption_tsv)
    transform = TrainTransform(
        train_crop_size=train_crop_size,
        min_size_range32=(160, train_crop_size) if multi_scale else None,
        patch_size=model.cfg.encoder.patch_size,
        seed=seed,
    )
    lead = mesh is None or mesh.rank == 0  # logs and validates
    rows = None
    if mesh is not None:
        rows = mesh.batch_rows(batch_size)
        broadcast_params(model)
        shard_params(model, mesh)
    state = init_train_state(model, *default_optimizer(
        model, learning_rate=learning_rate, weight_decay=weight_decay,
        warmup_steps=warmup_steps, total_steps=num_steps, zero1=zero1))
    start_step = _resume(state, save_dir, resume)
    step_fn = make_train_step(model, dtype=dtype, remat=remat)

    val = {"engine": None, "copy": None}

    def validate(step_now):
        val_model = model
        if model.textual.tp_group is not None:  # a collective over the model group
            val_model = val["copy"] = _one_card_copy(model, val["copy"])
        metrics = None
        if lead:
            vk = dict(val_kwargs or {})
            if val["engine"] is None:
                val["engine"] = _caption_engine(
                    val_model, tokenizer, vk.get("crop_size", 224), vk.get("batch_size", 8),
                    vk.get("num_beams", 4), vk.get("max_steps", 40), dtype)
            metrics = evaluate_model_on_tsv(
                val_model, tokenizer, val_image_tsv, val_caption_tsv,
                dtype=dtype, engine=val["engine"], **vk,
            )
            logging.info(
                "validation @ step %d: %s", step_now,
                " ".join("{}={:.4f}".format(k, v) for k, v in metrics.items()),
            )
        if mesh is not None:
            comm.barrier(device)
        return metrics

    t0 = time.time()
    window = 0
    try:
        for batch in batch_iterator(
            dataset, tokenizer, transform, batch_size, num_steps,
            start_step=start_step, max_text_len=max_text_len, seed=seed, rows=rows,
        ):
            batch = to_device(batch, device)
            batch["image"] = batch["image"].to(dtype)
            state, metrics = step_fn(state, batch)
            window += 1
            step_now = start_step + window
            if lead and step_now % log_every == 0:
                loss = float(metrics["loss"])  # waits for the step
                dt = time.time() - t0
                logging.info(
                    "step %d/%d loss %.4f  %.1f img/s",
                    step_now, num_steps, loss, log_every * batch_size / dt,
                )
                t0 = time.time()
            if save_dir and save_every and step_now % save_every == 0:
                save_train_state(save_dir, state, step=step_now)
            if val_image_tsv and validate_every and step_now % validate_every == 0:
                validate(step_now)
        if save_dir:
            save_train_state(save_dir, state, step=num_steps)
        if val_image_tsv:
            validate(num_steps)
    finally:
        if val["engine"] is not None:
            val["engine"].close()
    return state


def run_scst(
    image_tsv: str,
    caption_tsv: str,
    model,
    *,
    num_steps: int = 1000,
    batch_size: int = 8,
    num_samples: int = 5,
    learning_rate: float = 2e-6,
    max_decode_steps: int = 40,
    temperature: float = 1.0,
    crop_size: int = 224,
    dtype=None,
    save_dir: Optional[str] = None,
    save_every: int = 500,
    resume: bool = True,
    tokenizer=None,
    log_every: int = 10,
    seed: int = 0,
):
    """Self-critical sequence training over a TSV dataset: per step, a
    batch of images is greedy-decoded (the baseline) and sampled N
    times, the native CIDEr-D rewards form REINFORCE advantages, and one
    AdamW step (optax.adamw(learning_rate)'s settings) updates the model
    (training/scst.py).  The reference only sketches this and raises
    NotImplementedError (decoder.py:804-813).

    Each image's full gt caption list is its reward references (the
    standard SCST protocol).  The image draws and the sampling generator
    are seeded per step, so a resumed run continues the sequence.
    Returns the final TrainState."""
    from ..ckpt.serialization import save_train_state
    from .scst import ScstTrainer
    from .trainer import ConstantSchedule, adamw, init_train_state

    if tokenizer is None:
        from ..inference import _load_tokenizer

        tokenizer = _load_tokenizer()
    dtype = dtype or torch.float32
    device = _model_device(model)

    images = TSVFile(image_tsv)
    gts = TSVFile(caption_tsv)
    assert len(images) == len(gts), (len(images), len(gts))
    gt_lists = [
        [c["caption"] for c in json.loads(gts[i][1])] for i in range(len(gts))
    ]

    transform = TrainTransform(
        train_crop_size=crop_size, min_size_range32=None, seed=seed
    )

    state = init_train_state(model, *adamw(model, ConstantSchedule(learning_rate)))
    start_step = _resume(state, save_dir, resume)

    trainer = ScstTrainer(
        model,
        tokenizer,
        num_samples=num_samples,
        max_steps=max_decode_steps,
        temperature=temperature,
        dtype=dtype,
        sos_id=tokenizer.cls_token_id,
        eos_id=tokenizer.sep_token_id,
    )

    # private copy: re-seeded per step below; must not clobber the
    # caller's transform object
    transform = copy.copy(transform)
    t0 = time.time()
    for step_now in range(start_step + 1, num_steps + 1):
        # per-step streams (host sampling, crop draws and the device
        # generator) so a resumed run continues the sequence instead of
        # replaying a fresh run's early draws
        rng = np.random.RandomState(seed + step_now)
        transform.rng = random.Random((seed << 40) + step_now)
        idxs = rng.choice(len(images), size=batch_size, replace=False) \
            if len(images) >= batch_size else rng.randint(0, len(images), batch_size)
        batch_imgs, batch_gts = [], []
        for i in idxs:
            img = image_from_base64(images[int(i)][1])
            if img is None:
                continue
            batch_imgs.append(transform({"image": img})["image"])
            batch_gts.append(gt_lists[int(i)])
        if not batch_imgs:
            continue
        gen = torch.Generator(device=device).manual_seed((seed << 40) + step_now)
        x = torch.from_numpy(np.stack(batch_imgs)).to(device=device, dtype=dtype)
        state, metrics = trainer.step(state, x, batch_gts, gen)
        if step_now % log_every == 0:
            dt = time.time() - t0
            logging.info(
                "scst step %d/%d loss %.4f reward(sample/greedy) %.3f/%.3f  %.1f img/s",
                step_now, num_steps, metrics["loss"],
                metrics["reward_sample"], metrics["reward_greedy"],
                log_every * batch_size / dt,
            )
            t0 = time.time()
        if save_dir and save_every and step_now % save_every == 0:
            save_train_state(save_dir, state, step=step_now)
    if save_dir:
        save_train_state(save_dir, state, step=num_steps)
    return state
