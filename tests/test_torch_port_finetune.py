"""The port's fine-tuning side against gitax's (CPU, f32, small configs on
the same weights):

* `preprocess/train_transforms.py`: the same crop parameters and pixels
  for the same seed, the same samples and collated batches;
* `batch_iterator`: gitax's batches across an epoch boundary and across a
  resume; a producer failure raises;
* `ckpt.serialization`: a train state round-trips, latest_step skips an
  unfinished write;
* `run_finetune`: a run saved at step 2 and resumed ends with the
  continuous run's weights and moments, exactly; a mesh whose data
  ranks do not split the batch raises (meshes: test_torch_port_parallel);
* SCST: `sequence_logprob_loss` and its gradients against gitax's; one
  `ScstTrainer.step` with gitax's Gumbel draws replayed through
  `decode.beam.gumbel_noise` gives gitax's sequences, rewards,
  advantages and loss; `run_scst` resumes;
* `evaluate_model_on_tsv` and the `train` CLI's functions on the CPU."""

import base64
import io
import json
import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.preprocess import train_transforms as gx_tt
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax.training import finetune as gx_ft
from gitax.training import scst as gx_scst
from gitax_torch import ckpt, train
from gitax_torch.ckpt import serialization
from gitax_torch.decode import beam as pt_beam
from gitax_torch.io.tsv import tsv_writer
from gitax_torch.preprocess import train_transforms as tt
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
from gitax_torch.training import finetune as ft
from gitax_torch.training import scst
from gitax_torch.training.trainer import ConstantSchedule, adamw, init_train_state
from test_torch_port_sampling import replayed_gitax_noise

WORDS = ["a", "dog", "cat", "sits", "on", "the", "mat", "red"]
CFG = GitConfig(
    encoder=ViTConfig(16, 32, 1, 2, 32),
    visual_feature_size=32,
    vocab_size=30522,
    hidden_size=32,
    num_layers=1,
    num_heads=2,
    feedforward_size=64,
    max_caption_length=64,
)


def tokenizers():
    return BertTokenizer(build_tiny_vocab(words=WORDS)), GxTokenizer(gx_tiny_vocab(words=WORDS))


def pil_images(n, seed=0, size=(48, 40)):
    from PIL import Image

    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (size[1], size[0], 3), np.uint8))
            for _ in range(n)]


def fixture_tsvs(tmp_path, n_images=3):
    """An image + caption TSV pair in the prepare_coco_test format (PNG
    payloads, two captions an image)."""
    rows = []
    for i, img in enumerate(pil_images(n_images)):
        buf = io.BytesIO()
        img.save(buf, "PNG")
        rows.append(("k{}".format(i), base64.b64encode(buf.getvalue()).decode()))
    img_tsv, cap_tsv = str(tmp_path / "train.img.tsv"), str(tmp_path / "train.caption.tsv")
    tsv_writer(rows, img_tsv)
    tsv_writer([("k{}".format(i), json.dumps([{"caption": "a dog"},
                                               {"caption": "a red cat sits on the mat"}]))
                for i in range(n_images)], cap_tsv)
    return img_tsv, cap_tsv


def gitax_params(cfg=CFG, seed=0):
    return jax.tree_util.tree_map(np.asarray, GitModel(cfg).init_params(jax.random.PRNGKey(seed)))


def port_model(cfg=CFG, seed=0):
    return ckpt.params_from_gitax(gitax_params(cfg, seed), cfg, device="cpu")


# ---------------------------------------------------------------------------
# the train transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(48, 40), (640, 480), (33, 200)])
@pytest.mark.parametrize("ratio", [(1.0, 1.0), (3.0 / 4.0, 4.0 / 3.0)])
def test_random_resized_crop_params_match_gitax(size, ratio):
    for seed in range(20):
        got = tt.random_resized_crop_params(*size, ratio=ratio, rng=random.Random(seed))
        want = gx_tt.random_resized_crop_params(*size, ratio=ratio, rng=random.Random(seed))
        assert got == want


@pytest.mark.parametrize("kw", [dict(), dict(patch_size=14, min_size_range32=(160, 224)),
                                dict(min_size_range32=None, train_crop_size=32),
                                dict(interpolation=None, no_aspect_dist=False)])
def test_train_transform_matches_gitax_pixels(kw):
    ours, theirs = tt.TrainTransform(seed=5, **kw), gx_tt.TrainTransform(seed=5, **kw)
    assert ours.crop_sizes == theirs.crop_sizes
    for it, img in enumerate(pil_images(4, size=(300, 260))):
        got = ours({"image": img, "iteration": it})["image"]
        want = theirs({"image": img, "iteration": it})["image"]
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_caption_samples_and_collate_match_gitax():
    tok, gtok = tokenizers()
    img = pil_images(1)[0]
    samples, gsamples = [], []
    for i, (prefix, cap) in enumerate([("", "a dog"), ("the mat", "a red cat sits on the mat"),
                                       ("", " ".join(["dog"] * 12))]):
        kw = dict(iteration=i, max_text_len=8)
        samples.append(tt.make_caption_sample(tok, img, prefix, cap, tt.TrainTransform(
            train_crop_size=32, min_size_range32=None, seed=i), **kw))
        gsamples.append(gx_tt.make_caption_sample(gtok, img, prefix, cap, gx_tt.TrainTransform(
            train_crop_size=32, min_size_range32=None, seed=i), **kw))
    got, want = tt.collate_samples(samples), gx_tt.collate_samples(gsamples)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    padded, gpadded = ft._pad_tokens(got, 8), gx_ft._pad_tokens(want, 8)
    for k in padded:
        np.testing.assert_array_equal(padded[k], gpadded[k])


# ---------------------------------------------------------------------------
# the batch producer
# ---------------------------------------------------------------------------


def both_batches(img_tsv, cap_tsv, **kw):
    tok, gtok = tokenizers()
    tkw = dict(train_crop_size=32, min_size_range32=(16, 32), patch_size=16, seed=7)
    got = list(ft.batch_iterator(ft.TSVCaptionDataset(img_tsv, cap_tsv), tok,
                                 tt.TrainTransform(**tkw), **kw))
    want = list(gx_ft.batch_iterator(gx_ft.TSVCaptionDataset(img_tsv, cap_tsv), gtok,
                                     gx_tt.TrainTransform(**tkw), **kw))
    return got, want


@pytest.mark.parametrize("start_step", [0, 2])
def test_batch_iterator_matches_gitax_across_epochs_and_resume(tmp_path, start_step):
    """4 per batch over 6 samples: batch 2 spans the epoch boundary;
    start_step=2 is a resume in the second epoch."""
    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    got, want = both_batches(img_tsv, cap_tsv, batch_size=4, num_steps=5, seed=7,
                             start_step=start_step, max_text_len=10)
    assert len(got) == len(want) == 5 - start_step
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    if start_step:
        full, _ = both_batches(img_tsv, cap_tsv, batch_size=4, num_steps=5, seed=7,
                               max_text_len=10)
        for g, f in zip(got, full[start_step:]):
            np.testing.assert_array_equal(g["image"], f["image"])


def test_batch_iterator_raises_on_producer_failure(tmp_path):
    img_tsv, cap_tsv = str(tmp_path / "img.tsv"), str(tmp_path / "cap.tsv")
    tsv_writer([("k0", base64.b64encode(b"not an image").decode())], img_tsv)
    tsv_writer([("k0", json.dumps([{"caption": "a dog"}]))], cap_tsv)
    tok, _ = tokenizers()
    tr = tt.TrainTransform(train_crop_size=32, min_size_range32=None, seed=0)
    with pytest.raises(RuntimeError, match="producer failed"):
        list(ft.batch_iterator(ft.TSVCaptionDataset(img_tsv, cap_tsv), tok, tr, batch_size=1,
                               num_steps=1))


# ---------------------------------------------------------------------------
# checkpoints and the fine-tune loop
# ---------------------------------------------------------------------------


def test_train_state_round_trip_and_latest_step(tmp_path):
    model = port_model()
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-3)))
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.5)
    state.optimizer.step()
    state.step = 7
    serialization.save_train_state(str(tmp_path), state)
    # an unfinished write (a temporary directory) is never a step
    (tmp_path / ".step_00000009.tmp-1").mkdir()
    assert serialization.latest_step(str(tmp_path)) == 7
    other = port_model(seed=1)
    restored = serialization.restore_train_state(
        str(tmp_path), init_train_state(other, *adamw(other, ConstantSchedule(0.0))))
    assert restored.step == 7 and restored.schedule(0) == 1e-3
    for (n, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    for k in sa["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][name], sb["state"][k][name])
    serialization.save_params(str(tmp_path / "p"), model, step=3)
    fresh = port_model(seed=2)
    serialization.restore_params(str(tmp_path / "p"), fresh, step=3)
    assert torch.equal(fresh.textual.embedding.words.weight, model.textual.embedding.words.weight)
    with pytest.raises(FileNotFoundError):
        serialization.restore_train_state(str(tmp_path / "none"), state)


def finetune(img_tsv, cap_tsv, save_dir, num_steps, save_every, model=None):
    tok, _ = tokenizers()
    return ft.run_finetune(img_tsv, cap_tsv, model or port_model(), num_steps=num_steps,
                           batch_size=2, multi_scale=False, train_crop_size=32,
                           dtype=torch.float32, save_dir=save_dir, save_every=save_every,
                           tokenizer=tok, warmup_steps=1, learning_rate=1e-3, log_every=1)


def test_run_finetune_resume_equals_continuous(tmp_path):
    """A 4-step run saving every 2; a second run resumes from its step 2
    (as after a crash there) and ends with the continuous run's weights
    and moments, exactly."""
    import shutil

    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    cont = finetune(img_tsv, cap_tsv, str(tmp_path / "a"), 4, 2)
    assert cont.step == 4 and serialization.latest_step(str(tmp_path / "a")) == 4
    shutil.copytree(str(tmp_path / "a" / "step_00000002"), str(tmp_path / "b" / "step_00000002"))
    resumed = finetune(img_tsv, cap_tsv, str(tmp_path / "b"), 4, 2, model=port_model(seed=3))
    assert resumed.step == 4 and serialization.latest_step(str(tmp_path / "b")) == 4
    moved = False
    for (n, a), b, c in zip(cont.model.state_dict().items(), resumed.model.state_dict().values(),
                            port_model().state_dict().values()):
        assert torch.equal(a, b), n
        moved = moved or not torch.equal(a, c)
    assert moved
    sa, sb = cont.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for k in sa:
        assert torch.equal(sa[k]["exp_avg_sq"], sb[k]["exp_avg_sq"])


def test_run_finetune_resume_takes_the_new_schedule(tmp_path):
    """Resumed with a larger num_steps, the run decays over the new length
    (gitax rebuilds its schedule from the resumed run's arguments)."""
    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    finetune(img_tsv, cap_tsv, str(tmp_path / "a"), 2, 2)
    longer = finetune(img_tsv, cap_tsv, str(tmp_path / "a"), 6, 2)
    assert longer.step == 6 and longer.schedule.decay_steps == 6


def test_run_finetune_refuses_a_mesh(tmp_path):
    """A mesh whose data ranks do not split the batch raises before any
    collective (training on meshes: tests/test_torch_port_parallel.py)."""
    from gitax_torch.parallel.mesh import Mesh

    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    mesh = Mesh(data=2, model=1, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="does not split over 2 data ranks"):
        ft.run_finetune(img_tsv, cap_tsv, port_model(), mesh=mesh, batch_size=3,
                        tokenizer=tokenizers()[0])


def test_evaluate_model_on_tsv_scores_and_refuses_conflicts(tmp_path):
    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    tok, _ = tokenizers()
    model = port_model()
    metrics = ft.evaluate_model_on_tsv(model, tok, img_tsv, cap_tsv, batch_size=2, crop_size=32,
                                       num_beams=2, max_steps=6, dtype=torch.float32)
    assert set(metrics) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"}
    engine = ft._caption_engine(model, tok, 32, 2, 2, 6, torch.float32)
    with engine:
        assert ft.evaluate_model_on_tsv(model, tok, img_tsv, cap_tsv, engine=engine) == metrics
        with pytest.raises(ValueError, match="num_beams"):
            ft.evaluate_model_on_tsv(model, tok, img_tsv, cap_tsv, num_beams=4, engine=engine)


# ---------------------------------------------------------------------------
# SCST
# ---------------------------------------------------------------------------


def images(n=2, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 32, 3).astype(np.float32)


def test_sequence_logprob_loss_and_gradients_match_gitax():
    seqs = np.array([[101, 5, 102, 9, 9], [101, 7, 8, 3, 102], [101, 102, 4, 4, 4]], np.int64)
    adv = np.array([0.5, -1.25, 2.0], np.float32)
    x = images(3)
    params = gitax_params()
    gm = GitModel(CFG)
    want, grads = jax.jit(jax.value_and_grad(
        lambda p: gx_scst.sequence_logprob_loss(gm, p, jnp.asarray(x), jnp.asarray(seqs, jnp.int32),
                                                jnp.asarray(adv))))(params)
    mapped = dict(ckpt.params_from_gitax(jax.tree_util.tree_map(np.asarray, grads), CFG,
                                         device="cpu").named_parameters())
    model = port_model().trainable_(True)
    loss = scst.sequence_logprob_loss(model, torch.from_numpy(x), torch.from_numpy(seqs),
                                      torch.from_numpy(adv))
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    top = max(w.abs().max().item() for w in mapped.values())
    for n, p in model.named_parameters():
        w = mapped[n].detach()
        if n.endswith(".attention.self.key.bias"):  # zero in exact arithmetic
            assert p.grad.abs().max() <= 1e-6 * top
            continue
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(), err_msg=n)


def test_scst_step_matches_gitax_with_replayed_draws(monkeypatch):
    import optax

    tok, gtok = tokenizers()
    params = gitax_params()
    # the visual projection x10 so that outputs depend on the image
    lin = params["textual"]["visual_projection"]["linear"]
    lin["kernel"] = lin["kernel"] * 10
    x = images(2)
    kw = dict(num_samples=3, max_steps=6, temperature=1.0, sos_id=101, eos_id=102)
    gx_tr = gx_scst.ScstTrainer(GitModel(CFG), gtok, optax.adamw(1e-3), **kw)
    greedy, _ = gx_tr._greedy(params, jnp.asarray(x))
    key = jax.random.PRNGKey(11)
    sampled, _ = gx_tr._sample(params, jnp.asarray(x), key)
    sampled = np.asarray(sampled)
    # each image's references hold its first sample's caption, so rewards
    # (and advantages) are not all 0
    gts = [[gx_tr._decode(sampled[3 * i]), "a red cat sits on the mat"] for i in range(2)]
    want_base = gx_tr._rewards([gx_tr._decode(s) for s in np.asarray(greedy)], gts)
    want_r = gx_tr._rewards([gx_tr._decode(s) for s in sampled],
                            [gts[i // 3] for i in range(6)])
    want_adv = want_r - np.repeat(want_base, 3)
    from gitax.training import init_train_state as gx_init

    gx_state = gx_init(GitModel(CFG), None, optax.adamw(1e-3), params=params)
    _, want_loss = gx_tr._grad_step(gx_state, jnp.repeat(jnp.asarray(x), 3, axis=0),
                                    jnp.asarray(sampled), jnp.asarray(want_adv))

    monkeypatch.setattr(pt_beam, "gumbel_noise", replayed_gitax_noise(key))
    model = ckpt.params_from_gitax(params, CFG, device="cpu")
    state = init_train_state(model, *adamw(model, ConstantSchedule(1e-3)))
    tr = scst.ScstTrainer(model, tok, **kw)
    seqs, adv, sample_r, baseline = tr.rollout(torch.from_numpy(x), gts, torch.Generator())
    np.testing.assert_array_equal(seqs, sampled)
    np.testing.assert_array_equal(sample_r, want_r)
    np.testing.assert_array_equal(baseline, want_base)
    np.testing.assert_array_equal(adv, want_adv)
    assert np.abs(adv).max() > 0, "all advantages 0: the test would not see the loss"
    loss = tr.update(state, torch.from_numpy(x), seqs, adv)
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert state.step == 1


def test_run_scst_resumes(tmp_path):
    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    tok, _ = tokenizers()
    kw = dict(batch_size=2, num_samples=2, max_decode_steps=6, crop_size=32, tokenizer=tok,
              log_every=1, save_dir=str(tmp_path / "scst"))
    state = ft.run_scst(img_tsv, cap_tsv, port_model(), num_steps=2, save_every=1, **kw)
    assert state.step == 2 and serialization.latest_step(str(tmp_path / "scst")) == 2
    state = ft.run_scst(img_tsv, cap_tsv, port_model(seed=1), num_steps=3, save_every=10, **kw)
    assert state.step == 3


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_cli(monkeypatch):
    """The CLI's zoo configs replaced by CFG; its tokenizer by the tiny one."""
    monkeypatch.setattr(train, "config_from_param", lambda param: CFG)
    monkeypatch.setattr(train, "_tokenizer", lambda: tokenizers()[0])


def test_forward_backward_example_and_speed_test_on_the_cpu(tiny_cli, tmp_path):
    paths = []
    for i, img in enumerate(pil_images(2, size=(64, 48))):
        paths.append(str(tmp_path / "{}.png".format(i)))
        img.save(paths[-1])
    loss = train.forward_backward_example(paths, ["a dog", "a red cat"], device="cpu")
    assert np.isfinite(loss)
    out = train.speed_test_forward_backward(duplicate=2, iterations=3, dtype="float32",
                                            device="cpu")
    assert out["batch"] == 4 and len(out["losses"]) == 5 and out["peak_memory_bytes"] is None
    assert np.isfinite(out["losses"]).all() and out["ms_per_step"] > 0
    # the synthesized images: seeded, so two runs give the same losses
    again = train.speed_test_forward_backward(duplicate=2, iterations=3, dtype="float32",
                                              device="cpu")
    assert again["losses"] == out["losses"]


def test_train_cli_runs_on_the_card_by_default(tiny_cli, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.speed_test_forward_backward(duplicate=1, iterations=1)


def test_finetune_cli_loads_checkpoints_and_refuses_data_parallel(tiny_cli, tmp_path,
                                                                   monkeypatch):
    img_tsv, cap_tsv = fixture_tsvs(tmp_path)
    # data_parallel above the card count (data_parallel on CPU ranks:
    # tests/test_torch_port_parallel.py)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="data_parallel=2 needs 2 cards"):
        train.finetune(img_tsv, cap_tsv, data_parallel=2)
    src = port_model(seed=4)
    torch.save({"model": src.state_dict()}, str(tmp_path / "model.pt"))
    for ckpt_path in (str(tmp_path / "model.pt"), None):
        model = train._random_model({}, "cpu")
        train._load_checkpoint_params(ckpt_path, model)
        same = torch.equal(model.textual.embedding.words.weight,
                           src.textual.embedding.words.weight)
        assert same == (ckpt_path is not None)
    state = train.finetune(img_tsv, cap_tsv, checkpoint=str(tmp_path / "model.pt"), num_steps=2,
                           batch_size=2, save_dir=str(tmp_path / "ft"), save_every=1,
                           dtype="float32", device="cpu", multi_scale=False, train_crop_size=32,
                           warmup_steps=1, log_every=1, tokenizer=tokenizers()[0])
    assert state.step == 2
    # a fine-tune's save_dir loads its latest step's weights
    model = train._random_model({}, "cpu")
    train._load_checkpoint_params(str(tmp_path / "ft"), model)
    assert torch.equal(model.textual.embedding.words.weight,
                       state.model.textual.embedding.words.weight)
    state = train.scst_finetune(img_tsv, cap_tsv, checkpoint=str(tmp_path / "ft"), num_steps=1,
                                batch_size=2, device="cpu", num_samples=2, max_decode_steps=5,
                                crop_size=32, tokenizer=tokenizers()[0])
    assert state.step == 1
