"""Inference on a (data, model) mesh: the port's `CaptionEngine(mesh=...)`
and the entry points' `mesh_shape` against gitax's engine (CPU, f32),
the cases of gitax's tests/test_spmd_engine.py.

The port runs one gloo CPU process per rank.  Two groups (2 and 4 ranks,
`runtime.distributed.spawn_ranks`, rank 0 in this process) run every
mesh case once, in a module fixture, as the ranks of a launch of data x
model processes; the ranks are `tests/torch_parallel_worker.py::
infer_main`, which imports no jax, and each test reads its case.  gitax
runs one device, and its SPMD engine on the first data x model of its 8
virtual CPU devices.  The weights are the same numpy-seeded trees
(`ckpt.params_from_gitax`).

TINY's encoder has 2 heads and its decoder 4, so the model axis is at
most 2 here: gitax's GSPMD also splits 2 heads over 4 ranks, and the
port's `check_divides` refuses that (a documented difference).

* TSV bytes: the caption and VQA loops with a center-crop transform on
  [2, 1], the MinMax (varshape) loops on [2, 1] and [1, 2], and the CLI's
  `test_git_inference_single_tsv(mesh_shape=...)` for both;
* tokens of `dispatch` on [2, 1], [1, 2] and [2, 2], int8 on [1, 2] and
  [2, 2], video frames with a question prefix on [1, 2] and [2, 2]; the
  ranks of each model group hold equal sequences;
* the single-image CLI with beam and with trie on [2, 2], and from one
  process that spawns its rank;
* the batcher's replies through `build_serving_stack(mesh_shape=2)` and
  /stats counting the mesh's padding;
* sampling on [1, 2] (the repetition penalty, two return sequences),
  by `generate` and through the engine: one process's tokens with rank
  0's seed, whatever the other rank's caller seeded;
* the refusals: a batch size that does not divide the data axis,
  sampling on a tensor-parallel model without a generator; a follower
  that raises makes rank 0 raise at once, well inside the group's
  timeout;
* the int8 split rule against gitax's exact-leaf partition specs.
"""

import base64
import functools
import io
import os
import time

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

import gitax.inference as gx_inf
from gitax.decode import BeamSearchConfig as GxBeam
from gitax.io.tsv import tsv_writer
from gitax.ckpt.torch_convert import export_git_state_dict
from gitax.models import GitConfig as GxConfig
from gitax.models import GitModel
from gitax.models import ViTConfig as GxViT
from gitax.ops.quant import quantize_git_params
from gitax.parallel import make_mesh as gx_make_mesh
from gitax.parallel import param_partition_specs
from gitax.preprocess import transforms as gx_tf
from gitax.runtime import CaptionEngine as GxEngine
from gitax.runtime.serving import DynamicBatcher as GxBatcher
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt
from gitax_torch import inference as pt_inf
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models.config import GitConfig, ViTConfig
from gitax_torch.models.git import eos_gate_params
from gitax_torch.models.git import GitModel as PtModel
from gitax_torch.ops.quant import quantize_git_model_
from gitax_torch.parallel import mesh as pmesh
from gitax_torch.runtime import distributed
from gitax_torch.runtime.engine import CaptionEngine
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
from test_torch_port_parallel import port_cfg
from test_torch_port_cli import TINY_KW
from test_torch_port_cli import WORDS as CLI_WORDS
from test_torch_port_cli import configs as cli_configs
from test_torch_port_cli import image_tsv, png_file
from test_torch_port_cli import state_dict as cli_state_dict
from test_torch_port_tsv import TINY, TRANSFORMS, WORDS, assert_same_tsv, tiny_params
from test_torch_port_tsv import write_image_tsv, write_question_tsv

BEAM = dict(num_beams=2, max_steps=12)
ENGINE_KW = dict(batch_size=4, max_text_len=12)
SHAPES = {"2x1": (2, 1), "1x2": (1, 2), "2x2": (2, 2)}
FOLLOWER_TIMEOUT_S = 60


def wide_configs():
    """(gitax config, port config) of test_torch_port_cli's TINY with a
    128-wide encoder: the CLI reads the encoder from the checkpoint, whose
    heads it counts as width // 64, and 2 heads split over 2 ranks."""
    kw = dict(TINY_KW, visual_feature_size=128)
    return (GxConfig(encoder=GxViT(16, 128, 2, 2, 32), **kw),
            GitConfig(encoder=ViTConfig(16, 128, 2, 2, 32), **kw))


@functools.lru_cache(maxsize=None)
def wide_state_dict():
    """test_torch_port_cli.state_dict's sharpened, EOS-gated weights for
    `wide_configs`, with 'module.' prefixes."""
    gx_cfg = wide_configs()[0]
    params = GitModel(gx_cfg).init_params(jax.random.PRNGKey(2))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    emb = tx["embedding"]
    emb["words"] = jnp.asarray(eos_gate_params(np.asarray(emb["words"]) * 3.0,
                                               np.asarray(emb["positions"]), gate=6))
    return {"module." + k: torch.from_numpy(np.array(v))
            for k, v in export_git_state_dict(params, gx_cfg).items()}


def port_weights(cfg, sd):
    """A reference state dict ('module.' prefixes) in the port's layout."""
    model = ckpt.load_git_state_dict(PtModel(cfg, device="cpu"),
                                     {k[len("module."):]: v for k, v in sd.items()})
    return {n: t.clone() for n, t in model.state_dict().items()}


def jpeg_b64(seed, size=(40, 40)):
    img = Image.fromarray(np.random.RandomState(seed).randint(0, 255, (size[1], size[0], 3),
                                                              dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def images():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 255, (32, 32, 3), np.uint8) for _ in range(6)]


def clips():
    """Float frames [F=2, 32, 32, 3], already normalised (gitax
    test_spmd_video_frames_tokens_equal's)."""
    return list(np.random.RandomState(23).rand(4, 2, 32, 32, 3).astype(np.float32))


def cli_dir(root):
    """The CLI's working directory: output/TINY_CAP/snapshot/model.pt
    (`wide_state_dict`) and aux_data/models/TINY_CAP/parameter.yaml (32
    px), an image TSV, a question TSV, a PNG and a class list."""
    snap = root / "output" / "TINY_CAP" / "snapshot"
    snap.mkdir(parents=True)
    torch.save({"model": wide_state_dict()}, str(snap / "model.pt"))
    aux = root / "aux_data" / "models" / "TINY_CAP"
    aux.mkdir(parents=True)
    (aux / "parameter.yaml").write_text("test_crop_size: 32\n")
    keys = image_tsv(str(root / "img.tsv"))
    tsv_writer([[k, '[{"question": "what is the color", "question_id": %d}, '
                    '{"question": "red", "question_id": %d}]' % (2 * i, 2 * i + 1)]
                for i, k in enumerate(keys)], str(root / "q.tsv"))
    png_file(root / "f0.png", 0)
    (root / "names.txt").write_text("dog\ncat\ntruck\nred truck\n")
    return str(root)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' scenarios (tests/torch_parallel_worker.py::infer_main),
    with 1 thread a rank."""
    d = str(tmp_path_factory.mktemp("mesh_infer"))
    img_tsv, q_tsv = os.path.join(d, "img.tsv"), os.path.join(d, "q.tsv")
    write_question_tsv(q_tsv, write_image_tsv(img_tsv))
    video_gx, video_pt = cli_configs(2)
    job = {
        "engine": {"cfg": port_cfg(TINY), "weights": {
            n: t.clone() for n, t in ckpt.params_from_gitax(tiny_params(), TINY,
                                                            device="cpu").state_dict().items()}},
        "video": {"cfg": video_pt, "weights": port_weights(video_pt, cli_state_dict(2))},
        # use_native=False: the PIL decode of gitax's engines below
        "engine_kw": dict(ENGINE_KW, beam=BeamSearchConfig(**BEAM), dtype=torch.float32,
                          use_native=False),
        "words": WORDS, "images": images(), "clips": clips(), "transforms": TRANSFORMS,
        "img_tsv": img_tsv, "q_tsv": q_tsv, "payloads": [jpeg_b64(i) for i in range(3)],
        "cli": {"dir": cli_dir(tmp_path_factory.mktemp("cli")), "words": CLI_WORDS,
                "cfg": wide_configs()[1]},
    }
    torch.save(job, os.path.join(d, "infer_job.pt"))
    out = {"job": job}
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")  # the spawned ranks'; rank 0 is this process
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
            mp.delenv(k, raising=False)
        for world in (2, 4):
            try:
                distributed.spawn_ranks("torch_parallel_worker:infer_main", world, (d,))
                out[world] = torch.load(os.path.join(d, "infer{}.pt".format(world)),
                                        weights_only=False)
            except Exception as e:  # each test of this group reports it
                out[world] = {"error": repr(e)}
            finally:
                torch.set_num_threads(threads)
    return out


def case(runs, world, name):
    group = runs[world]
    assert "error" not in group, group.get("error")
    result = group[name]
    assert not (isinstance(result, dict) and "error" in result), result["error"]
    return result


# ---------------------------------------------------------------------------
# gitax's side
# ---------------------------------------------------------------------------

_GX = {}


def gx_mesh(shape):
    d, m = shape
    return gx_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])


def gx_engine(kind="crop", shape=None, int8=False, params=None, cfg=TINY, words=WORDS):
    """gitax's engine (use_native=False: exact PIL) on the same f32
    weights, one device or on a `shape` mesh of its virtual CPU devices;
    kept per setting with its compiled programs."""
    key = (kind, shape, int8, cfg is TINY)
    if key not in _GX:
        params = tiny_params() if params is None else params
        _GX[key] = GxEngine(GitModel(cfg), jax.tree_util.tree_map(jnp.asarray, params),
                            GxTokenizer(gx_tiny_vocab(words)),
                            gx_tf.TestTransform(**TRANSFORMS[kind]), beam=GxBeam(**BEAM),
                            dtype=jnp.float32, use_native=False, int8=int8,
                            mesh=None if shape is None else gx_mesh(shape), **ENGINE_KW)
    return _GX[key]


def gx_tokens(engine, items, prefix=(101,)):
    seqs = engine._dispatch_batch(items, [list(prefix)] * len(items))
    return np.concatenate([np.asarray(s) for s in seqs])[:len(items)]


def video_params():
    """gitax's video TINY params from test_torch_port_cli's state dict."""
    from gitax.ckpt.torch_convert import convert_git_state_dict

    return convert_git_state_dict({k[len("module."):]: v for k, v in cli_state_dict(2).items()},
                                  cli_configs(2)[0])


# ---------------------------------------------------------------------------
# TSV bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kind,loop,world", [
    ("tsv_caption_crop", "crop", "caption", 2), ("tsv_vqa_crop", "crop", "vqa", 2),
    ("tsv_caption_minmax", "minmax", "caption", 2), ("tsv_vqa_minmax_tp", "minmax", "vqa", 2)])
def test_mesh_tsv_matches_gitax_bytes(runs, tmp_path, name, kind, loop, world):
    got = case(runs, world, name)
    job = runs["job"]
    want = str(tmp_path / "gx.tsv")
    engine = gx_engine(kind)
    if loop == "vqa":
        engine.run_vqa_tsv(job["img_tsv"], job["q_tsv"], want)
    else:
        engine.run_caption_tsv(job["img_tsv"], want)
    assert_same_tsv(want, got["path"])
    assert got["unequal"] == 0
    if name == "tsv_caption_crop":  # gitax's own SPMD engine writes the same bytes
        spmd = str(tmp_path / "gx_spmd.tsv")
        gx_engine(kind, shape=(2, 1)).run_caption_tsv(job["img_tsv"], spmd)
        assert_same_tsv(spmd, got["path"])


@pytest.fixture
def cli_cwd(runs, monkeypatch):
    """gitax's CLI in the port's CLI directory, on the same TINY config
    and vocabulary."""
    cli = runs["job"]["cli"]
    monkeypatch.chdir(cli["dir"])
    monkeypatch.setattr("gitax.models.git.config_from_param",
                        lambda param=None: wide_configs()[0])
    monkeypatch.setattr(gx_inf, "_load_tokenizer", lambda: GxTokenizer(gx_tiny_vocab(CLI_WORDS)))
    return cli["dir"]


@pytest.mark.parametrize("loop", ["caption", "vqa"])
def test_mesh_cli_tsv_matches_gitax_bytes(runs, cli_cwd, loop):
    """test_git_inference_single_tsv(mesh_shape=2 | [2, 1]): every row, in
    gitax's bytes, in out_tsv itself (no row shards)."""
    got = case(runs, 2, "cli_" + loop)
    gx_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", "q.tsv" if loop == "vqa" else None,
                                         "gx_{}.tsv".format(loop), batch_size=2,
                                         dtype="float32", use_native=False)
    assert_same_tsv(os.path.join(cli_cwd, "gx_{}.tsv".format(loop)), got)
    assert len(open(got).read().splitlines()) == (10 if loop == "vqa" else 5)


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_mesh_tokens_match_gitax(runs, shape):
    """`dispatch` on the mesh: gitax's tokens on one device and on its SPMD
    engine of the same shape; 6 images in batches of 4, the tail padded;
    every model group's ranks agree."""
    world = 4 if shape == "2x2" else 2
    got = case(runs, world, "tokens_" + shape)
    items = runs["job"]["images"]
    want = gx_tokens(gx_engine(), items)
    np.testing.assert_array_equal(got["tokens"], want)
    np.testing.assert_array_equal(gx_tokens(gx_engine(shape=SHAPES[shape]), items), want)
    assert got["rows"] == [4, 4] and got["unequal"] == 0
    assert len({tuple(r) for r in want}) > 1  # image-dependent tokens


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_int8_mesh_tokens_match_gitax(runs, shape):
    """int8: the full model quantized, then split (weight_q8_t as its
    layer's weight, weight_scale with a column-parallel layer's columns):
    gitax's int8 tokens, one device and on its mesh."""
    world = 4 if shape == "2x2" else 2
    got = case(runs, world, "int8_" + shape)
    items = runs["job"]["images"]
    want = gx_tokens(gx_engine(int8=True), items)
    np.testing.assert_array_equal(got["tokens"], want)
    np.testing.assert_array_equal(gx_tokens(gx_engine(shape=SHAPES[shape], int8=True), items),
                                  want)
    assert got["unequal"] == 0


@pytest.mark.parametrize("shape", ["1x2", "2x2"])
def test_video_mesh_tokens_match_gitax(runs, shape):
    """Video frames [B, F=2, H, W, 3] with a question prefix (video QA) on
    the mesh: gitax's tokens on one device."""
    world = 4 if shape == "2x2" else 2
    got = case(runs, world, "video_" + shape)
    engine = gx_engine(params=video_params(), cfg=cli_configs(2)[0], words=CLI_WORDS)
    want = gx_tokens(engine, runs["job"]["clips"], prefix=(101, 7, 9))
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["unequal"] == 0


# ---------------------------------------------------------------------------
# the single-image CLI and serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("search", ["beam", "trie"])
def test_mesh_single_image_cli_matches_gitax(runs, cli_cwd, search):
    """test_git_inference_single_image(mesh_shape=[2, 2]): the one row
    repeated into both data ranks' slots; gitax's caption (one device)."""
    got = case(runs, 4, "cli_{}_2x2".format(search))
    kw = dict(vocab_file="names.txt") if search == "trie" else {}
    want = gx_inf.test_git_inference_single_image("f0.png", "TINY_CAP", "", **kw)
    assert isinstance(got, str) and got == want
    if search == "trie":
        assert got in ("dog", "cat", "truck", "red truck")


def test_mesh_single_image_cli_spawns_its_ranks(runs, cli_cwd, monkeypatch):
    """From one process (no launcher): test_git_inference_single_image
    with mesh_shape=[1, 2] spawns rank 1 (`engine.follower_main`), which
    receives the config and the weights from rank 0; gitax's caption, and
    the group is gone after."""
    import torch.distributed as dist

    case(runs, 4, "cli_beam_2x2")  # the groups of the fixture have ended
    monkeypatch.setattr(pt_inf, "config_from_param", lambda param=None: wide_configs()[1])
    monkeypatch.setattr(pt_inf, "_load_tokenizer", lambda: BertTokenizer(build_tiny_vocab(CLI_WORDS)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = pt_inf.test_git_inference_single_image("f0.png", "TINY_CAP", "", mesh_shape=[1, 2],
                                                 device="cpu")
    assert got == gx_inf.test_git_inference_single_image("f0.png", "TINY_CAP", "")
    assert not dist.is_initialized()


def test_mesh_serving_replies_and_stats(runs, cli_cwd):
    """build_serving_stack(mesh_shape=2): each request alone is a device
    batch of 1 that the mesh pads to 2; the replies are gitax's batcher's
    on one device, and /stats records the padded batch (gitax
    serving.py:407-415)."""
    got = case(runs, 2, "serving")
    model, params = gx_inf._build_model("TINY_CAP", {"test_crop_size": 32}, dtype=jnp.float32)
    gx_engine_cli = GxEngine(model, params, GxTokenizer(gx_tiny_vocab(CLI_WORDS)),
                             gx_tf.TestTransform(crop_size=32), batch_size=2,
                             beam=GxBeam(num_beams=4, max_steps=8), max_text_len=8,
                             dtype=jnp.float32, use_native=False)
    batcher = GxBatcher(gx_engine_cli, max_wait_ms=10.0, buckets=(1, 2))
    try:
        want = [batcher.caption(p, timeout=120) for p in runs["job"]["payloads"]]
        question = batcher.caption(runs["job"]["payloads"][0], question="what is the color",
                                   timeout=120)
    finally:
        batcher.close()
    assert got["replies"] == want and got["question"] == question
    snap = got["stats"]
    n = len(want) + 1
    assert snap["requests"] == n and snap["batches"] == n and snap["errors"] == 0
    assert snap["batch_size_hist"] == {2: n} and snap["padded_slots"] == n


# ---------------------------------------------------------------------------
# refusals and failures
# ---------------------------------------------------------------------------


def test_batch_size_must_divide_the_data_axis(runs, tmp_path):
    """gitax's assert: on every rank of a [2, 1] group, and at the entry
    points before any rank starts."""
    assert "batch_size 3 must divide over the mesh data axis 2" in case(runs, 2,
                                                                       "refusals")["batch"]
    with pytest.raises(ValueError, match="must divide over the mesh data axis 2"):
        pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP", None, "o.tsv", batch_size=3,
                                             dtype="float32", mesh_shape=[2, 1], device="cpu")


def test_sampling_on_a_tensor_parallel_model_raises(runs):
    """Without a generator; with one it runs (the TP sampling tests)."""
    assert "do_sample needs a torch.Generator" in case(runs, 2, "refusals")["sample"]


# ---------------------------------------------------------------------------
# sampling on a tensor-parallel model
# ---------------------------------------------------------------------------


def one_process_model(job):
    spec = job["engine"]
    model = PtModel(spec["cfg"], device="cpu")
    model.load_state_dict(spec["weights"])
    return model


def test_tp_sampling_matches_one_process(runs):
    """generate(do_sample) with the repetition penalty and two return
    sequences on [1, 2]: rank 0's generator state reaches rank 1, whose
    caller seeded another stream, so both ranks draw rank 0's noise; the
    tokens equal one process's with rank 0's seed, the log-probabilities
    within 1e-4 (the all-reduce sums in another order)."""
    from torch_parallel_worker import SAMPLE_BEAM, SAMPLE_SEED, sample_images

    got = case(runs, 2, "sample_1x2")
    job = runs["job"]
    model = one_process_model(job)
    want = {}
    for seed in (SAMPLE_SEED, SAMPLE_SEED + 1):
        want[seed] = model.generate(sample_images(job), beam=BeamSearchConfig(**SAMPLE_BEAM),
                                    num_return_sequences=2,
                                    rng=torch.Generator().manual_seed(seed))
    seqs, logprobs = want[SAMPLE_SEED]
    assert got["tokens"].shape == tuple(seqs.shape) and seqs.shape[0] == 6
    np.testing.assert_array_equal(got["tokens"], seqs.numpy())
    np.testing.assert_allclose(got["logprobs"], logprobs.numpy(), rtol=1e-4, atol=1e-4)
    assert got["unequal"] == 0 and got["states_unequal"] == 0
    assert len({tuple(r) for r in seqs.tolist()}) > 1  # the draws vary between rows
    # the draws matter: another seed gives other tokens
    assert not torch.equal(want[SAMPLE_SEED + 1][0], seqs)


def test_tp_sampling_through_the_engine_matches_one_process(runs):
    """The same search by `dispatch_device_batch` on the [1, 2] engine
    (rank 0's generator sent with the search's arguments, two sequences a
    row gathered) and on a one-process engine."""
    from torch_parallel_worker import SAMPLE_BEAM, SAMPLE_SEED

    got = case(runs, 2, "sample_engine_1x2")
    job = runs["job"]
    with CaptionEngine(one_process_model(job), BertTokenizer(build_tiny_vocab(WORDS)),
                       **job["engine_kw"]) as engine:
        seqs = engine.dispatch_device_batch(
            np.stack(job["images"][:3]), [[101]] * 3, beam=BeamSearchConfig(**SAMPLE_BEAM),
            num_return_sequences=2, rng=torch.Generator().manual_seed(SAMPLE_SEED))
        want = engine.to_host(seqs)
    assert want.shape[0] == 6
    np.testing.assert_array_equal(got["tokens"], want)
    assert got["unequal"] == 0


def test_a_failing_follower_makes_rank_0_raise(runs):
    """A spawned rank whose search raises (tests/torch_parallel_worker.py::
    faulty_follower) ends its process; rank 0's batch raises at once, far
    inside the group timeout, and closing the engine ends every rank."""
    job = runs["job"]
    spec = job["engine"]
    t0 = time.perf_counter()
    group = distributed.open_inference_group([1, 2], "torch_parallel_worker:faulty_follower",
                                             device="cpu", timeout_s=FOLLOWER_TIMEOUT_S)
    model = PtModel(spec["cfg"], device="cpu")
    model.load_state_dict(spec["weights"])
    engine = CaptionEngine(model, BertTokenizer(build_tiny_vocab(WORDS)), mesh=group.mesh,
                           on_close=group.close, **job["engine_kw"])
    try:
        with pytest.raises(RuntimeError):
            engine.generate_batch(job["images"][:2], [[101]] * 2)
    finally:
        engine.close()
    assert time.perf_counter() - t0 < FOLLOWER_TIMEOUT_S
    assert group.ranks is None  # joined
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_spawned_ranks_import_no_jax(runs):
    """The ranks import no jax (the card's machine has none)."""
    for world in (2, 4):
        assert runs[world]["jax_imported"][1:] == [0.0] * (world - 1)


def test_int8_split_rule_matches_gitax_exact_leaf_specs():
    """Every int8 leaf of a quantized gitax tree is filled with its spec's
    kind and carried into the port's layout: each port int8 buffer holds
    the kind of gitax's leaf, which must be the port's rule's
    (`weight_q8_t` as its weight, `weight_scale` split only with a
    column-parallel layer)."""
    params = quantize_git_params(jax.tree_util.tree_map(np.asarray, tiny_params()))
    specs = param_partition_specs(params)

    def kind(leaf, spec):
        parts = tuple(spec) + (None,) * (np.ndim(leaf) - len(tuple(spec)))
        code = 0.0 if "model" not in parts else (1.0 if parts[-1] == "model" else 2.0)
        return np.full(np.shape(leaf), code, np.float32)

    coded = jax.tree_util.tree_map(kind, params, specs)["textual"]["blocks"]
    gx_leaves = {"attention.self.query": coded["attn"]["qkv"],
                 "attention.self.key": coded["attn"]["qkv"],
                 "attention.self.value": coded["attn"]["qkv"],
                 "attention.output.dense": coded["attn"]["out"],
                 "intermediate.dense": coded["mlp"]["intermediate"],
                 "output.dense": coded["mlp"]["output"]}
    model = quantize_git_model_(ckpt.params_from_gitax(tiny_params(), TINY, device="cpu"))
    want = {pmesh.COLUMN: 1.0, pmesh.ROW: 2.0, None: 0.0}
    seen = set()
    for name, _ in model.named_buffers():
        if not name.startswith("textual.transformer."):
            continue
        module, leaf = name.split(".", 5)[-1].rsplit(".", 1)  # e.g. output.dense, weight_scale
        gx_leaf = gx_leaves[module]["kernel_q8" if leaf == "weight_q8_t" else "kernel_scale"]
        codes = np.unique(gx_leaf)
        rule = pmesh.split_rule(name)
        assert len(codes) == 1 and want[rule] == codes[0], (name, rule, codes)
        seen.add((leaf, rule))
    assert pmesh.split_rule("textual.output.weight_q8_t") is None
    assert pmesh.split_rule("textual.output.weight_scale") is None
    assert seen == {("weight_q8_t", pmesh.COLUMN), ("weight_q8_t", pmesh.ROW),
                    ("weight_scale", pmesh.COLUMN), ("weight_scale", None)}


def test_int8_shards_reassemble_the_one_card_layer():
    """`shard_for_inference` on a quantized layer: each rank's weight_q8_t
    is out-major, and the shards of a column- and a row-parallel layer
    reassemble the full int8 values; a column layer's scales split, a
    row layer's stay whole."""
    full = quantize_git_model_(ckpt.params_from_gitax(tiny_params(), TINY, device="cpu"))
    layer = full.textual.layers()[0]
    col, row = layer.attention.qkv.query, layer.output.dense
    shards = []
    for rank in range(2):
        model = quantize_git_model_(ckpt.params_from_gitax(tiny_params(), TINY, device="cpu"))
        pmesh.shard_for_inference(model, pmesh.Mesh(data=1, model=2, rank=rank, device="cpu"))
        lyr = model.textual.layers()[0]
        shards.append((lyr.attention.qkv.query, lyr.output.dense))
        for lin in shards[-1]:
            q = lin.weight_q8_t
            assert q.dtype == torch.int8 and q.t().is_contiguous()
        assert torch.equal(model.textual.output.weight_q8_t, full.textual.output.weight_q8_t)
    assert torch.equal(torch.cat([c.weight_q8_t for c, _ in shards], 1), col.weight_q8_t)
    assert torch.equal(torch.cat([c.weight_scale for c, _ in shards]), col.weight_scale)
    assert torch.equal(torch.cat([r.weight_q8_t for _, r in shards], 0), row.weight_q8_t)
    assert all(torch.equal(r.weight_scale, row.weight_scale) for _, r in shards)
