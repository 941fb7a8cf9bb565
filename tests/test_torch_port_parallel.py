"""Training on a (data, model) mesh: the port's `parallel/` against
gitax's `parallel/mesh.py` (CPU, f32).

The port runs one gloo CPU process per rank (`runtime.distributed.
spawn_ranks`, a file:// rendezvous under the test's tmp dir; the ranks
are `tests/torch_parallel_worker.py`, which imports no jax); gitax runs
its SPMD step on the 8 virtual CPU devices of `tests/conftest.py`.  Two
groups of ranks (2 and 4) run every mesh case once, in a module fixture,
and each test reads its case:

* the split rule equals gitax's `param_partition_specs` for every
  parameter, with the ViT's fused qkv split per head (no process);
* DP [2, 1], TP [1, 2] and DP x TP [2, 2], 3 steps against gitax's
  `make_train_step` on `make_mesh` of the same shape: the loss within
  1e-6, step 1's gradients within 1e-4 (the one-card tests' bar), the weights after 3
  steps within 1e-4; the data ranks hold unequal counts of caption
  tokens, so the loss is gitax's global mean, which the mean of the
  ranks' means misses;
* ZeRO-1: each data rank holds the moments of about 1/d of the
  elements, the step equals the one without it, and the port on gitax's
  `test_zero1_optimizer_sharding_matches_unsharded` inputs matches
  gitax's replicated run within that test's tolerances;
* remat under TP equals no remat;
* `run_finetune` on a [2, 1] mesh against the one-card run: one
  checkpoint set, resumed from a one-card checkpoint onto the mesh and
  the reverse, moments and step count kept; `train.finetune(
  data_parallel=2, device='cpu')` ends equal to it; validation on a
  [1, 2] mesh on rank 0 alone;
* the refusals: a mesh product other than the world size, heads that do
  not split, sampling on a tensor-parallel model in `generate`,
  `data_parallel` above the card count.
"""

import os
import shutil

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding

from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.parallel import batch_partition_specs, param_partition_specs
from gitax.parallel import make_mesh as gx_make_mesh
from gitax.parallel import shard_params as gx_shard_params
from gitax.training import caption_loss as gx_caption_loss
from gitax.training import init_train_state as gx_init_train_state
from gitax.training import make_train_step as gx_make_train_step
from gitax_torch import ckpt, train
from gitax_torch.models import config as pt_config
from gitax_torch.parallel import mesh as pmesh
from gitax_torch.runtime import distributed
from gitax_torch.training import caption_loss, run_finetune
from test_torch_port_finetune import CFG as FT_CFG
from test_torch_port_finetune import fixture_tsvs, tokenizers
from test_training import TINY

# gitax's test_zero1_optimizer_sharding_matches_unsharded configuration
ZCFG = GitConfig(encoder=ViTConfig(16, 64, 2, 2, 32), visual_feature_size=64, vocab_size=128,
                 hidden_size=64, num_layers=2, num_heads=4, feedforward_size=128,
                 max_caption_length=32)
SHAPES = {"dp": (2, 1), "tp": (1, 2), "dpxtp": (2, 2)}
STEPS = 3
LR = 1e-3
# the decoder's key biases: zero gradient in exact arithmetic (softmax
# shift invariance), rounding noise on both sides
ZERO_GRAD = ".attention.self.key.bias"
FT_KW = dict(num_steps=4, batch_size=4, learning_rate=1e-4, warmup_steps=1, multi_scale=False,
             train_crop_size=32, save_every=2, log_every=1, seed=0, dtype=torch.float32)


def port_cfg(cfg):
    """The port's GitConfig of a gitax one (what a spawned rank unpickles)."""
    return pt_config.GitConfig(**dict(vars(cfg), encoder=pt_config.ViTConfig(
        **vars(cfg.encoder))))


def gitax_params(cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, GitModel(cfg).init_params(jax.random.PRNGKey(seed)))


def port_layout(tree, cfg):
    """A gitax tree (params or gradients) in the port's names and layout."""
    model = ckpt.params_from_gitax(jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu")
    return {n: p.detach() for n, p in model.state_dict().items()}


def unequal_batch():
    """A global batch of 4 whose data halves hold 13 and 3 predicted
    tokens."""
    rng = np.random.RandomState(7)
    tokens = np.array([[101, 5, 9, 17, 23, 11, 8, 102], [101, 7, 3, 12, 6, 19, 102, 0],
                       [101, 14, 102, 0, 0, 0, 0, 0], [101, 102, 0, 0, 0, 0, 0, 0]], np.int64)
    need = (tokens != 0).astype(np.int64)
    need[:, 0] = 0
    return {"image": rng.randn(4, 32, 32, 3).astype(np.float32), "caption_tokens": tokens,
            "need_predict": need}


def zero1_batch():
    rng = np.random.RandomState(0)
    return {"image": rng.randn(8, 32, 32, 3).astype(np.float32),
            "caption_tokens": np.tile([[101, 5, 9, 102]], (8, 1)).astype(np.int64),
            "need_predict": np.tile([[0, 1, 1, 1]], (8, 1)).astype(np.int64)}


def to_gitax(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype) for k, v in b.items()}


def to_port(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def gitax_mesh_run(cfg, params, batch, tx, shape, steps):
    """gitax's train step on a `shape` mesh of the virtual CPU devices:
    per-step (loss, grad_norm) and the final params."""
    model = GitModel(cfg)
    d, m = shape
    mesh = gx_make_mesh(data=d, model=m, devices=jax.devices()[:d * m])
    sharded = gx_shard_params(params, mesh)
    state = gx_init_train_state(model, None, tx, params=sharded)
    specs = batch_partition_specs(batch)
    sbatch = {k: jax.device_put(v, NamedSharding(mesh, specs[k])) for k, v in batch.items()}
    step = jax.jit(gx_make_train_step(model, tx))
    out = []
    with jax.sharding.set_mesh(mesh):
        for _ in range(steps):
            state, metrics = step(state, sbatch)
            out.append((float(metrics["loss"]), float(metrics["grad_norm"])))
    return out, jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))


def warmup_tx_schedule():
    return optax.warmup_cosine_decay_schedule(0.0, LR, 2, 10)


def warmup_tx():
    return optax.adamw(warmup_tx_schedule(), weight_decay=0.2)


@pytest.fixture(scope="module")
def gitax_ref():
    """gitax's runs: the three meshes on the unequal batch, the gradient of
    its loss, and the replicated run of gitax's ZeRO-1 test."""
    params, batch = gitax_params(TINY), to_gitax(unequal_batch())
    out = {}
    for name, shape in SHAPES.items():
        metrics, final = gitax_mesh_run(TINY, params, batch, warmup_tx(), shape, STEPS)
        out[name] = {"metrics": metrics, "weights": port_layout(final, TINY)}
    model = GitModel(TINY)

    def loss_fn(p, b):
        logits = model.forward_logits(p, b["image"], b["caption_tokens"])
        return gx_caption_loss(logits, b["caption_tokens"], b["need_predict"])

    _, grads = jax.jit(jax.value_and_grad(loss_fn))(params, batch)
    out["grads"] = port_layout(grads, TINY)
    # gitax's test_zero1_optimizer_sharding_matches_unsharded: the
    # replicated reference run, 2 steps of optax.adamw(1e-3)
    zmodel, tx = GitModel(ZCFG), optax.adamw(LR)
    state = gx_init_train_state(zmodel, None, tx, params=gitax_params(ZCFG))
    step = jax.jit(gx_make_train_step(zmodel, tx))
    zb = to_gitax(zero1_batch())
    for _ in range(2):
        state, metrics = step(state, zb)
    out["zero1"] = {"loss": float(metrics["loss"]),
                    "weights": port_layout(jax.device_get(state.params), ZCFG)}
    return out


def state_of(state):
    return {"weights": {n: t.clone() for n, t in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(), "step": state.step}


def one_card_finetune(img_tsv, cap_tsv, save_dir, weights, tok):
    model = ckpt_model(weights)
    return state_of(run_finetune(img_tsv, cap_tsv, model, save_dir=save_dir, tokenizer=tok,
                                 **FT_KW))


def ckpt_model(weights):
    from gitax_torch.models.git import GitModel as PtModel

    model = PtModel(port_cfg(FT_CFG), device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port run: the one-card fine-tune, the groups of 2 and 4 gloo
    ranks (tests/torch_parallel_worker.py), the one-card resume from the
    mesh's checkpoint and `train.finetune(data_parallel=2)`."""
    d = str(tmp_path_factory.mktemp("mesh"))
    img_tsv, cap_tsv = fixture_tsvs(tmp_path_factory.mktemp("tsv"))
    tok = tokenizers()[0]
    ft_weights = port_layout(gitax_params(FT_CFG), FT_CFG)
    other = port_layout(gitax_params(FT_CFG, seed=1), FT_CFG)
    job = {
        "tiny": {"cfg": port_cfg(TINY), "weights": port_layout(gitax_params(TINY), TINY),
                 "batch": to_port(unequal_batch()), "lr": LR, "schedule": "warmup",
                 "steps": STEPS},
        "zero1": {"cfg": port_cfg(ZCFG), "weights": port_layout(gitax_params(ZCFG), ZCFG),
                  "batch": to_port(zero1_batch()), "lr": LR, "schedule": "constant",
                  "steps": 2},
        "finetune": {"cfg": port_cfg(FT_CFG), "weights": ft_weights, "other": other,
                     "kwargs": dict(FT_KW, tokenizer=tok)},
        "img_tsv": img_tsv, "cap_tsv": cap_tsv,
    }
    torch.save(job, os.path.join(d, "job.pt"))
    out = {"one": one_card_finetune(img_tsv, cap_tsv, os.path.join(d, "one_continuous"),
                                    ft_weights, tok)}
    for world in (2, 4):
        try:
            distributed.spawn_ranks("torch_parallel_worker:main", world, (d,))
            out[world] = torch.load(os.path.join(d, "results{}.pt".format(world)),
                                    weights_only=False)
        except Exception as e:  # each test of this group reports it
            out[world] = {"error": repr(e)}
    # the reverse resume: the mesh's step 2 onto one card
    os.makedirs(os.path.join(d, "one_resumed"))
    shutil.copytree(os.path.join(d, "mesh_continuous", "step_00000002"),
                    os.path.join(d, "one_resumed", "step_00000002"))
    out["one_resumed"] = one_card_finetune(img_tsv, cap_tsv, os.path.join(d, "one_resumed"),
                                           other, tok)
    # the CLI's function on two CPU ranks, from a model.pt of the same weights
    torch.save({"model": ft_weights}, os.path.join(d, "start.pt"))
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "config_from_param", lambda param: port_cfg(FT_CFG))
        mp.setenv("OMP_NUM_THREADS", "1")  # the spawned rank's; rank 0 is this process
        torch.set_num_threads(1)
        try:
            state = train.finetune(img_tsv, cap_tsv, checkpoint=os.path.join(d, "start.pt"),
                                   data_parallel=2, device="cpu", tokenizer=tok,
                                   save_dir=os.path.join(d, "cli"), **dict(FT_KW, dtype="float32"))
        finally:
            torch.set_num_threads(threads)
    out["cli"] = {"weights": {n: t.clone() for n, t in state.model.state_dict().items()},
                  "checkpoint": torch.load(os.path.join(d, "cli", "step_00000004", "state.pt"),
                                           weights_only=True)}
    out["mesh_checkpoint"] = torch.load(os.path.join(d, "mesh_continuous", "step_00000004",
                                                     "state.pt"), weights_only=True)
    return out


def case(runs, world, name):
    group = runs[world]
    assert "error" not in group, group.get("error")
    result = group[name]
    assert "error" not in result, result["error"]
    return result


def assert_weights_close(got, want, rtol, atol, scaled=False, noise=None):
    """Every tensor within rtol and atol (scaled: atol times the tensor's
    largest magnitude).  noise: a bound on both sides' decoder key biases
    instead, which start at 0 and move only by the rounding noise of their
    zero gradient."""
    assert set(got) == set(want)
    for n in want:
        w = want[n]
        if noise is not None and n.endswith(ZERO_GRAD):
            assert got[n].abs().max() <= noise and w.abs().max() <= noise, n
            continue
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=rtol,
                                   atol=atol * (w.abs().max().item() if scaled else 1.0),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# the split rule (no process)
# ---------------------------------------------------------------------------

KIND_CODE = {None: 0.0, pmesh.COLUMN: 1.0, pmesh.ROW: 2.0, pmesh.QKV: 1.0}


def test_split_rule_equals_gitax_partition_specs():
    """Every gitax leaf is filled with its spec's kind (0 replicated, 1
    last axis over 'model', 2 the middle one) and carried into the port's
    layout by `params_from_gitax`: each port parameter then holds the kind
    of gitax's leaf it came from, which must be the port's rule's."""
    params = gitax_params(TINY)
    specs = param_partition_specs(params)

    def kind(leaf, spec):
        parts = tuple(spec) + (None,) * (np.ndim(leaf) - len(tuple(spec)))
        code = 0.0 if "model" not in parts else (1.0 if parts[-1] == "model" else 2.0)
        return np.full(np.shape(leaf), code, np.float32)

    coded = jax.tree_util.tree_map(kind, params, specs)
    seen = set()
    for name, t in port_layout(coded, TINY).items():
        want = KIND_CODE[pmesh.split_rule(name)]
        assert torch.all(t == want), (name, pmesh.split_rule(name), t.flatten()[:3])
        seen.add(pmesh.split_rule(name))
    assert seen == set(KIND_CODE)


@pytest.mark.parametrize("model", [2, 4])
def test_fused_qkv_splits_per_head(model):
    """Rank r's rows of the ViT's in_proj [3D, D] are its heads' rows of
    q, of k and of v; the shards reassemble the full tensor; the decoder's
    query splits by heads alone."""
    w = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    rows = 8 // model
    shards = [pmesh.shard_tensor(pmesh.QKV, w, model, r) for r in range(model)]
    for r, s in enumerate(shards):
        want = torch.cat([w[j * 8 + r * rows:j * 8 + (r + 1) * rows] for j in range(3)])
        assert torch.equal(s, want)
    col = [pmesh.shard_tensor(pmesh.COLUMN, w, model, r) for r in range(model)]
    assert torch.equal(torch.cat(col), w)
    row = [pmesh.shard_tensor(pmesh.ROW, w.t().contiguous(), model, r) for r in range(model)]
    assert torch.equal(torch.cat(row, 1), w.t())
    assert pmesh.split_rule("image_encoder.transformer.resblocks.0.attn.in_proj_bias") == pmesh.QKV
    assert pmesh.split_rule("textual.transformer.encoder.layer.1.attention.self.query.weight") \
        == pmesh.COLUMN
    assert pmesh.split_rule("textual.output.weight") is None


def test_batch_rows_and_refusals_without_a_group():
    mesh = pmesh.Mesh(data=2, model=1, rank=1, device=torch.device("cpu"))
    assert mesh.batch_rows(8) == (4, 8)
    with pytest.raises(ValueError, match="split"):
        mesh.batch_rows(3)
    three = GitConfig(**dict(vars(TINY), num_heads=3, hidden_size=48))
    with pytest.raises(ValueError, match="decoder's 3 heads"):
        pmesh.check_divides(three, 2)
    model = ckpt.params_from_gitax(gitax_params(TINY), TINY, device="cpu")
    with pytest.raises(ValueError, match="encoder's 2 heads"):
        pmesh.shard_params(model, pmesh.Mesh(data=1, model=4, rank=0, device="cpu"))
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.make_mesh(data=1, device="cpu")


def test_data_parallel_above_the_card_count_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    distributed.check_data_parallel(1)
    distributed.check_data_parallel(4, device="cpu")
    with pytest.raises(ValueError, match="needs 2 cards"):
        distributed.check_data_parallel(2)
    with pytest.raises(ValueError, match="needs 2 cards"):
        train.finetune("img.tsv", "cap.tsv", data_parallel=2)


# ---------------------------------------------------------------------------
# the step on each mesh against gitax's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,world", [("dp", 2), ("tp", 2), ("dpxtp", 4)])
def test_mesh_step_matches_gitax(runs, gitax_ref, name, world):
    ours, want = case(runs, world, name), gitax_ref[name]
    for (loss, gnorm), (wloss, wnorm) in zip(ours["metrics"], want["metrics"]):
        assert abs(loss - wloss) <= 1e-6 * abs(wloss) + 1e-6, (loss, wloss)
        assert abs(gnorm - wnorm) <= 1e-4 * abs(wnorm), (gnorm, wnorm)
    assert want["metrics"][0][0] != want["metrics"][-1][0], "the steps did not move the loss"
    grads = gitax_ref["grads"]
    top = max(g.abs().max().item() for g in grads.values())
    for n, g in ours["grads"].items():
        w = grads[n]
        if n.endswith(ZERO_GRAD):
            assert g.abs().max() <= 1e-6 * top and w.abs().max() <= 1e-6 * top, n
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5 * w.abs().max().item(), err_msg=n)
    # 1e-4 at each tensor's scale: Adam's m / sqrt(v) magnifies the
    # rounding of a small gradient (1.2e-6 on 1 of TP's 49152 patch
    # weights); the key biases within 1e-3 of the summed rates
    moved = sum(float(warmup_tx_schedule()(i)) for i in range(STEPS))
    assert_weights_close(ours["weights"], want["weights"], rtol=1e-4, atol=1e-4, scaled=True,
                         noise=1e-3 * moved)


def test_loss_is_the_global_mean_over_unequal_ranks(runs, gitax_ref):
    """The data halves hold 13 and 3 predicted tokens: the port's DP loss
    is gitax's global mean, which the mean of the halves' means misses."""
    model = ckpt.params_from_gitax(gitax_params(TINY), TINY, device="cpu")
    b = to_port(unequal_batch())
    with torch.no_grad():
        logits = model.forward_logits(b["image"], b["caption_tokens"])
        means = [caption_loss(logits[s], b["caption_tokens"][s], b["need_predict"][s]).item()
                 for s in (slice(0, 2), slice(2, 4))]
    want = gitax_ref["dp"]["metrics"][0][0]
    assert abs(np.mean(means) - want) > 100 * (1e-6 * want + 1e-6)
    assert abs(case(runs, 2, "dp")["metrics"][0][0] - want) <= 1e-6 * want + 1e-6


# ---------------------------------------------------------------------------
# ZeRO-1 and remat
# ---------------------------------------------------------------------------


def test_zero1_splits_the_moments_and_equals_the_plain_step(runs):
    zero, plain = case(runs, 2, "dp_zero1"), case(runs, 2, "dp")
    sizes = [t.numel() for t in plain["weights"].values()]
    total = sum(sizes) - plain["weights"]["textual.output.weight"].numel()  # tied
    held = zero["moments"]
    assert sum(held) == total and plain["moments"] == [total, total]
    # greedy by size: each rank within one largest tensor of half
    assert all(abs(h - total / 2) <= max(sizes) for h in held), held
    assert zero["metrics"] == plain["metrics"]
    for n, w in plain["weights"].items():
        assert torch.equal(zero["weights"][n], w), n


def test_zero1_on_gitax_zero1_inputs(runs, gitax_ref):
    """gitax's test_zero1_optimizer_sharding_matches_unsharded on the
    port: ZeRO-1 on a [2, 2] mesh against gitax's replicated run, with
    that test's tolerances."""
    ours, want = case(runs, 4, "zero1_gitax"), gitax_ref["zero1"]
    np.testing.assert_allclose(ours["metrics"][-1][0], want["loss"], rtol=1e-5)
    assert_weights_close(ours["weights"], want["weights"], rtol=2e-4, atol=2e-5)
    assert all(0 < h < sum(ours["moments"]) for h in ours["moments"])


def test_remat_under_tensor_parallelism_equals_no_remat(runs):
    plain, remat = case(runs, 2, "tp"), case(runs, 2, "tp_remat")
    for (a, _), (b, _) in zip(plain["metrics"], remat["metrics"]):
        assert abs(a - b) <= 1e-6 * abs(a)
    for n, g in plain["grads"].items():
        np.testing.assert_allclose(remat["grads"][n].numpy(), g.numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=n)


# ---------------------------------------------------------------------------
# run_finetune and train.finetune on a mesh
# ---------------------------------------------------------------------------


def assert_same_run(got, want):
    """Weights (rtol 1e-5, atol 1e-6) and AdamW moments (rtol 1e-4, atol
    1e-6 of the largest moment of any parameter: the decoder's key biases
    hold moments of rounding noise, ~1e-14) of two fine-tunes, and the
    step count in each parameter's state."""
    assert got["step"] == want["step"]
    assert_weights_close(got["weights"], want["weights"], rtol=1e-5, atol=1e-6)
    gs, ws = got["optimizer"]["state"], want["optimizer"]["state"]
    assert set(gs) == set(ws)
    for k in ("exp_avg", "exp_avg_sq"):
        top = max(st[k].abs().max().item() for st in ws.values())
        for i in ws:
            assert float(gs[i]["step"]) == float(ws[i]["step"]) == want["step"]
            np.testing.assert_allclose(gs[i][k].numpy(), ws[i][k].numpy(), rtol=1e-4,
                                       atol=1e-6 * top, err_msg=(i, k))
    assert got["optimizer"]["param_groups"][0]["decoupled_weight_decay"] is True


def test_run_finetune_on_a_mesh_equals_one_card(runs):
    ft = case(runs, 2, "finetune")
    assert ft["continuous"]["files"] == ["step_00000002/state.pt", "step_00000004/state.pt"]
    assert_same_run(ft["continuous"], runs["one"])


@pytest.mark.parametrize("direction", ["one_card_to_mesh", "mesh_to_one_card"])
def test_run_finetune_resumes_across_meshes(runs, direction):
    """A run resumed at step 2 from the other side's checkpoint (weights,
    moments, step count) ends equal to the continuous run."""
    if direction == "one_card_to_mesh":
        got = case(runs, 2, "finetune")["resumed"]
    else:
        case(runs, 2, "finetune")
        got = runs["one_resumed"]
    assert_same_run(got, runs["one"])


def test_train_finetune_data_parallel_equals_run_finetune_on_a_mesh(runs):
    case(runs, 2, "finetune")
    cli, mesh = runs["cli"]["checkpoint"], runs["mesh_checkpoint"]
    assert_same_run({"weights": cli["model"], "optimizer": cli["optimizer"], "step": cli["step"]},
                    {"weights": mesh["model"], "optimizer": mesh["optimizer"],
                     "step": mesh["step"]})
    # the returned state is rank 0's: on a [2, 1] mesh its model is whole
    assert_weights_close(runs["cli"]["weights"], mesh["model"], rtol=0, atol=0)


def test_run_finetune_validates_on_rank_0_under_tensor_parallelism(runs):
    """Validation on a [1, 2] mesh: rank 0 runs the one-card engine on the
    gathered weights and logs gitax's metric set; the other rank logs
    none."""
    val = case(runs, 2, "validate_tp")
    assert val["counts"] == [1.0, 0.0]
    assert val["validations"][0].startswith("validation @ step 1:")
    assert "CIDEr=" in val["validations"][0]


def test_mesh_refusals_and_spawned_ranks_without_jax(runs):
    refused = case(runs, 2, "refusals")
    assert "2 x 2 != world size 2" in refused["mesh"]
    assert "do_sample needs a torch.Generator" in refused["generate"]
    for world in (2, 4):
        assert runs[world]["jax_imported"][1:] == [0.0] * (world - 1)
