"""The port's training path against gitax's (CPU, f32, gitax's TINY
training config and variants, the same weights carried across with
`ckpt.params_from_gitax`):

* the label-smoothed loss and the shifted caption loss within 1e-6;
* `forward_logits` within 1e-4 on images, a 2-frame clip, ragged text
  context and `bi_valid_mask`;
* `loss.backward()` against `jax.value_and_grad`, per parameter, rtol
  1e-4 and atol 1e-5 x that tensor's largest gitax magnitude; gitax's
  gradient tree is mapped into the port's layout by `params_from_gitax`
  itself (a linear map: slices, transposes, the fused-qkv split), the
  tied head's summed gradient included;
* the schedule against optax's (1e-7 rel) and AdamW on the same injected
  gradients against `optax.adamw` for three steps (parameters and
  moments, 1e-6 rel): updates on injected gradients, not whole runs,
  since Adam's m/sqrt(v) magnifies float noise in near-zero gradients;
* three `make_train_step` steps: loss and grad_norm within 1e-4 rel;
  remat against no remat (1e-6); a bf16 fast_softmax step close to f32;
* `trainable_` and the kernel wrappers' refusal of autograd."""

import functools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.training import caption_loss as gx_caption_loss
from gitax.training import init_train_state as gx_init_train_state
from gitax.training import make_train_step as gx_make_train_step
from gitax.training.loss import smooth_label_cross_entropy as gx_smooth_ce
from gitax_torch import ckpt
from gitax_torch.ops import decode_attention as pt_decode
from gitax_torch.ops import flash_attention as pt_flash
from gitax_torch.ops import vocab_topk as pt_vocab
from gitax_torch.ops.quant import quantize_git_model_
from gitax_torch.training import caption_loss, default_optimizer, init_train_state
from gitax_torch.training import make_train_step, smooth_label_cross_entropy
from gitax_torch.training.trainer import WarmupCosineSchedule, apply_gradients
from test_training import TINY  # gitax's training tests' config

# a 2-frame video config and a text-context config (visual width =
# decoder width, as the context needs)
VIDEO = GitConfig(**dict(vars(TINY), num_image_with_embedding=2))
CONTEXT = GitConfig(**dict(vars(TINY), encoder=ViTConfig(16, 48, 2, 2, 32),
                           visual_feature_size=48))
CONFIGS = {"tiny": TINY, "video": VIDEO, "context": CONTEXT}
TOL = dict(atol=1e-4, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def gitax_params(name, seed=0):
    cfg = CONFIGS[name]
    params = GitModel(cfg).init_params(jax.random.PRNGKey(seed))
    if cfg.num_image_with_embedding:
        # gitax initialises them to zeros; random ones show the offsets
        params["img_temporal_embedding"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1), params["img_temporal_embedding"].shape) * 0.5
    return jax.tree_util.tree_map(np.asarray, params)


def port_model(name, seed=0):
    return ckpt.params_from_gitax(gitax_params(name, seed), CONFIGS[name], device="cpu")


def batch(name="tiny", seed=3):
    """Images (or 2-frame clips), captions with padding and need_predict,
    plus the case's extra inputs."""
    rng = np.random.RandomState(seed)
    shape = (2, 2, 32, 32, 3) if name == "video" else (2, 32, 32, 3)
    out = {
        "image": rng.randn(*shape).astype(np.float32),
        "caption_tokens": np.array([[101, 5, 9, 17, 102, 0], [101, 7, 3, 102, 0, 0]], np.int64),
        "need_predict": np.array([[0, 1, 1, 1, 1, 0], [0, 1, 1, 1, 0, 0]], np.int64),
    }
    if name == "context":
        out["context_tokens"] = rng.randint(1, 100, (2, 5)).astype(np.int64)
        out["context_lengths"] = np.array([5, 2], np.int64)
    if name == "bi_valid":
        out["bi_valid_mask"] = np.array([[0, 1, 1, 0, 0, 0], [1, 1, 0, 0, 0, 0]], bool)
    return out


def to_gitax(b):
    return {k: jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else v.dtype) for k, v in b.items()}


def to_port(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


FWD_KEYS = ("bi_valid_mask", "context_tokens", "context_lengths")


def gitax_loss_fn(name):
    gm = GitModel(CONFIGS[name])

    def loss_fn(params, b):
        logits = gm.forward_logits(params, b["image"], b["caption_tokens"],
                                   **{k: b.get(k) for k in FWD_KEYS})
        return gx_caption_loss(logits, b["caption_tokens"], b["need_predict"])

    return loss_fn


def port_loss(model, b, **kw):
    logits = model.forward_logits(b["image"], b["caption_tokens"],
                                  **{k: b.get(k) for k in FWD_KEYS}, **kw)
    return caption_loss(logits, b["caption_tokens"], b["need_predict"])


def cfg_name(case):
    return "tiny" if case == "bi_valid" else case


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_smooth_label_cross_entropy_matches_gitax(masked):
    rng = np.random.RandomState(0)
    logits = (rng.randn(12, 31) * 3).astype(np.float32)
    targets = rng.randint(0, 31, (12,))
    valid = rng.rand(12) > 0.4 if masked else np.ones(12, bool)
    want = float(gx_smooth_ce(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(valid)))
    got = smooth_label_cross_entropy(torch.from_numpy(logits), torch.from_numpy(targets),
                                     torch.from_numpy(valid)).item()
    assert abs(got - want) < 1e-6


def test_smooth_label_cross_entropy_all_rows_masked():
    """No valid row: the count clamps to 1 and the loss is 0, as gitax's."""
    logits = np.random.RandomState(1).randn(4, 9).astype(np.float32)
    valid = np.zeros(4, bool)
    want = float(gx_smooth_ce(jnp.asarray(logits), jnp.zeros(4, jnp.int32), jnp.asarray(valid)))
    got = smooth_label_cross_entropy(torch.from_numpy(logits), torch.zeros(4, dtype=torch.long),
                                     torch.from_numpy(valid)).item()
    assert got == want == 0.0


@pytest.mark.parametrize("eps,pad", [(0.1, 0), (0.05, 0), (0.2, 3)])
def test_caption_loss_matches_gitax(eps, pad):
    rng = np.random.RandomState(2)
    logits = rng.randn(3, 7, 40).astype(np.float32)
    tokens = rng.randint(1, 40, (3, 7))
    need = np.array([[0, 0, 1, 1, 1, 1, 0], [0, 1, 1, 1, 0, 0, 0], [0, 0, 0, 0, 0, 0, 0]])
    want = float(gx_caption_loss(jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(need),
                                 eps=eps, padding_idx=pad))
    got = caption_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                       torch.from_numpy(need), eps=eps, padding_idx=pad).item()
    assert abs(got - want) < 1e-6


def test_caption_loss_without_smoothing_is_cross_entropy():
    """eps=0 is the plain cross-entropy over the predicted positions (0 log
    0 = 0; gitax's jnp.log(0) gives NaN there)."""
    rng = np.random.RandomState(2)
    logits = torch.from_numpy(rng.randn(3, 7, 40).astype(np.float32))
    tokens = torch.from_numpy(rng.randint(1, 40, (3, 7)))
    need = torch.tensor([[0, 0, 1, 1, 1, 1, 0], [0, 1, 1, 1, 0, 0, 0], [0] * 7])
    mask = need[:, 1:] == 1
    want = torch.nn.functional.cross_entropy(logits[:, :-1][mask], tokens[:, 1:][mask])
    got = caption_loss(logits, tokens, need, eps=0.0)
    assert abs(got.item() - want.item()) < 1e-6


# ---------------------------------------------------------------------------
# forward_logits and the gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["tiny", "video", "context", "bi_valid"])
def test_forward_logits_matches_gitax(case):
    name = cfg_name(case)
    b = batch(case)
    gm = GitModel(CONFIGS[name])
    gb = to_gitax(b)
    want = gm.forward_logits(gitax_params(name), gb["image"], gb["caption_tokens"],
                             **{k: gb.get(k) for k in FWD_KEYS})
    model = port_model(name).trainable_(True)
    pb = to_port(b)
    got = model.forward_logits(pb["image"], pb["caption_tokens"],
                               **{k: pb.get(k) for k in FWD_KEYS})
    assert got.requires_grad and got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_forward_logits_refuses_context_with_memory_valid():
    b = to_port(batch("context"))
    model = port_model("context")
    with pytest.raises(ValueError, match="not both"):
        model.forward_logits(b["image"], b["caption_tokens"], memory_valid=torch.ones(2, 5).bool(),
                             context_tokens=b["context_tokens"],
                             context_lengths=b["context_lengths"])


def gradient_pairs(case):
    """(name, port grad, gitax grad mapped into the port's layout) per
    parameter, and both losses."""
    name = cfg_name(case)
    b = batch(case)
    loss, grads = jax.jit(jax.value_and_grad(gitax_loss_fn(name)))(gitax_params(name),
                                                                  to_gitax(b))
    mapped = ckpt.params_from_gitax(jax.tree_util.tree_map(np.asarray, grads), CONFIGS[name],
                                    device="cpu")
    model = port_model(name).trainable_(True)
    ours = port_loss(model, to_port(b))
    ours.backward()
    want = dict(mapped.named_parameters())
    pairs = [(n, p.grad, want[n].detach()) for n, p in model.named_parameters()]
    return pairs, ours.item(), float(loss)


# the decoder's key biases: their gradient is zero in exact arithmetic
# (a softmax is unchanged by adding one constant to every key a query
# scores), so both sides hold rounding noise there, held to a bound
ZERO_GRAD = ".attention.self.key.bias"


@pytest.mark.parametrize("case", ["tiny", "video", "context", "bi_valid"])
def test_gradients_match_gitax(case):
    pairs, ours, want = gradient_pairs(case)
    assert abs(ours - want) <= 1e-6 * abs(want) + 1e-6
    names = [n for n, _, _ in pairs]
    # the tied head is one Parameter: its gradient sums the embedding's
    # and the head's, gitax's one `embedding.words` leaf
    assert "textual.embedding.words.weight" in names and "textual.output.weight" not in names
    top = max(w.abs().max().item() for _, _, w in pairs)
    for n, g, w in pairs:
        assert g is not None, n
        if n.endswith(ZERO_GRAD):
            assert g.abs().max() <= 1e-6 * top and w.abs().max() <= 1e-6 * top, n
            continue
        scale = w.abs().max().item()
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=n)


def test_tied_head_gradient_is_the_sum_of_both_uses():
    """The words gradient is non-zero on rows no caption token embeds:
    the head's share reaches every row, the embedding's only the tokens'."""
    pairs, _, _ = gradient_pairs("tiny")
    g = dict((n, gr) for n, gr, _ in pairs)["textual.embedding.words.weight"]
    used = set(batch()["caption_tokens"].ravel().tolist())
    unused = [i for i in range(TINY.vocab_size) if i not in used]
    assert g[unused].abs().max() > 0
    head_only = g[unused].abs().mean().item()
    assert g[sorted(used)].abs().mean().item() > head_only


def test_remat_gives_the_same_loss_and_gradients():
    b = to_port(batch())
    grads = []
    for remat in (False, True):
        model = port_model("tiny").trainable_(True)
        loss = port_loss(model, b, remat=remat)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = grads
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=n)


def test_trainable_switch_and_int8_refusal():
    model = port_model("tiny")
    assert not any(p.requires_grad for p in model.parameters())
    model.trainable_(True)
    assert all(p.requires_grad for p in model.parameters())
    # the tied weight is counted once
    n = sum(p.numel() for p in model.parameters())
    flat = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(gitax_params("tiny")))
    assert n == flat
    model.trainable_(False)
    assert not any(p.requires_grad for p in model.parameters())
    quantize_git_model_(model)
    with pytest.raises(ValueError, match="int8"):
        model.trainable_(True)


# ---------------------------------------------------------------------------
# the schedule and AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warmup,total", [(1e-5, 500, 100_000), (3e-4, 7, 20),
                                               (1e-3, 2, 2)])
def test_schedule_matches_optax(peak, warmup, total):
    decay = max(total, warmup + 1)
    want_fn = optax.warmup_cosine_decay_schedule(0.0, peak, warmup, decay)
    ours = WarmupCosineSchedule(peak, warmup, decay)
    for count in sorted({0, 1, warmup - 1, warmup, (warmup + decay) // 2, decay - 1, decay,
                         decay + 5}):
        want = float(want_fn(count))
        got = ours(count)
        assert abs(got - want) <= 1e-7 * abs(want), (count, got, want)
    assert ours(0) == 0.0


def adamw64(p, m, v, g, t, lr, wd, b1=0.9, b2=0.999, eps=1e-8):
    """optax.adamw's update rule in float64: decoupled decay on p,
    eps outside the square root, bias corrections at count t."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh, vh = m / (1 - b1 ** t), v / (1 - b2 ** t)
    return p - lr * (mh / (np.sqrt(vh) + eps) + wd * p), m, v


def test_adamw_on_injected_gradients_matches_optax():
    """Three AdamW updates of the port (default_optimizer: warmup 2,
    weight decay 0.2) and of optax's on the same gradients (gitax's,
    mapped): the moments within 1e-6 rel of optax's, the parameters
    within 1e-6 rel of optax's rule replayed in float64 on the same
    gradients and rates (atol 1e-6 of the summed rates: Adam's m/sqrt(v)
    magnifies f32 rounding in gradients near eps).  Against optax's own parameters the bound is
    optax's: it takes the bias correction 1 - 0.999^t in float32, which
    cancels (1.3e-5 relative at t=1), so its updates stray from its own
    rule by up to ~1.5e-5 relative in the first steps; the port's
    (torch's, in float64) do not, and the test holds optax to its rule
    within that bound."""
    name = "tiny"
    params = gitax_params(name)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)
    tx = optax.adamw(sched, b1=0.9, b2=0.999, weight_decay=0.2)
    opt_state = tx.init(params)
    model = port_model(name)
    state = init_train_state(model, *default_optimizer(model, learning_rate=1e-2,
                                                       weight_decay=0.2, warmup_steps=2,
                                                       total_steps=6))
    ref = {n: (p.detach().double().numpy(), 0.0, 0.0) for n, p in model.named_parameters()}
    loss_fn = jax.jit(jax.value_and_grad(gitax_loss_fn(name)))
    b = to_gitax(batch(name))
    moved = 0.0
    for step in range(3):
        lr = float(sched(step))
        assert state.schedule(step) == lr
        moved += lr
        _, grads = loss_fn(params, b)
        grads = jax.tree_util.tree_map(np.asarray, grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, updates))
        mapped = dict(ckpt.params_from_gitax(grads, TINY, device="cpu").named_parameters())
        for n, p in model.named_parameters():
            p.grad = mapped[n].detach().clone()
            ref[n] = adamw64(*ref[n], p.grad.double().numpy(), step + 1, lr, 0.2)
        apply_gradients(state)

        def port_layout(tree):
            return dict(ckpt.params_from_gitax(jax.tree_util.tree_map(np.asarray, tree), TINY,
                                               device="cpu").named_parameters())

        want, mu, nu = port_layout(params), port_layout(opt_state[0].mu), port_layout(
            opt_state[0].nu)
        for n, p in model.named_parameters():
            msg = "{} step {}".format(n, step)
            st = state.optimizer.state[p]
            # atol 1e-6 of the tensor's largest moment: where a gradient
            # changes sign the moment cancels toward 0
            for ours, theirs in ((st["exp_avg"], mu[n]), (st["exp_avg_sq"], nu[n])):
                theirs = theirs.detach().numpy()
                np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6,
                                           atol=1e-6 * np.abs(theirs).max(), err_msg=msg)
            # atol: 1e-6 of the largest move Adam's rule allows (sum of lr)
            np.testing.assert_allclose(p.detach().double().numpy(), ref[n][0], rtol=1e-6,
                                       atol=1e-6 * moved, err_msg=msg)
            np.testing.assert_allclose(want[n].detach().double().numpy(), ref[n][0], rtol=1e-6,
                                       atol=2e-5 * moved, err_msg=msg)
    assert state.step == 3


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def gitax_steps(name, b, n, **kw):
    tx = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 2, 10), weight_decay=0.2)
    model = GitModel(CONFIGS[name])
    state = gx_init_train_state(model, None, tx, params=gitax_params(name))
    step = jax.jit(gx_make_train_step(model, tx, **kw))
    out = []
    for _ in range(n):
        state, m = step(state, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def port_steps(name, b, n, **kw):
    model = port_model(name)
    state = init_train_state(model, *default_optimizer(model, learning_rate=1e-3,
                                                       weight_decay=0.2, warmup_steps=2,
                                                       total_steps=10))
    step = make_train_step(model, **kw)
    out = []
    for _ in range(n):
        state, m = step(state, b)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


@pytest.mark.parametrize("case", ["tiny", "context"])
def test_three_train_steps_match_gitax(case):
    b = batch(case)
    want = gitax_steps(case, to_gitax(b), 3)
    got = port_steps(case, to_port(b), 3)
    assert want[0][0] != want[2][0], "the steps did not move the loss"
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=1e-4)


def test_bf16_fast_softmax_step_close_to_f32():
    """gitax's test_fast_softmax_train_step_close on the port: at f32
    the fast path equals parity mode (1e-6), and a bf16 fast step is
    finite and within 0.1 of f32."""
    b = to_port(batch())
    ref = port_steps("tiny", b, 1)[0][0]
    fast = port_steps("tiny", b, 1, fast_softmax=True)[0][0]
    assert abs(fast - ref) <= 1e-6 * abs(ref)
    bb = dict(b, image=b["image"].to(torch.bfloat16))
    bf = port_steps("tiny", bb, 1, dtype=torch.bfloat16, fast_softmax=True)[0][0]
    assert np.isfinite(bf) and abs(bf - ref) < 0.1


# ---------------------------------------------------------------------------
# the kernel wrappers under autograd
# ---------------------------------------------------------------------------


def test_kernel_wrappers_refuse_autograd():
    """Each CUDA entry raises before any device check when grad mode is
    on and an input requires grad; it does not fall back."""
    q = torch.randn(1, 2, 8, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention.*no backward"):
        pt_flash.flash_attention_cuda(q, q, q, torch.empty(1, 2, 8, 64))
    x = torch.randn(4, 128, requires_grad=True)
    txt = torch.zeros(3, 4, 128)
    with pytest.raises(RuntimeError, match="decode_attention.*no backward"):
        pt_decode.decode_attention_cuda(x[:, :64].contiguous(), x, txt,
                                        torch.zeros(4, 3, dtype=torch.int32), 0,
                                        torch.zeros(1, 1, 5, 128), beams=4, num_heads=1,
                                        head_dim=64)
    bias = torch.zeros(512, requires_grad=True)
    with pytest.raises(RuntimeError, match="vocab_topk.*no backward"):
        pt_vocab.vocab_logits_topk_cuda(torch.randn(2, 16), torch.zeros(16, 512, dtype=torch.int8),
                                        torch.ones(512), bias)
    # without grad mode the autograd check passes and the device checks speak
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        pt_flash.flash_attention_cuda(q, q, q, torch.empty(1, 2, 8, 64))


def test_plain_paths_keep_the_gradient_on_the_cpu():
    """On CPU tensors each entry runs its plain version under autograd."""
    qkv = torch.randn(2, 5, 3 * 128, requires_grad=True)
    pt_flash.flash_qkv_attention(qkv, 2).sum().backward()
    assert qkv.grad is not None and qkv.grad.abs().sum() > 0
    q = torch.randn(1, 2, 6, 64, requires_grad=True)
    pt_flash.fused_attention(q, q, q, num_memory=3, masked=True).sum().backward()
    assert q.grad.abs().sum() > 0
    h = torch.randn(2, 16, requires_grad=True)
    logits, _, _ = pt_vocab.vocab_logits_topk(h, torch.randint(-5, 5, (16, 512), dtype=torch.int8),
                                              torch.ones(512), torch.zeros(512))
    logits.sum().backward()
    assert h.grad.abs().sum() > 0
    kv_new = torch.randn(4, 128, requires_grad=True)
    ctx = pt_decode.decode_attention(torch.randn(4, 64), kv_new, torch.zeros(3, 4, 128),
                                     torch.zeros(4, 3, dtype=torch.int32), 0,
                                     torch.randn(1, 1, 5, 128), beams=4, num_heads=1,
                                     head_dim=64)
    ctx.sum().backward()
    assert kv_new.grad is not None
