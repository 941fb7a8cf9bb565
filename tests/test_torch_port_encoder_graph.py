"""The encoder's graph cache (`decode.device_loop.encode`, entered through
`GitModel.encode_images`) on the CPU, with a fake capturer: a "graph" whose
replay runs the body again with the kernel wrappers' counting held off,
as a replayed CUDA graph runs no wrapper code.  Covered: what the key
holds (the input's shape and dtype, frames, the activation dtype, fast
and flash as resolved), weights in new storage, the LRU bound, traffic
of more keys than the bound (eager misses, captures at a bounded rate),
the one pool an owner's graphs share, that the returned tensor is never
the static buffer, when `encode_images` stays eager, and the counters
(the encoder's move, the search's do not)."""

import dataclasses

import pytest
import torch

from gitax_torch.decode import device_loop
from gitax_torch.models.config import GitConfig, ViTConfig
from gitax_torch.models.git import GitModel
from gitax_torch.ops import flash_attention
from gitax_torch.runtime import profiling

CFG = GitConfig(encoder=ViTConfig(8, 32, 1, 2, 16), visual_feature_size=32, vocab_size=64,
                hidden_size=32, num_layers=1, num_heads=2, feedforward_size=64,
                max_caption_length=16)
VIDEO = dataclasses.replace(CFG, num_image_with_embedding=2)


class FakeGraph(object):
    def __init__(self, fn, x):
        self.fn, self.x = fn, x
        self.out = fn(x)
        self.replays = 0

    def pool(self):  # the pool it was captured into, as a CUDA graph's
        return self.into if self.into is not None else ("pool", id(self))

    def replay(self):
        counts = device_loop._counts(None)
        self.out.copy_(self.fn(self.x))
        device_loop._add_counts(None, {k: counts[k] - v
                                       for k, v in device_loop._counts(None).items()})
        self.replays += 1


@pytest.fixture
def fake(monkeypatch):
    """The card's warm-up and capture replaced; returns the graphs made,
    each with the pool it was captured into (`.into`)."""
    made = []

    def capture(fn, x, pool):
        made.append(FakeGraph(fn, x))
        made[-1].into = pool
        return made[-1], made[-1].out

    monkeypatch.setattr(device_loop, "_warm_up", lambda fn, x: fn(x))
    monkeypatch.setattr(device_loop, "_capture_encoder", capture)
    return made


def model(cfg=CFG):
    return GitModel(cfg, device="cpu").init_params(torch.Generator().manual_seed(0))


def images(b=2, size=16, frames=0, dtype=torch.float32):
    shape = (b, frames, size, size, 3) if frames else (b, size, size, 3)
    return torch.randn(shape, generator=torch.Generator().manual_seed(b + size)).to(dtype)


def run(m, x, key=(torch.float32, False, False)):
    return device_loop.encode(m, key, x, lambda y: m._encode(y, key[0], key[1], key[2]))


def graphs(m):
    cache = device_loop._ENCODERS.get(m)
    return list(cache.graphs.values()) if cache is not None else []


def delta(c0):
    c1 = profiling.counters()
    return {k: c1[k] - c0[k] for k in ("encode_captures", "encode_replays", "encode_evictions",
                                       "encode_eager", "captures", "capture_s", "evictions")}


@pytest.mark.parametrize("change", ["rows", "size", "frames", "input_dtype", "dtype", "fast",
                                    "flash"])
def test_key_holds_shape_dtype_and_switches(fake, change):
    m = model(VIDEO)
    base = dict(x=images(), key=(torch.float32, False, False))
    if change == "frames":
        base["x"] = images(frames=1)
    other = dict(base)
    other["x"] = {"rows": images(b=3), "size": images(size=24), "frames": images(frames=2),
                  "input_dtype": base["x"].double()}.get(change, base["x"])
    i = {"dtype": 0, "fast": 1, "flash": 2}.get(change)
    if i is not None:
        key = list(base["key"])
        key[i] = torch.float64 if change == "dtype" else True
        other["key"] = tuple(key)
    c0 = profiling.counters()
    with torch.inference_mode():
        for kw in (base, base, other, other, base):
            device_loop.encode(m, kw["key"], kw["x"], lambda y: y * 2)
    assert len(graphs(m)) == 2
    assert delta(c0)["encode_captures"] == 2 and delta(c0)["encode_replays"] == 3


def test_weights_in_new_storage_capture_anew(fake):
    m = model()
    x = images()
    with torch.inference_mode():
        first = run(m, x)
    with torch.no_grad():
        m.image_encoder.ln_post.bias.add_(1.0)  # in place: the same graph sees it
    with torch.inference_mode():
        moved = run(m, x)
    assert len(graphs(m)) == 1 and torch.allclose(moved, first + 1.0, atol=1e-6)
    m.image_encoder.ln_post.bias = torch.nn.Parameter(m.image_encoder.ln_post.bias.clone(),
                                                      requires_grad=False)
    c0 = profiling.counters()
    with torch.inference_mode():
        again = run(m, x)
    # the graph of the old weights is dropped, the new weights' captured
    assert len(graphs(m)) == 1 and graphs(m)[0].graph is fake[-1]
    assert delta(c0)["encode_evictions"] == 1 and delta(c0)["encode_captures"] == 1
    assert torch.equal(again, moved)


def test_lru_evicts_the_least_recently_used_at_the_bound(fake, monkeypatch):
    monkeypatch.setattr(device_loop, "ENCODER_REPLAYS_A_CAPTURE", 3)
    m = model()
    n = device_loop.MAX_ENCODER_GRAPHS
    c0 = profiling.counters()
    with torch.inference_mode():
        for b in range(1, n + 1):
            run(m, images(b=b))
        for _ in range(3):
            run(m, images(b=1))  # now the most recent: b=2 goes first
        run(m, images(b=n + 1))
    assert len(graphs(m)) == n
    assert sorted(g.static_in.shape[0] for g in graphs(m)) == [1] + list(range(3, n + 2))
    assert delta(c0)["encode_evictions"] == 1
    with torch.inference_mode():
        for b in (1, 1, 3, 2):
            run(m, images(b=b))
    assert delta(c0)["encode_captures"] == n + 2 and delta(c0)["encode_evictions"] == 2
    assert 4 not in [g.static_in.shape[0] for g in graphs(m)]


def test_more_keys_than_the_bound_run_eagerly_and_do_not_thrash(fake, monkeypatch):
    monkeypatch.setattr(device_loop, "ENCODER_REPLAYS_A_CAPTURE", 10)
    m = model()
    n = device_loop.MAX_ENCODER_GRAPHS
    keys = n + 4  # a server's buckets x grids, called in turn
    c0 = profiling.counters()
    with torch.inference_mode():
        for _ in range(3):
            for b in range(1, keys + 1):
                x = images(b=b)
                assert torch.equal(run(m, x), m._encode(x, torch.float32, False, False))
    d = delta(c0)
    # the first n keys fill the cache; after 10 replays, one capture evicts
    assert len(graphs(m)) == n and d["encode_captures"] == n + 1
    assert d["encode_evictions"] == 1
    assert d["encode_captures"] + d["encode_replays"] + d["encode_eager"] == 3 * keys
    assert d["encode_eager"] >= 2 * (keys - n)


def test_an_owner_s_graphs_share_one_pool(fake):
    m, other = model(), model()
    with torch.inference_mode():
        for b in (1, 2, 3):
            run(m, images(b=b))
        run(other, images(b=1))
    assert [g.into for g in fake] == [None, fake[0].pool(), fake[0].pool(), None]
    m.image_encoder.ln_post.bias = torch.nn.Parameter(m.image_encoder.ln_post.bias.clone(),
                                                      requires_grad=False)
    with torch.inference_mode():
        run(m, images(b=1))
    assert fake[-1].into is None  # new weights: a new cache and pool


def test_returns_a_new_tensor_equal_to_the_eager_body(fake):
    m = model(VIDEO)
    x, y = images(frames=2), images(frames=2).flip(0)
    with torch.inference_mode():
        eager_x, eager_y = m._encode(x, torch.float32, False, False), m._encode(
            y, torch.float32, False, False)
        got_x = run(m, x)
    with torch.no_grad():  # a hit outside inference mode, on the other rows
        got_y = run(m, y)
    g = graphs(m)[0]
    assert torch.equal(got_x, eager_x) and torch.equal(got_y, eager_y)
    for got in (got_x, got_y):
        assert got.data_ptr() != g.static_out.data_ptr()
    assert not got_y.is_inference()
    got_y.zero_()
    assert torch.equal(g.static_out, eager_y)


class OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, for the engagement rule."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case", ["cpu", "grad", "remat", "tp_group", "card"])
def test_encode_images_takes_the_graph_only_on_a_card_in_inference(monkeypatch, case):
    m = model()
    keys = []

    def recorded(owner, key, x, fn):
        keys.append(key)
        return fn(x.as_subclass(torch.Tensor))

    monkeypatch.setattr(device_loop, "encode", recorded)
    monkeypatch.setattr(m, "_encode", lambda x, *a, **kw: torch.zeros(2, 5, 32))
    x = images() if case == "cpu" else images().as_subclass(OnCard)
    if case == "tp_group":
        m.image_encoder.tp_group = object()
    with torch.set_grad_enabled(case == "grad"):
        out = m.encode_images(x, remat=case == "remat")
        if case == "card":  # fast and flash as resolved: None and the values they resolve to
            m.encode_images(x, fast=CFG.encoder.fast_softmax, flash=False)
    assert out.shape == (2, 5, 32)
    assert keys == ([(torch.float32, False, False)] * 2 if case == "card" else [])


def test_counters_move_for_the_encoder_and_not_for_the_search(fake):
    m = model()
    x = images()
    launches = flash_attention.launches

    def body(y):
        flash_attention.launches += 3  # as kernel 2's wrapper counts a launch
        return y + 1

    profiling.clear()
    c0 = profiling.counters()
    with torch.inference_mode():
        device_loop.encode(m, "k", x, body)  # warm-up and capture taken back, replay 3
        assert flash_attention.launches - launches == 3
        device_loop.encode(m, "k", x, body)
    assert flash_attention.launches - launches == 6
    assert delta(c0) == {"encode_captures": 1, "encode_replays": 1, "encode_evictions": 0,
                         "encode_eager": 0, "captures": 0, "capture_s": 0.0, "evictions": 0}
    assert device_loop.graphs(m) == [] and graphs(m)[0].per_call == {"flash_attention": 3}
    names = [r.name for r in profiling.spans()]
    assert names.count("model.encode_capture") == (1 if profiling.ON else 0)
    assert "search.capture" not in names
    device_loop.release(m)
    assert graphs(m) == []
