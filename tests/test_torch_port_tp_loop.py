"""A model group's search on the card's schedule, and the groups every rank
makes, on gloo CPU ranks (CPU, f32).

On a model group of m > 1 ranks over NCCL the port runs gitax's
device-side search (one SPMD `while_loop`, gitax/decode/beam.py:488) as
one captured decode step, its all-reduces inside, replayed under an IF
node whose predicate the card computes (`decode.device_loop`).  That
holds only if every rank takes the same branch at every launch, else the
all-reduces inside the step stop pairing up.  Here two gloo ranks run
that schedule on the host (`device_loop.run_on_host`: every launch, the
body only where the last body's predicate holds) on a [1, 2] mesh, and
each rank logs, after every body, the predicate it computed and the
bodies run so far:

* beam search with a [CLS] prefix and a question prefix, greedy, trie
  and sampling (gitax's own draws replayed through `gumbel_noise` on both
  ranks): the tokens equal the eager loop's on the same mesh and gitax's
  `generate` on a [1, 2] mesh of its virtual CPU devices (tokens exact,
  logprobs within 1e-4), the ranks' sequences are equal, and the ranks'
  logs are equal step for step;
* `_search_run` takes the graph for an NCCL model group (its key names
  the group) and the eager loop for a gloo one (a mocked backend name).

Under NCCL every rank must call `new_group` for every group, in the same
order.  A launch of 4 ranks and one of 2 (`tests/torch_parallel_worker.py
::tp_loop_main`, which imports no jax) record each rank's `new_group`
calls (`GroupLog`) around row shards over hosts (2 hosts x [2, 1],
through `test_git_inference_single_tsv`), an engine on [1, 2] and on
[2, 2], and the search above; every rank's sequence must be rank 0's.
`init_training_group` binds no card to the process group: bound, torch
makes each later group by splitting the default communicator, and a
gloo group of some ranks only (the hosts' barrier group) leaves the
ranks' splits unpaired, the four-card hang of row shards over hosts.
"""

import os
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gitax.decode import BeamSearchConfig as GxBeam
from gitax.decode import build_vocab_trie as gx_build_vocab_trie
from gitax.models import GitModel
from gitax.parallel import make_mesh as gx_make_mesh
from gitax.parallel import shard_params as gx_shard_params
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch.decode import device_loop
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.models.git import GitModel as PortModel
from gitax_torch.parallel import comm
from gitax_torch.runtime import distributed
from test_torch_port_cli import WORDS as CLI_WORDS
from test_torch_port_device_loop import CFG, CLASSES, PREFIX, TOL, WORDS, images, weights
from test_torch_port_mesh_engine import cli_dir, wide_configs
from test_torch_port_parallel import port_cfg
from torch_parallel_worker import group_order_mismatch

TP_CASES = {
    "beam": dict(beam=dict(num_beams=4, max_steps=16)),
    "beam_prefix": dict(beam=dict(num_beams=4, max_steps=16), prefix=PREFIX.tolist()),
    "greedy": dict(mode="greedy", max_steps=14),
    "trie": dict(mode="trie", max_steps=10),
    "sampled": dict(beam=dict(num_beams=4, max_steps=10, do_sample=True, temperature=0.7,
                              top_k=50, top_p=0.9, repetition_penalty=1.2)),
}
# cases whose searches end before their last launch on these weights
EARLY = {"beam", "beam_prefix", "greedy", "trie"}
NOISE_KEY = 7
GROUP_CASES = {"groups_hosts_2x1": 4, "groups_engine_1x2": 2, "groups_engine_2x2": 4,
               "groups_tp_graph_search": 2}


def gitax_noise(case, n_images):
    """gitax's Gumbel draws of a sampled search, one a step: each step
    splits the carried key and draws [B*K, V] from the subkey."""
    beam = case["beam"]
    key, out = jax.random.PRNGKey(NOISE_KEY), []
    for _ in range(beam["max_steps"]):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.gumbel(sub, (n_images * beam["num_beams"],
                                                    CFG.vocab_size), jnp.float32)))
    return out


def engine_images():
    rng = np.random.RandomState(3)
    return [rng.randint(0, 255, (32, 32, 3), np.uint8) for _ in range(6)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both launches' scenarios, with 1 thread a rank."""
    d = str(tmp_path_factory.mktemp("tp_loop"))
    _, model = weights()
    x = images()
    job = {
        "tp": {"cfg": port_cfg(CFG), "weights": {n: t.clone() for n, t in model.state_dict().items()},
               "images": x},
        "tp_cases": TP_CASES,
        "tp_noise": {"sampled": gitax_noise(TP_CASES["sampled"], len(x))},
        "trie_words": WORDS, "trie_classes": CLASSES,
        "engine_kw": dict(batch_size=4, max_text_len=12, beam=BeamSearchConfig(num_beams=2,
                                                                             max_steps=12),
                          dtype=torch.float32, use_native=False),
        "words": WORDS, "images": engine_images(),
        "cli": {"dir": cli_dir(tmp_path_factory.mktemp("tp_cli")), "words": CLI_WORDS,
                "cfg": wide_configs()[1]},
    }
    torch.save(job, os.path.join(d, "tp_job.pt"))
    out = {"job": job}
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            mp.delenv(k, raising=False)
        mp.setattr(distributed, "_GROUP_TIMEOUT_S", None)  # rank 0's group is this process's
        for world in (2, 4):
            try:
                distributed.spawn_ranks("torch_parallel_worker:tp_loop_main", world, (d,))
                out[world] = torch.load(os.path.join(d, "tp{}.pt".format(world)),
                                        weights_only=False)
            except Exception as e:  # each test of this launch reports it
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


def gitax_mesh_generate(name):
    """gitax's `generate` on a [1, 2] mesh of its virtual CPU devices (the
    params TP-sharded by gitax's partition specs), jitted: (tokens,
    logprobs)."""
    c = TP_CASES[name]
    params, _ = weights()
    mode = c.get("mode", "beam")
    kw = dict(mode=mode)
    if mode == "beam":
        kw["beam"] = GxBeam(**c["beam"])
    else:
        kw["max_steps"] = c["max_steps"]
    if mode == "trie":
        kw["trie"] = gx_build_vocab_trie(GxTokenizer(gx_tiny_vocab(WORDS)), CLASSES)
    gm = GitModel(CFG)
    mesh = gx_make_mesh(data=1, model=2, devices=jax.devices()[:2])

    @jax.jit
    def gen(p, im, pr, rng):
        return gm.generate(p, im, pr, rng=rng, **kw)

    prefix = None if c.get("prefix") is None else jnp.asarray(c["prefix"], jnp.int32)
    seqs, lp = gen(gx_shard_params(params, mesh), jnp.asarray(images()), prefix,
                   jax.random.PRNGKey(NOISE_KEY))
    return np.asarray(seqs), np.asarray(lp)


@pytest.mark.parametrize("name", sorted(TP_CASES))
def test_tp_step_form_matches_eager_loop_and_gitax_mesh(runs, name):
    """The [1, 2] model group's search on the card's schedule: gitax's
    mesh tokens and the eager loop's on the same mesh; every rank's
    predicate and body count equal after every body; the search ends
    early where gitax's does, the later launches skipping on both
    ranks."""
    got = case(runs, 2, "tp_" + name)
    want_seqs, want_lp = gitax_mesh_generate(name)
    for loop in ("schedule", "eager"):
        np.testing.assert_array_equal(got[loop]["tokens"], want_seqs)
        np.testing.assert_allclose(got[loop]["logprobs"], want_lp, **TOL)
        assert got[loop]["unequal"] == 0
    (log0, launches0), (log1, launches1) = got["logs"]
    assert log0 == log1 and launches0 == launches1
    c = TP_CASES[name]
    tp = 1 if c.get("prefix") is None else len(c["prefix"][0])
    replays = c["beam"]["max_steps"] - tp if "beam" in c else c["max_steps"] - tp - 1
    assert launches0 == [replays]
    bodies = log0[-1][1]
    assert [b for _, b in log0] == list(range(bodies + 1))  # one entry before, one a body
    assert not log0[-1][0] or bodies == replays
    if name in EARLY:
        assert 0 < bodies < replays
    if name in ("beam_prefix", "sampled"):  # rows that differ: other prefixes, other draws
        assert len({tuple(r) for r in want_seqs.reshape(len(want_seqs), -1).tolist()}) > 1


@pytest.mark.parametrize("name", sorted(GROUP_CASES))
def test_every_rank_makes_the_same_groups(runs, name):
    """Every rank of the launch called `new_group` with the same ranks and
    backend, in the same order (NCCL's rule), around each case."""
    got = case(runs, GROUP_CASES[name], name)
    calls = got["groups"]
    assert len(calls) == GROUP_CASES[name] and calls[0]
    assert group_order_mismatch(calls) is None, group_order_mismatch(calls)
    if name == "groups_hosts_2x1":
        # each host's mesh groups on every rank, and the hosts' barrier group
        assert ((0, 2), "gloo") in calls[0] and ((0, 1), "gloo") in calls[0]
        assert os.path.isfile(got["result"])


def test_group_order_check_catches_a_group_of_one_host_and_another_order():
    """The check fails a launch where one rank makes a group the others do
    not (a group made by one host only), or makes them in another order."""
    made = [((0, 1), "gloo"), ((2, 3), "gloo"), ((0, 2), "gloo")]
    assert group_order_mismatch([made] * 4) is None
    one_host = [made, made, made[:2], made[:2]]
    assert group_order_mismatch(one_host) == "rank 2 call 2: nothing where rank 0 made " \
        "((0, 2), 'gloo')"
    reordered = [made, [made[1], made[0], made[2]], made, made]
    assert group_order_mismatch(reordered).startswith("rank 1 call 0:")
    other_backend = [made, made, made, made[:2] + [((0, 2), "nccl")]]
    assert group_order_mismatch(other_backend).startswith("rank 3 call 2:")


def test_spawned_ranks_import_no_jax(runs):
    """The spawned ranks import no jax (rank 0 is this process)."""
    for world in (2, 4):
        assert case(runs, world, "jax_imported")[1:] == [0.0] * (world - 1)


def test_init_training_group_binds_no_card(monkeypatch):
    """NCCL ranks join a process group with no `device_id`: each NCCL group
    then makes its communicator among its own ranks, and a gloo group of
    some ranks costs the others nothing.  They also turn NCCL's graph
    mixing off unless the environment sets it."""
    import torch.distributed as dist

    seen = {}
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: seen.setdefault("set", dev))
    monkeypatch.setattr(distributed, "_GROUP_TIMEOUT_S", None)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", "")  # restored after the test
    monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT")
    dev, backend = distributed.init_training_group(1, 2, "tcp://localhost:1", timeout_s=30)
    assert backend == "nccl" and dev == torch.device("cuda", 1) and seen["set"] == dev
    assert seen["backend"] == "nccl" and "device_id" not in seen
    # a captured collective holds no event node, so an IF node's body takes it
    assert os.environ["NCCL_GRAPH_MIXING_SUPPORT"] == "0"


class _Group(object):
    def __init__(self, name="7", ranks=(2, 3)):
        self.group_name, self.ranks = name, list(ranks)


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_search_run_takes_the_graph_on_nccl_and_the_eager_loop_on_gloo(backend, monkeypatch):
    """A model group over NCCL searches on the card's replayed graph, its
    key naming the mesh's graph group (the captured step's communicator);
    over gloo (no graph can capture its host round trips), the eager
    loop; eager_loop=True and CPU tensors the eager loop on either.  An
    NCCL model group with no graph group raises."""
    import torch.distributed as dist

    _, model = weights()
    group, twin = _Group("7"), _Group("8")
    monkeypatch.setattr(model.textual, "tp_group", group)
    monkeypatch.setattr(model.textual, "graph_group", twin if backend == "nccl" else None)
    monkeypatch.setattr(dist, "get_backend", lambda g: backend if g is group else "?")
    monkeypatch.setattr(dist, "get_process_group_ranks", lambda g: g.ranks)
    keys = []
    monkeypatch.setattr(device_loop, "run", lambda owner, key, *a: keys.append((owner, key)))
    on_card = types.SimpleNamespace(is_cuda=True)
    run = model._search_run(on_card, False, ("beam", 4))
    assert model._search_run(on_card, True, ("beam", 4)) is None
    assert model._search_run(torch.zeros(1), False, ("beam", 4)) is None
    assert comm.capturable(None) and comm.capturable(group) == (backend == "nccl")
    if backend == "gloo":
        assert run is None
        return
    run("state", "step", "running", "result", 5)
    assert keys == [(model, ("beam", 4, ("8", (2, 3))))]
    assert isinstance(model, PortModel)
    monkeypatch.setattr(model.textual, "graph_group", None)
    with pytest.raises(RuntimeError, match="graph group"):
        model._search_run(on_card, False, ("beam", 4))


def _fake_world(monkeypatch, world, rank, backend):
    """torch.distributed as `make_mesh` sees it on global rank `rank` of
    `world`, every group of `backend`: new_group records (ranks,
    backend) and returns a new _Group."""
    import torch.distributed as dist

    calls = []

    def new_group(ranks, backend=None, timeout=None):
        calls.append((tuple(ranks), backend))
        return _Group(str(len(calls)), ranks)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "get_backend", lambda g=None: backend)
    monkeypatch.setattr(dist, "new_group", new_group)
    return calls


# mesh_shape, world size, the groups made under NCCL and under gloo: each
# model group (with its twin under NCCL), each data group, the hosts' group
MESH_SHAPES = {"1x2": ([1, 2], 2, 2, 1), "2x2": ([2, 2], 4, 6, 4),
               "hosts_2x[1,2]": ([1, 2], 4, 5, 3)}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("shape", sorted(MESH_SHAPES))
def test_nccl_model_groups_get_a_graph_group_in_lockstep(shape, backend, monkeypatch):
    """Under NCCL every model group of m > 1 has a twin over the same
    ranks (`Mesh.graph_group`), which only a captured decode step uses:
    with NCCL's graph mixing off, the model group's eager collectives
    may not share a communicator with an outstanding graph launch.
    Every rank makes every host's groups, twins included, in one order
    (no card: torch.distributed mocked).  Over gloo there is no twin."""
    from gitax_torch.parallel.mesh import make_mesh_from_shape

    mesh_shape, world, n_nccl, n_gloo = MESH_SHAPES[shape]
    seqs = []
    for rank in range(world):
        calls = _fake_world(monkeypatch, world, rank, backend)
        mesh = make_mesh_from_shape(mesh_shape, device="cpu", backend=backend)
        seqs.append(calls)
        if backend == "gloo":
            assert mesh.graph_group is None
            continue
        assert mesh.graph_group is not mesh.model_group
        assert mesh.graph_group.ranks == mesh.model_group.ranks
        assert rank in mesh.model_group.ranks and len(mesh.model_group.ranks) == mesh.model
    assert all(s == seqs[0] for s in seqs)
    assert len(seqs[0]) == (n_nccl if backend == "nccl" else n_gloo)


class _Recorder(object):
    """comm.all_reduce over a group of one rank, recording each call's
    group."""

    def __init__(self):
        self.groups = []

    def __call__(self, t, group):
        self.groups.append(group)
        return t


@pytest.mark.parametrize("mode", ["beam", "greedy"])
def test_captured_steps_sum_over_the_graph_group(mode, monkeypatch):
    """The search's steps under `device_loop` (here its schedule on the
    host) send their all-reduces over the graph group and the prefill
    over the model group; the eager loop sends every one over the model
    group.  Either way the tokens are the unsharded model's (an all-reduce
    over one rank is the identity)."""
    from test_torch_port_device_loop import host_schedule

    _, model = weights()
    x = torch.from_numpy(images())
    kw = (dict(beam=BeamSearchConfig(num_beams=4, max_steps=10)) if mode == "beam"
          else dict(mode="greedy", max_steps=10))
    ref, _ = model.generate(x, **kw)
    group, twin = _Group("7"), _Group("8")
    monkeypatch.setattr(model.textual, "tp_group", group)
    monkeypatch.setattr(model.textual, "graph_group", twin)
    rec = _Recorder()
    monkeypatch.setattr(comm, "all_reduce", rec)
    eager, _ = model.generate(x, **kw)
    assert rec.groups and set(rec.groups) == {group}
    n_prefill = 2 * CFG.num_layers
    launches, bodies = [], []
    monkeypatch.setattr(PortModel, "_search_run", host_schedule(launches, bodies))
    rec.groups.clear()
    graph, _ = model.generate(x, **kw)
    assert rec.groups[:n_prefill] == [group] * n_prefill
    assert rec.groups[n_prefill:] == [twin] * (2 * CFG.num_layers * len(bodies))
    assert len(bodies) > 0
    np.testing.assert_array_equal(eager.numpy(), ref.numpy())
    np.testing.assert_array_equal(graph.numpy(), ref.numpy())
