"""Row shards over hosts, w8a8 on a mesh and the mesh groups' timeouts, on
gloo CPU ranks (CPU, f32).

gitax runs one mesh per host and splits a TSV's rows over the hosts
(gitax/inference.py:226-230, gitax/parallel/mesh.py:36-48; gitax's
tests/test_multihost_distributed.py).  The port does the same under a
launch of H x data x model ranks: one launch of 4 gloo CPU ranks
(`runtime.distributed.spawn_ranks`, rank 0 in this process; the ranks are
`tests/torch_parallel_worker.py::hosts_main`, which imports no jax) runs
every case once, in a module fixture:

* the CLI's TSV loops (captions and VQA) on 2 hosts x [2, 1] and 2 hosts
  x [1, 2]: each host's rank 0 writes its row shard, host 0 joins them
  after a barrier of the hosts' rank 0s, and the bytes equal one
  process's;
* the w8a8 encoder (`quantize_git_model_(encoder=True)`) on 2 hosts x
  [1, 2] and on [2, 2]: one process's tokens on every host;
* a w8a8 row-parallel layer whose rows keep their amax on one model rank
  or the other: one process's output bit for bit (the amax is
  all-reduced, the int32 partials summed).

Then, without the group: a launch that is not a multiple of data x model
raises, and so does a LOCAL_WORLD_SIZE other than data x model; a
follower that hangs (sleeps) makes rank 0's collective on each group the
mesh and the engine make (the model group, the data group, the engine's
batch channel) raise at the group's timeout, not when the follower exits.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from gitax_torch import ckpt
from gitax_torch import inference as pt_inf
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.ops.int8_dynamic import int8_dynamic_matmul, quantize_rows_reference
from gitax_torch.ops.quant import quantize_git_model_, quantize_linear
from gitax_torch.runtime import distributed
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab
from test_torch_port_cli import WORDS as CLI_WORDS
from test_torch_port_mesh_engine import cli_dir, wide_configs
from test_torch_port_parallel import port_cfg
from test_torch_port_tsv import TINY, assert_same_tsv, tiny_params

W8A8_BEAM = dict(num_beams=2, max_steps=10)
SLEEP_TIMEOUT_S = 3.0


def row_case():
    """x [8, 64] whose rows 0-3 keep their amax in the first half of K and
    rows 4-7 in the second, and a quantized [64, 16] layer."""
    rng = np.random.RandomState(5)
    x = rng.randn(8, 64).astype(np.float32)
    for i in range(8):
        x[i, (i % 4) + (0 if i < 4 else 32)] = 9.0 + i
    q = quantize_linear({"kernel": rng.randn(64, 16).astype(np.float32) * 0.1})
    return {"x": torch.from_numpy(x),
            "w_q8_t": torch.from_numpy(q["kernel_q8"]).t().contiguous().t(),
            "scale": torch.from_numpy(q["kernel_scale"]),
            "bias": torch.from_numpy(rng.randn(16).astype(np.float32) * 0.1)}


def w8a8_weights():
    return {n: t.clone() for n, t in ckpt.params_from_gitax(tiny_params(), TINY,
                                                           device="cpu").state_dict().items()}


def w8a8_images():
    return np.random.RandomState(17).randn(4, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("hosts"))
    job = {
        "cli": {"dir": cli_dir(tmp_path_factory.mktemp("hosts_cli")), "words": CLI_WORDS,
                "cfg": wide_configs()[1]},
        "w8a8": {"cfg": port_cfg(TINY), "weights": w8a8_weights(), "images": w8a8_images(),
                 "beam": W8A8_BEAM},
        "row": row_case(),
    }
    torch.save(job, os.path.join(d, "hosts_job.pt"))
    out = {"job": job}
    threads = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            mp.delenv(k, raising=False)
        mp.setattr(distributed, "_GROUP_TIMEOUT_S", None)  # rank 0's group is this process's
        try:
            distributed.spawn_ranks("torch_parallel_worker:hosts_main", 4, (d,))
            out["results"] = torch.load(os.path.join(d, "hosts.pt"), weights_only=False)
        except Exception as e:  # each test reports it
            out["results"] = {"error": repr(e)}
        finally:
            torch.set_num_threads(threads)
    return out


def case(runs, name):
    results = runs["results"]
    assert "error" not in results, results.get("error")
    got = results[name]
    assert not (isinstance(got, dict) and "error" in got), got["error"]
    return got


_ONE = {}


def one_process_tsv(cli, loop, monkeypatch):
    """The port's CLI in one process (no mesh, no row shards) on the same
    checkpoint and TSVs."""
    if loop not in _ONE:
        monkeypatch.chdir(cli["dir"])
        monkeypatch.setattr(pt_inf, "config_from_param", lambda param=None: cli["cfg"])
        monkeypatch.setattr(pt_inf, "_load_tokenizer",
                            lambda: BertTokenizer(build_tiny_vocab(cli["words"])))
        for k in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(k, raising=False)
        out = "one_{}.tsv".format(loop)
        pt_inf.test_git_inference_single_tsv("img.tsv", "TINY_CAP",
                                             "q.tsv" if loop == "vqa" else None, out,
                                             batch_size=2, dtype="float32", device="cpu")
        _ONE[loop] = os.path.join(cli["dir"], out)
    return _ONE[loop]


@pytest.mark.parametrize("loop,shape", [("caption", "2x1"), ("vqa", "2x1"), ("caption", "1x2"),
                                        ("vqa", "1x2")])
def test_row_shards_over_hosts_match_one_process(runs, monkeypatch, loop, shape):
    """2 hosts x mesh_shape: each host's engine on its rows, the shards
    joined by host 0: one process's TSV, byte for byte."""
    got = case(runs, "hosts_{}_{}".format(loop, shape))
    assert_same_tsv(one_process_tsv(runs["job"]["cli"], loop, monkeypatch), got)
    assert len(open(got).read().splitlines()) == (10 if loop == "vqa" else 5)
    for h in range(2):
        assert os.path.isfile("{}.{}.2.tsv".format(got, h))  # each host wrote its shard


@pytest.fixture(scope="module")
def w8a8_one_process():
    model = quantize_git_model_(ckpt.params_from_gitax(tiny_params(), TINY, device="cpu"),
                                encoder=True)
    seqs, _ = model.generate(torch.from_numpy(w8a8_images()), beam=BeamSearchConfig(**W8A8_BEAM))
    return seqs.numpy()


@pytest.mark.parametrize("shape,hosts", [("1x2", 2), ("2x2", 1)])
def test_w8a8_mesh_tokens_match_one_process(runs, w8a8_one_process, shape, hosts):
    """The w8a8 model quantized whole, then split (the fused qkv by heads,
    `c_fc` by columns, `out_proj` and `c_proj` by rows, each row-parallel
    product on the row's whole amax): one process's tokens on each host."""
    got = case(runs, "w8a8_" + shape)
    assert sorted(got) == list(range(hosts))
    for h in range(hosts):
        np.testing.assert_array_equal(got[h], w8a8_one_process)
    assert len({tuple(r) for r in w8a8_one_process.tolist()}) > 1


def test_w8a8_row_parallel_takes_the_rows_amax(runs):
    """A row-parallel w8a8 layer on [1, 2], rows whose amax lies on either
    rank: one process's output bit for bit; a rank that quantized with its
    own shard's amax would not give it."""
    got = case(runs, "w8a8_row")
    row = runs["job"]["row"]
    want = int8_dynamic_matmul(row["x"], row["w_q8_t"], row["scale"], row["bias"])
    assert torch.equal(got, want)
    halves = row["x"].abs().reshape(8, 2, 32).amax(-1)
    owner = halves.argmax(-1)
    assert owner.tolist() == [0] * 4 + [1] * 4
    # the same layer with each rank's own amax: other codes, another output
    local = sum(
        (quantize_rows_reference(row["x"][:, r * 32:(r + 1) * 32])[0].double()
         @ row["w_q8_t"][r * 32:(r + 1) * 32].double())
        * quantize_rows_reference(row["x"][:, r * 32:(r + 1) * 32])[1][:, None].double()
        for r in range(2))
    naive = (local * row["scale"].double()).float() + row["bias"]
    assert not torch.equal(naive, want)


def test_spawned_ranks_import_no_jax(runs):
    assert case(runs, "jax_imported")[1:] == [0.0] * 3


def test_launch_of_another_size_raises_before_anything_starts(monkeypatch):
    """W not a multiple of data x model raises; so does a LOCAL_WORLD_SIZE
    (torchrun's processes a machine) other than data x model, since a
    host's mesh never spans machines."""
    for k in ("LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "6")
    with pytest.raises(ValueError, match="need a multiple of data x model"):
        distributed.open_inference_group([2, 2], "unused:follower", device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="never spans machines"):
        distributed.open_inference_group([2, 1], "unused:follower", device="cpu")
    import torch.distributed as dist

    assert not dist.is_initialized()


def test_a_sleeping_follower_makes_rank_0_raise_within_the_timeout(monkeypatch):
    """A follower that hangs (sleeps 60 s) instead of joining: rank 0's
    all-reduce on a [1, 2] mesh's model group, a [2, 1] mesh's data group
    and an engine's batch channel (`_Channel.world`), issued at once from
    three threads, each raises at the group's timeout (3 s) plus slack,
    not when the follower exits.  A group made without a timeout would
    take torch's default (30 min for gloo)."""
    import torch.distributed as dist

    from gitax_torch.parallel.mesh import make_mesh
    from gitax_torch.runtime.engine import _Channel

    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(distributed, "_GROUP_TIMEOUT_S", None)
    sleep_s = 60.0
    ranks = distributed.SpawnedRanks("torch_parallel_worker:sleeping_follower", 2,
                                     (SLEEP_TIMEOUT_S, sleep_s))
    raised = {}
    try:
        # the rendezvous on a long timeout: the follower may start late
        distributed.init_training_group(0, 2, ranks.init_method, device="cpu", timeout_s=120)
        dist.barrier()
        mesh = make_mesh(1, 2, device="cpu", timeout_s=SLEEP_TIMEOUT_S)
        groups = {"model": mesh.model_group,
                  "data": make_mesh(2, 1, device="cpu", timeout_s=SLEEP_TIMEOUT_S).data_group,
                  "engine": _Channel(mesh).world}
        assert all(g is not None for g in groups.values())

        def wait(name, group):
            t0 = time.perf_counter()
            try:
                dist.all_reduce(torch.ones(1), group=group)
                raised[name] = None
            except RuntimeError:
                raised[name] = time.perf_counter() - t0

        waits = [threading.Thread(target=wait, args=item) for item in groups.items()]
        for t in waits:
            t.start()
        for t in waits:
            t.join(sleep_s)
        alive = [p.is_alive() for p in ranks.procs]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        ranks.join(ok=False)
    assert sorted(raised) == ["data", "engine", "model"], raised
    for name, seconds in raised.items():
        assert seconds is not None and SLEEP_TIMEOUT_S * 0.9 <= seconds < SLEEP_TIMEOUT_S + 10, (
            name, seconds)
    assert alive == [True]  # the follower was still sleeping when rank 0 raised
