"""The port's dynamic batcher and HTTP endpoint (CPU, a tiny model):
gitax's tests/test_serving.py cases on the port's engine and batcher,
with the same fake engines where gitax uses them (straggler coalescing,
the hard cap, zero-valued knobs, open-loop overload); replies equal to
gitax's batcher's on the same weights in f32, captions and questions;
the endpoint on an ephemeral localhost port (200, 400, 413, 503,
/healthz, /stats); `to_host`; the refusals (`mesh_shape`,
`use_native=True` where the native loader did not build, no card); `serve_caption` resolving the card under
mocked CUDA; and the copy held to gitax's: the batching policy's code and
its knobs' arithmetic."""

import ast
import base64
import functools
import http.client
import inspect
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

import jax
import jax.numpy as jnp
import torch

import gitax.runtime.serving as gx_serving
from gitax.decode import BeamSearchConfig as GxBeam
from gitax.models import GitConfig, GitModel, ViTConfig
from gitax.preprocess import TestTransform as GxTestTransform
from gitax.runtime import CaptionEngine as GxEngine
from gitax.tokenization import BertTokenizer as GxTokenizer
from gitax.tokenization import build_tiny_vocab as gx_tiny_vocab
from gitax_torch import ckpt, inference, serve
from gitax_torch.decode.beam import BeamSearchConfig
from gitax_torch.io.image import image_from_base64
from gitax_torch.preprocess import transforms as pt_transforms
from gitax_torch.preprocess.transforms import center_crop, resize_shorter
from gitax_torch.runtime import serving
from gitax_torch.runtime.engine import CaptionEngine
from gitax_torch.runtime.serving import DynamicBatcher, OverloadedError, ServingStats
from gitax_torch.serve import MAX_BODY_BYTES, make_http_server
from gitax_torch.tokenization import BertTokenizer, build_tiny_vocab

TINY = GitConfig(
    encoder=ViTConfig(16, 64, 2, 2, 32),
    visual_feature_size=64,
    vocab_size=30522,
    hidden_size=48,
    num_layers=2,
    num_heads=4,
    feedforward_size=96,
    max_caption_length=64,  # the engine's buffer: prefix + max_text_len 40
)
QUESTION = "the0 the1"  # tiny-vocab words: a multi-token prefix


def jpeg_b64(seed, size=(40, 50)):
    rng = np.random.RandomState(seed)
    img = Image.fromarray(rng.randint(0, 255, (size[1], size[0], 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


@functools.lru_cache(maxsize=None)
def gitax_params():
    """Random TINY weights with the visual projection and the attention
    x10, so that captions depend on the image."""
    params = GitModel(TINY).init_params(jax.random.PRNGKey(0))
    tx = params["textual"]
    tx["visual_projection"]["linear"]["kernel"] = tx["visual_projection"]["linear"]["kernel"] * 10
    for name in ("qkv", "out"):
        tx["blocks"]["attn"][name]["kernel"] = tx["blocks"]["attn"][name]["kernel"] * 10
    return params


def port_engine():
    params = jax.tree_util.tree_map(np.asarray, gitax_params())
    return CaptionEngine(ckpt.params_from_gitax(params, TINY, device="cpu"),
                         BertTokenizer(build_tiny_vocab()), batch_size=4,
                         beam=BeamSearchConfig(num_beams=2, max_steps=8), dtype=torch.float32,
                         transform=pt_transforms.TestTransform(crop_size=32))


@pytest.fixture(scope="module")
def engine():
    eng = port_engine()
    yield eng
    eng.close()


def direct_captions(engine, payloads, question=""):
    imgs = [engine.transform(image_from_base64(p)) for p in payloads]
    prefix = engine.encode_prefix(question)
    return engine.generate_batch(imgs, [prefix] * len(imgs))


# ---------------------------------------------------------------------------
# gitax's cases on the port's engine
# ---------------------------------------------------------------------------


def test_batched_captions_match_direct(engine):
    payloads = [jpeg_b64(i) for i in range(4)]
    want = direct_captions(engine, payloads)
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=500)
    try:
        futs = [batcher.submit(p) for p in payloads]
        got = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert got == want
    assert len(set(got)) > 1  # the captions depend on the image
    snap = batcher.stats.snapshot()
    # 4 concurrent requests became ONE full device batch
    assert snap["requests"] == 4
    assert snap["batches"] == 1
    assert snap["batch_size_hist"] == {4: 1}
    assert snap["padded_slots"] == 0


def test_partial_batch_pads_to_bucket(engine):
    payloads = [jpeg_b64(10 + i) for i in range(3)]
    want = direct_captions(engine, payloads)
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=60)
    try:
        futs = [batcher.submit(p) for p in payloads]
        got = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert got == want
    snap = batcher.stats.snapshot()
    assert snap["requests"] == 3
    assert sum(snap["batch_size_hist"].values()) == snap["batches"]
    assert all(b in (1, 2, 4) for b in snap["batch_size_hist"])


def test_vqa_groups_by_prefix_length(engine):
    """Different prefix lengths never share a dispatch, and answers match
    the direct engine path."""
    payloads = [jpeg_b64(20), jpeg_b64(21)]
    want_cap = direct_captions(engine, payloads)
    want_qa = direct_captions(engine, payloads, question=QUESTION)
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=60)
    try:
        futs = [batcher.submit(p) for p in payloads]
        futs += [batcher.submit(p, question=QUESTION) for p in payloads]
        got = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert got[:2] == want_cap
    assert got[2:] == want_qa
    assert batcher.stats.snapshot()["batches"] >= 2


def test_submit_rejects_bad_payload(engine):
    batcher = DynamicBatcher(engine, max_batch=2, max_wait_ms=10)
    try:
        with pytest.raises(ValueError, match="undecodable"):
            batcher.submit("not-a-real-image!!")
    finally:
        batcher.close()


def test_overload_rejects_and_accepted_complete(engine):
    """Admission control: with max_queue requests waiting the next submit
    raises OverloadedError; requests accepted before still complete."""
    batcher = DynamicBatcher(engine, max_batch=64, max_wait_ms=60_000, max_queue=5)
    try:
        payload = jpeg_b64(50)
        accepted = [batcher.submit(payload) for _ in range(5)]
        assert batcher.queue_depth() == 5
        for _ in range(2):
            with pytest.raises(OverloadedError):
                batcher.submit(payload)
        snap = batcher.snapshot()
        assert (snap["rejected"], snap["queue_depth"], snap["max_queue"]) == (2, 5, 5)
    finally:
        batcher.close(timeout=120)
    results = [f.result(timeout=120) for f in accepted]
    assert all(isinstance(r, str) for r in results)
    assert batcher.queue_depth() == 0


def test_uint8_and_float_requests_never_share_a_batch(engine):
    """uint8 rows (normalised on the device) and float rows (the
    transform's output) of one shape dispatch separately."""
    payloads = [jpeg_b64(60), jpeg_b64(61)]
    pils = [image_from_base64(p) for p in payloads]
    float_arrs = [np.asarray(engine.transform(im), np.float32) for im in pils]
    u8_arrs = [np.asarray(center_crop(resize_shorter(im, 32), 32), np.uint8) for im in pils]
    want_float = engine.generate_batch(float_arrs, [[101]] * 2)
    want_u8 = engine.generate_batch(u8_arrs, [[101]] * 2)
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=200)
    try:
        futs = [batcher.submit_array(a, [101]) for a in float_arrs]
        futs += [batcher.submit_array(a, [101]) for a in u8_arrs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        batcher.close()
    assert got[:2] == want_float
    assert got[2:] == want_u8
    assert batcher.stats.snapshot()["batches"] >= 2


def test_warm_runs_every_bucket(engine, monkeypatch):
    """warm() runs one search per bucket size and prefix length, on the
    transform's own output shape and dtype."""
    seen = []
    orig = engine.dispatch_device_batch

    def spy(imgs, pref):
        seen.append((imgs.shape, imgs.dtype, pref.shape))
        return orig(imgs, pref)

    monkeypatch.setattr(engine, "dispatch_device_batch", spy)
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=10)
    try:
        batcher.warm(prefix_lens=(1, 3))
    finally:
        batcher.close()
    assert [(s[0][0], s[2]) for s in seen] == [(b, (b, tp)) for tp in (1, 3) for b in (1, 2, 4)]
    assert all(s[0][1:] == (32, 32, 3) and s[1] == np.float32 for s in seen)


def test_close_drains_queued_requests(engine):
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=2000)
    fut = batcher.submit(jpeg_b64(30))
    batcher.close()  # close while the group is still aging
    assert isinstance(fut.result(timeout=120), str)


def test_to_host_on_a_cpu_engine(engine):
    seqs = torch.tensor([[101, 7, 102], [101, 8, 102]])
    out = engine.to_host(seqs)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, seqs.numpy())


# ---------------------------------------------------------------------------
# replies equal to gitax's batcher on the same weights
# ---------------------------------------------------------------------------


def test_replies_equal_gitax_batcher_replies(engine):
    gx_engine = GxEngine(GitModel(TINY), gitax_params(), GxTokenizer(gx_tiny_vocab()),
                         GxTestTransform(crop_size=32), batch_size=4,
                         beam=GxBeam(num_beams=2, max_steps=8), dtype=jnp.float32,
                         use_native=False)
    payloads = [jpeg_b64(70 + i) for i in range(4)]
    replies = {}
    for name, eng, batcher_cls in (("gitax", gx_engine, gx_serving.DynamicBatcher),
                                   ("port", engine, DynamicBatcher)):
        batcher = batcher_cls(eng, max_batch=4, max_wait_ms=500)
        try:
            futs = [batcher.submit(p) for p in payloads]
            futs += [batcher.submit(p, question=QUESTION) for p in payloads]
            replies[name] = [f.result(timeout=300) for f in futs]
            replies[name + "_hist"] = batcher.stats.snapshot()["batch_size_hist"]
        finally:
            batcher.close(timeout=300)
    assert replies["port"] == replies["gitax"]
    assert replies["port_hist"] == replies["gitax_hist"] == {4: 2}
    assert len(set(replies["port"][:4])) > 1


# ---------------------------------------------------------------------------
# the batching policy on fake engines (gitax's timing cases)
# ---------------------------------------------------------------------------


class _SlowFakeEngine(object):
    """Deterministic device stand-in: records dispatch batch sizes and
    sleeps a fixed per-batch 'compute' time."""

    class _Tok(object):
        @staticmethod
        def decode(ids, skip_special_tokens=True):
            return "cap"

    def __init__(self, batch_size=8, compute_s=0.3):
        self.batch_size = batch_size
        self.compute_s = compute_s
        self.tokenizer = self._Tok()
        self.dispatched = []  # real (pre-padding) sizes, in order
        self.lock = threading.Lock()

    def dispatch_device_batch(self, imgs, pref):
        with self.lock:
            self.dispatched.append(len(imgs))
        time.sleep(self.compute_s)
        return torch.full((len(imgs), 4), 102, dtype=torch.long)

    @staticmethod
    def to_host(seqs):
        return seqs.numpy()


def test_straggler_coalesces_while_device_busy():
    """A sub-full group does not age out into its own dispatch while a
    batch is still in flight."""
    fake = _SlowFakeEngine(batch_size=8, compute_s=0.4)
    batcher = DynamicBatcher(fake, max_batch=8, max_wait_ms=20, max_hold_ms=5000)
    img = np.zeros((8, 8, 3), np.uint8)
    try:
        first = [batcher.submit_array(img, [101]) for _ in range(8)]
        time.sleep(0.05)   # the full batch is dispatched (0.4 s compute)
        straggler = batcher.submit_array(img, [101])
        time.sleep(0.1)    # straggler is 100 ms > max_wait old, device busy
        wave = [batcher.submit_array(img, [101]) for _ in range(7)]
        for f in first + [straggler] + wave:
            f.result(timeout=30)
    finally:
        batcher.close()
    # the port's dispatch returns after the search, so the straggler and
    # the wave queue up during it and form one group: two dispatches of 8
    assert fake.dispatched == [8, 8], fake.dispatched


def test_subfull_group_dispatches_when_idle():
    fake = _SlowFakeEngine(batch_size=8, compute_s=0.01)
    batcher = DynamicBatcher(fake, max_batch=8, max_wait_ms=20, max_hold_ms=5000)
    try:
        t0 = time.monotonic()
        batcher.submit_array(np.zeros((8, 8, 3), np.uint8), [101]).result(timeout=30)
        elapsed = time.monotonic() - t0
    finally:
        batcher.close()
    assert fake.dispatched == [1]
    assert elapsed < 2.0, elapsed


def flood_and_time_lone_request(open_loop):
    """Keep group B busy (closed loop: full batches resubmitted on
    completion; open loop: >= 2 batches always queued) and time one
    group-A request; returns (seconds it waited, dispatched sizes)."""
    fake = _SlowFakeEngine(batch_size=4, compute_s=0.02 if open_loop else 0.05)
    batcher = DynamicBatcher(fake, max_batch=4, max_wait_ms=20, max_hold_ms=300,
                             max_queue=1000 if open_loop else None)
    img_a = np.zeros((8, 8, 3), np.uint8)
    img_b = np.zeros((16, 16, 3), np.uint8)  # another group key
    stop = threading.Event()

    def flood():
        backlog = []
        while not stop.is_set():
            if open_loop:
                while batcher.queue_depth() < 8 and not stop.is_set():
                    backlog.append(batcher.submit_array(img_b, [101]))
                time.sleep(0.002)
            else:
                for f in [batcher.submit_array(img_b, [101]) for _ in range(4)]:
                    f.result(timeout=30)
        for f in backlog:
            f.result(timeout=60)

    t = threading.Thread(target=flood, daemon=True)
    t.start()
    try:
        time.sleep(0.1)  # flood established
        t0 = time.monotonic()
        batcher.submit_array(img_a, [101]).result(timeout=30)
        waited = time.monotonic() - t0
    finally:
        stop.set()
        t.join(timeout=60)
        batcher.close(timeout=120)
    assert not t.is_alive()
    return waited, fake.dispatched


@pytest.mark.parametrize("open_loop", [False, True], ids=["closed_loop", "open_loop"])
def test_lone_group_dispatches_by_max_hold_under_load(open_loop):
    """gitax's hard-cap and open-loop overload cases: while another group
    keeps the device busy (or always has a full group queued), a lone
    sub-full group still dispatches by max_hold (300 ms) plus one compute
    and slack."""
    waited, dispatched = flood_and_time_lone_request(open_loop)
    assert waited < 2.0, waited
    assert 1 in dispatched


def test_zero_valued_knobs_are_honored():
    """max_hold_ms=0 means no hold beyond max_wait and max_queue=0 rejects
    everything: a falsy zero does not fall back to the defaults."""
    fake = _SlowFakeEngine(batch_size=8, compute_s=0.01)
    b = DynamicBatcher(fake, max_batch=8, max_wait_ms=20, max_hold_ms=0)
    try:
        assert b.max_hold == pytest.approx(b.max_wait)
    finally:
        b.close()
    b2 = DynamicBatcher(fake, max_batch=8, max_wait_ms=20, max_queue=0)
    try:
        with pytest.raises(OverloadedError):
            b2.submit_array(np.zeros((8, 8, 3), np.uint8), [101])
    finally:
        b2.close()


# ---------------------------------------------------------------------------
# the copy held to gitax's
# ---------------------------------------------------------------------------


def _defs(module):
    """{qualified name: ast dump without docstrings} of a module's
    top-level functions, classes and methods."""
    tree = ast.parse(inspect.getsource(module))
    out = {}

    def strip(node):
        body = getattr(node, "body", None)
        if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
        return node

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(strip(node))
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        out[node.name + "." + sub.name] = ast.dump(strip(sub))
    return out


# the batcher's framework-free parts: the policy, admission control, the
# stats and the shutdown; what differs (thread targets, to_host, the
# constructor's comments) is listed in the copy's docstring
SAME = ["OverloadedError", "ServingStats", "_Request", "DynamicBatcher.submit_array",
        "DynamicBatcher.submit", "DynamicBatcher.caption", "DynamicBatcher.queue_depth",
        "DynamicBatcher.snapshot", "DynamicBatcher._oldest_key", "DynamicBatcher._full_key",
        "DynamicBatcher._wait_for_group", "DynamicBatcher._loop", "DynamicBatcher.close"]


def test_batching_code_is_gitax_copy():
    ours, theirs = _defs(serving), _defs(gx_serving)
    for name in SAME:
        assert ours[name] == theirs[name], name
    assert serving.DEFAULT_BUCKETS == gx_serving.DEFAULT_BUCKETS
    assert set(ours) - set(theirs) == {"DynamicBatcher._on_card"}


@pytest.mark.parametrize("kw", [
    dict(), dict(max_batch=6, max_wait_ms=1.0), dict(max_batch=3, buckets=(2, 5, 8)),
    dict(max_batch=16, max_hold_ms=0), dict(max_wait_ms=10, max_hold_ms=30, max_queue=0),
    dict(max_batch=1, buckets=())])
def test_batcher_knobs_match_gitax(kw):
    fake = _SlowFakeEngine(batch_size=8)
    ours, theirs = DynamicBatcher(fake, **kw), gx_serving.DynamicBatcher(fake, **kw)
    try:
        for attr in ("max_batch", "max_wait", "max_hold", "buckets", "max_queue"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert ours.snapshot() == theirs.snapshot()
    finally:
        ours.close()
        theirs.close()


def test_stats_snapshot_matches_gitax():
    ours, theirs = ServingStats(), gx_serving.ServingStats()
    for s in (ours, theirs):
        s.record_requests(5)
        s.record_batch(3, 4, group_key=(1, 32, 32, "f"))
        s.record_batch(4, 4)
        s.record_error()
        s.record_rejected()
    assert ours.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------------
# the HTTP endpoint
# ---------------------------------------------------------------------------


def post(base, body, timeout=120):
    req = urllib.request.Request(base + "/v1/caption", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class served(object):
    """make_http_server on an ephemeral localhost port, in a thread."""

    def __init__(self, batcher, name="TINY_TEST"):
        self.httpd = make_http_server(batcher, name, host="127.0.0.1", port=0)
        self.port = self.httpd.server_address[1]
        self.base = "http://127.0.0.1:%d" % self.port
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def test_http_endpoint(engine):
    batcher = DynamicBatcher(engine, max_batch=4, max_wait_ms=20)
    try:
        with served(batcher) as srv:
            payload = jpeg_b64(40)
            want = direct_captions(engine, [payload])[0]
            assert post(srv.base, json.dumps({"image": payload}).encode()) == \
                (200, {"caption": want})
            want_qa = direct_captions(engine, [payload], question=QUESTION)[0]
            assert post(srv.base, json.dumps({"image": payload, "question": QUESTION}).encode()) \
                == (200, {"caption": want_qa})
            with urllib.request.urlopen(srv.base + "/healthz", timeout=30) as r:
                assert json.loads(r.read()) == {"ok": True, "model": "TINY_TEST"}
            with urllib.request.urlopen(srv.base + "/stats", timeout=30) as r:
                snap = json.loads(r.read())
            assert snap["requests"] == 2 and snap["batches"] == 2 and snap["errors"] == 0
            code, _ = post(srv.base, b"{}")
            assert code == 400
            code, reply = post(srv.base, json.dumps({"image": "bm90IGFuIGltYWdl"}).encode())
            assert code == 400 and "undecodable" in reply["error"]
    finally:
        batcher.close()


def test_http_error_mapping():
    """OverloadedError -> 503; an oversized Content-Length -> 413 and a
    negative one -> 400, both closing the connection (the body is never
    read)."""
    class StubBatcher(object):
        stats = ServingStats()

        def snapshot(self):
            return self.stats.snapshot()

        def caption(self, *a, **k):
            raise OverloadedError("pending queue full (64 requests)")

    with served(StubBatcher(), "STUB") as srv:
        code, reply = post(srv.base, json.dumps({"image": "aGk="}).encode(), timeout=30)
        assert code == 503 and "queue full" in reply["error"]
        for length, want in ((MAX_BODY_BYTES + 1, 413), (-5, 400)):
            conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
            conn.putrequest("POST", "/v1/caption")
            conn.putheader("Content-Length", str(length))
            conn.putheader("Content-Type", "application/json")
            conn.endheaders()
            resp = conn.getresponse()
            assert resp.status == want
            assert resp.getheader("Connection") == "close"
            conn.close()
        with urllib.request.urlopen(srv.base + "/stats", timeout=30) as r:
            assert json.loads(r.read())["requests"] == 0


def test_http_accepts_a_burst_of_connections():
    """48 clients connecting at once are all served: the listen backlog
    (128) holds the connections the server has not accepted yet, where
    socketserver's default of 5 resets them."""
    class SlowBatcher(object):
        stats = ServingStats()

        def snapshot(self):
            return self.stats.snapshot()

        def caption(self, *a, **k):
            time.sleep(0.2)
            return "cap"

    body = json.dumps({"image": "aGk="}).encode()
    replies = [None] * 48
    with served(SlowBatcher(), "STUB") as srv:
        start = threading.Barrier(len(replies))

        def send(i):
            start.wait()
            try:
                replies[i] = post(srv.base, body, timeout=60)
            except OSError as e:
                replies[i] = repr(e)

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(replies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    assert replies == [(200, {"caption": "cap"})] * len(replies)


# ---------------------------------------------------------------------------
# the entry points: refusals and the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,error,match", [
    (dict(mesh_shape=2, device=None), ValueError, r"mesh_shape \[2, 1\] needs 2 cards"),
    (dict(use_native=True, device="cpu"), RuntimeError, "use_native")])
def test_build_serving_stack_refuses_what_is_not_ported(kw, error, match, monkeypatch):
    """use_native=True where the native loader did not build raises,
    naming the build's reason; mesh_shape on the card with more ranks than
    cards raises before any rank starts, unless share_card asks for one
    shared card (CUDA mocked: one card)."""
    from gitax_torch import native

    for k in ("RANK", "WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(native, "_module", None)
    monkeypatch.setattr(native, "_error", "RuntimeError: g++ exit 1: jpeglib.h missing")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(error, match=match):
        serve.build_serving_stack("GIT_BASE", **kw)
    with pytest.raises(error, match=match):
        serve.serve_caption("GIT_BASE", **kw)


def test_serving_stack_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """device='cpu' builds the stack on the CPU (random init: no
    checkpoint in the working directory), the model in the asked dtype."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(inference, "config_from_param", lambda param: TINY)
    engine, batcher = serve.build_serving_stack("GIT_BASE", batch_size=2, dtype="float32",
                                                max_steps=6, max_text_len=6, device="cpu")
    try:
        assert engine.device == torch.device("cpu") and engine.dtype == torch.float32
        assert batcher.max_batch == 2 and batcher.buckets == [1, 2]
        assert isinstance(batcher.caption(jpeg_b64(3), timeout=120), str)
    finally:
        batcher.close()
        engine.close()


@pytest.mark.parametrize("env,want", [
    ({}, "cuda"), ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "cuda:1")])
def test_serve_caption_resolves_the_card(env, want, monkeypatch):
    """With no device, serve_caption builds on this process's card, as
    the CLI does (CUDA mocked: the CPU-only torch then refuses the CUDA
    parameters); without a card it raises."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "OMPI_COMM_WORLD_RANK",
              "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    resolved = []
    orig = inference._process_device

    def spy(device=None):
        resolved.append(orig(device))
        return resolved[-1]

    monkeypatch.setattr(inference, "_process_device", spy)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(AssertionError, match="CUDA"):
        serve.serve_caption("GIT_BASE", warmup=False)
    assert resolved == [torch.device(want)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve_caption("GIT_BASE", warmup=False)
