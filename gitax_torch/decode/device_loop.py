"""The device-side search: one step of a search captured as a CUDA graph
and replayed under a condition the card computes, the counterpart of
gitax's searches as one device program (`gitax/decode/beam.py:1-11`: a
`lax.while_loop`, `cond` :283-284, `while_loop` :488; `greedy.py:66`;
`trie.py:188`), whose dispatch returns before the search ends.

`run(owner, key, state, step, running, result, replays, draw, rng)` takes
a search's fresh state (its init: the prefill's cache and logits, the
sequences, scores and flags), its step (in place on the state), its
predicate (a 0-dim bool computed on the card: gitax's `cond`), its result
(new tensors read from the state) and, for a sampled search, its draw
(the step's random input from a generator):

  * The first call of a key runs one step eagerly on a side stream, the
    warm-up (cuBLAS's handle and workspace for that stream, the kernels'
    builds, bindings and shared-memory attributes, kernel 1's error flag),
    then captures one step, `step(state); steps += 1; pred =
    running(state)`, into a `torch.cuda.CUDAGraph` with a private memory
    pool, and builds from it the executable graph

        set_condition(pred)  ->  IF pred { the step }

    with CUDA's conditional nodes (`csrc/graph_if.cu`; PyTorch 2.11's
    CUDAGraph has no conditional-node methods in Python).  That state
    becomes the graph's static state.  A failed capture raises; there is
    no fallback.
  * Every later call copies its fresh state into the static state (device
    copies: the cache once, the rest small), sets pred and launches the
    graph `replays` times (the most steps the search can take).  Once
    pred is false the IF node skips the step on the card, so the host
    reads nothing and `run` returns once the launches and the result are
    enqueued.  The result is computed into new tensors on the stream, so
    the next call of the same key may overwrite the static state before
    the caller has read this one's.
  * A sampled search's draw is a second graph, captured with a generator
    of its own (`CUDAGraph.register_generator_state`) that takes the
    caller's state before the launches and hands it back after; it is
    replayed before each launch of the step (two launches a step) and
    draws at the offsets the eager loop draws at, one draw a step.  It is
    replayed whether or not the step runs, so the caller's generator ends
    where an eager search running every step would leave it.

Graphs are cached per owner (the model: they hold its weights'
addresses), keyed by the caller's key (the mode, the search settings,
the activation dtype, the kernel switches) with the shapes and dtypes of
every tensor of the state (batch, beams, keep-best, buffer length,
memory length, int8 memory, a memory bias, a trie's size), sampling, and
the addresses of the owner's decoder tensors (a model quantized or
reloaded in new storage captures anew).  At most MAX_GRAPHS per owner,
least recently used first out: a serving stack's bucket sizes times its
prefix lengths and image grids, which `warm()` captures up front.  Each
graph holds its static state (a batch's cache) and its pool.

Launch counts: a launch of the graph launches the captured kernels
without the wrappers' Python code, so `run` takes back the counts the
capture added and `settle()` adds, for each graph, the steps its
launches ran (a device counter) times the kernels one captured step
launches, to the wrappers' counts and to the owner's `decode_step_calls`
(an owner's graphs are settled as the owner goes, which waits for the
card once).  `launches` counts the graph's launches, each of which
launches `set_condition` once.

Spans (`runtime.profiling`): a miss is a `search.capture` span (the
warm-up, the capture and the LRU eviction it causes: the evicted graph's
settle and its release, graphs and pool, which wait for the card; `key`
labels the graph), and each run's copy, predicate, launches and result a
`search.launch` device span whose `steps` are the bodies its launches ran:
its end stamp copies the graph's `steps` counter (never reset: `settle`
keeps what it has taken on the host), less the graph's copy before.  An
LRU eviction marks `search.evict` (its settle's and release's ms).  No
device span sits inside a capture.

On a model group of m > 1 ranks over NCCL, one card a rank, the step's
all-reduces are captured with it (NCCL's collectives are kernels on the
card) and the IF node's body holds them.  They go over the mesh's graph
group (`parallel.mesh.Mesh.graph_group`), a communicator of their own:
with NCCL's graph mixing off, an eager call on a communicator that has
a graph launch outstanding is unsupported, and the model group's eager
collectives run while the last search's launches are queued.  The
graph group's one eager use is the warm-up, after the host has read the
predicate, so with no launch outstanding.  Every rank of the group runs
the same key at the same call, so the ranks warm up (the collectives'
first run, which makes the group's communicator) and capture together;
and each rank's predicate comes from values equal on every rank, so all
of them run or skip the body at each launch and the all-reduces inside
pair up (`GitModel._search_run`).  A failed capture raises there as
anywhere: a rank that fell back to the eager loop would leave the
others' collectives unpaired.

The encoder (`encode`): the body of `GitModel.encode_images` on a card
in inference, which eagerly enqueues some 60 small kernels a ViT-L
block, is one CUDA graph a key: the caller's key (the activation dtype,
`fast` and `flash` as resolved) with the input's shape and dtype and
TF32's switch.  A miss copies the input into a static one, runs the body
once eagerly on the side stream (the warm-up), captures it there (a
`model.encode_capture` span), then replays it; a hit copies the input in
and replays.  Either returns a clone of the static output, made before
the lock is let go: an owner's encoder graphs share one memory pool, so
the next replay of any of them may write where this one's output lies.
At most MAX_ENCODER_GRAPHS an owner, least recently used first out; a
full cache evicts for a miss only once it has replayed
ENCODER_REPLAYS_A_CAPTURE times since its last capture, and runs other
misses eagerly, so traffic of more keys than the bound captures at a
bounded rate and does not thrash.  A call that sees the encoder's
weights (the image encoder's and the clips' temporal embeddings'
addresses) elsewhere than the cache's drops the cache.  Counted in
`profiling.counters()` as encode_captures, encode_replays (hits),
encode_evictions and encode_eager (misses run eagerly), apart from the
search's captures and evictions.  The launches the warm-up and the
capture counted are taken back, and the capture's are added at each
replay, so the wrappers' counts (kernel 2's, the w8a8 encoder's) count
each call's launches as the eager body does (the warm-up's kernels run
uncounted, once a key).

The eager loop (`run_eager`, one host read a step) serves CPU tensors,
gloo model groups (a gloo all-reduce is a host round trip, which a
graph cannot capture) and the reference the graph is held against;
`run_on_host` runs the graph's schedule on the host, the body under the
predicate as the IF node runs it, for the CPU tests (gloo model groups
included).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import itertools
import threading
import time
import weakref

import torch

from ..runtime import profiling

MAX_GRAPHS = 32
# an owner's encoder graphs, one a batch shape (vqa.tsv's five MinMax grids)
MAX_ENCODER_GRAPHS = 8
# a full encoder cache evicts for a new key only after this many replays
# since its last capture: traffic of more keys (a VQA server's buckets x
# grids) runs its other keys eagerly rather than capturing at every miss
ENCODER_REPLAYS_A_CAPTURE = 64

# every run, capture and settle, one at a time (the host side of a run is
# short: copies and replays enqueued)
_LOCK = threading.RLock()
# device -> the stream captures and warm-ups run on
_SIDE_STREAMS = {}
# every live StepGraph, for settle()
_LIVE = weakref.WeakSet()
# owner -> its StepGraphs by key, least recently used first (not an
# attribute of the owner: a copy of the model does not copy its graphs)
_GRAPHS = weakref.WeakKeyDictionary()
# owner -> its _EncoderCache
_ENCODERS = weakref.WeakKeyDictionary()


def _counts(owner):
    """The launch counts of the kernel wrappers a step or an encoder call
    can reach (kernels 1-3 and the w8a8 encoder's two), and the owner's
    decode_step_calls."""
    from ..ops import flash_attention, vocab_topk
    from ..ops.decode_attention import decode_attention
    from ..ops.int8_dynamic import quantize_rows, scale_rows

    return {"decode_attention": decode_attention.launches, "vocab_topk": vocab_topk.launches,
            "flash_attention": flash_attention.launches,
            "quantize_rows": quantize_rows.launches, "scale_rows": scale_rows.launches,
            "decode_step_calls": getattr(owner, "decode_step_calls", 0)}


def _add_counts(owner, delta):
    """Add `delta` to the counts; an owner that is gone (None) keeps none."""
    from ..ops import flash_attention, vocab_topk
    from ..ops.decode_attention import decode_attention
    from ..ops.int8_dynamic import quantize_rows, scale_rows

    decode_attention.launches += delta.get("decode_attention", 0)
    vocab_topk.launches += delta.get("vocab_topk", 0)
    flash_attention.launches += delta.get("flash_attention", 0)
    quantize_rows.launches += delta.get("quantize_rows", 0)
    scale_rows.launches += delta.get("scale_rows", 0)
    if hasattr(owner, "decode_step_calls"):
        owner.decode_step_calls += delta.get("decode_step_calls", 0)


class StepGraph(object):
    """One captured step and its static state.  graph: its `IfGraph`;
    draw_graph: a sampled search's draw, or None; steps: [] int64 on the
    card, the bodies its launches ran since the last `settle`; per_step:
    the launches one body makes ({kernel or 'decode_step_calls': n});
    replays: the launches the host enqueued; capture_s: the capture's
    host seconds (the warm-up step excluded); label: the key's label in
    the spans; last: the last `search.launch` span that copied `steps`."""

    def __init__(self, owner, state, graph, draw_graph, pred, steps, rng, per_step, capture_s):
        self.owner = weakref.ref(owner)
        self.state = state
        self.graph = graph
        self.draw_graph = draw_graph
        self.pred = pred
        self.steps = steps
        self.rng = rng
        self.per_step = per_step
        self.capture_s = capture_s
        self.replays = 0
        self.settled = 0  # the bodies of `steps` already added to the counts
        self.label = self.last = None

    def settle(self):
        """Add the launches of the bodies run since the last settle to the
        counts (and to the module's `bodies`); waits for the card."""
        global bodies
        total = int(self.steps.item())
        n, self.settled = total - self.settled, total
        _add_counts(self.owner(), {k: n * v for k, v in self.per_step.items()})
        bodies += n
        return n


def _device_of(state):
    for t in _tensors(state):
        return t.device
    raise ValueError("a search state holds no tensor")


def _tensors(x):
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))


def signature(x):
    """The shapes, dtypes and structure of a state: what, beside the
    caller's key, fixes a captured step's shapes."""
    if torch.is_tensor(x):
        return ("t", tuple(x.shape), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(signature(y) for y in x)
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(signature(getattr(x, f.name))
                                           for f in dataclasses.fields(x))
    return x


def copy_state(dst, src):
    """Copy a fresh state into a static one of the same signature, tensor
    by tensor on the current stream (a tensor both share is skipped)."""
    if dst is src:
        return
    if torch.is_tensor(dst):
        dst.copy_(src)
    elif isinstance(dst, (list, tuple)):
        for a, b in zip(dst, src):
            copy_state(a, b)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            copy_state(getattr(dst, f.name), getattr(src, f.name))
    elif dst != src:
        raise ValueError("states differ: {!r} != {!r}".format(dst, src))


def _weights_signature(owner, parts=("textual",)):
    """The addresses of the owner's tensors in its submodules named in
    `parts` (the decoder's: its textual head), or of the owner's own where
    it has none of them: a graph reads them where they were at capture."""
    mods = [m for m in (getattr(owner, p, None) for p in parts) if isinstance(m, torch.nn.Module)]
    if not mods and isinstance(owner, torch.nn.Module):
        mods = [owner]
    # each module's own tensors, walked directly: a third of the cost of
    # parameters() and buffers() (~0.4 ms for ViT-L's ~300 on a host core)
    return tuple((t.data_ptr(), t.dtype, t.shape) for m in mods for sub in m.modules()
                 for t in itertools.chain(sub._parameters.values(), sub._buffers.values())
                 if t is not None)


def _body(state, step, running, noise, pred, steps=None):
    """One step under the predicate's protocol: the step, the body count,
    the next predicate; the body of the IF node."""
    step(state, noise)
    if steps is not None:
        steps.add_(1)
    pred.copy_(running(state))


def run_eager(state, step, running, result, draw=None, rng=None):
    """The eager loop: one host read of the predicate a step."""
    while bool(running(state)):
        step(state, None if draw is None else draw(rng))
    return result(state)


def run_on_host(state, step, running, result, replays, draw=None, rng=None):
    """The graph's schedule on the host: `replays` launches, each drawing
    (as the draw graph is replayed every launch) and running the body
    only where the predicate, computed by the last body on the state's
    device, is true, as the IF node does."""
    pred = running(state).clone()
    for _ in range(replays):
        noise = None if draw is None else draw(rng)
        if bool(pred):
            _body(state, step, running, noise, pred)
    return result(state)


# the conditional graph's entry points (csrc/graph_if.cu), bound at the
# first capture
_LIB = None
# launches of the conditional graph (each launches set_condition once)
launches = 0
# the bodies (search steps) the graphs ran on the card, summed over every
# settle, an owner's last included
bodies = 0


def _bind():
    global _LIB
    if _LIB is None:
        from ..ops import cuda_build

        lib = cuda_build.load("graph_if")
        lib.gitax_graph_if.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_void_p)]
        lib.gitax_graph_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.gitax_graph_destroy.argtypes = [ctypes.c_void_p]
        lib.gitax_graph_node_types.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_int]
        for fn in (lib.gitax_graph_if, lib.gitax_graph_launch, lib.gitax_graph_destroy,
                   lib.gitax_graph_node_types):
            fn.restype = ctypes.c_int
        lib.gitax_graph_error_string.argtypes = [ctypes.c_int]
        lib.gitax_graph_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def cuda_error(rc):
    """'cudaError <rc>: <the runtime's text>'."""
    return "cudaError {}: {}".format(rc, _bind().gitax_graph_error_string(rc).decode())


# cudaGraphNodeType's values (driver_types.h)
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
              6: "wait_event", 7: "event_record", 8: "ext_semaphore_signal",
              9: "ext_semaphore_wait", 10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}


def node_types(body):
    """The types of a captured torch.cuda.CUDAGraph's (keep_graph=True)
    nodes, child graphs' nodes included, by name: what decides whether it
    may be the body of a conditional node."""
    lib = _bind()
    cap = 4096
    buf = (ctypes.c_int * cap)()
    n = lib.gitax_graph_node_types(body.raw_cuda_graph(), buf, cap)
    if n < 0:
        raise RuntimeError("graph_if: reading the graph's nodes failed: " + cuda_error(-n))
    return [NODE_TYPES.get(t, str(t)) for t in buf[:min(n, cap)]]


# the node types a conditional node's body may hold (CUDA 12.4+)
BODY_NODES = {"kernel", "memcpy", "memset", "empty", "graph", "conditional"}


class IfGraph(object):
    """The executable graph `set_condition(pred) -> IF pred { body }`, the
    body a clone of `body` (a torch.cuda.CUDAGraph captured with
    keep_graph=True, kept alive for its pool).  A body holding another
    node type raises, naming it: NCCL's captured collectives bring event
    nodes unless NCCL_GRAPH_MIXING_SUPPORT=0
    (`runtime.distributed.init_training_group` sets it)."""

    def __init__(self, body, pred):
        lib = _bind()
        self.body, self.pred = body, pred
        other = collections.Counter(t for t in node_types(body) if t not in BODY_NODES)
        if other:
            raise RuntimeError(
                "graph_if: the captured step holds {} nodes, which a conditional body cannot "
                "hold (a collective captured by NCCL with NCCL_GRAPH_MIXING_SUPPORT other than "
                "0 brings event nodes)".format(dict(other)))
        handle = ctypes.c_void_p()
        rc = lib.gitax_graph_if(body.raw_cuda_graph(), pred.data_ptr(), ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError("graph_if: building the conditional graph failed: " +
                               cuda_error(rc))
        self.exec = handle.value
        self._destroy = lib.gitax_graph_destroy

    def launch(self):
        """One launch on the current stream of the predicate's device."""
        global launches
        rc = _LIB.gitax_graph_launch(self.exec, torch.cuda.current_stream(self.pred.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("graph_if: launch failed: " + cuda_error(rc))
        launches += 1

    def __del__(self):
        if getattr(self, "exec", None):
            self._destroy(self.exec)
            self.exec = None


def _side_stream(dev):
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def _captured(fn, side, rng=None):
    """fn() captured on the side stream into a CUDAGraph whose cudaGraph_t
    is kept (`raw_cuda_graph`), with a private pool; a generator the
    captured code draws from is registered first.  Returns (graph,
    fn's output)."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    if rng is not None:
        graph.register_generator_state(rng)
    with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        out = fn()
    return graph, out


def _capture(owner, state, step, running, draw, rng):
    """Warm up with one real step (the search's first), then capture one
    step (and a sampled search's draw).  Returns the StepGraph, or None
    when the search was over before its first step."""
    dev = _device_of(state)
    side = _side_stream(dev)
    current = torch.cuda.current_stream(dev)
    loop_rng = None
    if rng is not None:
        loop_rng = torch.Generator(dev)
        loop_rng.set_state(rng.get_state())
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        # the warm-up is the search's first step; a capture synchronises
        # the card anyway, so the host may read the predicate here.  The
        # read also waits out every graph launched before on this stream:
        # the warm-up's eager collectives then find none of them
        # outstanding on the graph group (`Mesh.graph_group`)
        go = bool(running(state))
        if go:
            _body(state, step, running, None if draw is None else draw(loop_rng), pred)
    current.wait_stream(side)
    if not go:
        return None
    before = _counts(owner)
    t0 = time.perf_counter()
    draw_graph = noise = None
    try:
        if draw is not None:
            draw_graph, noise = _captured(lambda: draw(loop_rng), side, loop_rng)
        body, _ = _captured(lambda: _body(state, step, running, noise, pred, steps), side)
        cond = IfGraph(body, pred)
    finally:
        after = _counts(owner)
        # the capture launched nothing: take back what the wrappers counted
        _add_counts(owner, {k: before[k] - after[k] for k in after})
    capture_s = time.perf_counter() - t0
    per_step = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    loop = StepGraph(owner, state, cond, draw_graph, pred, steps, loop_rng, per_step, capture_s)
    if rng is not None:
        rng.set_state(loop_rng.get_state())
    return loop


def _launch(loop, n, rng):
    if rng is not None:
        loop.rng.set_state(rng.get_state())
    for _ in range(n):
        if loop.draw_graph is not None:
            loop.draw_graph.replay()
        loop.graph.launch()
    loop.replays += n
    if rng is not None:
        rng.set_state(loop.rng.get_state())


def run(owner, key, state, step, running, result, replays, draw=None, rng=None):
    """Run a search on the card (see the module docstring); returns
    result(static state) without waiting for the card.  owner: the object
    the graphs are cached on (the model); key: hashable, what fixes the
    step's code beyond the state's shapes; state: the search's fresh
    state on a CUDA device; step(state, noise); running(state) -> 0-dim
    bool; result(state) -> new tensors; replays: the most steps the
    search can take; draw(rng) -> the step's noise, with rng, a sampled
    search's torch.Generator on the card (None for a search that draws
    nothing)."""
    dev = _device_of(state)
    if dev.type != "cuda":
        raise ValueError("device_loop runs on a CUDA device, got a state on {}; the eager "
                         "loop (run_eager) serves the CPU".format(dev))
    full_key = (key, signature(state), _weights_signature(owner), draw is not None)
    with _LOCK:
        loops = _GRAPHS.get(owner)
        if loops is None:
            loops = _GRAPHS[owner] = collections.OrderedDict()
            # the owner's graphs go with it; their counts are added first
            weakref.finalize(owner, _settle_loops, loops).atexit = False
        loop = loops.get(full_key)
        if loop is None:
            label = "{}:{:08x}".format(key[0] if isinstance(key, tuple) and key else key,
                                       hash(full_key) & 0xffffffff)
            t0 = time.perf_counter()
            with profiling.span("search.capture", key=label):
                loop = _capture(owner, state, step, running, draw, rng)
                if loop is not None:
                    loop.label = label
                    loops[full_key] = loop
                    _LIVE.add(loop)
                    while len(loops) > MAX_GRAPHS:
                        _, old = loops.popitem(last=False)
                        t1 = time.perf_counter()
                        old.settle()  # reads its step counter: waits for the card
                        _LIVE.discard(old)
                        gone, t2 = old.label, time.perf_counter()
                        del old  # its graphs and pool are freed here, inside the span
                        profiling.count(evictions=1)
                        profiling.mark("search.evict", key=gone, settle_ms=(t2 - t1) * 1e3,
                                       release_ms=(time.perf_counter() - t2) * 1e3)
            profiling.count(captures=1, capture_s=time.perf_counter() - t0)
            if loop is None:
                return result(state)
            copy_in, n = False, replays - 1  # the warm-up was the first step
        else:
            loops.move_to_end(full_key)
            copy_in, n = True, replays
        with profiling.span("search.launch", device=True, replays=n) as s:
            if copy_in:  # the caller's state into the graph's
                copy_state(loop.state, state)
                loop.pred.copy_(running(loop.state))
            _launch(loop, n, rng)
            s.counter("steps", loop.steps, loop.last)
            loop.last = s
            return result(loop.state)


def graphs(owner):
    """The owner's cached StepGraphs, least recently used first."""
    return list(_GRAPHS.get(owner, {}).values())


def settle():
    """Add the launches of every graph's steps since the last settle to
    the wrappers' counts and the owners' decode_step_calls; waits for the
    card.  Returns the bodies run."""
    with _LOCK, torch.inference_mode():
        return sum(loop.settle() for loop in list(_LIVE))


def _settle_loops(loops):
    with _LOCK, torch.inference_mode():
        for loop in loops.values():
            loop.settle()
            _LIVE.discard(loop)
        loops.clear()


def release(owner):
    """Settle and drop the owner's graphs (their static states and pools),
    the encoder's too: the next search or encoder call of each key
    captures again."""
    _settle_loops(_GRAPHS.pop(owner, {}))
    with _LOCK:
        _ENCODERS.pop(owner, None)


# -- the encoder's graphs ------------------------------------------------------


# one captured encoder call: its torch.cuda.CUDAGraph, static input and
# output, the wrappers' launches a replay makes ({kernel: n}) and its label
EncoderGraph = collections.namedtuple("EncoderGraph",
                                      ("graph", "static_in", "static_out", "per_call", "label"))


class _EncoderCache(object):
    """An owner's encoder graphs for one set of weights: by key, least
    recently used first; the pool they share (None until the first
    capture); the replays since the last capture."""

    def __init__(self, weights):
        self.weights = weights
        self.graphs = collections.OrderedDict()
        self.pool = None
        self.replays = 0


def _warm_up(fn, x):
    """fn(x) once on the side stream of x's device, after the current
    stream's work and before its next (cuBLAS's workspace for that
    stream and the kernels' first-call set-up, before a capture there)."""
    side = _side_stream(x.device)
    current = torch.cuda.current_stream(x.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn(x)
    current.wait_stream(side)


def _capture_encoder(fn, x, pool):
    """fn(x) captured on the side stream into a CUDAGraph in the memory
    pool `pool` (a graph's `pool()`; None: a new one).  Returns (graph,
    fn's output: the static output)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=_side_stream(x.device),
                          capture_error_mode="thread_local"):
        out = fn(x)
    return graph, out


def _capture_into(cache, owner, key, images, fn):
    """A miss's warm-up and capture of fn for `key` into `cache`, with
    the LRU eviction it makes room by; returns the new EncoderGraph."""
    label = "{}:{:08x}".format("x".join(str(n) for n in images.shape[:-1]),
                               hash(key) & 0xffffffff)
    with profiling.span("model.encode_capture", key=label):
        static_in = images.clone()
        while len(cache.graphs) >= MAX_ENCODER_GRAPHS:
            _, old = cache.graphs.popitem(last=False)
            del old  # its static tensors go back to the shared pool
            profiling.count(encode_evictions=1)
        before = _counts(owner)
        try:
            _warm_up(fn, static_in)
            warm = _counts(owner)
            graph, static_out = _capture_encoder(fn, static_in, cache.pool)
        finally:
            after = _counts(owner)
            # the capture launched nothing, and the warm-up is no call's
            # work: take back what the wrappers counted
            _add_counts(owner, {k: before[k] - after[k] for k in after})
        cache.pool = graph.pool()
        per_call = {k: after[k] - warm[k] for k in after if after[k] != warm[k]}
        g = cache.graphs[key] = EncoderGraph(graph, static_in, static_out, per_call, label)
    cache.replays = 0
    profiling.count(encode_captures=1)
    return g


def encode(owner, key, images, fn):
    """fn(images), an encoder call's body, replayed from the owner's graph
    for `key` (hashable: what fixes the body's code beyond the input's
    shape and dtype) and the input, captured on a miss while the cache
    has room or has paid for its last capture (see the module
    docstring); other misses run fn eagerly.  Returns a new tensor.
    images: on a CUDA device; fn launches no device span and reads
    nothing on the host."""
    weights = _weights_signature(owner, ("image_encoder", "img_temperal_embedding"))
    full_key = (key, tuple(images.shape), images.dtype, torch.backends.cuda.matmul.allow_tf32)
    with _LOCK:
        cache = _ENCODERS.get(owner)
        if cache is None or cache.weights != weights:
            # graphs of other weights never hit again: dropped at once
            if cache is not None and cache.graphs:
                profiling.count(encode_evictions=len(cache.graphs))
            cache = _ENCODERS[owner] = _EncoderCache(weights)
        g = cache.graphs.get(full_key)
        if g is None and (len(cache.graphs) < MAX_ENCODER_GRAPHS
                          or cache.replays >= ENCODER_REPLAYS_A_CAPTURE):
            # in inference mode whoever calls: the static tensors are
            # inference tensors, written in place at every call
            with torch.inference_mode():
                g = _capture_into(cache, owner, full_key, images, fn)
                g.graph.replay()
        elif g is not None:
            cache.graphs.move_to_end(full_key)
            cache.replays += 1
            with torch.inference_mode():
                g.static_in.copy_(images)
                g.graph.replay()
            profiling.count(encode_replays=1)
        if g is not None:
            _add_counts(owner, g.per_call)
            # cloned before the lock goes: the next replay of any graph in
            # the shared pool may write over this one's output
            return g.static_out.clone()
    profiling.count(encode_eager=1)
    return fn(images)
