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

The eager loop (`run_eager`, one host read a step) serves CPU tensors,
model groups of m > 1 ranks (the step all-reduces over a group that
cannot be captured) and the reference the graph is held against;
`run_on_host` runs the graph's schedule on the host, the body under the
predicate as the IF node runs it, for the CPU tests.
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

MAX_GRAPHS = 32

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


def _counts(owner):
    """The launch counts of the kernel wrappers a step can reach, and the
    owner's decode_step_calls."""
    from ..ops import vocab_topk
    from ..ops.decode_attention import decode_attention

    return {"decode_attention": decode_attention.launches, "vocab_topk": vocab_topk.launches,
            "decode_step_calls": getattr(owner, "decode_step_calls", 0)}


def _add_counts(owner, delta):
    """Add `delta` to the counts; an owner that is gone (None) keeps none."""
    from ..ops import vocab_topk
    from ..ops.decode_attention import decode_attention

    decode_attention.launches += delta.get("decode_attention", 0)
    vocab_topk.launches += delta.get("vocab_topk", 0)
    if hasattr(owner, "decode_step_calls"):
        owner.decode_step_calls += delta.get("decode_step_calls", 0)


class StepGraph(object):
    """One captured step and its static state.  graph: its `IfGraph`;
    draw_graph: a sampled search's draw, or None; steps: [] int64 on the
    card, the bodies its launches ran since the last `settle`; per_step:
    the launches one body makes ({kernel or 'decode_step_calls': n});
    replays: the launches the host enqueued; capture_s: the capture's
    host seconds (the warm-up step excluded)."""

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

    def settle(self):
        """Add the launches of the bodies run since the last settle to the
        counts; waits for the card."""
        n = int(self.steps.item())
        self.steps.zero_()
        _add_counts(self.owner(), {k: n * v for k, v in self.per_step.items()})
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


def _weights_signature(owner):
    """The addresses of the owner's decoder tensors (its textual head, or
    the owner itself): a graph reads them where they were at capture."""
    mod = getattr(owner, "textual", owner)
    if not isinstance(mod, torch.nn.Module):
        return ()
    return tuple((t.data_ptr(), t.dtype, tuple(t.shape))
                 for t in itertools.chain(mod.parameters(), mod.buffers()))


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


def _bind():
    global _LIB
    if _LIB is None:
        from ..ops import cuda_build

        lib = cuda_build.load("graph_if")
        lib.gitax_graph_if.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_void_p)]
        lib.gitax_graph_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.gitax_graph_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.gitax_graph_if, lib.gitax_graph_launch, lib.gitax_graph_destroy):
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


class IfGraph(object):
    """The executable graph `set_condition(pred) -> IF pred { body }`, the
    body a clone of `body` (a torch.cuda.CUDAGraph captured with
    keep_graph=True, kept alive for its pool)."""

    def __init__(self, body, pred):
        lib = _bind()
        self.body, self.pred = body, pred
        handle = ctypes.c_void_p()
        rc = lib.gitax_graph_if(body.raw_cuda_graph(), pred.data_ptr(), ctypes.byref(handle))
        if rc != 0:
            raise RuntimeError("graph_if: building the conditional graph failed: cudaError "
                               "{}".format(rc))
        self.exec = handle.value
        self._destroy = lib.gitax_graph_destroy

    def launch(self):
        """One launch on the current stream of the predicate's device."""
        global launches
        rc = _LIB.gitax_graph_launch(self.exec, torch.cuda.current_stream(self.pred.device).cuda_stream)
        if rc != 0:
            raise RuntimeError("graph_if: launch failed: cudaError {}".format(rc))
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
        # the card anyway, so the host may read the predicate here
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
            loop = _capture(owner, state, step, running, draw, rng)
            if loop is None:
                return result(state)
            loops[full_key] = loop
            _LIVE.add(loop)
            while len(loops) > MAX_GRAPHS:
                _, old = loops.popitem(last=False)
                old.settle()
                _LIVE.discard(old)
            _launch(loop, replays - 1, rng)  # the warm-up was the first step
        else:
            loops.move_to_end(full_key)
            copy_state(loop.state, state)
            loop.pred.copy_(running(loop.state))
            _launch(loop, replays, rng)
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
    """Settle and drop the owner's graphs (their static states and pools):
    the next search of each key captures again."""
    _settle_loops(_GRAPHS.pop(owner, {}))
