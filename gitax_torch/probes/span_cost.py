"""The recorder's host cost a device batch (`runtime/profiling.py`):

    python3 -m gitax_torch.probes.span_cost [--batches N]

replays, N times, the spans and counters one device batch of the caption
TSV loop makes (the pool wait, two assembles, the dispatch with its stack,
the device batch with its cast, upload, encoder, prefill and search
launch, the resolve with its read-back and detokenisation, the write, the
pool's chunk: 17 spans, 3 of them device spans on the card launching 5
stamps, the prefill's start the encoder's end, and the search's step
counter copied) around empty blocks, with the recorder on
and off (`profiling.ON`, which GITAX_TORCH_SPANS=0 sets at import), in
turns of 1000 batches, and prints host microseconds a batch for each
(median and mean over the turns) as one JSON line, with `parts_us`: the
recorder's pieces alone, each timed over 20000 calls (a host span, a
device span, a counter's copy, a device span's resolution, the CUDA calls
a device span makes).  The on figure counts
the device spans' resolution (their stamps read), which a run pays when
its spans are read.  On the card the device spans launch their stamps on
the current stream; without one they keep host times only."""

import argparse
import json
import statistics
import sys
import time

import torch

from gitax_torch.runtime import profiling

TURN = 1000


def one_batch(steps, last):
    """The spans of one device batch; returns its search.launch span."""
    p = profiling
    with p.span("tsv.pool_wait", chunk=1):
        pass
    with p.span("tsv.assemble", items=32, chunk=2):
        pass
    with p.span("tsv.assemble", items=32):
        pass
    with p.span("engine.dispatch", items=32):
        with p.span("engine.stack", rows=32, real=32):
            pass
        p.count(rows=32, real_rows=32)
        with p.span("engine.device_batch", rows=32, real=32, grid=(16, 16), prefix=1):
            with p.span("engine.host_cast"):
                pass
            with p.span("engine.upload", bytes=9633792):
                pass
            with p.span("model.encode", device=steps.is_cuda) as s:
                s.set(tokens=257)
            with p.span("model.prefill", device=steps.is_cuda, chain=True, tokens=258):
                pass
            with p.span("search.launch", device=steps.is_cuda, replays=40) as s:
                s.counter("steps", steps, last)
    with p.span("engine.resolve", items=32):
        with p.span("engine.to_host"):
            pass
        with p.span("engine.detokenize", items=32):
            pass
    with p.span("tsv.write", rows=32):
        pass
    with p.span("decode.chunk", chunk=3, rows=32):
        pass
    return s


def turn(on, steps):
    profiling.ON = on
    last = None
    t0 = time.perf_counter()
    for _ in range(TURN):
        last = one_batch(steps, last if isinstance(last, profiling.Span) else None)
    profiling.read_pending()
    dt = time.perf_counter() - t0
    profiling.clear()
    return dt / TURN * 1e6


def timed(fn, n=20000):
    """Host us a call of fn (n calls, the best of three passes)."""
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n * 1e6
        best = dt if best is None else min(best, dt)
    return best


def parts(steps):
    """{piece: host us a call}."""
    p = profiling
    p.ON = True
    out = {}

    def host():
        with p.span("x", rows=32):
            pass

    def device():
        with p.span("x", device=steps.is_cuda):
            pass

    def counted():
        with p.span("x", device=steps.is_cuda) as s:
            s.counter("steps", steps)

    out["host_span"] = timed(host)
    p.clear()
    out["device_span"] = timed(device, 3000)
    t0 = time.perf_counter()
    n = len(p._pending)
    p.read_pending()
    out["resolve_a_device_span"] = (time.perf_counter() - t0) / max(n, 1) * 1e6
    p.clear()
    out["device_span_with_counter"] = timed(counted, 3000)
    p.clear()
    p.ON = False
    out["off_span"] = timed(host)
    p.ON = True
    if steps.is_cuda:
        out["is_current_stream_capturing"] = timed(p._capturing)
        out["raw_stream"] = timed(lambda: p._raw_stream(p._device()))
    return out


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, default=20000)
    args = ap.parse_args(argv)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    was = profiling.ON
    turn(True, steps)  # warm-up: events made, the slots allocated
    turn(False, steps)
    us = {True: [], False: []}
    for _ in range(max(1, args.batches // TURN)):
        for on in (True, False):
            us[on].append(turn(on, steps))
    profiling.ON = was
    out = {"device": torch.cuda.get_device_name(0) if dev == "cuda" else "cpu",
           "spans_a_batch": 17, "device_spans_a_batch": 3 if dev == "cuda" else 0,
           "turns": len(us[True]), "batches_a_turn": TURN}
    for on, name in ((True, "on"), (False, "off")):
        out[name + "_us_median"] = statistics.median(us[on])
        out[name + "_us_mean"] = statistics.mean(us[on])
    out["parts_us"] = parts(steps)
    profiling.ON = was
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
