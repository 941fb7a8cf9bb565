"""Dynamic-batching serving frontend over a CaptionEngine, the port's
copy of `gitax.runtime.serving` (framework-free there, so copied as the
port copied `common.py` and `io/`).

The reference's only "serving" story is the batch-1 demo CLI
(reference inference.py:67-109): one process, one image per forward,
a host-synced beam loop.  A production endpoint should convert
concurrency into device batching.  This module does that:

* callers submit single requests from any thread (`submit` /
  `caption`) and get a Future;
* a batcher thread groups compatible requests — same prefix length and
  image shape, i.e. one batch shape — within a bounded wait
  window (`max_wait_ms`), pads the group to a small set of BUCKET batch
  sizes so the number of batch shapes stays bounded, and runs one
  device dispatch for the whole group;
* preprocessing (jpeg decode + resize/crop) runs on the CALLER's
  thread, so an HTTP frontend with a thread per connection decodes in
  parallel while the batcher keeps the device busy;
* while dispatched batches are unresolved, sub-full groups keep
  coalescing instead of aging out (busy-hold, `_wait_for_group`): on a
  device that serializes programs an early sub-full dispatch gains no
  latency, and each completion's resubmit wave gets a fresh window —
  bounded by ``max_hold_ms`` so nothing starves.

Padding rows replicate the last real request (exactly what the TSV
engine's `_dispatch_batch` does for tail batches); padded outputs are
dropped before detokenization.  Bucketing bounds the batch shapes per
(prefix_len, image_shape) family to ``len(buckets)``.

What differs from gitax's copy: the device sequences reach the host
through the engine's `to_host`; the batcher and resolver threads make
the engine's card their current CUDA device (it is per thread, and the
kernels launch on the thread's current device).  As in gitax, dispatch
is asynchronous on one card: `dispatch_device_batch` returns once the
upload (pinned) and the search (a replayed CUDA graph step,
`decode.device_loop`) are enqueued, so up to `max_in_flight` batches'
uploads and searches overlap on the card, and the resolver's `to_host`
is the first host wait.  A model group of m > 1 ranks still searches
with one host read a step.
"""

import collections
import logging
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np
import torch

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32)


class OverloadedError(RuntimeError):
    """Raised by submit when the pending queue is at max_queue depth.

    Admission control: without it a sustained overload accumulates
    unbounded request + decoded-image memory until OOM (the completion
    queue alone only bounds DISPATCHED batches).  The HTTP frontend maps
    this to 503 so load balancers back off."""


class ServingStats(object):
    """Counters a load balancer / test can read: total requests, device
    batches, padded slots, rejections, and a batch-size histogram."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.batches = 0
        self.padded_slots = 0
        self.errors = 0
        self.rejected = 0
        self.batch_size_hist = collections.Counter()
        # per-group-key batch counts (key = (prefix_len, h, w, dtype
        # kind)) — mixed caption+VQA traffic forms one group per prefix
        # length, and a load test needs to see batches PER class to
        # check no group starves under the busy-hold policy
        self.batches_by_group = collections.Counter()

    def record_batch(self, n_real, bucket, group_key=None):
        with self.lock:
            self.batches += 1
            self.batch_size_hist[bucket] += 1
            self.padded_slots += bucket - n_real
            if group_key is not None:
                self.batches_by_group[group_key] += 1

    def record_requests(self, n):
        with self.lock:
            self.requests += n

    def record_error(self):
        with self.lock:
            self.errors += 1

    def record_rejected(self):
        with self.lock:
            self.rejected += 1

    def snapshot(self):
        with self.lock:
            return {
                "requests": self.requests,
                "batches": self.batches,
                "padded_slots": self.padded_slots,
                "errors": self.errors,
                "rejected": self.rejected,
                "batch_size_hist": dict(self.batch_size_hist),
                "batches_by_group": {
                    str(k): v for k, v in self.batches_by_group.items()
                },
            }


class _Request(object):
    __slots__ = ("image", "prefix", "future", "arrival")

    def __init__(self, image, prefix):
        self.image = image
        self.prefix = prefix
        self.future = Future()
        self.arrival = time.monotonic()


class DynamicBatcher(object):
    """Groups concurrent single-caption requests into device batches.

    engine: a CaptionEngine (supplies the batch search,
    tokenizer, transform and params).
    max_batch: largest device batch (clipped to the engine's configured
    batch_size by default).
    max_wait_ms: how long the oldest waiting request may age before its
    group is dispatched regardless of fill.
    buckets: allowed dispatch batch sizes (padded up); bounds the
    number of batch shapes.
    """

    def __init__(self, engine, max_batch: Optional[int] = None,
                 max_wait_ms: float = 4.0,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_in_flight: int = 3,
                 max_queue: Optional[int] = None,
                 max_hold_ms: Optional[float] = None):
        self.engine = engine
        self.max_batch = int(max_batch or engine.batch_size)
        self.max_wait = max_wait_ms / 1000.0
        # staleness bound for the busy-hold policy (see _wait_for_group):
        # a sub-full group may coalesce across in-flight completions for
        # at most this long before dispatching anyway.
        # Latency trade-off under SPARSE traffic: an isolated sub-full
        # request arriving while any batch is in flight waits for that
        # batch to resolve plus a fresh max_wait (bounded by max_hold,
        # default 200 ms) instead of dispatching after max_wait, and it
        # forgoes the max_in_flight upload/compute overlap.  The hold
        # pays off only when completions trigger resubmit waves
        # (closed-loop clients: measured 64.5 -> 125.4 req/s at C=16);
        # latency-sensitive sparse deployments should lower max_hold_ms
        # (0 disables the hold entirely).
        # `is not None` so max_hold_ms=0 means "no hold beyond max_wait"
        # instead of silently falling back to the default
        self.max_hold = (
            max(max_hold_ms / 1000.0, self.max_wait)
            if max_hold_ms is not None
            else max(50 * self.max_wait, 0.2)
        )
        bs = sorted({int(b) for b in buckets if 0 < int(b) <= self.max_batch})
        if not bs or bs[-1] != self.max_batch:
            bs.append(self.max_batch)
        self.buckets = bs
        # admission control: total UNDISPATCHED requests across all
        # groups; max_in_flight separately bounds dispatched batches.
        # Default 8 full batches of headroom.
        self.max_queue = (
            int(max_queue) if max_queue is not None else 8 * self.max_batch
        )
        self.stats = ServingStats()
        # group key (prefix_len, h, w, dtype) -> deque of _Request
        self._pending = collections.defaultdict(collections.deque)
        self._pending_count = 0
        self._cv = threading.Condition()
        self._closed = False
        # dispatched-but-unresolved batches / total resolved batches —
        # the busy-hold policy's inputs (guarded by _cv)
        self._in_flight = 0
        self._completed = 0
        # dispatch / completion split, as in gitax: dispatch is
        # asynchronous and batch N+1 is enqueued while the device runs
        # batch N; the resolver's to_host is the first wait on the card.
        # Bounded queue caps queued batches (latency, memory).
        import queue as _queue

        self._completions = _queue.Queue(maxsize=max(1, int(max_in_flight)))
        self._thread = threading.Thread(
            target=self._on_card, args=(self._loop,), name="gitax-batcher", daemon=True
        )
        self._resolver = threading.Thread(
            target=self._on_card, args=(self._resolve_loop,), name="gitax-resolver",
            daemon=True
        )
        self._thread.start()
        self._resolver.start()

    def _on_card(self, loop):
        """Run a thread's loop with the engine's card as the thread's
        current CUDA device (engines without a CUDA device run it as is)."""
        dev = getattr(self.engine, "device", None)
        if dev is not None and torch.device(dev).type == "cuda":
            with torch.cuda.device(dev):
                return loop()
        return loop()

    # -- submission (any thread) ------------------------------------------

    def submit_array(self, image: np.ndarray, prefix: List[int]) -> Future:
        """Queue one preprocessed HWC image (uint8 native-path layout or
        float CHW->HWC transform output) with its prefix token ids.

        Raises OverloadedError when max_queue requests are already
        waiting (admission control — reject at the door instead of
        accumulating decoded images until OOM)."""
        req = _Request(np.asarray(image), list(prefix))
        # dtype is part of the group identity: a uint8 row (native path,
        # fused on-device normalization) stacked with a float row would
        # silently promote to float and skip the normalize branch
        kind = "u8" if req.image.dtype == np.uint8 else "f"
        key = (len(req.prefix),) + tuple(req.image.shape[:2]) + (kind,)
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self._pending_count >= self.max_queue:
                self.stats.record_rejected()
                raise OverloadedError(
                    "pending queue full (%d requests)" % self._pending_count
                )
            self._pending[key].append(req)
            self._pending_count += 1
            self.stats.record_requests(1)
            self._cv.notify()
        return req.future

    def submit(self, image_b64=None, question: str = "",
               image=None) -> Future:
        """Decode + preprocess on the caller's thread, then queue.

        image_b64: base64 jpeg/png payload (str or bytes); image: a
        PIL.Image or HWC uint8 array alternative.  question: optional
        VQA question (empty -> plain captioning)."""
        from ..io.image import image_from_base64

        if image is None:
            image = image_from_base64(image_b64)
            if image is None:
                raise ValueError("undecodable image payload")
        elif isinstance(image, np.ndarray):
            from PIL import Image as PILImage

            image = PILImage.fromarray(image)
        arr = self.engine.transform(image)
        # high-res transforms emit non-patch-multiple dims; truncate like
        # the reference's strided patchify conv (CLIP/model.py:221)
        p = self.engine.model.cfg.encoder.patch_size
        h, w = (arr.shape[0] // p) * p, (arr.shape[1] // p) * p
        arr = arr[:h, :w]
        prefix = self.engine.encode_prefix(question or "")
        return self.submit_array(arr, prefix)

    def caption(self, image_b64=None, question: str = "", image=None,
                timeout: Optional[float] = None) -> str:
        """Blocking convenience: submit and wait for the caption."""
        return self.submit(image_b64, question, image).result(timeout)

    def queue_depth(self) -> int:
        """Current undispatched-request count (admission-control gauge)."""
        with self._cv:
            return self._pending_count

    def snapshot(self):
        """Stats counters plus the live queue-depth gauge."""
        snap = self.stats.snapshot()
        snap["queue_depth"] = self.queue_depth()
        snap["max_queue"] = self.max_queue
        return snap

    def warm(self, prefix_lens: Sequence[int] = (1,),
             buckets: Optional[Sequence[int]] = None):
        """Run every bucket size once for the given prefix lengths before
        traffic: the first search builds the CUDA kernels (nvcc at first
        use, about 11 s), warms cuBLAS and the allocator and captures the
        search's step graph for each batch shape, which would otherwise
        stall every group behind it on the single batcher thread.

        Warms the exact path HTTP traffic hits: a dummy image is run
        through the engine's own transform, so shape and dtype match real
        submits."""
        from PIL import Image as PILImage

        eng = self.engine
        crop = getattr(eng.transform, "crop_size", 224)
        arr = eng.transform(
            PILImage.fromarray(np.zeros((crop, crop, 3), np.uint8))
        )
        p = eng.model.cfg.encoder.patch_size
        h, w = (arr.shape[0] // p) * p, (arr.shape[1] // p) * p
        arr = np.asarray(arr)[:h, :w]
        if arr.dtype != np.uint8:
            arr = arr.astype(np.float32)
        cls = eng.tokenizer.cls_token_id
        for tp in prefix_lens:
            for b in (buckets or self.buckets):
                imgs = np.stack([arr] * b)
                pref = np.full((b, tp), cls, np.int32)
                seqs = eng.dispatch_device_batch(imgs, pref)
                eng.to_host(seqs)  # block until built + run

    # -- batcher thread ----------------------------------------------------

    def _oldest_key(self):
        # called under the lock; None when nothing is pending
        best_key, best_t = None, None
        for key, dq in self._pending.items():
            if dq and (best_t is None or dq[0].arrival < best_t):
                best_key, best_t = key, dq[0].arrival
        return best_key

    def _full_key(self):
        # called under the lock; a group at max_batch dispatches now
        for k, d in self._pending.items():
            if len(d) >= self.max_batch:
                return k
        return None

    def _wait_for_group(self):
        """Under the lock: block until some group should dispatch and
        return its key (None only on close with nothing pending).

        Policy: a FULL group dispatches immediately.  A sub-full group
        waits max_wait from its oldest arrival — and, while dispatched
        batches are still unresolved, KEEPS waiting: on a device that
        serializes programs, a sub-full dispatch gains no latency (it
        queues behind the running batch anyway) and wastes a whole
        program, while each completion releases a wave of closed-loop
        resubmits that deserves one fresh max_wait window to coalesce.
        Without the busy-hold, C=16 closed-loop traffic phase-splits
        into an alternating full-batch/straggler pattern (measured
        33x B16 + 33x B1 per 8 s — two serial dispatches per round
        where one would do).  max_hold bounds total staleness so a
        group can't starve while other groups keep the device busy."""
        while True:
            key = self._oldest_key()
            while key is None and not self._closed:
                self._cv.wait()
                key = self._oldest_key()
            if key is None:
                return None
            dq = self._pending[key]
            soft = dq[0].arrival + self.max_wait
            hard = dq[0].arrival + self.max_hold
            seen = self._completed
            while not self._closed:
                # the hard deadline outranks fullness: under sustained
                # overload some group is ALWAYS full, and checking
                # fullness first would starve every other group forever
                # (its hard deadline never reached) — max_hold is a
                # promise, so the oldest group dispatches once it ages
                # out even while full groups keep arriving
                now = time.monotonic()
                if now >= hard:
                    return key
                full = self._full_key()
                if full is not None:
                    return full
                if now < soft:
                    self._cv.wait(min(soft, hard) - now)
                elif self._in_flight > 0:
                    self._cv.wait(min(0.05, hard - now))
                    if self._completed != seen:
                        seen = self._completed
                        soft = time.monotonic() + self.max_wait
                else:
                    return key
            # closed: flush this group as-is (outer _loop iterates until
            # the queue drains)
            return key

    def _loop(self):
        try:
            while True:
                with self._cv:
                    key = self._wait_for_group()
                    if key is None:
                        return
                    dq = self._pending[key]
                    take = min(len(dq), self.max_batch)
                    items = [dq.popleft() for _ in range(take)]
                    self._pending_count -= take
                    if not dq:
                        del self._pending[key]
                if items:
                    self._run_batch(items)
        finally:
            # the batcher thread OWNS the sentinel: it goes in strictly
            # after every dispatched batch (same thread, same queue), so
            # close() can never race it ahead of an in-flight batch that
            # is still building its kernels
            self._completions.put(None)

    def _run_batch(self, items: List[_Request]):
        """Upload + dispatch one device batch and hand the result to the
        resolver thread.  Device placement lives in the engine's
        dispatch_device_batch."""
        eng = self.engine
        n = len(items)
        bucket = next(b for b in self.buckets if b >= n)
        try:
            imgs = np.stack(
                [r.image for r in items] + [items[-1].image] * (bucket - n)
            )
            pref = np.asarray(
                [r.prefix for r in items] + [items[-1].prefix] * (bucket - n),
                np.int32,
            )
            seqs = eng.dispatch_device_batch(imgs, pref)
            # record the ACTUAL device batch so /stats padding numbers
            # are honest; .shape is metadata, no device sync
            r0 = items[0]
            kind = "u8" if r0.image.dtype == np.uint8 else "f"
            key = (len(r0.prefix),) + tuple(r0.image.shape[:2]) + (kind,)
            self.stats.record_batch(n, int(seqs.shape[0]), group_key=key)
        except BaseException as e:  # noqa: BLE001 — futures must not hang
            logging.exception("serving dispatch failed")
            self.stats.record_error()
            for req in items:
                if not req.future.done():
                    req.future.set_exception(e)
            return
        with self._cv:
            self._in_flight += 1
        # blocks when max_in_flight batches are already queued — that
        # back-pressures the batcher (and transitively submitters)
        self._completions.put((items, seqs))

    def _resolve_loop(self):
        while True:
            job = self._completions.get()
            if job is None:
                return
            items, seqs = job
            try:
                arr = self.engine.to_host(seqs)[: len(items)]  # device sync
                for req, row in zip(items, arr):
                    req.future.set_result(
                        self.engine.tokenizer.decode(
                            row.tolist(), skip_special_tokens=True
                        )
                    )
            except BaseException as e:  # noqa: BLE001
                logging.exception("serving resolve failed")
                self.stats.record_error()
                for req in items:
                    if not req.future.done():
                        req.future.set_exception(e)
            finally:
                # wake the batcher: the busy-hold window refreshes on
                # every completion (the resolved futures are about to
                # trigger a resubmit wave)
                with self._cv:
                    self._in_flight -= 1
                    self._completed += 1
                    self._cv.notify_all()

    def close(self, timeout: float = 10.0):
        """Stop the batcher; queued requests still drain first.

        The batcher thread enqueues the completion sentinel itself on
        exit, so a slow first-use kernel build can't strand an in-flight
        batch behind a prematurely-placed sentinel.  If the join times
        out (a build or search still running), the threads keep draining in the
        background and futures resolve late rather than never."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout)
        self._resolver.join(timeout)
        if self._thread.is_alive():
            # still building/dispatching: it will drain the queue and
            # plant the sentinel when done — do NOT fail its futures
            logging.warning("batcher close timed out; draining continues")
            return
        # batcher is dead; anything still pending can never dispatch
        with self._cv:
            leftovers = [r for dq in self._pending.values() for r in dq]
            self._pending.clear()
            self._pending_count = 0
        for r in leftovers:
            if not r.future.done():
                r.future.set_exception(RuntimeError("batcher closed"))
