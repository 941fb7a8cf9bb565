"""HTTP caption/VQA serving endpoint with dynamic batching, the port's
counterpart of `gitax.serve`: a threaded HTTP server whose request
threads decode images in parallel, and a `runtime.serving.DynamicBatcher`
that turns request concurrency into device batches on the card.

    python -m gitax_torch.serve -p "{'type': 'serve_caption', \\
        'model_name': 'GIT_LARGE_COCO', 'port': 8080}"

API:
  POST /v1/caption   json {"image": <base64 jpeg/png>,
                           "question": "optional VQA question"}
                     -> {"caption": "..."}
  GET  /healthz      -> {"ok": true, "model": "..."}
  GET  /stats        -> batcher counters (requests, batches, padding,
                        batch-size histogram)

The CLI follows the `-p/-c/-bp` YAML `type`-dispatch convention of every
entry point (reference common.py:339-377).  The model is built as
`inference._build_model` builds it: from output/{model}/snapshot/model.pt
when it exists, on this process's card unless the caller passes
device='cpu'.  mesh_shape (an int N is [N, 1], else [data, model]) serves
every device batch on a mesh of data x model ranks as the CLI does
(`inference`'s docstring): one card a rank over NCCL, or every rank on
card 0 over gloo with share_card=True.  The batcher's thread is the only
one that reaches the mesh (`engine.dispatch_device_batch`); the request
threads never do.  use_native is the engine's (the TSV loops' decode;
requests decode with the transform, as in gitax).  One change to gitax's
server: its listen backlog is 128 connections, not socketserver's 5,
which resets a burst of concurrent connections before they are
accepted.
"""

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .common import dispatch_main


def build_serving_stack(model_name, batch_size=32, max_wait_ms=4.0,
                        dtype="bfloat16", int8=False, num_beams=4,
                        max_steps=40, max_text_len=40, use_native=None,
                        mesh_shape=None, max_hold_ms=None, device=None, share_card=False):
    """Model + CaptionEngine + DynamicBatcher for `model_name`, built like
    the TSV batch CLI (inference.py); on the card unless device='cpu'.
    With mesh_shape the engine is rank 0's of the mesh (closing it stops
    the other ranks); under a launch of data x model processes, ranks 1..
    serve rank 0's batches and return (None, None) when it closes."""
    import torch

    from .decode.beam import BeamSearchConfig
    from .inference import _build_model, _load_param, _load_tokenizer
    from .preprocess.transforms import get_image_transform
    from .runtime.engine import CaptionEngine, open_mesh_engine, resolve_use_native
    from .runtime.serving import DynamicBatcher

    use_native = resolve_use_native(use_native)  # before any rank starts
    param = _load_param(model_name)
    tdtype = getattr(torch, dtype)
    tokenizer = _load_tokenizer()

    engine_kwargs = dict(
        batch_size=batch_size,
        beam=BeamSearchConfig(num_beams=num_beams, max_steps=max_steps),
        # decode length: the engine sizes each prefix bucket's buffer at
        # max(max_steps, prefix_len + max_text_len), so to shorten
        # generation both knobs must come down
        max_text_len=max_text_len,
        dtype=tdtype,
        int8=int8,
        transform=get_image_transform(param),
        use_native=use_native,
    )

    def model_fn(dev):
        return _build_model(model_name, param, dtype=tdtype, device=dev)

    if mesh_shape is None:
        engine = CaptionEngine(model_fn(device), tokenizer, **engine_kwargs)
    else:
        engine = open_mesh_engine(model_fn, tokenizer, mesh_shape, device=device,
                                  share_card=share_card, **engine_kwargs)
        if engine is None:  # a rank 1.. under a launcher
            return None, None
    return engine, DynamicBatcher(engine, max_wait_ms=max_wait_ms,
                                  max_hold_ms=max_hold_ms)


MAX_BODY_BYTES = 32 * 1024 * 1024  # reject larger POSTs with 413


def make_http_server(batcher, model_name, host="127.0.0.1", port=8080,
                     request_timeout=120.0):
    """A ThreadingHTTPServer wired to `batcher` (separate from
    serve_caption so that a caller can drive it on an ephemeral port).

    Binds localhost by default; pass host='0.0.0.0' explicitly to expose
    the (unauthenticated) endpoint beyond the machine."""
    from .runtime.serving import OverloadedError

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code, payload, close=False):
            # close=True for replies sent WITHOUT draining the request
            # body: on a keep-alive connection the unread body bytes would
            # be parsed as the next request line
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if close:
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "model": model_name})
            elif self.path == "/stats":
                self._reply(200, batcher.snapshot())
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path != "/v1/caption":
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    self._reply(400, {"error": "bad Content-Length"}, close=True)
                    return
                if length < 0:
                    self._reply(400, {"error": "negative Content-Length"}, close=True)
                    return
                if length > MAX_BODY_BYTES:
                    # body is left unread: the connection must close
                    self._reply(413, {"error": "body exceeds %d bytes" % MAX_BODY_BYTES},
                                close=True)
                    return
                req = json.loads(self.rfile.read(length) or b"{}")
                if "image" not in req:
                    self._reply(400, {"error": "missing 'image' (base64)"})
                    return
                caption = batcher.caption(req["image"], question=req.get("question", ""),
                                          timeout=request_timeout)
                self._reply(200, {"caption": caption})
            except OverloadedError as e:
                # admission control tripped: tell load balancers to back off
                self._reply(503, {"error": str(e)})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — HTTP boundary
                logging.exception("request failed")
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *args):
            logging.info("http: " + fmt, *args)

    class Server(ThreadingHTTPServer):
        # the listen backlog: socketserver's default of 5 resets a burst
        # of concurrent clients' connections before they are accepted
        request_queue_size = 128

    return Server((host, port), Handler)


def serve_caption(model_name, host="127.0.0.1", port=8080, batch_size=32,
                  max_wait_ms=4.0, dtype="bfloat16", int8=False,
                  num_beams=4, max_steps=40, max_text_len=40,
                  use_native=None, warmup=True, run_seconds=None,
                  warm_prefix_lens=(1,), mesh_shape=None, max_hold_ms=None,
                  device=None, share_card=False):
    """Start the endpoint.  warmup: run every bucket size (plus any
    expected VQA prefix lengths) before accepting traffic, so that the
    kernels' first build and cuBLAS's first calls do not stall the
    batcher thread.  run_seconds: exit after N seconds; None = forever.
    host: localhost by default; '0.0.0.0' exposes it externally."""
    engine, batcher = build_serving_stack(
        model_name, batch_size=batch_size, max_wait_ms=max_wait_ms,
        dtype=dtype, int8=int8, num_beams=num_beams, max_steps=max_steps,
        max_text_len=max_text_len, use_native=use_native,
        mesh_shape=mesh_shape, max_hold_ms=max_hold_ms, device=device, share_card=share_card,
    )
    if engine is None:  # a rank 1.. of a mesh under a launcher: rank 0 has closed
        return
    try:
        if warmup:
            batcher.warm(prefix_lens=tuple(warm_prefix_lens))
            logging.info("warm-up done (buckets %s, prefix lens %s)",
                         batcher.buckets, tuple(warm_prefix_lens))
        httpd = make_http_server(batcher, model_name, host, port)
        logging.info("serving %s on %s:%d", model_name, host, port)
        timer = None
        if run_seconds is not None:
            timer = threading.Timer(float(run_seconds), httpd.shutdown)
            timer.start()
        try:
            httpd.serve_forever()
        finally:
            if timer is not None:
                timer.cancel()
            httpd.server_close()
    finally:
        batcher.close()
        engine.close()


if __name__ == "__main__":
    dispatch_main(globals())
