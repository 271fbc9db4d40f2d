"""Minimal production inference endpoint over a serving artifact.

    python -m cfpnet_torch.serve.http --artifact artifacts/cfpnet [--port 8000]
                                      [--batch_wait_ms 2]

Port of ``tools/serve_http.py`` (``MicroBatcher``, ``predict_npz``,
``make_server``): a stdlib-only HTTP server in front of
``cfpnet_torch.serve.ServingModel``. The deployment is: export
(``python -m cfpnet_torch.export_serving``) -> validate
(``python -m cfpnet_torch.evaluate_all --serving_artifact``) -> serve (this).

Protocol (binary, numpy .npz both ways — no base64 inflation):

  GET  /healthz    -> 200 "ok" once the model answered a warmup predict
  GET  /manifest   -> the artifact's manifest.json
  POST /predict    -> body: .npz with
                        image_u8 [N,H,W,3] uint8   raw RGB
                        hist     [N,Z,S]   float32 sampled zone depth points
                        mask     [N,Z]     bool    valid zones
                      response: .npz with depth [N,H,W] float32 (meters)

Requests of any N are padded/chunked through the exported static batch
sizes by ``ServingModel.predict`` (one CUDA graph per exported size on the
card; the pad rows are zero images with all-invalid masks, sliced off
before the response). ``--sharded`` serves through
``ServingModel.predict_sharded`` instead: each batch split over the local
cards.

Concurrent requests are micro-batched: a single dispatcher thread owns the
device and coalesces whatever is queued (up to ``--batch_wait_ms`` after
the first request, up to the largest exported batch size) into one
batched call, so N concurrent bs=1 clients approach the batched
throughput instead of serializing N padded bs=1 calls.
``--batch_wait_ms 0`` restores strict one-request-per-call serving. The
warmup runs one predict per exported batch size, which captures its
graph, so no client pays for a capture.
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

REQUIRED = ("image_u8", "hist", "mask")


class MicroBatcher:
    """Coalesce concurrent predict calls into one batched device call.

    One dispatcher thread owns the device: it takes the first queued
    request, waits up to ``max_wait_s`` for more (stopping early once
    ``max_rows`` — the largest exported batch size — are queued),
    concatenates along the batch axis, runs ONE ``predict_fn``, and slices
    the results back per request. Every request's arrays are already
    shape-validated against the manifest (predict_npz), so concatenation is
    always well-formed. ``predict_fn`` chunks anything larger than the
    largest exported size internally (``ServingModel._chunked``)."""

    class _Item:
        __slots__ = ("arrays", "n", "event", "result", "error")

        def __init__(self, arrays):
            self.arrays = arrays
            self.n = int(arrays[0].shape[0])
            self.event = threading.Event()
            self.result = None
            self.error = None

    def __init__(self, predict_fn, max_rows: int, max_wait_s: float = 0.002):
        self.predict_fn = predict_fn
        self.max_rows = max(1, int(max_rows))
        self.max_wait_s = float(max_wait_s)
        self.batches_run = 0
        self.rows_run = 0
        self._q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-microbatch")
        self._thread.start()

    def submit(self, image_u8, hist, mask) -> np.ndarray:
        item = self._Item((np.asarray(image_u8), np.asarray(hist),
                           np.asarray(mask)))
        self._q.put(item)
        item.event.wait()
        if item.error is not None:
            raise item.error
        return item.result

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            items = [first]
            rows = first.n
            deadline = time.monotonic() + self.max_wait_s
            while rows < self.max_rows:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # re-post shutdown for after this batch
                    break
                items.append(nxt)
                rows += nxt.n
            try:
                cat = [np.concatenate([it.arrays[k] for it in items], axis=0)
                       for k in range(3)]
                depth = self.predict_fn(*cat)
                self.batches_run += 1
                self.rows_run += rows
                off = 0
                for it in items:
                    it.result = depth[off:off + it.n]
                    off += it.n
            except Exception as e:  # poison only this batch's requests
                for it in items:
                    it.error = e
            finally:
                for it in items:
                    it.event.set()


def predict_npz(model, body: bytes, sharded: bool = False,
                run=None) -> bytes:
    """Decode a request .npz, run the artifact, encode the response .npz.

    ``run(image_u8, hist, mask)`` overrides the predict callable (the
    server passes the micro-batcher's ``submit`` here). Raises ValueError
    on malformed payloads (missing arrays, wrong rank, mismatched batch) —
    mapped to HTTP 400 by the handler."""
    try:
        with np.load(io.BytesIO(body)) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        raise ValueError(f"body is not a readable .npz: {e}") from e
    missing = [k for k in REQUIRED if k not in arrays]
    if missing:
        raise ValueError(f"missing arrays in request: {missing}; "
                         f"need {list(REQUIRED)}")
    img, hist, mask = (arrays[k] for k in REQUIRED)
    if img.ndim != 4 or img.shape[-1] != 3:
        raise ValueError(f"image_u8 must be [N,H,W,3], got {img.shape}")
    if hist.ndim != 3 or mask.ndim != 2:
        raise ValueError(
            f"hist must be [N,Z,S] and mask [N,Z], got {hist.shape}, "
            f"{mask.shape}")
    if not (img.shape[0] == hist.shape[0] == mask.shape[0]):
        raise ValueError(
            f"batch mismatch: image {img.shape[0]}, hist {hist.shape[0]}, "
            f"mask {mask.shape[0]}")
    spec = model.manifest["input"]
    want_hw = tuple(spec["image_u8"][1:3])
    if tuple(img.shape[1:3]) != want_hw:
        raise ValueError(
            f"artifact expects {want_hw[0]}x{want_hw[1]} images, got "
            f"{img.shape[1]}x{img.shape[2]}")
    if run is None:
        run = model.predict_sharded if sharded else model.predict
    depth = run(img, hist, mask)
    out = io.BytesIO()
    np.savez(out, depth=depth.astype(np.float32))
    return out.getvalue()


def make_server(artifact: str, port: int = 0, sharded: bool = False,
                batch_wait_ms: float = 2.0, device=None, host: str = ""):
    """Build (but don't start) the HTTP server; returns it warmed up.

    Warmup runs one predict per exported batch size, so no client request
    pays for loading a program or capturing its CUDA graph. ``device``
    must be the artifact's (default: it). The server listens on ``host``
    (default: every interface) at ``port`` (0: a free one). ``sharded``
    serves through ``predict_sharded`` (the local cards).

    ``batch_wait_ms > 0`` (default 2 ms) serves through a MicroBatcher:
    concurrent requests coalesce into one batched device call (see module
    docstring). 0 restores the strict lock-serialized per-request path."""
    from .export import ServingModel

    model = ServingModel(artifact, device)
    lock = threading.Lock()

    spec = model.manifest["input"]
    h, w = spec["image_u8"][1], spec["image_u8"][2]
    zones, s = spec["hist"][1], spec["hist"][2]
    fn = model.predict_sharded if sharded else model.predict
    for bs in model.batch_sizes:
        try:
            fn(np.zeros((bs, h, w, 3), np.uint8),
               np.full((bs, zones, s), 2.0, np.float32),
               np.ones((bs, zones), bool))
        except ValueError:
            # sharded serving uses only the sizes that split over the cards;
            # requests chunk through those, so this size is never run
            if not sharded:
                raise

    batcher = None
    if batch_wait_ms > 0:
        if max(model.batch_sizes) == 1:
            # a bs=1-only artifact gives coalescing nothing to ride — every
            # coalesced batch would chunk back into bs=1 device calls
            print("note: artifact exports only batch size 1; micro-batching "
                  "has no effect (re-export with --serve_batch_sizes 1 8 to "
                  "let concurrent clients share batched calls)", flush=True)
        batcher = MicroBatcher(fn, max_rows=max(model.batch_sizes),
                               max_wait_s=batch_wait_ms / 1000.0)

    class Handler(BaseHTTPRequestHandler):
        # one artifact per process; quiet request logging to stderr noise
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok", "text/plain")
            elif self.path == "/manifest":
                self._send(200, json.dumps(model.manifest).encode(),
                           "application/json")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            try:
                if batcher is not None:
                    # decode+validate on the HTTP thread; the dispatcher
                    # thread owns the device and coalesces queued requests
                    out = predict_npz(model, body, run=batcher.submit)
                else:
                    with lock:  # one device at a time; threads queue here
                        out = predict_npz(model, body, sharded=sharded)
            except ValueError as e:
                self._send(400, str(e).encode(), "text/plain")
                return
            self._send(200, out, "application/octet-stream")

    server = ThreadingHTTPServer((host, port), Handler)
    server.artifact_model = model  # for tests/introspection
    server.batcher = batcher
    return server


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", required=True,
                    help="serving artifact directory (python -m cfpnet_torch.export_serving)")
    ap.add_argument("--host", default="", help="address to listen on (default: every interface)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--sharded", action="store_true",
                    help="split each batch over the local cards (predict_sharded)")
    ap.add_argument("--batch_wait_ms", type=float, default=2.0,
                    help="micro-batching window after the first queued "
                         "request (0 disables coalescing)")
    args = ap.parse_args(argv)
    server = make_server(args.artifact, args.port, sharded=args.sharded,
                         batch_wait_ms=args.batch_wait_ms, host=args.host)
    print(f"serving {args.artifact} on :{server.server_address[1]}", flush=True)
    server.serve_forever()


if __name__ == "__main__":
    main()
