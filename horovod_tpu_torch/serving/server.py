"""HTTP request frontend for the serving engine.

Port of the JAX package's ``serving/server.py``, with the same routes and
codes, in the same dependency-free threaded-HTTP idiom as the metrics
scrape endpoint and the runner KV store: ``POST /generate`` with
``{"prompt": [token ids], "max_new": n, "temperature": t, "top_k": k,
"top_p": p, "eos_id": e, "seed": s}`` blocks until the request
completes and answers ``{"rid", "tokens", "generated", "ttft_s"}``;
``GET /health`` returns the engine snapshot (503 + ``Retry-After`` when
the queue is saturated — load balancers read this as backpressure);
``GET /debug/trace/<rid>`` returns the request's live span tree (queue /
prefill / decode / stream phases, requeue/restore markers — see
``horovod_tpu_torch/trace``).

A background drive thread owns every device interaction
(:meth:`ServingEngine.step`: the model, the cache, every CUDA call);
handler threads only enqueue and wait on the request's completion event
and never touch the device, so request concurrency is bounded by
the HTTP thread pool while the decode batch stays at the engine's fixed
slot count — continuous batching does the multiplexing.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.serving.scheduler import QueueFull

_IDLE_SLEEP_S = 0.002


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence
        pass

    def _send(self, obj, code=200, retry_after=None):
        data = json.dumps(obj).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        if retry_after is not None:
            self.send_header("Retry-After", str(retry_after))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path.startswith("/debug/trace/"):
            from horovod_tpu_torch import trace
            rid = self.path[len("/debug/trace/"):]
            tree = trace.tree_for_rid(rid)
            if tree is None:
                # Unknown OR already evicted from the bounded store —
                # the rid in the body tells the caller which id missed.
                self._send({"error": "no trace", "rid": rid}, code=404)
                return
            self._send(tree)
            return
        if self.path not in ("/health", "/serving/health"):
            self._send({"error": "not found"}, code=404)
            return
        snap = self.server.frontend.engine.snapshot()
        if snap.get("saturated"):
            self._send(snap, code=503, retry_after=1)
            return
        self._send(snap)

    def do_POST(self):
        if self.path != "/generate":
            self._send({"error": "not found"}, code=404)
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            prompt = body["prompt"]
            max_new = int(body.get("max_new", 16))
        except (KeyError, TypeError, ValueError,
                json.JSONDecodeError) as e:
            self._send({"error": f"bad request: {e}"}, code=400)
            return
        fe = self.server.frontend
        try:
            req = fe.engine.submit(
                prompt, max_new,
                temperature=float(body.get("temperature", 0.0)),
                top_k=int(body.get("top_k", 0)),
                top_p=float(body.get("top_p", 1.0)),
                eos_id=body.get("eos_id"),
                seed=int(body.get("seed", 0)))
        except QueueFull:
            self._send({"error": "queue full"}, code=503, retry_after=1)
            return
        except (TypeError, ValueError) as e:
            # TypeError: non-numeric JSON values (e.g. "temperature":
            # null) reaching the float()/int() coercions — a client
            # error, not a handler crash.
            self._send({"error": str(e)}, code=400)
            return
        try:
            tokens = req.result(timeout=fe.request_timeout)
        except TimeoutError:
            self._send({"error": "timed out", "rid": req.rid,
                        "generated": len(req.committed)}, code=504)
            return
        self._send({
            "rid": req.rid,
            "tid": req.tid,
            "tokens": [int(t) for t in tokens],
            "generated": len(req.committed),
            "ttft_s": None if req.t_first is None
            else round(req.t_first - req.t_submit, 6)})


class ServingFrontend:
    """Drive thread + HTTP server over one engine; ``port=0`` binds a
    free port (read ``.port`` after :meth:`start`).

    ``drive=False`` starts only the HTTP listener: the caller owns the
    engine loop (the elastic serve path, where stepping and committing
    must share one thread — a commit racing a step could snapshot a
    half-applied decode)."""

    def __init__(self, engine, port=0, addr="0.0.0.0",
                 request_timeout=300.0, drive=True):
        self.engine = engine
        self.request_timeout = float(request_timeout)
        self.drive = bool(drive)
        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self._httpd.frontend = self
        self._stop = threading.Event()
        self._threads = []
        self.drive_errors = 0        # steps that raised on the drive thread

    @property
    def port(self):
        return self._httpd.server_address[1]

    def _drive(self):
        dev = getattr(self.engine, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            try:
                if not self.engine.step():
                    time.sleep(_IDLE_SLEEP_S)
            except Exception as e:  # noqa: BLE001 — keep serving
                # Logged, counted and left in the flight ring.
                self.drive_errors += 1
                from horovod_tpu_torch.flight import recorder as _flight
                _flight.record_event("serving", what="drive_error")
                hvd_logging.warning("serving drive step failed: %r", e)
                time.sleep(0.05)

    def start(self):
        self._threads = [
            threading.Thread(target=self._httpd.serve_forever, daemon=True,
                             name="hvd-serving-http"),
        ]
        if self.drive:
            self._threads.append(
                threading.Thread(target=self._drive, daemon=True,
                                 name="hvd-serving-drive"))
        for t in self._threads:
            t.start()
        return self.port

    def stop(self):
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        # Persist this process's request traces when a dump dir is
        # configured (trace_r<rank>.json): the live /debug/trace/<rid>
        # store dies with the frontend.
        import os
        trace_dir = os.environ.get("HOROVOD_TRACE_DIR", "")
        if trace_dir:
            try:
                from horovod_tpu_torch import trace
                rank = int(os.environ.get("HOROVOD_RANK", "0") or 0)
                os.makedirs(trace_dir, exist_ok=True)
                trace.dump(os.path.join(trace_dir,
                                        f"trace_r{rank}.json"), rank=rank)
            except Exception:  # noqa: BLE001 — dumps must not block stop
                pass
