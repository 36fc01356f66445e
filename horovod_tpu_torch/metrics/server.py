"""Prometheus-style scrape endpoint for the metrics registry.

Port of the JAX package's ``metrics/server.py``: a stdlib threaded HTTP
server (no new dependencies). ``GET /metrics`` returns the registry in text
exposition format 0.0.4; ``GET /serving/health`` returns the serving
engine's readiness frame (503 when no engine runs in this process). Started
by ``hvd.init()`` when ``HOROVOD_METRICS`` and ``HOROVOD_METRICS_PORT`` are
set (each process binds ``port + local_rank``), or by
:func:`start_http_server`.

The debug routes, as JAX's: ``GET /debug/profile?ms=<window>`` captures a
``torch.profiler`` trace for that window (409 while another capture or
profiler session runs), ``GET /debug/steps?last=<n>`` serves the step
profiler's summary and recent records, ``GET /debug/flight`` the flight
ring as JSONL. The cluster routes (``/cluster/health``,
``/cluster/steps``, ``/cluster/metrics``) read the cluster telemetry plane,
which comes with A16's second half; until then they answer 404 with a body
that says so.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_CLUSTER_ROUTES = ("/cluster/health", "/cluster/steps", "/cluster/metrics")


class _MetricsHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence
        pass

    def _send(self, body, code=200, content_type="application/json"):
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        split = urlsplit(self.path)
        path = split.path
        if path in _CLUSTER_ROUTES:
            self._send(json.dumps(
                {"error": f"{path} is not served by the PyTorch port yet "
                          "(ROADMAP A16's second half: the cluster "
                          "telemetry plane)"}),
                code=404)
            return
        if path == "/debug/profile":
            # A capture of ?ms=<window> (default 1000, clamped) on this
            # handler thread, exported under HOROVOD_PROFILE_DIR; 409 when
            # a capture or another profiler session is running.
            from horovod_tpu_torch.profile import capture
            try:
                ms = int(parse_qs(split.query).get("ms", ["1000"])[0])
            except ValueError:
                ms = 1000
            ms = capture.clamp_ms(ms)
            d = capture.capture_ms(ms, tag="debug_endpoint")
            if d is None:
                self._send(json.dumps(
                    {"error": capture.last_refusal
                     or "capture already running"}), code=409)
                return
            self._send(json.dumps({"path": d, "ms": ms}))
            return
        if path == "/debug/steps":
            # The step profiler's recent records and aggregate: the live
            # counterpart of the HVD_STEP_REPORT_FILE stream.
            from horovod_tpu_torch.profile import ledger
            try:
                last = int(parse_qs(split.query).get("last", ["32"])[0])
            except ValueError:
                last = 32
            self._send(json.dumps({
                "summary": ledger.step_report_summary(),
                "records": ledger.get().records(last=last)}))
            return
        if path == "/debug/flight":
            # The flight ring served directly (meta line + events as
            # JSONL), no file written.
            from horovod_tpu_torch.flight import recorder as _flight
            self._send(_flight.render_jsonl("debug_endpoint"),
                       content_type="application/jsonl")
            return
        if path == "/serving/health":
            # The serving engine's readiness frame; 503 when no engine runs
            # in this process: a load-balancer probe must fail closed.
            from horovod_tpu_torch.serving.engine import serving_snapshot
            snap = serving_snapshot()
            if snap is None:
                self._send(json.dumps(
                    {"error": "no serving engine in this process"}),
                    code=503)
                return
            self._send(json.dumps(snap))
            return
        if path not in ("/metrics", "/"):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self._send(self.server.registry.render_text(),
                   content_type=CONTENT_TYPE)


class MetricsServer:
    """Background scrape server over one registry; ``port=0`` binds a free
    port (read it back from ``.port`` after ``start()``)."""

    def __init__(self, port=0, registry=None, addr="0.0.0.0"):
        from horovod_tpu_torch.metrics.instruments import REGISTRY
        self._httpd = ThreadingHTTPServer((addr, port), _MetricsHandler)
        self._httpd.registry = registry if registry is not None else REGISTRY
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="hvd-metrics-scrape")
        self._thread.start()
        return self.port

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


_server = None
_server_lock = threading.Lock()


def start_http_server(port=0, registry=None, addr="0.0.0.0"):
    """Start (or return) the process-wide scrape server; returns the bound
    port. Idempotent: a second call returns the running server's port."""
    global _server
    with _server_lock:
        if _server is None:
            s = MetricsServer(port=port, registry=registry, addr=addr)
            s.start()
            _server = s
        return _server.port


def stop_http_server():
    global _server
    with _server_lock:
        if _server is not None:
            _server.stop()
            _server = None


def http_server_port():
    """Bound port of the running scrape server, or None."""
    with _server_lock:
        return _server.port if _server is not None else None
