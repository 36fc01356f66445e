"""HTTP key-value store: the launcher's out-of-band control plane.

Reference: horovod/runner/http/http_server.py (RendezvousServer/KVStoreServer,
PUT/GET/DELETE ``/scope/key``) + http_client.py, and the C++ HTTPStore client
(horovod/common/gloo/http_store.cc) that workers use to rendezvous.

Port of the JAX package's ``runner/http_kv.py``: ``KVStoreServer`` and
``KVStoreClient`` with the per-job HMAC digest on every request and
response, 404s included. The process group bootstraps through the
``TCPStore`` rank 0 serves (``common/basics.py``); this store carries what
the launcher and the workers exchange around it: ``run()``'s pickled
function and results, the workers' bootstrap probes, the elastic driver's
membership versions, assignment rows and ready marks, and the cluster
telemetry plane's beacons, slice summaries and job view.

Sharding (``KVStoreServer(shards=k)``, the launcher's
``--kv-shard-count``): ``k`` more listeners serve the slice-local scopes
(``scope@s<i>``, ``common/control_plane.slice_scope``) by ``i % k``, so no
one listener carries the whole world's telemetry fan-in; the workers learn
their ports from ``HOROVOD_KV_SHARD_PORTS`` and route through the same
``shard_of_scope`` rule, and the server's in-process accessors read through
it, so the launcher still sees one store. The client counts its RPCs
(``record_http_kv``) and retries (``record_kv_retry``, a ``kv_retry`` flight
event; a final failure other than a 404 is a ``kv_error`` event), and each
attempt is the ``http_kv.request`` chaos site.
"""

import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerror
from urllib import request as urlrequest

from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.common.config import Config, _env_float, _env_int
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.runner.secret import (SECRET_ENV, check_digest,
                                             compute_digest)

SIG_HEADER = "X-Hvd-Sig"


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # silence
        pass

    def _parse(self):
        parts = self.path.strip("/").split("/", 1)
        if len(parts) != 2:
            return None, None
        return parts[0], parts[1]

    def _authenticate(self, body: bytes) -> bool:
        """Fail-closed HMAC check when the server holds a job secret
        (reference: network.py:306 — unsigned/mis-signed messages rejected
        before deserialization)."""
        secret = self.server.secret
        if not secret:
            return True
        sig = self.headers.get(SIG_HEADER, "")
        if check_digest(secret, sig, self.command.encode(),
                        self.path.encode(), body):
            return True
        self.send_response(403)
        self.send_header("Content-Length", "0")
        self.end_headers()
        return False

    def do_GET(self):
        if not self._authenticate(b""):
            return
        scope, key = self._parse()
        store = self.server.store
        with self.server.lock:
            value = store.get(scope, {}).get(key)
        if value is None:
            # A 404 is acted on ("key absent"), so it is signed like a 200.
            self.send_response(404)
            self.send_header("Content-Length", "0")
            if self.server.secret:
                self.send_header(SIG_HEADER, compute_digest(
                    self.server.secret, b"RESP404", self.path.encode(), b""))
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        if self.server.secret:
            self.send_header(SIG_HEADER, compute_digest(
                self.server.secret, b"RESP", self.path.encode(), value))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        value = self.rfile.read(length)
        if not self._authenticate(value):
            return
        scope, key = self._parse()
        with self.server.lock:
            self.server.store.setdefault(scope, {})[key] = value
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        if not self._authenticate(b""):
            return
        scope, key = self._parse()
        with self.server.lock:
            if key == "*":
                self.server.store.pop(scope, None)
            else:
                self.server.store.get(scope, {}).pop(key, None)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


class KVStoreServer:
    """reference: http_server.py KVStoreServer (threaded, scoped KV).

    ``shards`` > 0 starts that many more listeners for the slice-local
    scopes (``scope@s<k>`` is served by shard ``k % shards``); ports from
    ``shard_port_base`` on, or ephemeral ones (``shard_ports``). The
    in-process accessors route through the same rule the client does."""

    def __init__(self, port=0, secret=None, shards=0, shard_port_base=0):
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _KVHandler)
        self._httpd.store = {}
        self._httpd.lock = threading.Lock()
        self._httpd.secret = secret if secret is not None \
            else os.environ.get(SECRET_ENV)
        self._thread = None
        self._shards = [
            KVStoreServer(port=(shard_port_base + i) if shard_port_base
                          else 0, secret=secret)
            for i in range(max(int(shards), 0))]

    @property
    def port(self):
        return self._httpd.server_address[1]

    @property
    def shard_ports(self):
        return [s.port for s in self._shards]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        for s in self._shards:
            s.start()
        return self.port

    def stop(self):
        # shutdown() handshakes with serve_forever and would block forever
        # if start() was never called; close the listener either way.
        for s in self._shards:
            s.stop()
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    def _server_for(self, scope):
        """The shard (or the root, self) whose store owns ``scope``."""
        from horovod_tpu_torch.common.control_plane import shard_of_scope
        k = shard_of_scope(scope, len(self._shards))
        return self if k is None else self._shards[k]

    # Direct (in-process) access for the launcher side, scope-routed.
    def get(self, scope, key):
        srv = self._server_for(scope)
        with srv._httpd.lock:
            return srv._httpd.store.get(scope, {}).get(key)

    def put(self, scope, key, value):
        srv = self._server_for(scope)
        with srv._httpd.lock:
            srv._httpd.store.setdefault(scope, {})[key] = value

    def delete(self, scope, key=None):
        srv = self._server_for(scope)
        with srv._httpd.lock:
            if key is None:
                srv._httpd.store.pop(scope, None)
            else:
                srv._httpd.store.get(scope, {}).pop(key, None)

    def prune_scope(self, scope, keep_prefixes):
        """Drop every key of ``scope``, and of its slice-scoped family
        ``scope@s*`` on every shard, that starts with none of
        ``keep_prefixes`` (the elastic driver's garbage collection of
        version-scoped keys)."""
        family_prefix = scope + "@s"
        for srv in [self] + self._shards:
            with srv._httpd.lock:
                for sc in [x for x in srv._httpd.store
                           if x == scope or x.startswith(family_prefix)]:
                    d = srv._httpd.store.get(sc)
                    if not d:
                        continue
                    for k in [k for k in d
                              if not any(k.startswith(p)
                                         for p in keep_prefixes)]:
                        del d[k]


class KVStoreClient:
    """reference: http_client.py read_data_from_kvstore/put_data_into_kvstore,
    with per-job HMAC signing (network.py:306). Slice-local scopes resolve
    to their shard's port (``shard_ports``, default
    ``HOROVOD_KV_SHARD_PORTS``), every other scope to the root."""

    def __init__(self, addr, port, timeout=30, secret=None, retries=None,
                 backoff_ms=None, backoff_max_ms=None, shard_ports=None):
        self._addr = addr
        self._base = f"http://{addr}:{port}"
        if shard_ports is None:
            raw = os.environ.get("HOROVOD_KV_SHARD_PORTS", "")
            shard_ports = [int(p) for p in raw.split(",") if p.strip()]
        self._shard_ports = list(shard_ports or [])
        self._timeout = timeout
        self._secret = secret if secret is not None \
            else os.environ.get(SECRET_ENV)
        self._retries = retries if retries is not None \
            else max(_env_int("HOROVOD_KV_RETRIES", Config.kv_retries), 0)
        self._backoff_s = (backoff_ms if backoff_ms is not None
                           else _env_float("HOROVOD_KV_RETRY_BACKOFF_MS",
                                           Config.kv_retry_backoff_ms)) / 1000.0
        self._backoff_max_s = (
            backoff_max_ms if backoff_max_ms is not None
            else _env_float("HOROVOD_KV_RETRY_BACKOFF_MAX_MS",
                            Config.kv_retry_backoff_max_ms)) / 1000.0

    def _base_for(self, scope):
        from horovod_tpu_torch.common.control_plane import shard_of_scope
        k = shard_of_scope(scope, len(self._shard_ports))
        if k is None:
            return self._base
        return f"http://{self._addr}:{self._shard_ports[k]}"

    def _request(self, method, path, body=None, base=None):
        req = urlrequest.Request((base or self._base) + path, data=body,
                                 method=method)
        if self._secret:
            req.add_header(SIG_HEADER, compute_digest(
                self._secret, method.encode(), path.encode(), body or b""))
        return req

    def _open(self, method, path, body=None, base=None):
        """One KV RPC with bounded retry on transient transport faults
        (connection reset or refused, HTTP 5xx) under jittered exponential
        backoff; every verb is idempotent. A 4xx, the 404 that ``get``
        reads as "absent" among them, propagates at once. Each attempt is
        one call of the ``http_kv.request`` chaos site."""
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                if _chaos.armed:
                    _chaos.fire("http_kv.request",
                                url=(base or self._base) + path)
                return urlrequest.urlopen(
                    self._request(method, path, body, base=base),
                    timeout=self._timeout)
            except urlerror.HTTPError as e:
                if e.code < 500 or attempt == self._retries:
                    # A 404 is get()'s "absent", polled constantly by the
                    # elastic version checks: not an anomaly for the ring.
                    if e.code != 404 and _flight.armed:
                        _flight.record_event("kv_error", name=path,
                                             what=f"http_{e.code}")
                    raise
            except (urlerror.URLError, ConnectionError, TimeoutError) as e:
                if attempt == self._retries:
                    if _flight.armed:
                        _flight.record_event("kv_error", name=path,
                                             what=type(e).__name__)
                    raise
            _metrics.record_kv_retry()
            if _flight.armed:
                _flight.record_event("kv_retry", name=path, seq=attempt)
            time.sleep(delay * (0.5 + random.random()))
            delay = min(delay * 2, self._backoff_max_s)

    def get(self, scope, key):
        path = f"/{scope}/{key}"
        _metrics.record_http_kv("get")
        try:
            with self._open("GET", path, base=self._base_for(scope)) as r:
                value = r.read()
                if self._secret and not check_digest(
                        self._secret, r.headers.get(SIG_HEADER, ""),
                        b"RESP", path.encode(), value):
                    raise PermissionError(
                        f"unsigned/tampered KV response for {path}")
                return value
        except urlerror.HTTPError as e:
            if e.code == 404:
                if self._secret and not check_digest(
                        self._secret, e.headers.get(SIG_HEADER, ""),
                        b"RESP404", path.encode(), b""):
                    raise PermissionError(
                        f"unsigned/tampered KV 404 for {path}") from e
                return None
            raise

    def put(self, scope, key, value: bytes):
        _metrics.record_http_kv("put", payload_bytes=len(value))
        with self._open("PUT", f"/{scope}/{key}", value,
                        base=self._base_for(scope)):
            pass

    def delete(self, scope, key="*"):
        _metrics.record_http_kv("delete")
        with self._open("DELETE", f"/{scope}/{key}",
                        base=self._base_for(scope)):
            pass

    def wait_for(self, scope, key, timeout=60, interval=0.1,
                 max_interval=2.0):
        """Poll until ``scope/key`` appears: capped exponential backoff with
        jitter from ``interval`` up to ``max_interval``, each poll counted
        (``control_plane_rpcs_total{http,wait_poll}``) on top of one
        ``wait``."""
        _metrics.record_http_kv("wait")
        deadline = time.time() + timeout
        delay = max(float(interval), 0.01)
        while True:
            _metrics.record_http_kv("wait_poll")
            v = self.get(scope, key)
            if v is not None:
                return v
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(
                    f"KV key {scope}/{key} not set within {timeout}s")
            time.sleep(min(delay * (0.5 + random.random()), remaining))
            delay = min(delay * 2, float(max_interval))
