"""HTTP key-value store: the launcher's out-of-band control plane.

Reference: horovod/runner/http/http_server.py (RendezvousServer/KVStoreServer,
PUT/GET/DELETE ``/scope/key``) + http_client.py, and the C++ HTTPStore client
(horovod/common/gloo/http_store.cc) that workers use to rendezvous.

Port of the JAX package's ``runner/http_kv.py``: ``KVStoreServer`` and
``KVStoreClient`` with the per-job HMAC digest on every request and
response, 404s included. The process group bootstraps through the
``TCPStore`` rank 0 serves (``common/basics.py``); this store carries what
the launcher and the workers exchange around it: ``run()``'s pickled
function and results, the workers' bootstrap probes, and the elastic
driver's membership versions, assignment rows and ready marks. The JAX store's
chaos, flight-recorder and metrics hooks (``record_http_kv``,
``record_kv_retry``, the ``kv_retry``/``kv_error`` events) and its per-slice
shard router come with the control plane (ROADMAP A17).
"""

import os
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerror
from urllib import request as urlrequest

from horovod_tpu_torch.common.config import _env_float, _env_int
from horovod_tpu_torch.runner.secret import (SECRET_ENV, check_digest,
                                             compute_digest)

SIG_HEADER = "X-Hvd-Sig"

# The JAX package's Config defaults for the client's retries.
KV_RETRIES = 3
KV_RETRY_BACKOFF_MS = 50.0
KV_RETRY_BACKOFF_MAX_MS = 2000.0


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


def _no_shards():
    if os.environ.get("HOROVOD_KV_SHARD_PORTS"):
        raise NotImplementedError(
            "HOROVOD_KV_SHARD_PORTS: the sharded KV control plane (per-slice "
            "shard listeners and the scope router) is not ported to "
            "horovod_tpu_torch yet (ROADMAP A17); unset it")


class KVStoreServer:
    """reference: http_server.py KVStoreServer (threaded, scoped KV)."""

    def __init__(self, port=0, secret=None):
        _no_shards()
        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), _KVHandler)
        self._httpd.store = {}
        self._httpd.lock = threading.Lock()
        self._httpd.secret = secret if secret is not None \
            else os.environ.get(SECRET_ENV)
        self._thread = None

    @property
    def port(self):
        return self._httpd.server_address[1]

    def start(self):
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        # shutdown() handshakes with serve_forever and would block forever
        # if start() was never called; close the listener either way.
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    # Direct (in-process) access for the launcher side.
    def get(self, scope, key):
        with self._httpd.lock:
            return self._httpd.store.get(scope, {}).get(key)

    def put(self, scope, key, value):
        with self._httpd.lock:
            self._httpd.store.setdefault(scope, {})[key] = value

    def delete(self, scope, key=None):
        with self._httpd.lock:
            if key is None:
                self._httpd.store.pop(scope, None)
            else:
                self._httpd.store.get(scope, {}).pop(key, None)

    def prune_scope(self, scope, keep_prefixes):
        """Drop every key of ``scope`` that starts with none of
        ``keep_prefixes`` (the elastic driver's garbage collection of
        version-scoped keys)."""
        with self._httpd.lock:
            d = self._httpd.store.get(scope, {})
            for k in [k for k in d
                      if not any(k.startswith(p) for p in keep_prefixes)]:
                del d[k]


class KVStoreClient:
    """reference: http_client.py read_data_from_kvstore/put_data_into_kvstore,
    with per-job HMAC signing (network.py:306)."""

    def __init__(self, addr, port, timeout=30, secret=None, retries=None,
                 backoff_ms=None, backoff_max_ms=None):
        _no_shards()
        self._base = f"http://{addr}:{port}"
        self._timeout = timeout
        self._secret = secret if secret is not None \
            else os.environ.get(SECRET_ENV)
        self._retries = retries if retries is not None \
            else max(_env_int("HOROVOD_KV_RETRIES", KV_RETRIES), 0)
        self._backoff_s = (backoff_ms if backoff_ms is not None
                           else _env_float("HOROVOD_KV_RETRY_BACKOFF_MS",
                                           KV_RETRY_BACKOFF_MS)) / 1000.0
        self._backoff_max_s = (
            backoff_max_ms if backoff_max_ms is not None
            else _env_float("HOROVOD_KV_RETRY_BACKOFF_MAX_MS",
                            KV_RETRY_BACKOFF_MAX_MS)) / 1000.0

    def _request(self, method, path, body=None):
        req = urlrequest.Request(self._base + path, data=body, method=method)
        if self._secret:
            req.add_header(SIG_HEADER, compute_digest(
                self._secret, method.encode(), path.encode(), body or b""))
        return req

    def _open(self, method, path, body=None):
        """One KV RPC with bounded retry on transient transport faults
        (connection reset or refused, HTTP 5xx) under jittered exponential
        backoff; every verb is idempotent. A 4xx, the 404 that ``get``
        reads as "absent" among them, propagates at once."""
        delay = self._backoff_s
        for attempt in range(self._retries + 1):
            try:
                return urlrequest.urlopen(self._request(method, path, body),
                                          timeout=self._timeout)
            except urlerror.HTTPError as e:
                if e.code < 500 or attempt == self._retries:
                    raise
            except (urlerror.URLError, ConnectionError, TimeoutError):
                if attempt == self._retries:
                    raise
            time.sleep(delay * (0.5 + random.random()))
            delay = min(delay * 2, self._backoff_max_s)

    def get(self, scope, key):
        path = f"/{scope}/{key}"
        try:
            with self._open("GET", path) as r:
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
        with self._open("PUT", f"/{scope}/{key}", value):
            pass

    def delete(self, scope, key="*"):
        with self._open("DELETE", f"/{scope}/{key}"):
            pass

    def wait_for(self, scope, key, timeout=60, interval=0.1,
                 max_interval=2.0):
        """Poll until ``scope/key`` appears: capped exponential backoff with
        jitter from ``interval`` up to ``max_interval``."""
        deadline = time.time() + timeout
        delay = max(float(interval), 0.01)
        while True:
            v = self.get(scope, key)
            if v is not None:
                return v
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError(
                    f"KV key {scope}/{key} not set within {timeout}s")
            time.sleep(min(delay * (0.5 + random.random()), remaining))
            delay = min(delay * 2, float(max_interval))
