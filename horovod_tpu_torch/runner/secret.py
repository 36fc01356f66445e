"""Per-job shared secret for control-plane authentication.

Reference: horovod/runner/common/util/secret.py (random per-job key) +
network.py:306 (every launcher/task message carries an HMAC digest computed
with that key, and unsigned/mis-signed messages are rejected).

Port of the JAX package's ``runner/secret.py``. The launcher's control plane
is the HTTP KV store (runner/http_kv.py); the same model applies: the
launcher mints one key per job, ships it to workers through the environment
(``HOROVOD_SECRET_KEY``), and every KV request and response is
HMAC-SHA256-signed. This authenticates traffic — it does not encrypt it,
matching the reference's threat model.
"""

import hmac
import secrets

SECRET_ENV = "HOROVOD_SECRET_KEY"
DIGEST = "sha256"


def make_secret_key() -> str:
    """Random 256-bit hex key (reference: secret.py make_secret_key)."""
    return secrets.token_hex(32)


def compute_digest(secret: str, *parts: bytes) -> str:
    mac = hmac.new(secret.encode(), digestmod=DIGEST)
    for p in parts:
        mac.update(p)
        mac.update(b"\x00")
    return mac.hexdigest()


def check_digest(secret: str, digest: str, *parts: bytes) -> bool:
    if not digest:
        return False
    return hmac.compare_digest(compute_digest(secret, *parts), digest)
