"""Worker-side bootstrap for ``horovod_tpu_torch.runner.run()``.

Reference: horovod/runner/run_task.py + task_fn.py — loads the cloudpickled
function, initializes, executes, reports the result. Port of the JAX
package's ``runner/task.py``: the function comes from the launcher's KV
store, ``hvd.init()`` (``common/basics.py``) takes the place of the
``jax.distributed`` bootstrap, and the result goes back to the store keyed
by rank. The goodput hooks are not ported (ROADMAP A16).
"""

import json
import os
import socket
import sys


def _load_payload(spec):
    """``kv:scope/key`` fetches the pickled function from the launcher's KV
    store (no shared filesystem needed); anything else is a local path."""
    if spec.startswith("kv:"):
        from horovod_tpu_torch.runner.http_kv import KVStoreClient
        scope, key = spec[3:].split("/", 1)
        client = KVStoreClient(os.environ["HOROVOD_KV_ADDR"],
                               int(os.environ["HOROVOD_KV_PORT"]))
        return client.wait_for(scope, key, timeout=60)
    with open(spec, "rb") as f:
        return f.read()


def register_bootstrap():
    """Reachability probe, called as ``hvd.init()`` starts in a launched
    worker: record which address this worker routes to the launcher from,
    keyed by its rank (reference: task_fn.py:23-54 — tasks probe routable
    NICs so the launcher can diagnose dead launches early). The signed KV
    write is the routability proof; a failure is reported, never fatal."""
    kv_addr = os.environ.get("HOROVOD_KV_ADDR")
    kv_port = os.environ.get("HOROVOD_KV_PORT")
    if not (kv_addr and kv_port):
        return
    try:
        from horovod_tpu_torch.runner.http_kv import KVStoreClient
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((kv_addr, int(kv_port)))
            src = s.getsockname()[0]
        KVStoreClient(kv_addr, int(kv_port), timeout=5, retries=0).put(
            "bootstrap", os.environ.get("HOROVOD_RANK", "0"),
            json.dumps({"hostname": socket.gethostname(), "src_addr": src,
                        "pid": os.getpid()}).encode())
    except Exception as e:  # noqa: BLE001 — diagnostic only
        print(f"# bootstrap probe failed (continuing): {e}", file=sys.stderr)


def main():
    import cloudpickle
    func, args, kwargs, device = cloudpickle.loads(_load_payload(sys.argv[1]))

    import horovod_tpu_torch as hvd
    hvd.init(device=device)
    result = func(*args, **kwargs)

    kv_addr = os.environ.get("HOROVOD_KV_ADDR")
    kv_port = os.environ.get("HOROVOD_KV_PORT")
    if kv_addr and kv_port:
        from horovod_tpu_torch.runner.http_kv import KVStoreClient
        KVStoreClient(kv_addr, int(kv_port)).put(
            "results", str(hvd.rank()), cloudpickle.dumps(result))
    hvd.shutdown()


if __name__ == "__main__":
    main()
