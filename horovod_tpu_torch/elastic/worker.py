"""Worker-side elastic plumbing: membership-change detection.

Port of the JAX package's ``elastic/worker.py`` (reference:
horovod/runner/elastic/worker.py WorkerNotificationService, where the
driver pushes HostsUpdated to the workers). Workers poll the elastic
driver's version counter in the launcher's KV store (HOROVOD_KV_ADDR/PORT);
``runner/elastic/driver.py`` writes it. Where the JAX workers are one per
host, the port's are one per slot: the ready barrier counts the version's
slots, and a worker reads the assignment row of its own slot (host and
local rank). The membership watchdog records the ``abort`` elastic event
and dumps the flight ring (``membership_abort``) before it aborts the
group, as JAX's does. ``mark_new_rank_ready`` is the
``elastic.rendezvous`` chaos site (a delay there holds the whole membership
at the ready barrier: a slow-to-rejoin host).
"""

import json
import os
import threading
import time

from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.common.exceptions import HostsUpdatedInterrupt
from horovod_tpu_torch.runner.http_kv import KVStoreClient


def _kv_client(timeout=30):
    """The launcher's KV store under an elastic launch, else None."""
    addr = os.environ.get("HOROVOD_KV_ADDR")
    port = os.environ.get("HOROVOD_KV_PORT")
    if not (addr and port and Config.from_env().elastic):
        return None
    return KVStoreClient(addr, int(port), timeout=timeout)


def _latest(client):
    return (client.get("elastic", "version") or b"0").decode()


class HostUpdateListener:
    """Polls the driver's membership version; attached to a ``State`` by
    :func:`attach_listener`, it makes ``State.commit`` raise
    ``HostsUpdatedInterrupt`` at a new version."""

    def __init__(self, addr=None, port=None):
        addr = addr or os.environ.get("HOROVOD_KV_ADDR")
        port = port or os.environ.get("HOROVOD_KV_PORT")
        self._client = KVStoreClient(addr, int(port)) if addr and port \
            else None
        self._seen = self._current()

    def _current(self):
        if self._client is None:
            return 0
        return int(_latest(self._client))

    def poll(self):
        """The new version if one was published since the last
        acknowledge, else None: one read, so the caller acknowledges
        exactly what it saw."""
        v = self._current()
        return v if v != self._seen else None

    def acknowledge(self, version=None):
        """Mark a version consumed. Pass the version acted upon: a fresh
        read could swallow a bump published in between."""
        self._seen = int(version) if version is not None else self._current()

    def removal_only(self, observed):
        """Whether every version since the last acknowledged one, up to
        ``observed``, only removed slots: survivors may then skip the state
        sync and keep their uncommitted progress (reference:
        HostUpdateResult.removed -> skip_sync, common/elastic.py). An
        unknown kind or a KV error syncs. Call before ``acknowledge``; the
        elastic loop's vote makes the decision unanimous."""
        if self._client is None:
            return False
        try:
            for v in range(int(self._seen) + 1, int(observed) + 1):
                if self._client.get("elastic",
                                    f"update_kind/{v}") != b"removal":
                    return False
        except Exception:  # noqa: BLE001 — a transient KV error: sync
            return False
        return True


def configured_version():
    """The membership version this worker runs at: the one it was spawned
    or last re-initialized under (HOROVOD_ELASTIC_INIT_VERSION), never a
    fresh KV read, or a worker configured for v2 could join v3's barrier
    with v2's world view."""
    if "HOROVOD_ELASTIC_INIT_VERSION" in os.environ:
        return str(Config.from_env().elastic_init_version)
    client = _kv_client()
    return "0" if client is None else _latest(client)


def mark_new_rank_ready():
    """Announce that this (possibly new) worker is initialized for its
    configured version (reference: the fork's horovod_mark_new_rank_ready,
    operations.cc:1264-1305): a KV write keyed by (version, rank). No-op
    outside an elastic launch."""
    client = _kv_client()
    if client is None:
        return
    if _chaos.armed:
        _chaos.fire("elastic.rendezvous")
    client.put(f"new_rank_ready/{configured_version()}",
               os.environ.get("HOROVOD_RANK", "0"), b"1")


def read_new_rank_ready(timeout=600):
    """Block until every slot of this worker's version has marked itself
    ready; True when the world is complete (reference: the fork's
    horovod_read_new_rank_ready + ProcessSetTable::CheckNewRankReady,
    process_set.h:142-145). Raises ``HostsUpdatedInterrupt`` if the driver
    publishes a newer version meanwhile: this barrier can then never
    complete. Returns at once outside an elastic launch."""
    client = _kv_client()
    if client is None:
        return True
    version = configured_version()
    # The version's own count: pairing v's marks with a newer version's
    # count could release the barrier early on a scale-down. When its row
    # is collected (this worker lags two versions), its own spawn-time size
    # is the same version's.
    nslots = int(client.get("elastic", f"nslots/{version}") or
                 os.environ.get("HOROVOD_SIZE", "1"))
    deadline = time.time() + timeout
    seen = set()    # marks are monotonic: never re-poll a seen rank
    while time.time() < deadline:
        for r in range(nslots):
            if r not in seen and client.get(f"new_rank_ready/{version}",
                                            str(r)) is not None:
                seen.add(r)
        if len(seen) >= nslots:
            return True
        if _latest(client) != version:
            raise HostsUpdatedInterrupt(skip_sync=False)
        time.sleep(0.1)
    raise TimeoutError(
        f"only part of membership v{version} marked ready within {timeout}s")


def wait_for_version_change(known_version, timeout=30.0, interval=0.2):
    """Block until the driver publishes a version other than
    ``known_version``; returns the version then, or ``known_version`` after
    ``timeout`` (a retry at an unchanged membership). Returns at once
    outside an elastic launch."""
    client = _kv_client()
    if client is None:
        return str(known_version)
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = _latest(client)
        if v != str(known_version):
            return v
        time.sleep(interval)
    return str(known_version)


def refresh_assignment_env():
    """Read this slot's row of the current version and update the rank,
    size and coordinator env that the next ``hvd.init`` reads (reference:
    the elastic rendezvous's GET /rank_and_size/host:local_rank,
    runner/elastic/rendezvous.py:37-42). Returns the version consumed, so
    the caller acknowledges exactly it, or None when this slot is not a
    member any more (the worker should exit). Outside an elastic launch,
    "0" and nothing changes."""
    client = _kv_client()
    if client is None:
        return "0"
    config = Config.from_env()
    version = _latest(client)
    if not config.host_key:
        return version
    row = client.get("assignment",
                     f"{version}/{config.host_key}/{config.local_rank}")
    if row is None:
        return None
    a = json.loads(row)
    os.environ.update({
        "HOROVOD_RANK": str(a["rank"]),
        "HOROVOD_SIZE": str(a["size"]),
        "HOROVOD_LOCAL_SIZE": str(a["local_size"]),
        "HOROVOD_CROSS_RANK": str(a["cross_rank"]),
        "HOROVOD_CROSS_SIZE": str(a["cross_size"]),
        "HOROVOD_COORDINATOR_ADDR": a["coordinator_addr"],
        "HOROVOD_COORDINATOR_PORT": str(a["coordinator_port"]),
        "HOROVOD_ELASTIC_INIT_VERSION": version,
    })
    return version


# --- the membership watchdog ---------------------------------------------
#
# KV polling tells a worker of a new membership; the watchdog is the other
# half of the reference's push (the gloo context is aborted so collectives
# in flight raise on every rank at once). While the user function runs, a
# published version that removed a slot aborts this process's group
# (basics.abort): a collective blocked on a dead peer then raises
# HorovodInternalError, which the elastic loop recovers from, on every rank
# rather than only on the dead peer's neighbours. Where the JAX watchdog
# severs its data-plane sockets, this one aborts the torch.distributed group
# (NCCL aborts its communicators; gloo's blocked call ends when the dead
# peer's connection does).

_WATCH_INTERVAL = 0.5

_watch_lock = threading.Lock()
_watch_thread = None
_watch_stop = None         # the running watchdog's stop event
_armed_version = None      # the version the training function runs at
_last_abort_version = 0    # never abort for the same bump twice


def arm_collective_abort(version):
    """Watch for a disruptive version while training runs at ``version``;
    no-op outside an elastic launch."""
    global _watch_thread, _watch_stop, _armed_version
    if _kv_client() is None:
        return
    with _watch_lock:
        _armed_version = int(version)
        if _watch_thread is None or not _watch_thread.is_alive():
            # An event per thread: a watchdog that outlives its stop's join
            # still sees its own event set, whatever a new one does.
            _watch_stop = threading.Event()
            _watch_thread = threading.Thread(
                target=_watch_loop, args=(_watch_stop,),
                name="hvd-membership-watchdog", daemon=True)
            _watch_thread.start()


def disarm_collective_abort():
    """Stop aborting (training unwound into recovery, whose new group must
    not be aborted for the version it is joining). Waits for an abort in
    progress."""
    global _armed_version
    with _watch_lock:
        _armed_version = None


def stop_collective_abort(timeout=2.0):
    """End the watchdog thread (``hvd.shutdown``'s path). Unlike
    :func:`disarm_collective_abort`, which idles the loop so that a re-arm
    is cheap, this ends it: a process torn down must not keep polling the
    KV store for a membership. The next :func:`arm_collective_abort`
    starts a new one."""
    global _watch_thread, _watch_stop
    with _watch_lock:
        t, stop = _watch_thread, _watch_stop
        _watch_thread = _watch_stop = None
    if stop is not None:
        stop.set()
    if t is not None and t.is_alive() \
            and t is not threading.current_thread():
        t.join(timeout=timeout)


def _removed_since(client, armed, current):
    """Whether a version in (armed, current] removed a slot. A collected
    row means this worker lags two versions: its collective is doomed."""
    return any(client.get("elastic", f"removed/{v}") != b"0"
               for v in range(int(armed) + 1, int(current) + 1))


def _watch_loop(stop):
    global _last_abort_version
    client = _kv_client()
    if client is None:
        return
    while not stop.wait(_WATCH_INTERVAL):
        with _watch_lock:
            armed = _armed_version
        if armed is None:
            continue
        try:
            current = int(_latest(client))
            if current <= max(armed, _last_abort_version) or \
                    not _removed_since(client, armed, current):
                continue
        except Exception:  # noqa: BLE001 — a transient KV error: retry
            continue
        with _watch_lock:
            # Again under the lock: the main thread may have unwound into
            # recovery, or re-armed at the very version seen here, whose
            # new group must live.
            if _armed_version is None or current <= _armed_version \
                    or current <= _last_abort_version:
                continue
            _last_abort_version = current
        hvd_logging.warning(
            "membership v%d removed a slot while training at v%d: "
            "aborting the process group", current, armed)
        # Dump BEFORE severing: the ring's tail is the in-flight collective
        # the abort is about to end. The dump is file I/O, so it runs
        # outside the lock that disarm_collective_abort waits on.
        from horovod_tpu_torch.flight import recorder as _flight
        from horovod_tpu_torch.metrics import instruments as _metrics
        _metrics.record_elastic_event("abort")
        _flight.dump("membership_abort")
        with _watch_lock:
            # Once more: the main thread may have unwound into recovery
            # during the dump, and the abort must end only the group the
            # disruptive version dooms. Under the lock, so disarm waits
            # for an abort in progress.
            if _armed_version is None or current <= _armed_version:
                continue
            basics.abort(f"membership v{current} removed a slot while this "
                         f"worker trained at v{armed}")


def attach_listener(state):
    """Attach a KV listener to an elastic ``State`` under an elastic launch
    (no-op otherwise)."""
    if _kv_client() is not None:
        state._host_messages = HostUpdateListener()
    return state
