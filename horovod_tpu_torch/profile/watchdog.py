"""Online straggler/regression watchdog over the step ledger.

Port of the JAX package's ``profile/watchdog.py``: the same detectors,
thresholds and findings; the cross-rank rows travel through the
``TCPStore`` that ``hvd.init()`` serves (where JAX uses ``jax.distributed``'s
KV client), with the same bounded reads.

Two detectors, both robust-z-score based (median/MAD — a single outlier
must not poison its own baseline), both emitting evidence WHILE THE JOB
RUNS (a metrics counter + a flight-ring event + a bounded findings list)
instead of waiting for the post-mortem analyzer:

- **regression** (local): the just-closed step's wall time against the
  rolling window of this rank's recent steps. Catches "the job got slower
  at step N" — thermal throttling, a noisy neighbor, a leak.
- **straggler** (cross-rank): every ``HOROVOD_PROFILE_PUBLISH_STEPS``
  steps each rank publishes its recent median wall AND median
  host-dispatch time into the process group's store (the existing control
  plane — no new transport), then reads its peers' row for the same
  round. The rank whose HOST-DISPATCH median is a robust-z outlier high
  is named: a straggler stalls in its own dispatch path (that is where
  the chaos ``delay`` site lands), while its peers show the wait under
  ``collective`` — so the signal separates the culprit from the victims.

Publish cadence is low (default every 16 steps) and reads are bounded
(``HOROVOD_PROFILE_PUBLISH_TIMEOUT_MS`` per peer, failures swallowed), so
the watchdog can never wedge a training loop; a peer too slow to publish
within the window is simply absent from that round (and will usually name
ITSELF when it arrives and reads everyone else's rows).
"""

import collections
import json
import threading
import time

from horovod_tpu_torch.common.config import Config, _env_float, _env_int
from horovod_tpu_torch.profile.ledger import median as _median
from horovod_tpu_torch.profile.ledger import robust_z as _robust_z

_MAX_FINDINGS = 64

_lock = threading.Lock()
_walls = collections.deque(maxlen=64)
_hosts = collections.deque(maxlen=64)
_steps_seen = 0
_round = 0
_gen = 0                     # bumped by reset(): keys must not collide
_findings = collections.deque(maxlen=_MAX_FINDINGS)

# knobs (configure() re-reads from Config/env)
_publish_every = _env_int("HOROVOD_PROFILE_PUBLISH_STEPS",
                          Config.profile_publish_steps)
_read_timeout_ms = _env_int("HOROVOD_PROFILE_PUBLISH_TIMEOUT_MS",
                            Config.profile_publish_timeout_ms)
_z_threshold = _env_float("HOROVOD_PROFILE_Z_THRESHOLD",
                          Config.profile_z_threshold)
_min_excess_s = _env_float("HOROVOD_PROFILE_STRAGGLER_MIN_MS",
                           Config.profile_straggler_min_ms) / 1e3
_min_window = 8


def configure(config):
    global _publish_every, _read_timeout_ms, _z_threshold, _min_excess_s
    _publish_every = int(config.profile_publish_steps)
    _read_timeout_ms = int(config.profile_publish_timeout_ms)
    _z_threshold = float(config.profile_z_threshold)
    _min_excess_s = float(config.profile_straggler_min_ms) / 1e3


def reset():
    """Elastic reset: history and rounds restart (step times across a
    membership change are not comparable), and the key generation bumps
    so a replayed round number can never read a stale row."""
    global _steps_seen, _round, _gen
    with _lock:
        _walls.clear()
        _hosts.clear()
        _steps_seen = 0
        _round = 0
        _gen += 1


def findings(last=None):
    """Bounded list of watchdog findings, oldest first. Each is a dict:
    ``kind`` (straggler|regression), ``step``, plus kind-specific fields
    (``rank``/``z``/``value_s``/``median_s``)."""
    with _lock:
        out = list(_findings)
    return out if last is None else out[-last:]


def _emit(finding):
    with _lock:
        _findings.append(finding)
    try:
        from horovod_tpu_torch.metrics import instruments as _metrics
        _metrics.record_profiler_event(finding["kind"])
    except Exception:  # noqa: BLE001
        pass
    if finding["kind"] == "straggler":
        # The goodput report's victim naming: this is the cross-rank
        # COMPARATIVE verdict (a straggler stalls in its own dispatch
        # path), stronger evidence than each rank's self-relative
        # straggler_wait excess — under a synchronous collective every
        # rank books wait, but only the victim is named here.
        try:
            from horovod_tpu_torch.goodput import ledger as _goodput
            _goodput.note_straggler(finding.get("rank"))
        except Exception:  # noqa: BLE001
            pass
    try:
        from horovod_tpu_torch.flight import recorder as _flight
        if _flight.armed:
            _flight.record_event(
                "profiler", what=finding["kind"],
                name=f"rank{finding['rank']}"
                if "rank" in finding else None,
                seq=finding.get("step"), dur=finding.get("value_s"))
    except Exception:  # noqa: BLE001
        pass
    try:
        from horovod_tpu_torch.common import logging as hvd_logging
        hvd_logging.warning("step profiler watchdog: %s", finding)
    except Exception:  # noqa: BLE001
        pass


def observe(rec):
    """Feed one closed step record (called by the ledger at every step
    boundary). Never raises."""
    global _steps_seen, _round
    try:
        wall = rec["wall_s"]
        host = rec["attribution"].get("host_dispatch", 0.0)
        with _lock:
            window = list(_walls)
            _walls.append(wall)
            _hosts.append(host)
            _steps_seen += 1
            steps_seen = _steps_seen
        if len(window) >= _min_window:
            z, med = _robust_z(wall, window)
            if z >= _z_threshold and wall - med >= _min_excess_s:
                _emit({"kind": "regression", "step": rec.get("step"),
                       "rank": rec.get("rank"), "z": round(z, 2),
                       "value_s": round(wall, 6),
                       "median_s": round(med, 6)})
        if _publish_every > 0 and steps_seen % _publish_every == 0:
            _publish_round(rec)
    except Exception:  # noqa: BLE001 — the watchdog must never fail a step
        pass


_client = None                # (store, its clone) for the watchdog's reads


def _kv_client():
    """A connection of the watchdog's own to the process group's store
    (a clone: the fusion runtime's threads use theirs), or None with one
    process or no store."""
    global _client
    try:
        from horovod_tpu_torch.common import basics
        st = basics._get_state()
        store = st.store
        if store is None:
            return None
        if _client is None or _client[0] is not store:
            try:
                _client = (store, store.clone())
            except Exception:  # noqa: BLE001 — a store without clone()
                _client = (store, store)
        return _client[1]
    except Exception:  # noqa: BLE001
        return None


def _world():
    from horovod_tpu_torch.common import basics
    if not basics.is_initialized():
        return 0, 1, 0
    st = basics._get_state()
    return st.rank, st.size, st.config.elastic_init_version


def _publish_round(rec):
    """One cross-rank publish/read round. SPMD guarantees every rank hits
    the same round at the same step count, so the round number is the
    rendezvous key; reads are bounded per peer and failures (a dead or
    very-slow peer) leave that rank out of this round's comparison."""
    global _round
    import datetime
    me, world, epoch = _world()
    if world <= 1:
        return
    client = _kv_client()
    if client is None:
        return
    with _lock:
        my_round = _round
        _round += 1
        med_wall = _median(list(_walls)) if _walls else 0.0
        med_host = _median(list(_hosts)) if _hosts else 0.0
    base = f"hvd/prof/e{epoch}/g{_gen}/r{my_round}"
    row = {"rank": me, "wall": round(med_wall, 6),
           "host": round(med_host, 6), "step": rec.get("step")}
    try:
        client.set(f"{base}/{me}", json.dumps(row))
        try:
            from horovod_tpu_torch.metrics import instruments as _metrics
            _metrics.record_profiler_kv(sets=1)
        except Exception:  # noqa: BLE001
            pass
        if my_round >= 2:
            try:
                client.delete_key(
                    f"hvd/prof/e{epoch}/g{_gen}/r{my_round - 2}/{me}")
            except Exception:  # noqa: BLE001
                pass
    except Exception:  # noqa: BLE001 — publish is best-effort
        return
    rows = {me: row}
    # ONE shared deadline across all peer reads (not per-peer): with dead
    # or wedged peers the whole round is bounded by ~2x the read timeout
    # instead of (world-1) x timeout of serial stalls in the training
    # loop — absent peers just miss this round's comparison.
    deadline = time.monotonic() + 2.0 * _read_timeout_ms / 1e3
    for p in range(world):
        if p == me:
            continue
        budget_ms = int((deadline - time.monotonic()) * 1e3)
        if budget_ms <= 0:
            break
        key = f"{base}/{p}"
        try:
            client.wait([key], datetime.timedelta(
                milliseconds=min(budget_ms, _read_timeout_ms)))
            rows[p] = json.loads(client.get(key))
            try:
                from horovod_tpu_torch.metrics import instruments as _metrics
                _metrics.record_profiler_kv(gets=1)
            except Exception:  # noqa: BLE001
                pass
        except Exception:  # noqa: BLE001 — absent peer: skip this round
            continue
    if len(rows) < 3:
        return                    # outlier math needs a real quorum
    _name_stragglers(rows, rec, me)


def _name_stragglers(rows, rec, me):
    hosts = {r: row.get("host", 0.0) for r, row in rows.items()}
    values = list(hosts.values())
    for r, x in sorted(hosts.items()):
        others = [v for rr, v in hosts.items() if rr != r]
        z, med = _robust_z(x, others or values)
        if z >= _z_threshold and x - med >= _min_excess_s:
            _emit({"kind": "straggler", "rank": r,
                   "step": rec.get("step"), "z": round(z, 2),
                   "value_s": round(x, 6), "median_s": round(med, 6),
                   "observer": me})
