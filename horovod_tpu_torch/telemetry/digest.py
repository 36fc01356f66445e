"""Per-rank telemetry digest: what one process tells its slice leader.

Port of the JAX package's ``telemetry/digest.py``: the same schema, read
from the port's planes (``profile/ledger.digest``, ``flight/recorder.digest``,
``profile/watchdog.findings``, ``goodput/ledger.snapshot``,
``metrics/merge.compact`` of the registry). A process's rank is
``HOROVOD_RANK`` (one process per device).

A digest is the compact, JSON-serializable beacon each process publishes
every ``HOROVOD_TELEMETRY_INTERVAL`` seconds — the *only* thing a rank
contributes to the cluster view, so everything the job health model needs
must be in it:

- liveness: ``t`` (publish wall time) — beacon age IS the liveness signal;
- progress: current step + when it closed, recent wall/attribution means
  (step-profiler ledger digest — the step-lag/stall/straggler inputs);
- anomalies: flight-recorder anomaly counts + per-process-set max
  collective seq (the desync key);
- findings: the watchdog's recent straggler/regression namings;
- metrics: a mergeable compacted registry snapshot
  (``HOROVOD_TELEMETRY_METRICS=0`` drops it for minimal beacons).

Collection runs on the beacon thread, off every dispatch hot path; each
contributor is independently fail-soft (a wedged subsystem must not
silence the liveness beacon that reports it wedged).
"""

import os
import time

from horovod_tpu_torch.common.config import _env_bool, _env_int

SCHEMA_VERSION = 1


def _rank():
    return _env_int("HOROVOD_RANK", 0)


def _host():
    h = os.environ.get("HOROVOD_HOST_KEY")
    if h:
        return h
    import socket
    try:
        return socket.gethostname()
    except OSError:
        return ""


def collect(rank=None, include_metrics=None):
    """Build this process's digest. Never raises: each contributing
    subsystem is wrapped separately so the beacon survives any of them
    misbehaving — a beacon with a missing section still proves liveness."""
    d = {
        "v": SCHEMA_VERSION,
        "rank": _rank() if rank is None else rank,
        "host": _host(),
        "pid": os.getpid(),
        "t": round(time.time(), 6),
    }
    try:
        from horovod_tpu_torch.profile import ledger
        d["profile"] = ledger.digest()
    except Exception:  # noqa: BLE001 — beacon survives a wedged ledger
        pass
    try:
        from horovod_tpu_torch.flight import recorder
        d["flight"] = recorder.digest()
    except Exception:  # noqa: BLE001
        pass
    try:
        from horovod_tpu_torch.profile import watchdog
        d["findings"] = watchdog.findings(last=4)
    except Exception:  # noqa: BLE001
        pass
    try:
        from horovod_tpu_torch.goodput import ledger as goodput_ledger
        snap = goodput_ledger.snapshot()
        if snap.get("enabled"):
            d["goodput"] = snap
    except Exception:  # noqa: BLE001
        pass
    if include_metrics is None:
        include_metrics = _env_bool("HOROVOD_TELEMETRY_METRICS", True)
    if include_metrics:
        try:
            from horovod_tpu_torch.metrics import merge
            from horovod_tpu_torch.metrics.instruments import REGISTRY, enabled
            if enabled():
                d["metrics"] = merge.compact(REGISTRY.snapshot())
        except Exception:  # noqa: BLE001
            pass
    return d


def health_row(digest_dict):
    """The slice-summary per-rank row: the digest minus its metrics bulk
    (metrics are merged INTO the slice summary, not repeated per rank),
    keeping exactly the health-model inputs + identity."""
    prof = digest_dict.get("profile") or {}
    flight = digest_dict.get("flight") or {}
    row = {
        "t": digest_dict.get("t"),
        "host": digest_dict.get("host"),
        "pid": digest_dict.get("pid"),
        "step": prof.get("step"),
        "step_t": prof.get("step_t"),
        "steps": prof.get("steps", 0),
        "wall_mean_s": prof.get("wall_mean_s"),
        "host_dispatch_mean_s": (prof.get("attribution_mean_s") or {})
        .get("host_dispatch"),
        "anomalies": flight.get("anomalies", 0),
        "anomaly_kinds": flight.get("by_kind") or {},
        "max_seq": flight.get("max_seq") or {},
        "findings": digest_dict.get("findings") or [],
    }
    gp = digest_dict.get("goodput") or {}
    if gp.get("enabled"):
        cats = gp.get("categories") or {}
        row["goodput_ratio"] = gp.get("goodput_ratio")
        row["goodput_wall_s"] = gp.get("wall_s")
        # The two per-rank badput numbers the victim-naming report (and
        # the chaos-soak brackets) need; the full decomposition stays in
        # the digest, not every row.
        row["straggler_wait_s"] = cats.get("straggler_wait", 0.0)
        row["rendezvous_recovery_s"] = cats.get("rendezvous_recovery", 0.0)
    return row
