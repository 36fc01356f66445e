"""Automated remediation: health verdicts → blacklist + re-rendezvous.

Port of the JAX package's ``autopilot/remediate.py``: the policy, the
KV requests over the port's launcher KV client
(``elastic/worker.py::_kv_client``) and the elastic driver's arm over its
``HostManager``, with JAX's verdicts, keys and flight events.

The loop that stands in for a human reading ``/cluster/health``, in
three pieces:

- :class:`RemediationPolicy` — a PURE decision core (fake-clock testable):
  per-epoch verdicts in (watchdog straggler namings + telemetry
  dead/stalled states), bounded actions out, guarded by **hysteresis**
  (a rank must be named ``hysteresis`` consecutive epochs — one noisy
  publish round must never cost a host), a **rate limiter** (at most
  ``max_removals`` per rolling ``window_s`` — a systemic slowdown that
  names a different rank each round must not strip the fleet), a
  **do-not-shrink floor** (``min_world``), and a per-host re-request
  cooldown (an actioned host is not re-requested within the window; its
  driver-side cooldown — the existing ``blacklist_cooldown_range``
  exponential backoff — governs actual re-admission).

- the **coordinator arm** (:func:`publish_request`, called by the
  controller): publishes each action to the launcher HTTP-KV under the
  ``autopilot`` scope (``req/<n>`` + a ``head`` counter), records the
  ``autopilot_remediate`` flight event and the
  ``autopilot_remediations_total{cause,outcome=requested}`` metric.

- the **driver arm** (:class:`DriverArm`, polled by the elastic driver's
  discovery loop): consumes requests, re-validates floor + rate against
  the driver's OWN view (the worker-side checks ran on a stale world —
  the driver's are authoritative), then cools the host down through the
  existing :class:`~horovod_tpu_torch.runner.elastic.discovery.HostManager`
  failure path — discovery drops the host, the normal membership update
  re-rendezvouses the survivors, and the exponential cooldown re-admits
  the host later exactly like a crash would. Every consumed request is
  acked back to ``autopilot/ack/<id>`` so the decision's outcome is
  KV-auditable too.

Rank 0 is protected: the coordination service and the boundary stream
live there, and removing it converts a slow job into a dead one.
"""

import json
import os
import time

from horovod_tpu_torch.common import logging as hvd_logging

# Rolling rate-limiter window (seconds). Deliberately not a knob: the
# knobs bound HOW MUCH may be removed (HOROVOD_AUTOPILOT_MAX_REMOVALS)
# and HOW SMALL the world may get (HOROVOD_AUTOPILOT_MIN_WORLD); the
# window just defines "per incident".
WINDOW_S = 600.0

# Causes, most severe first (a dead verdict overrides a straggler one).
CAUSES = ("dead", "stalled", "straggler")


class RemediationPolicy:
    """The pure decision core. ``observe`` is called once per decision
    epoch with that epoch's verdicts; state (streaks, action log) lives
    here so the controller stays stateless about remediation."""

    def __init__(self, hysteresis=3, max_removals=1, min_world=1,
                 window_s=WINDOW_S, protected=(0,), protected_hosts=(),
                 time_fn=time.monotonic):
        self.hysteresis = max(int(hysteresis), 1)
        self.max_removals = max(int(max_removals), 0)
        self.min_world = max(int(min_world), 1)
        self.window_s = float(window_s)
        self.protected = set(protected or ())
        # Removal is per HOST: protecting rank 0 alone would still evict
        # its host through a verdict on a COLOCATED rank (multi-slot
        # launches). The controller keeps this set pointed at its own
        # host each epoch.
        self.protected_hosts = set(protected_hosts or ())
        self._time = time_fn
        self._streaks = {}        # rank -> (consecutive epochs, last cause)
        self._actions = []        # (t, host, rank, cause) actioned log
        self._hosts_cooling = {}  # host -> t actioned (re-request cooldown)

    def _in_window(self, now):
        return [a for a in self._actions if now - a[0] < self.window_s]

    def observe(self, verdicts, world, now=None, host_sizes=None):
        """``verdicts``: {rank: {"cause": dead|stalled|straggler,
        "host": str|None}} for THIS epoch (absent rank = healthy this
        epoch, which resets its streak). ``world``: current live world
        size. ``host_sizes`` ({host: ranks-on-it}, from the telemetry
        view): removal is per HOST, so the floor debits the victim
        host's whole rank count, not 1. Returns the list of actions to
        execute now, each ``{"rank", "host", "cause", "streak"}`` —
        already debited from the rate limiter, so the caller executes
        all of them (and feeds driver rejections back via
        :meth:`refund`)."""
        now = self._time() if now is None else now
        # Streak bookkeeping: consecutive epochs named, any cause.
        for rank in list(self._streaks):
            if rank not in verdicts:
                del self._streaks[rank]
        for rank, v in verdicts.items():
            n, _ = self._streaks.get(rank, (0, None))
            self._streaks[rank] = (n + 1, v.get("cause"))

        actions = []
        recent = self._in_window(now)
        self._actions = recent
        budget = self.max_removals - len(recent)
        # Most-severe cause first, then longest streak, then lowest rank:
        # a deterministic order so two coordinators (tests, re-elections)
        # would pick the same victim.
        order = sorted(
            verdicts.items(),
            key=lambda kv: (CAUSES.index(kv[1].get("cause"))
                            if kv[1].get("cause") in CAUSES else len(CAUSES),
                            -self._streaks.get(kv[0], (0, None))[0],
                            kv[0]))
        pending = 0
        for rank, v in order:
            if budget <= 0:
                break
            if rank in self.protected:
                continue
            streak, _ = self._streaks.get(rank, (0, None))
            if streak < self.hysteresis:
                continue
            host = v.get("host")
            if host is None:
                # Unmappable target (telemetry view not fresh yet): emit
                # nothing — a host-less request would only burn the rate
                # budget at the driver. The streak KEEPS accumulating, so
                # the action fires the first epoch the host resolves.
                continue
            if host in self.protected_hosts:
                continue          # the coordinator's host lives here
            if host in self._hosts_cooling and \
                    now - self._hosts_cooling[host] < self.window_s:
                continue          # already actioned; driver cooldown owns it
            removes = (host_sizes or {}).get(host, 1)
            if world - pending - removes < self.min_world:
                # Floor veto for THIS victim only (`continue`, like the
                # DriverArm's per-request rejection): one oversized host
                # must not starve a smaller eligible one behind it.
                continue
            actions.append({"rank": rank, "host": host,
                            "cause": v.get("cause"), "streak": streak})
            self._actions.append((now, host, rank, v.get("cause")))
            self._hosts_cooling[host] = now
            self._streaks.pop(rank, None)
            pending += removes
            budget -= 1
        return actions

    def refund(self, host):
        """Driver-arm REJECTION feedback: the request executed nothing,
        so its rate-budget slot and host cooldown are returned — a veto
        (floor/rate divergence between the coordinator's view and the
        driver's authoritative one) must not starve the arm for a whole
        window. The cleared hysteresis streak is deliberately NOT
        restored: re-accumulating it is the damping that prevents a
        request/reject ping-pong."""
        for i in range(len(self._actions) - 1, -1, -1):
            if self._actions[i][1] == host:
                del self._actions[i]
                break
        self._hosts_cooling.pop(host, None)

    def streaks(self):
        return {r: n for r, (n, _) in self._streaks.items()}


# --- coordinator arm: KV publication --------------------------------------

def _launcher_kv():
    """The launcher HTTP-KV client — the elastic worker's ONE
    env-to-client helper, with a bounded timeout (remediation runs on
    the control thread; a wedged KV must cost seconds, not the default
    30)."""
    from horovod_tpu_torch.elastic.worker import _kv_client
    return _kv_client(timeout=5)


def host_of_rank(rank, cluster_view=None):
    """rank→host mapping for a remediation target: the telemetry health
    row's host (beacons carry ``HOROVOD_HOST_KEY`` — the same key the
    driver's host table uses), else None: the driver arm refuses
    host-less requests, so a target the telemetry plane cannot place is
    never removed on a guess."""
    if cluster_view:
        row = (cluster_view.get("health") or {}).get(str(rank)) or {}
        if row.get("host"):
            return row["host"]
    return None


def publish_request(action, epoch=None):
    """Coordinator side: write one remediation request to the launcher
    KV (scope ``autopilot``) and record the forensics trail. Returns the
    request id, or None when no launcher KV is reachable (single-process
    / non-hvdrun runs: the decision is still recorded, nothing executes
    it)."""
    from horovod_tpu_torch.flight import recorder as _flight
    from horovod_tpu_torch.metrics import instruments as _metrics

    cause = action.get("cause") or "unknown"
    if _flight.armed:
        _flight.record_event(
            "autopilot_remediate", name=f"rank{action.get('rank')}",
            what=cause, seq=epoch,
            sig=None, nbytes=None, op=action.get("host"))
    client = _launcher_kv()
    if client is None or not os.environ.get("HOROVOD_ELASTIC"):
        # A static launch has the launcher KV but NO DriverArm polling
        # it (only run_elastic_driver installs one): publishing would
        # record `requested` for a request nothing can ever execute —
        # and the runbook would read the missing `applied` as a driver
        # veto. The decision is still on the flight ring above.
        _metrics.record_autopilot_remediation(cause, "no_driver")
        return None
    try:
        head = int(client.get("autopilot", "head") or 0)
        req_id = f"{os.getpid()}-{head}"
        payload = dict(action)
        payload.update({"id": req_id, "t": round(time.time(), 3),
                        "epoch": epoch})
        client.put("autopilot", f"req/{head}",
                   json.dumps(payload).encode())
        client.put("autopilot", "head", str(head + 1).encode())
    except Exception as e:  # noqa: BLE001 — remediation is best-effort
        hvd_logging.warning("autopilot remediation publish failed: %s", e)
        _metrics.record_autopilot_remediation(cause, "publish_failed")
        return None
    _metrics.record_autopilot_remediation(cause, "requested")
    hvd_logging.warning(
        "autopilot: requested removal of rank %s (host %s, cause %s)",
        action.get("rank"), action.get("host"), cause)
    return req_id


# --- driver arm ------------------------------------------------------------

class DriverArm:
    """Polled by the elastic driver's discovery loop (one KV head read
    per poll). Applies each new request through the HostManager's
    failure/cooldown path and acks the outcome."""

    def __init__(self, kv, host_manager, min_world=1, max_removals=1,
                 window_s=WINDOW_S, time_fn=time.monotonic):
        self._kv = kv
        self._hm = host_manager
        self.min_world = max(int(min_world), 1)
        self.max_removals = max(int(max_removals), 0)
        self.window_s = float(window_s)
        self._time = time_fn
        self._next = 0            # next req index to consume
        self._seen = set()        # request ids already processed
        self._applied = []        # (t, host) applied log (rate window)

    def _ack(self, req, outcome):
        try:
            self._kv.put("autopilot", f"ack/{req.get('id')}",
                         outcome.encode())
        except Exception:  # noqa: BLE001
            pass
        try:
            from horovod_tpu_torch.metrics import instruments as _metrics
            _metrics.record_autopilot_remediation(
                req.get("cause") or "unknown", outcome)
        except Exception:  # noqa: BLE001
            pass
        from horovod_tpu_torch.flight import recorder as _flight
        if _flight.armed:
            _flight.record_event("autopilot_remediate",
                                 name=f"rank{req.get('rank')}",
                                 what=outcome, op=req.get("host"))

    def poll(self, hosts):
        """Consume any new requests against the freshly-discovered
        ``hosts`` dict; returns the set of hosts removed THIS poll (the
        driver excludes them from this round's assignment immediately —
        the HostManager cooldown keeps them out of later rounds)."""
        removed = set()
        try:
            head = int(self._kv.get("autopilot", "head") or 0)
        except Exception:  # noqa: BLE001
            return removed
        now = self._time()
        self._applied = [a for a in self._applied
                         if now - a[0] < self.window_s]
        while self._next < head:
            idx = self._next
            self._next += 1
            try:
                raw = self._kv.get("autopilot", f"req/{idx}")
            except Exception:  # noqa: BLE001
                # Transient transport fault: do NOT consume the index —
                # a dropped request would get no blacklist, no ack and
                # no retry until the policy's whole cooldown window.
                self._next = idx
                break
            try:
                req = json.loads(raw) if raw else None
            except Exception:  # noqa: BLE001 — malformed: skip it
                req = None
            if not req or req.get("id") in self._seen:
                continue
            self._seen.add(req.get("id"))
            host = req.get("host")
            if not host or host not in hosts:
                self._ack(req, "rejected_unknown_host")
                continue
            if len(self._applied) >= self.max_removals:
                self._ack(req, "rejected_rate")
                continue
            # Floor in PROCESSES (slots), not hosts: min_world mirrors
            # --min-np, and a multi-slot deployment removing one host
            # loses that host's slot count, not 1.
            live = sum(s for h, s in hosts.items() if h not in removed)
            if live - hosts[host] < self.min_world:
                self._ack(req, "rejected_floor")
                continue
            # The existing blacklist/cooldown path: record_failure applies
            # the exponential cooldown (HOROVOD_BLACKLIST_COOLDOWN_RANGE),
            # discovery drops the host while it cools, and re-admits it
            # after — the same lifecycle a crashed host gets.
            self._hm.record_failure(host)
            self._applied.append((now, host))
            removed.add(host)
            hvd_logging.warning(
                "autopilot driver arm: removing host %s (rank %s, "
                "cause %s) — re-rendezvous follows", host,
                req.get("rank"), req.get("cause"))
            self._ack(req, "applied")
        return removed
