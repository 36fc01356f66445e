"""The hierarchical aggregation agent: rank → slice leader → job view.

Port of the JAX package's ``telemetry/aggregator.py``: the same keys,
leadership rules, health model, event log and views, so the same beacons
give the same job view in both packages. Every process runs one
:class:`TelemetryAgent` (started by ``hvd.init`` when the launcher's
HTTP-KV store is reachable and the world has more than one process). Each beacon round
(``HOROVOD_TELEMETRY_INTERVAL``), an agent:

1. publishes its own digest at ``telemetry/g<gen>/rank/<r>`` — one PUT;
2. if it is its slice's leader, reads the slice members' digests
   (slice-size GETs), merges them into one slice summary at
   ``telemetry/g<gen>/slice/<s>``;
3. if it is the job leader (the leader of the lowest live slice), reads
   every slice summary (num_slices GETs), classifies rank health
   (:mod:`horovod_tpu.telemetry.health`), and publishes the job view at
   ``telemetry/job``.

So the fan-in above slice level is ``num_slices``, not world size. A
non-leader costs 2 RPCs per round (beacon PUT + one freshness probe GET).

**Leadership is leased by freshness, not configured.** The lowest rank
of a slice leads by default; every other member probes the slice
summary's age each round and, when it goes stale past ``dead_after``,
checks whether any lower-ranked member still beacons — if none does, it
takes over. An acting (non-default) leader stands down the moment a
lower-ranked member's beacon reappears. Job leadership uses the same
rule one level up, over slice summaries. Re-election therefore converges
within ~2 beacon intervals of a leader death, with no extra election
traffic in the steady state.

**Generations.** Keys are scoped by the elastic membership generation
(``HOROVOD_ELASTIC_INIT_VERSION``): rank numbering changes across a
membership change, so mixing generations would mark renumbered ranks
dead forever. The unscoped ``telemetry/job`` view always reflects the
newest generation; when a generation changes, the new job leader diffs
the previous view's host set and records hosts that vanished as ``dead``
transitions in the view's bounded event log: the "who did we lose in
that membership change" evidence.

The whole tick is wrapped fail-soft: a telemetry plane that can crash
the job it watches is worse than none. Each round is the ``telemetry.tick``
chaos site, counts its KV RPCs into ``telemetry_rpcs_total{phase}``
(``record_telemetry_rpc``), and the job leader feeds its own stall verdict
to the goodput ledger (``goodput.wedge_from_rows``).
"""

import json
import os
import threading
import time

from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.common.config import _env_float, _env_int
from horovod_tpu_torch.telemetry import digest as _digest
from horovod_tpu_torch.telemetry import health as _health

SCOPE = "telemetry"
JOB_KEY = "job"
MAX_EVENTS = 32

# Counter phases (also the metrics label values of
# ``telemetry_rpcs_total{phase}``). The first six are the AGGREGATION
# round's traffic — what the scaling contract bounds; ``read_get`` is
# demand-driven endpoint/API reads (/cluster/*, cluster_snapshot on
# non-leaders) and scales with scrape rate, so it is counted apart.
PHASES = ("beacon_put", "probe_get", "slice_get", "slice_put",
          "job_get", "job_put", "read_get")


def slice_of(rank, world, num_slices):
    """Process → slice under the rank-major near-equal partition (exact
    when ``world % num_slices == 0``, the topology's slice layout; still
    total otherwise, so a shrunk elastic world keeps a working
    hierarchy)."""
    k = max(1, min(num_slices, world))
    return rank * k // world


def slice_members(sid, world, num_slices):
    k = max(1, min(num_slices, world))
    return [r for r in range(world) if r * k // world == sid]


def goodput_view(rows):
    """Job-level goodput aggregate from per-rank health rows: the job
    ``ratio`` is wall-weighted (a rank that lived longer weighs more),
    and each beaconing rank keeps its ratio plus the two badput numbers
    the victim-naming report reads. None until any rank reports."""
    walls = prod = 0.0
    ranks = {}
    for r, row in rows.items():
        if not row or row.get("goodput_ratio") is None:
            continue
        w = float(row.get("goodput_wall_s") or 0.0)
        ratio = float(row["goodput_ratio"])
        walls += w
        prod += ratio * w
        ranks[str(r)] = {
            "ratio": round(ratio, 6),
            "straggler_wait_s": round(
                float(row.get("straggler_wait_s") or 0.0), 6),
            "rendezvous_recovery_s": round(
                float(row.get("rendezvous_recovery_s") or 0.0), 6),
        }
    if not ranks:
        return None
    return {
        "ratio": round(prod / walls, 6) if walls > 0 else None,
        "wall_s": round(walls, 6),
        "ranks": ranks,
    }


class TelemetryAgent:
    """One process's member of the aggregation plane. ``kv`` is any
    object with the :class:`horovod_tpu_torch.runner.http_kv.KVStoreClient`
    get/put surface (tests pass the in-process server directly);
    ``time_fn`` is injectable so the failover tests drive a fake clock.
    ``tick()`` performs one full round synchronously; ``start()`` runs
    ticks on a daemon thread every ``interval`` seconds."""

    def __init__(self, kv, rank, world, num_slices=1, interval=None,
                 dead_after=None, stall_after=None, step_lag=None,
                 seq_lag=None, gen=None, include_metrics=None,
                 time_fn=time.time):
        self.kv = kv
        self.rank = int(rank)
        self.world = int(world)
        self.num_slices = max(1, min(int(num_slices), self.world))
        self.interval = interval if interval is not None \
            else _env_float("HOROVOD_TELEMETRY_INTERVAL", 2.0)
        if dead_after is None:
            env_v = _env_float("HOROVOD_TELEMETRY_DEAD_AFTER", 0.0)
            dead_after = env_v if env_v > 0 else None
        if stall_after is None:
            env_v = _env_float("HOROVOD_TELEMETRY_STALL_AFTER", 0.0)
            stall_after = env_v if env_v > 0 else None
        self.thresholds = _health.thresholds(
            interval=self.interval,
            dead_after=dead_after,
            stall_after=stall_after,
            step_lag=step_lag if step_lag is not None
            else _env_int("HOROVOD_TELEMETRY_STEP_LAG", 5),
            seq_lag=seq_lag if seq_lag is not None
            else _env_int("HOROVOD_TELEMETRY_SEQ_LAG", 64))
        self.gen = str(gen) if gen is not None else \
            os.environ.get("HOROVOD_ELASTIC_INIT_VERSION", "0")
        self.include_metrics = include_metrics
        self.time_fn = time_fn
        self.slice = slice_of(self.rank, self.world, self.num_slices)
        self.members = slice_members(self.slice, self.world,
                                     self.num_slices)
        self.counters = dict.fromkeys(PHASES, 0)
        self.rounds = 0
        self._acting_slice_leader = False
        self._acting_job_leader = False
        self._last_digest = None
        self._last_slice_summary = None
        self._last_job_view = None
        self._events = []           # job-view transition log (leader-held)
        self._prev_states = {}
        self._inherited = False     # previous job view consulted for
        #                             this leadership tenure
        self._last_compose_t = None
        self._gen_diff_waited = 0   # compose rounds spent waiting for a
        #                             complete new-gen picture to diff
        self._thread = None
        self._stop = threading.Event()

    # --- KV plumbing ----------------------------------------------------

    def _key(self, rest):
        return f"g{self.gen}/{rest}"

    def _count(self, phase, n=1):
        self.counters[phase] += n
        try:
            from horovod_tpu_torch.metrics import instruments as _metrics
            _metrics.record_telemetry_rpc(phase, n)
        except Exception:  # noqa: BLE001
            pass

    def _scope(self, sid=None):
        """Slice-local keys (rank beacons, slice summaries) live under a
        slice-scoped spelling so the KV resolver (KVStoreClient /
        KVStoreServer scope router) lands them on the per-slice shard
        listener when the launcher sharded the plane — beacon fan-in off
        the root store. Job-global keys (``sid=None``) stay on the
        root."""
        if sid is None:
            return SCOPE
        from horovod_tpu_torch.common.control_plane import slice_scope
        return slice_scope(SCOPE, sid)

    def _get_json(self, key, phase, scoped=True, sid=None):
        try:
            self._count(phase)
            raw = self.kv.get(self._scope(sid),
                              self._key(key) if scoped else key)
        except Exception:  # noqa: BLE001 — a KV blip is one missed round
            return None
        if raw is None:
            return None
        try:
            return json.loads(raw)
        except (ValueError, TypeError):
            return None

    def _put_json(self, key, obj, phase, scoped=True, sid=None):
        try:
            self._count(phase)
            self.kv.put(self._scope(sid),
                        self._key(key) if scoped else key,
                        json.dumps(obj).encode())
            return True
        except Exception:  # noqa: BLE001
            return False

    def _fresh(self, row, now):
        return row is not None and row.get("t") is not None \
            and now - row["t"] <= self.thresholds["dead_after"]

    # --- leadership -----------------------------------------------------

    def _lead_slice(self, now):
        lower = [m for m in self.members if m < self.rank]
        if not lower:
            return True
        if self._acting_slice_leader:
            # Stand down the moment any lower-ranked member is back —
            # and drop job leadership with it (job leadership is only
            # ever held BY a slice leader; a stale _acting_job_leader
            # would make job_view() serve this rank's frozen view
            # forever) plus the inherited event state (the next
            # acquisition must re-read the then-current view).
            for m in lower:
                if self._fresh(self._get_json(f"rank/{m}", "probe_get",
                                              sid=self.slice), now):
                    self._acting_slice_leader = False
                    self._acting_job_leader = False
                    self._inherited = False
                    return False
            return True
        s = self._get_json(f"slice/{self.slice}", "probe_get",
                           sid=self.slice)
        if s is not None and self._fresh(s, now):
            return False
        # Summary stale or absent: the next live member takes over.
        for m in lower:
            if self._fresh(self._get_json(f"rank/{m}", "probe_get",
                                          sid=self.slice), now):
                return False
        self._acting_slice_leader = True
        return True

    def _lead_job(self, now):
        """Called only on slice leaders: the leader of the lowest slice
        with a live summary composes the job view."""
        lower = list(range(self.slice))
        if not lower:
            return True
        if self._acting_job_leader:
            for s in lower:
                if self._fresh(self._get_json(f"slice/{s}", "probe_get",
                                              sid=s),
                               now):
                    self._acting_job_leader = False
                    self._inherited = False
                    return False
            return True
        j = self._get_json(JOB_KEY, "probe_get", scoped=False)
        if j is not None and j.get("gen") == self.gen \
                and self._fresh(j, now):
            return False
        for s in lower:
            if self._fresh(self._get_json(f"slice/{s}", "probe_get",
                                          sid=s), now):
                return False
        self._acting_job_leader = True
        return True

    # --- the round ------------------------------------------------------

    def tick(self):
        """One aggregation round. Never raises — a telemetry fault is a
        missed round, not a crashed trainer (the chaos contract)."""
        try:
            self._tick_inner()
        except Exception:  # noqa: BLE001
            try:
                from horovod_tpu_torch.common import logging as hvd_logging
                hvd_logging.debug("telemetry tick failed", exc_info=True)
            except Exception:  # noqa: BLE001
                pass

    def _tick_inner(self):
        self.rounds += 1
        now = self.time_fn()
        if _chaos.armed:
            # Chaos site: drop/delay/crash one aggregation round — the
            # "never a crashed aggregator" contract rides the tick()
            # wrapper above this.
            _chaos.fire("telemetry.tick")
        d = _digest.collect(rank=self.rank,
                            include_metrics=self.include_metrics)
        d["t"] = round(now, 6)
        self._last_digest = d
        self._put_json(f"rank/{self.rank}", d, "beacon_put",
                       sid=self.slice)
        if self._lead_slice(now):
            summary = self._compose_slice(now)
            if summary is not None:
                self._last_slice_summary = summary
                self._put_json(f"slice/{self.slice}", summary, "slice_put",
                               sid=self.slice)
                if self._lead_job(now):
                    view = self._compose_job(now, summary)
                    if view is not None:
                        self._last_job_view = view
                        self._put_json(JOB_KEY, view, "job_put",
                                       scoped=False)

    def _compose_slice(self, now):
        rows, metrics_snaps, fresh = {}, [], 0
        for m in self.members:
            if m == self.rank:
                dig = self._last_digest      # own copy: no self-GET
            else:
                dig = self._get_json(f"rank/{m}", "slice_get",
                                     sid=self.slice)
            if dig is None:
                rows[str(m)] = None
                continue
            rows[str(m)] = _digest.health_row(dig)
            if self._fresh(dig, now):
                fresh += 1
                if dig.get("metrics"):
                    metrics_snaps.append(dig["metrics"])
        from horovod_tpu_torch.metrics import merge as _merge
        return {
            "v": 1, "slice": self.slice, "leader": self.rank,
            "gen": self.gen, "t": round(now, 6), "world": self.world,
            "members": self.members, "digests": fresh,
            "ranks": rows,
            "metrics": _merge.merge_snapshots(metrics_snaps),
        }

    def _fetch_slice_summaries(self, own_summary=None, phase="job_get"):
        """All slice summaries, using the local copy for our own slice.
        The job-level fan-in: ``num_slices - 1`` GETs. Demand-driven
        callers (endpoints) pass ``phase="read_get"`` so the aggregation
        round's scaling counters stay uncontaminated by scrape traffic."""
        out = {}
        for s in range(self.num_slices):
            if own_summary is not None and s == self.slice:
                out[s] = own_summary
            else:
                out[s] = self._get_json(f"slice/{s}", phase, sid=s)
        return out

    def _inherit_previous_view(self):
        """Once per leadership acquisition: pull the previous job view to
        carry its event log forward and, across a generation change, mark
        the hosts that vanished from the membership as dead transitions —
        the age-based detector can't see them (their beacons died with
        the old generation's key space)."""
        prev = self._get_json(JOB_KEY, "probe_get", scoped=False)
        self._inherited = True
        if prev is None:
            return
        self._events = list(prev.get("events") or [])[-MAX_EVENTS:]
        self._prev_states = {
            r: s.get("state") for r, s in (prev.get("health") or {}).items()
        } if prev.get("gen") == self.gen else {}
        if prev.get("gen") != self.gen:
            # The new membership's hosts are resolved in _compose_job
            # (we may not have seen every beacon yet); stash the old
            # rank → host map for the diff there.
            self._prev_gen_hosts = {
                r: s.get("host")
                for r, s in (prev.get("health") or {}).items()
                if s.get("host")}
            self._prev_gen = prev.get("gen")

    def _record_transitions(self, states, now, slice_summaries):
        for r, s in states.items():
            prev = self._prev_states.get(r)
            if prev is not None and prev != s["state"]:
                self._events.append({
                    "t": round(now, 6), "gen": self.gen, "rank": int(r),
                    "from": prev, "to": s["state"],
                    "why": s.get("why"), "age_s": s.get("age_s"),
                    "host": s.get("host")})
            self._prev_states[r] = s["state"]
        # Generation diff: hosts that existed in the previous generation's
        # view but are absent from this membership were removed/killed.
        # Deferred until every new-generation rank has beaconed (bounded
        # by a few rounds) — diffing against a half-assembled membership
        # would mark not-yet-started survivors as removed.
        prev_hosts = getattr(self, "_prev_gen_hosts", None)
        if prev_hosts:
            live_hosts, seen_ranks = set(), 0
            for summ in slice_summaries.values():
                for row in (summ or {}).get("ranks", {}).values():
                    if row and row.get("host"):
                        live_hosts.add(row["host"])
                        seen_ranks += 1
            if seen_ranks >= self.world or self._gen_diff_waited >= 5:
                for old_rank, host in sorted(prev_hosts.items()):
                    if host not in live_hosts:
                        self._events.append({
                            "t": round(now, 6), "gen": self.gen,
                            "rank": int(old_rank), "host": host,
                            "from": "healthy", "to": "dead",
                            "why": "membership_removed",
                            "prev_gen": getattr(self, "_prev_gen", None)})
                self._prev_gen_hosts = None
            else:
                self._gen_diff_waited += 1
        self._trim_events()

    def _trim_events(self):
        """Bound the event log, but never evict ``membership_removed``
        entries in favor of churn: a dead↔healthy flap storm (loaded
        hosts near the dead_after boundary) must not flush the one event
        that says which host the job actually lost."""
        overflow = len(self._events) - MAX_EVENTS
        if overflow <= 0:
            return
        pruned = []
        for e in self._events:
            if overflow > 0 and e.get("why") != "membership_removed":
                overflow -= 1
                continue
            pruned.append(e)
        self._events = pruned[-MAX_EVENTS:]

    def _compose_job(self, now, own_summary):
        # Re-inherit after a composing gap: a default leader paused past
        # the dead window (GC stall, machine wedge) may have been
        # substituted by an acting leader — resuming with the pre-pause
        # event log would overwrite the interim leader's transitions.
        if self._last_compose_t is not None and \
                now - self._last_compose_t > self.thresholds["dead_after"]:
            self._inherited = False
        if not self._inherited:
            self._inherit_previous_view()
        self._last_compose_t = now
        summaries = self._fetch_slice_summaries(own_summary)
        rows, slices_meta = {}, {}
        for sid, summ in summaries.items():
            if summ is None:
                slices_meta[str(sid)] = {
                    "t": None, "leader": None, "digests": 0,
                    "members": slice_members(sid, self.world,
                                             self.num_slices)}
                for m in slice_members(sid, self.world, self.num_slices):
                    rows[m] = None
                continue
            slices_meta[str(sid)] = {
                "t": summ.get("t"), "leader": summ.get("leader"),
                "digests": summ.get("digests", 0),
                "age_s": round(now - summ["t"], 3)
                if summ.get("t") else None,
                "members": summ.get("members", [])}
            for r_str, row in summ.get("ranks", {}).items():
                rows[int(r_str)] = row
        # Every rank of the world appears, beaconed or not.
        for r in range(self.world):
            rows.setdefault(r, None)
        states, progress = _health.classify(rows, now, self.thresholds)
        self._record_transitions({str(r): s for r, s in states.items()},
                                 now, summaries)
        # Feed this rank's own stall verdict back into its goodput
        # ledger: a "stalled" classification flips the phase to
        # wedge_idle, "healthy" flips it back (a completed step always
        # overrides both — see goodput/ledger.note_wedge).
        try:
            from horovod_tpu_torch.goodput import ledger as _goodput
            _goodput.wedge_from_rows(
                [{"rank": r, "state": s["state"]}
                 for r, s in states.items()], self.rank)
        except Exception:  # noqa: BLE001
            pass
        return {
            "v": 1, "t": round(now, 6), "gen": self.gen,
            "leader": self.rank, "leader_slice": self.slice,
            "world": self.world, "num_slices": self.num_slices,
            "interval_s": self.interval,
            "thresholds": self.thresholds,
            "slices": slices_meta,
            "health": {str(r): states[r] for r in sorted(states)},
            "counts": _health.counts(states),
            "progress": progress,
            "goodput": goodput_view(rows),
            "events": list(self._events),
        }

    # --- reads ----------------------------------------------------------

    def job_view(self):
        """The freshest job view this process can produce: the local copy
        when we lead AND it is recent, else one KV GET (counted as
        ``read_get`` — demand traffic, not aggregation traffic). None
        when nothing published yet."""
        local = self._last_job_view
        if local is not None and (
                self._acting_job_leader or
                (self.slice == 0 and self.rank == self.members[0])):
            t = local.get("t")
            if t is not None and \
                    self.time_fn() - t <= self.thresholds["dead_after"]:
                return local
        return self._get_json(JOB_KEY, "read_get", scoped=False)

    def slice_summaries(self):
        """Every slice's latest summary (the ``/cluster/metrics`` /
        ``/cluster/steps`` composition input; counted as ``read_get``).
        The local copy is used only while FRESH — a leader whose beacon
        thread wedged must serve its successor's KV summary, not its own
        frozen one (the same guard as job_view())."""
        own = None
        local = self._last_slice_summary
        if local is not None and (
                self._acting_slice_leader
                or self.rank == self.members[0]):
            t = local.get("t")
            if t is not None and \
                    self.time_fn() - t <= self.thresholds["dead_after"]:
                own = local
        return self._fetch_slice_summaries(own, phase="read_get")

    # --- lifecycle ------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            # Jittered phase so a synchronized fleet doesn't thundering-
            # herd the KV store at each interval boundary.
            import random
            self._stop.wait(random.random() * self.interval)
            while not self._stop.is_set():
                self.tick()
                self._stop.wait(self.interval)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="hvd-telemetry")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


# --- process-global agent (wired by basics.init / shutdown) ---------------

_agent = None
_agent_lock = threading.Lock()


def get_agent():
    return _agent


def set_agent(agent):
    """Install (tests) or replace the process-global agent."""
    global _agent
    with _agent_lock:
        prev, _agent = _agent, agent
    if prev is not None and prev is not agent:
        prev.stop()
    return agent


def start_from_config(config, topology=None, rank=None, world=None):
    """Start the process-global agent from a Config, the world's topology
    and this process's ``rank`` of ``world`` (called by ``hvd.init``).
    No-ops (returns None) when telemetry is off, the launcher KV is
    unreachable, or the world is one process: ``cluster_snapshot()`` then
    serves the local-only view."""
    if not getattr(config, "telemetry", True):
        return None
    addr = os.environ.get("HOROVOD_KV_ADDR")
    port = os.environ.get("HOROVOD_KV_PORT")
    world = int(world if world is not None else 1)
    if not addr or not port or world <= 1:
        return None
    from horovod_tpu_torch.runner.http_kv import KVStoreClient
    # Short timeout: a wedged KV must cost a beacon round, not block the
    # thread for the default 30 s request timeout.
    kv = KVStoreClient(addr, int(port), timeout=5)
    num_slices = getattr(topology, "num_slices", 1) if topology is not None \
        else 1
    # A forced HOROVOD_MESH_SLICES keeps the telemetry hierarchy even
    # where the topology's layout collapsed (it needs size % k == 0; an
    # elastic shrink 8 -> 7 breaks that): telemetry slices are process
    # groupings, and the near-equal partition (slice_of) is total for any
    # world size.
    forced = _env_int("HOROVOD_MESH_SLICES", 0)
    if forced > 1:
        num_slices = forced
    if rank is None:
        rank = _env_int("HOROVOD_RANK", 0)
    agent = TelemetryAgent(
        kv, rank=rank, world=world, num_slices=num_slices,
        interval=config.telemetry_interval,
        dead_after=config.telemetry_dead_after or None,
        stall_after=config.telemetry_stall_after or None,
        step_lag=config.telemetry_step_lag,
        seq_lag=config.telemetry_seq_lag,
        include_metrics=config.telemetry_metrics)
    return set_agent(agent).start()


def stop():
    set_agent(None)


def _local_view():
    """Single-process / no-KV fallback: the job view composed from this
    process's own digest — ``cluster_snapshot()`` is never empty."""
    now = time.time()
    d = _digest.collect()
    row = _digest.health_row(d)
    states, progress = _health.classify({d["rank"]: row}, now,
                                        _health.thresholds())
    return {
        "v": 1, "t": round(now, 6), "gen": "local", "leader": d["rank"],
        "world": 1, "num_slices": 1, "local_only": True,
        "slices": {"0": {"t": round(now, 6), "leader": d["rank"],
                         "digests": 1, "members": [d["rank"]]}},
        "health": {str(r): s for r, s in states.items()},
        "counts": _health.counts(states),
        "progress": progress,
        "goodput": goodput_view({d["rank"]: row}),
        "events": [],
    }


def cluster_snapshot():
    """The job-level cluster view: per-rank health states, per-slice
    digest counts, job step progress, and the bounded state-transition
    event log (``hvd.cluster_snapshot()``). Falls back to a local-only
    view when no aggregation plane is running: never returns None."""
    agent = _agent
    if agent is not None:
        view = agent.job_view()
        if view is not None:
            return view
    return _local_view()


def cluster_steps():
    """Per-rank step progress (the ``/cluster/steps`` payload): rank →
    {step, step_t, wall_mean_s, host_dispatch_mean_s} + job medians."""
    agent = _agent
    out = {"ranks": {}, "progress": {}}
    if agent is None:
        d = _digest.collect()
        row = _digest.health_row(d)
        out["ranks"][str(d["rank"])] = {
            k: row.get(k) for k in ("step", "step_t", "wall_mean_s",
                                    "host_dispatch_mean_s", "steps")}
        if row.get("step") is not None:
            out["progress"] = {"median_step": row["step"]}
        return out
    now = agent.time_fn()
    rows = {}
    for summ in agent.slice_summaries().values():
        for r_str, row in (summ or {}).get("ranks", {}).items():
            if row is None:
                continue
            rows[int(r_str)] = row
            out["ranks"][r_str] = {
                k: row.get(k) for k in ("step", "step_t", "wall_mean_s",
                                        "host_dispatch_mean_s", "steps")}
    out["progress"] = _health.job_progress(rows, now, agent.thresholds)
    return out


def cluster_metrics_text():
    """Job-aggregated Prometheus exposition (the ``/cluster/metrics``
    payload): every slice's merged snapshot stamped with its ``slice``
    label, then merged — counters sum within a slice and stay
    distinguishable across slices."""
    from horovod_tpu_torch.metrics import merge as _merge
    from horovod_tpu_torch.metrics.instruments import REGISTRY
    agent = _agent
    if agent is None:
        snap = _merge.add_labels(_merge.compact(REGISTRY.snapshot()),
                                 slice="0")
        return _merge.render_text(snap, prefix=REGISTRY.prefix)
    labelled = []
    for sid, summ in agent.slice_summaries().items():
        m = (summ or {}).get("metrics")
        if m:
            labelled.append(_merge.add_labels(m, slice=sid))
    merged = _merge.merge_snapshots(labelled)
    return _merge.render_text(merged, prefix=REGISTRY.prefix)
