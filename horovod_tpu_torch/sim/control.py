"""The control-plane digital twin: virtual ranks over the event heap.

Port of the JAX package's ``sim/control.py`` over the port's
``common/control_plane.py`` (``exchange_plan``, ``_rotated_after``),
``common/topology.py::slice_layout``, ``chaos/plan.py`` and
``autopilot/remediate.py``. Rank programs here mirror
:mod:`horovod_tpu_torch.common.control_plane`'s ``flat_exchange`` /
``hier_exchange`` *statement for statement* — same
key layout (``{base}/{p}``, ``{base}/agg/{s}``, ``{base}/fb/{s}``), same
rotated read order, same raw-JSON string aggregation, same counter
fields — with the blocking KV calls replaced by priced events. The
thread-per-rank dryrun (``simulate_exchange``) stays the ground-truth
anchor: ``python -m horovod_tpu_torch.sim`` asserts the twin's per-role
counters equal the thread dryrun's measured ones at n=128 before anything
trusts the extrapolation to n=65536.

:class:`TwinJob` composes the rest of the twin on top of one exchange:
chaos faults decided by the REAL :class:`~horovod_tpu_torch.chaos.plan.
FaultSpec` triggers through a rank-keyed
:class:`~horovod_tpu_torch.chaos.plan.TriggerCursor` (kill / straggle /
KV-delay at simulated scale), and elastic membership transitions decided
by the REAL :class:`~horovod_tpu_torch.autopilot.remediate.RemediationPolicy`
running on the twin's virtual clock (``time_fn`` — the fake-clock seam
the policy was built with).
"""

import json

from horovod_tpu_torch.common.control_plane import (_rotated_after,
                                                    exchange_plan)
from horovod_tpu_torch.common.topology import slice_layout
from horovod_tpu_torch.sim.core import LatencyModel, Simulator, SimTimeout

# Virtual-seconds deadline for one blocking get. Costs nothing real —
# it only bounds how long a round with a dead participant stays open.
TIMEOUT_S = 30.0

# Full event simulation of the FLAT strategy is O(world^2) events; past
# this world size the twin refuses and points at the analytic
# ``exchange_plan`` (which is exact for flat — that is the point of the
# hierarchy guard).
FLAT_WORLD_CAP = 2048

_COUNTER_KEYS = ("sets", "gets", "attempts", "gets_local", "gets_cross",
                 "gets_fanback")


def flat_reference(world, rnd=0, payload_fn=None):
    """The ordered payload list ONE flat round trivially produces (every
    rank reads every peer's blob in proc order) — the twin's flat-vs-hier
    payload-identity oracle at world sizes where simulating the flat
    O(world^2) fan-out event-by-event is pointless."""
    payload_fn = payload_fn or _default_payload
    return [payload_fn(p, rnd) for p in range(int(world))]


def _default_payload(p, r):
    # The thread dryrun's default payload (control_plane.simulate_exchange)
    return [p + 1, r, p % 7]


def _loads_cached(blob, cache):
    """``json.loads`` with a shared per-call decode cache. Every reader
    decodes the SAME stored string object (the simulator interns landed
    values), so at n=65536 each distinct blob is parsed once instead of
    once per reader — a semantic no-op (results are never mutated) that
    turns the decode fan-out from O(world^2) into O(world)."""
    v = cache.get(blob)
    if v is None:
        v = json.loads(blob)
        cache[blob] = v
    return v


def _flatten_fanback(fanback, cache):
    """The fan-back decode (``[p for g in loads(fb) for p in g]``),
    shared across readers via ``cache`` — every slice publishes an
    equal blob, so all world ranks can share ONE ordered result list."""
    out = cache.get(fanback)
    if out is None:
        out = [p for g in json.loads(fanback) for p in g]
        cache[fanback] = out
    return out


def _flat_program(me, procs, base, blob, slice_size, counters, cache,
                  timeout_s):
    """``control_plane.flat_exchange`` as an event program. The bounded
    short-timeout sweep is a wall-clock head-of-line fix with no virtual
    analogue, so the twin prices every read as the blocking pass;
    ``gets`` (the guard's quantity) is identical, ``attempts`` may be
    lower than a thread run's sweep misses."""
    yield ("put", f"{base}/{me}", blob, False)
    counters["sets"] += 1
    got = {me: blob}
    my_slice = me // slice_size if slice_size else 0
    for p in _rotated_after(procs, me):
        cross = slice_size and (p // slice_size) != my_slice
        got[p] = yield ("get", f"{base}/{p}", bool(cross), timeout_s)
        counters["gets"] += 1
        counters["attempts"] += 1
    return [_loads_cached(got[q], cache) for q in procs]


def _hier_program(me, procs, groups, sid, base, blob, counters, cache,
                  timeout_s):
    """``control_plane.hier_exchange`` as an event program: slice-local
    gather, ONE leaders-only cross-slice round (the DCN-priced gets),
    leader->member fan-back. Same key layout, same JSON string
    aggregation, same counters. ``sid`` is precomputed by the caller
    (the real code's linear group scan is O(world) per rank — fine for
    threads at n<=512, O(world^2) for the twin at 65536)."""
    group = groups[sid]
    leader = group[0]
    yield ("put", f"{base}/{me}", blob, False)
    counters["sets"] += 1
    if me != leader:
        fanback = yield ("get", f"{base}/fb/{sid}", False, timeout_s)
        counters["gets"] += 1
        counters["attempts"] += 1
        counters["gets_fanback"] += 1
        return _flatten_fanback(fanback, cache)
    raw_by_proc = {me: blob}
    for p in _rotated_after(group, me):
        raw_by_proc[p] = yield ("get", f"{base}/{p}", False, timeout_s)
        counters["gets"] += 1
        counters["attempts"] += 1
        counters["gets_local"] += 1
    agg = "[" + ",".join(raw_by_proc[p] for p in group) + "]"
    yield ("put", f"{base}/agg/{sid}", agg, False)
    counters["sets"] += 1
    aggs = []
    for gi in range(len(groups)):
        if gi == sid:
            aggs.append(agg)
        else:
            aggs.append((yield ("get", f"{base}/agg/{gi}", True,
                                timeout_s)))
            counters["gets"] += 1
            counters["attempts"] += 1
            counters["gets_cross"] += 1
    fanback = "[" + ",".join(aggs) + "]"
    yield ("put", f"{base}/fb/{sid}", fanback, False)
    counters["sets"] += 1
    return _flatten_fanback(fanback, cache)


def _round_program(me, procs, groups, sid, base, blob, slice_size,
                   counters, cache, timeout_s):
    """One rank's round, timeout-guarded: a :class:`SimTimeout` (a dead
    or hung peer) aborts the round with a failure result instead of
    crashing the scheduler — the live analogue is the exchange raising
    and the caller re-rendezvousing."""
    try:
        if groups is None:
            out = yield from _flat_program(me, procs, base, blob,
                                           slice_size, counters, cache,
                                           timeout_s)
        else:
            out = yield from _hier_program(me, procs, groups, sid, base,
                                           blob, counters, cache,
                                           timeout_s)
    except SimTimeout as e:
        return {"ok": False, "error": f"timeout waiting for {e}"}
    return {"ok": True, "out": out}


def _layout(procs, num_slices):
    """Slice groups over the sorted live proc list — the thread dryrun's
    grouping rule (contiguous blocks of ``slice_size``), collapsing to
    flat exactly when :func:`topology.slice_layout` does."""
    k, per = slice_layout(len(procs), num_slices or None)
    if k <= 1:
        return None, 1, len(procs)
    groups = [procs[i * per:(i + 1) * per] for i in range(k)]
    return groups, k, per


def twin_exchange(world, num_slices, rounds=1, payload_fn=None,
                  strategy="hier", latency=None, record_trail=False,
                  plan=None):
    """The twin counterpart of ``control_plane.simulate_exchange``: same
    arguments, same result shape (so the two are drop-in comparable),
    plus ``virtual_s`` (priced round latency), ``events`` and — when
    ``record_trail`` — the deterministic event ``trail``. ``plan`` (a
    :class:`~horovod_tpu_torch.chaos.plan.ChaosPlan`) arms KV-site faults; for
    kill/straggle + elastic membership use :class:`TwinJob`."""
    world = int(world)
    procs = list(range(world))
    k, per = slice_layout(world, num_slices or None)
    hier = strategy == "hier" and k > 1
    if not hier and world > FLAT_WORLD_CAP:
        raise ValueError(
            f"flat twin exchange at n={world} would be O(world^2) "
            f"events; past n={FLAT_WORLD_CAP} price it analytically "
            "with control_plane.exchange_plan instead")
    groups = [procs[i * per:(i + 1) * per] for i in range(k)] if hier \
        else None
    payload_fn = payload_fn or _default_payload
    counters = [dict.fromkeys(_COUNTER_KEYS, 0) for _ in procs]
    payload_bytes = [0] * world
    outs = [None] * world
    virtual_s = 0.0
    events = 0
    timeouts = 0
    trail = [] if record_trail else None
    cursor = None
    if plan is not None:
        from horovod_tpu_torch.chaos.plan import TriggerCursor
        cursor = TriggerCursor(plan)

    for r in range(rounds):
        sim = Simulator(latency=latency or LatencyModel.from_env(),
                        record_trail=record_trail)
        if cursor is not None:
            sim.kv_hook = _kv_chaos_hook(cursor, r)
        base = f"sim/{r}"
        cache = {}
        for p in procs:
            blob = json.dumps(payload_fn(p, r))
            payload_bytes[p] += len(blob)
            sim.spawn(p, _round_program(p, procs, groups,
                                        p // per if hier else 0, base,
                                        blob, per if hier else 0,
                                        counters[p], cache, TIMEOUT_S))
        results = sim.run()
        for p in procs:
            res = results.get(p) or {"ok": False, "error": "killed"}
            outs[p] = res.get("out") if res.get("ok") else None
        virtual_s += max(sim.finish_t.values()) if sim.finish_t else 0.0
        events += sim.stats["events"]
        timeouts += sim.stats["timeouts"]
        if record_trail:
            trail.extend((r,) + e for e in sim.trail)

    # `is` shortcut first: the shared fan-back decode makes every rank's
    # result ONE list object at scale — a full O(world^2) elementwise
    # compare would defeat the decode cache.
    first = outs[0]
    identical = first is not None and all(
        o is first or o == first for o in outs)
    leaders = [g[0] for g in groups] if groups else []
    member_gets = [counters[p]["gets"] for p in procs
                   if p not in leaders] if groups else \
        [counters[p]["gets"] for p in procs]
    leader_gets = [counters[p]["gets"] for p in leaders]
    out = {
        "world": world, "num_slices": k if hier else 1,
        "slice_size": per if hier else world,
        "strategy": "hier" if hier else "flat", "rounds": rounds,
        "identical": identical, "per_proc": counters,
        "payload_bytes": sum(payload_bytes),
        "gets_total": sum(c["gets"] for c in counters),
        "member_gets_per_round": (max(member_gets) / rounds)
        if member_gets else 0.0,
        "leader_gets_per_round": (max(leader_gets) / rounds)
        if leader_gets else 0.0,
        "result": outs[0],
        "virtual_s": virtual_s, "events": events, "timeouts": timeouts,
        "plan": exchange_plan(world, k if hier else 1),
    }
    if record_trail:
        out["trail"] = trail
    return out


def _kv_chaos_hook(cursor, step):
    """Adapt the plan's ``http_kv.request`` site to the simulator's KV
    hook: ``delay`` prices the injected latency, ``drop``/``http_5xx``
    price one retry backoff (the client's retry loop absorbs them),
    ``crash`` kills the rank, ``hang`` parks it past any round
    deadline."""
    def hook(rank, op, key):
        delay = 0.0
        kill = False
        for spec in cursor.decide("http_kv.request", rank, step):
            if spec.kind == "crash":
                kill = True
            elif spec.kind == "hang":
                delay += float(spec.hang_s)
            else:                 # delay / drop / http_5xx: priced retry
                delay += float(spec.delay_ms) / 1e3
        return delay, kill
    return hook


class TwinJob:
    """A multi-round control-plane job at simulated scale: per round one
    negotiation exchange over the surviving members, chaos verdicts from
    the plan's pure triggers, health verdicts fed to the REAL
    :class:`RemediationPolicy` on the virtual clock, and membership
    shrink applied exactly where the live stack would re-rendezvous.

    Deterministic end to end: same ``(plan seed, world, slices)`` →
    bit-identical event trail and report across runs."""

    def __init__(self, world, num_slices, rounds=4, plan=None,
                 latency=None, payload_fn=None, record_trail=False,
                 hysteresis=2, max_removals=4, min_world=1,
                 round_gap_s=30.0, straggle_factor=3.0):
        from horovod_tpu_torch.autopilot.remediate import RemediationPolicy
        from horovod_tpu_torch.chaos.plan import TriggerCursor
        self.world0 = int(world)
        self.num_slices = int(num_slices)
        self.rounds = int(rounds)
        self.latency = latency or LatencyModel.from_env()
        self.payload_fn = payload_fn or _default_payload
        self.record_trail = record_trail
        self.round_gap_s = float(round_gap_s)
        self.straggle_factor = float(straggle_factor)
        self.t = 0.0                       # the job's virtual clock
        self.cursor = TriggerCursor(plan)
        self.policy = RemediationPolicy(
            hysteresis=hysteresis, max_removals=max_removals,
            min_world=min_world, protected=(0,),
            time_fn=lambda: self.t)        # the fake-clock seam
        self._dead = set()

    def _chaos_round_start(self, procs, rnd):
        """``negotiation.exchange``-site faults at round start: crash
        and hang take the rank out of the round (and every later one —
        a crashed process does not come back), delay defers its entry."""
        delays = {}
        for rank in procs:
            if rank in self._dead:
                continue
            for spec in self.cursor.decide("negotiation.exchange", rank,
                                           rnd):
                if spec.kind in ("crash", "hang"):
                    self._dead.add(rank)
                elif spec.kind == "delay":
                    delays[rank] = delays.get(rank, 0.0) \
                        + float(spec.delay_ms) / 1e3
        return delays

    def _delayed(self, program, delay_s):
        yield ("advance", delay_s)
        res = yield from program
        return res

    def run(self):
        live = list(range(self.world0))
        rounds_out = []
        membership = []
        trail = [] if self.record_trail else None
        stats = {"events": 0, "kv_ops": 0, "timeouts": 0}
        for rnd in range(self.rounds):
            procs = list(live)
            groups, k, per = _layout(procs, self.num_slices)
            delays = self._chaos_round_start(procs, rnd)
            sim = Simulator(latency=self.latency,
                            record_trail=self.record_trail)
            sim.kv_hook = _kv_chaos_hook(self.cursor, rnd)
            base = f"job/{rnd}"
            counters = {p: dict.fromkeys(_COUNTER_KEYS, 0)
                        for p in procs}
            cache = {}
            sid_of = {}
            if groups is not None:
                for gi, g in enumerate(groups):
                    for p in g:
                        sid_of[p] = gi
            for p in procs:
                if p in self._dead:
                    continue               # dead ranks publish nothing
                blob = json.dumps(self.payload_fn(p, rnd))
                prog = _round_program(p, procs, groups, sid_of.get(p, 0),
                                      base, blob, per if groups else 0,
                                      counters[p], cache, TIMEOUT_S)
                if p in delays:
                    prog = self._delayed(prog, delays[p])
                sim.spawn(p, prog)
            results = sim.run()
            self._dead |= sim.killed
            for key in stats:
                stats[key] += sim.stats[key]
            if self.record_trail:
                trail.extend((rnd,) + e for e in sim.trail)

            ok = {p for p, res in results.items()
                  if res and res.get("ok")}
            duration = max(sim.finish_t.values()) if sim.finish_t else 0.0
            verdicts = self._verdicts(procs, ok, sim.finish_t)
            self.t += duration + self.round_gap_s
            actions = self.policy.observe(verdicts, world=len(live),
                                          host_sizes=None)
            for action in actions:
                if action["rank"] in live:
                    live.remove(action["rank"])
                membership.append({"round": rnd, "t": round(self.t, 6),
                                   **action})
            rounds_out.append({
                "round": rnd, "world": len(procs),
                "num_slices": k if groups else 1,
                "strategy": "hier" if groups else "flat",
                "ok": len(ok), "failed": len(procs) - len(ok),
                "virtual_s": round(duration, 9),
                "worst_gets": max((c["gets"]
                                   for c in counters.values()),
                                  default=0),
            })
        report = {
            "world0": self.world0, "num_slices": self.num_slices,
            "rounds": rounds_out, "membership": membership,
            "final_world": len(live), "dead": sorted(self._dead),
            "virtual_s": round(self.t, 6),
            "chaos_fires": list(self.cursor.log), "stats": stats,
        }
        if self.record_trail:
            report["trail"] = trail
        return report

    def _verdicts(self, procs, ok, finish_t):
        """This round's health verdicts: a dead/hung rank is named
        ``dead`` (one host per rank — the worst-case layout the policy's
        host accounting degenerates to), a finisher far beyond the
        median is named ``straggler``."""
        verdicts = {}
        for p in procs:
            if p in self._dead:
                verdicts[p] = {"cause": "dead", "host": f"h{p}"}
        finishers = sorted(finish_t[p] for p in ok if p in finish_t)
        if finishers:
            median = finishers[len(finishers) // 2]
            floor = max(self.straggle_factor * median, median + 1e-3)
            for p in ok:
                if finish_t.get(p, 0.0) > floor:
                    verdicts[p] = {"cause": "straggler", "host": f"h{p}"}
        return verdicts
