"""Hierarchical control plane: slice-local negotiation, leaders-only
cross-slice rounds, and the scope-to-shard routing of the launcher's KV.

Port of the JAX package's ``common/control_plane.py``. A flat control plane
issues O(world) blocking store reads per process per negotiation round and
fans every fusion boundary out to every follower from one store; this
module gives both a per-slice hierarchy:

- ``exchange_groups`` partitions the participating processes by slice with
  :func:`topology.slice_layout` (the layout the tiers use too), so the two
  hierarchies cannot disagree. One process drives one device in the port,
  so the process space is the rank space.
- ``hier_exchange`` decomposes one ``negotiation.exchange`` round into a
  slice-local gather (members to their slice leader), ONE leaders-only
  cross-slice round, and a leader-to-member fan-back: blocking gets drop
  from O(world) to O(slice_size + num_slices) for leaders and O(1) for
  members.
- ``flat_exchange`` keeps the flat path but reads peers rotated from
  ``me+1`` with a bounded short-timeout sweep, so one slow early rank no
  longer holds up every later get.
- ``boundary_role`` assigns the fusion boundary stream's re-publish roles
  (process 0 publishes once; slice leaders re-publish to their members),
  with a lease-based takeover when a leader dies mid-stream.
- ``slice_scope`` / ``shard_of_scope`` are the launcher KV's routing
  convention: slice-local scopes resolve to the per-slice shard listener,
  job-global scopes to the root listener.
- ``simulate_exchange`` drives the real exchange implementations over an
  in-memory KV with one thread per virtual rank, at any world size.

:class:`CoordKV` puts the ``TCPStore`` that ``hvd.init`` opens behind the
small set/get/delete surface the exchanges drive; it stands where the JAX
package has its coordination service's key-value store.

The strategy is ``HOROVOD_CONTROL_PLANE=flat|hier`` ("" = auto, hier
whenever the slice layout has more than one slice). A one-slice layout is
always flat: the hierarchy would add hops for no fan-out saving.
"""

import datetime
import json
import os
import threading
import time

from horovod_tpu_torch.common.topology import parse_slices, slice_layout

# Bounded short-timeout sweep ahead of the blocking pass (flat path): a
# ready peer is drained in ``SWEEP_MS``; after ``SWEEP_MISS_CAP`` misses
# the sweep stops and the remaining peers get the normal blocking read,
# so the sweep can never add more than CAP x SWEEP_MS latency.
SWEEP_MS = 50
SWEEP_MISS_CAP = 4


def configured(env=None):
    """The ``HOROVOD_CONTROL_PLANE`` knob (of ``env``, default the process
    environment), normalized: ``"flat"``, ``"hier"``, or ``""`` (auto:
    hier when the slice layout has >1 slice)."""
    env = os.environ if env is None else env
    v = env.get("HOROVOD_CONTROL_PLANE", "").strip().lower()
    if v in ("flat", "hier"):
        return v
    return ""


def _live_num_slices():
    """Slice count of the live topology (``HOROVOD_MESH_SLICES``, or one
    slice per node), or 0 to defer to the forced layout."""
    try:
        from horovod_tpu_torch.common import basics
        if basics.is_initialized():
            topo = basics._get_state().topology
            if topo is not None and topo.num_slices > 1:
                return topo.num_slices
    except Exception:  # noqa: BLE001 — uninitialized: env layout only
        pass
    return 0


def proc_slice_layout(n_procs, local_size=None, num_slices=None):
    """``(num_slices, procs_per_slice)`` over the PROCESS space, derived
    from the rank-space layout (:func:`topology.slice_layout`).
    ``local_size`` is the ranks a process drives (1 in the port, the
    default; the JAX package's processes drive every chip of a host).
    Collapses to ``(1, n_procs)`` when the rank layout is single-slice or a
    process's rank block would straddle a slice boundary."""
    n_procs = max(int(n_procs), 1)
    local_size = max(int(local_size or 1), 1)
    size = n_procs * local_size
    k, rank_ss = slice_layout(size, num_slices or _live_num_slices()
                              or None)
    if k <= 1 or rank_ss % local_size != 0:
        return 1, n_procs
    per = rank_ss // local_size
    if per < 1 or n_procs % per != 0:
        return 1, n_procs
    return n_procs // per, per


def exchange_groups(procs, local_size=None):
    """Slice groups (ordered list of ordered process lists) for one
    hierarchical exchange over the sorted participant list ``procs`` —
    or ``None`` for the flat path (knob forced flat, 1-slice layout, or
    every participant landing in one slice). Resolved per call so an
    elastic shrink to an undivisible world degrades to flat on every
    process identically (the layout math is pure and the knob env is
    propagated)."""
    if configured() == "flat":
        return None
    n_procs = (max(procs) + 1) if procs else 1
    try:
        from horovod_tpu_torch.common import basics
        if basics.is_initialized():
            n_procs = basics.size()
    except Exception:  # noqa: BLE001
        pass
    k, per = proc_slice_layout(n_procs, local_size=local_size)
    if k <= 1:
        return None
    groups = {}
    for p in procs:
        groups.setdefault(int(p) // per, []).append(p)
    if len(groups) <= 1:
        return None
    return [groups[s] for s in sorted(groups)]


def boundary_role(proc, groups, coordinator=0):
    """Fusion-boundary consumer role of ``proc`` under ``groups``:
    ``(slice_id, role, n_members)`` with role in ``{"root", "leader",
    "member"}``. The coordinator (who publishes, never consumes) and
    every process on a flat layout read the root key; each slice's
    leader — its lowest non-coordinator process — reads the root key and
    re-publishes to the slice key; everyone else reads the slice key.
    ``n_members`` is how many members the leader re-publishes for (0
    means the re-publish can be skipped)."""
    if groups is None or proc == coordinator:
        return 0, "root", 0
    for sid, g in enumerate(groups):
        if proc not in g:
            continue
        followers = [p for p in g if p != coordinator]
        leader = followers[0] if followers else None
        n_members = max(len(followers) - 1, 0)
        if proc == leader:
            return sid, "leader", n_members
        return sid, "member", n_members
    return 0, "root", 0


def exchange_plan(world, num_slices):
    """Structural per-role KV RPC counts for ONE negotiation round — the
    quantities a scaling check or a cost model prices. Pure
    math over the SAME layout rules the runtime resolves
    (:func:`topology.slice_layout`)."""
    world = max(int(world), 1)
    k, per = slice_layout(world, num_slices or None)
    if k <= 1:
        n = world - 1
        return {"strategy": "flat", "num_slices": 1, "slice_size": world,
                "member_gets": n, "leader_gets": n,
                "leader_local_gets": 0, "leader_cross_gets": 0,
                "member_sets": 1, "leader_sets": 1,
                "round_gets_total": world * n}
    return {
        "strategy": "hier", "num_slices": k, "slice_size": per,
        # Members: publish own payload, read ONE fan-back blob.
        "member_gets": 1, "member_sets": 1,
        # Leaders: read their members, one leaders-only cross-slice round, then
        # publish the aggregate + the fan-back (3 sets incl. own key).
        "leader_local_gets": per - 1, "leader_cross_gets": k - 1,
        "leader_gets": (per - 1) + (k - 1), "leader_sets": 3,
        "round_gets_total": k * ((per - 1) + (k - 1)) + (world - k),
    }


def kv_shard_count(size, num_slices=None, env=None):
    """Launcher-side shard count for the sharded HTTP-KV plane: the
    ``HOROVOD_KV_SHARD_COUNT`` override, else one shard per slice of the
    ``size``-rank layout when the hierarchical control plane is armed
    (0 = unsharded). ``env``: the knobs' mapping (default the process
    environment; the launcher passes the workers' env)."""
    from horovod_tpu_torch.common.config import _env_int
    env = os.environ if env is None else env
    explicit = _env_int("HOROVOD_KV_SHARD_COUNT", 0, env)
    if explicit:
        return max(explicit, 0)
    if configured(env) == "flat":
        return 0
    k, _ = slice_layout(max(int(size), 1), num_slices or parse_slices(
        env.get("HOROVOD_MESH_SLICES")) or None)
    return k if k > 1 else 0


# --- scope -> shard routing (the runner HTTP-KV convention) --------------

_SLICE_SCOPE_SEP = "@s"


def slice_scope(scope, sid):
    """Slice-local spelling of ``scope``: routed by
    :class:`~horovod_tpu_torch.runner.http_kv.KVStoreClient` (and the server's
    in-process accessors) to slice ``sid``'s shard listener when shards
    exist, and served from the root store (as a distinct scope) when they
    don't."""
    return f"{scope}{_SLICE_SCOPE_SEP}{int(sid)}"


def shard_of_scope(scope, n_shards):
    """Shard index for ``scope`` (``None`` = the root store): scopes
    carrying the ``@s<k>`` suffix resolve to shard ``k % n_shards``,
    job-global scopes to the root."""
    if n_shards <= 0:
        return None
    i = scope.rfind(_SLICE_SCOPE_SEP)
    if i < 0:
        return None
    try:
        sid = int(scope[i + len(_SLICE_SCOPE_SEP):])
    except ValueError:
        return None
    return sid % int(n_shards)


# --- KV adapters ---------------------------------------------------------

class CoordKV:
    """The ``TCPStore`` behind the small set/get/delete surface the exchange
    implementations drive (so the virtual-world simulator can substitute
    :class:`LocalKV`). A store's ``set`` always overwrites, so
    ``overwrite`` changes nothing; ``get`` waits up to ``timeout_ms`` for
    the key and raises when it does not appear."""

    __slots__ = ("_s",)

    def __init__(self, store):
        self._s = store

    def set(self, key, value, overwrite=False):
        self._s.set(key, value)

    def get(self, key, timeout_ms):
        self._s.wait([key], datetime.timedelta(milliseconds=int(timeout_ms)))
        raw = self._s.get(key)
        return raw.decode() if isinstance(raw, bytes) else raw

    def delete(self, key):
        self._s.delete_key(key)


class LocalKV:
    """In-memory blocking KV with the :class:`CoordKV` surface: the
    virtual-world simulation tier (one thread per simulated rank drives
    the real exchange code against it).

    ``observer(op, key)`` (optional) is called once per ``set``/``get``
    entry, for per-operation accounting. It runs OUTSIDE the condition
    lock, before the blocking wait, so an observer can never deadlock the
    exchange (and a get that times out still counts as the one RPC it
    issued)."""

    def __init__(self, observer=None):
        self._d = {}
        self._cv = threading.Condition()
        self._observer = observer

    def set(self, key, value, overwrite=False):
        if self._observer is not None:
            self._observer("set", key)
        with self._cv:
            if key in self._d and not overwrite:
                raise KeyError(f"key exists: {key}")
            self._d[key] = value
            self._cv.notify_all()

    def get(self, key, timeout_ms):
        if self._observer is not None:
            self._observer("get", key)
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(f"key not set: {key}")
                self._cv.wait(remaining)
            return self._d[key]

    def delete(self, key):
        with self._cv:
            self._d.pop(key, None)


# --- exchange implementations -------------------------------------------

def _rotated_after(procs, me):
    """Peers in ``procs`` order rotated to start just after ``me`` — the
    head-of-line fix: the peer most likely ready first (the one whose
    publish raced ours) is read first, and a slow early rank only delays
    the reads behind it instead of every read."""
    i = procs.index(me)
    return procs[i + 1:] + procs[:i]


def flat_exchange(kv, me, procs, base, blob, timeout_ms,
                  sweep_ms=SWEEP_MS):
    """One flat exchange round over ``kv``: publish own blob, read every
    peer rotated from ``me+1`` with a bounded short-timeout sweep before
    the long blocking pass. Returns ``(blobs_by_proc, counters)``."""
    kv.set(f"{base}/{me}", blob)
    got = {me: blob}
    pending = []
    attempts = 0
    order = _rotated_after(procs, me)
    misses = 0
    for p in order:
        if misses >= SWEEP_MISS_CAP:
            pending.append(p)
            continue
        attempts += 1
        try:
            got[p] = kv.get(f"{base}/{p}", sweep_ms)
        except Exception:  # noqa: BLE001 — not published yet
            misses += 1
            pending.append(p)
    for p in pending:
        attempts += 1
        got[p] = kv.get(f"{base}/{p}", timeout_ms)
    counters = {"sets": 1, "gets": len(procs) - 1, "attempts": attempts,
                "gets_local": 0, "gets_cross": 0, "gets_fanback": 0}
    return got, counters


def hier_exchange(kv, me, procs, base, blob, groups, timeout_ms):
    """One hierarchical exchange round: slice-local gather (members ->
    leader), ONE leaders-only cross-slice round, leader -> member
    fan-back. Returns ``(ordered_payloads, counters)`` where the payload
    list is bit-identical (same ordering, same JSON values) to the flat
    path's result over the same ``procs``.

    Key layout under ``base``: every participant publishes its own blob
    at ``{base}/{p}`` (flat-compatible); slice ``s``'s leader publishes
    the slice aggregate at ``{base}/agg/{s}`` and the full ordered
    fan-back at ``{base}/fb/{s}``. Blobs are raw JSON, so aggregation is
    string concatenation — no decode/re-encode drift between tiers."""
    sid = next(i for i, g in enumerate(groups) if me in g)
    group = groups[sid]
    leader = group[0]
    kv.set(f"{base}/{me}", blob)
    if me != leader:
        fanback = kv.get(f"{base}/fb/{sid}", timeout_ms)
        out = [p for g in json.loads(fanback) for p in g]
        counters = {"sets": 1, "gets": 1, "attempts": 1,
                    "gets_local": 0, "gets_cross": 0, "gets_fanback": 1}
        return out, counters
    # Slice-local gather, rotated like the flat path.
    raw_by_proc = {me: blob}
    for p in _rotated_after(group, me):
        raw_by_proc[p] = kv.get(f"{base}/{p}", timeout_ms)
    agg = "[" + ",".join(raw_by_proc[p] for p in group) + "]"
    kv.set(f"{base}/agg/{sid}", agg)
    # Leaders-only cross-slice round (the one cross-slice rendezvous).
    aggs = []
    for gi in range(len(groups)):
        aggs.append(agg if gi == sid
                    else kv.get(f"{base}/agg/{gi}", timeout_ms))
    fanback = "[" + ",".join(aggs) + "]"
    kv.set(f"{base}/fb/{sid}", fanback)
    out = [p for g in json.loads(fanback) for p in g]
    counters = {"sets": 3, "gets": (len(group) - 1) + (len(groups) - 1),
                "attempts": (len(group) - 1) + (len(groups) - 1),
                "gets_local": len(group) - 1,
                "gets_cross": len(groups) - 1, "gets_fanback": 0}
    return out, counters


def gc_exchange_keys(kv, me, base_prev, groups):
    """Best-effort deletion of one SUPERSEDED round's keys (the lag-2 GC
    discipline ``negotiation.exchange`` documents): own payload key
    always; the slice aggregate + fan-back too when this process led its
    slice that round."""
    keys = [f"{base_prev}/{me}"]
    if groups is not None:
        for sid, g in enumerate(groups):
            if g and g[0] == me:
                keys += [f"{base_prev}/agg/{sid}", f"{base_prev}/fb/{sid}"]
    for key in keys:
        try:
            kv.delete(key)
        except Exception:  # noqa: BLE001 — housekeeping only
            pass


# --- virtual-world dryrun tier ------------------------------------------

def simulate_exchange(world, num_slices, rounds=1, payload_fn=None,
                      strategy="hier", sweep_ms=5, observer=None):
    """Drive the REAL exchange implementations at a virtual world size:
    one thread per simulated rank over a :class:`LocalKV`, ``rounds``
    exchange rounds each: the control-plane dryrun, with no devices and no
    processes, but the exact code path and the exact RPC counts.

    Returns a dict with the resolved layout, whether every rank produced
    the identical ordered payload list (the SPMD contract), and per-role
    RPC counters aggregated over all rounds. ``observer`` is forwarded to
    :class:`LocalKV`: per-op ``(op, key)`` callbacks."""
    world = int(world)
    procs = list(range(world))
    k, per = slice_layout(world, num_slices or None)
    hier = strategy == "hier" and k > 1
    groups = [procs[i * per:(i + 1) * per] for i in range(k)] if hier \
        else None
    kv = LocalKV(observer=observer)
    payload_fn = payload_fn or (lambda p, r: [p + 1, r, p % 7])
    counters = [dict.fromkeys(
        ("sets", "gets", "attempts", "gets_local", "gets_cross",
         "gets_fanback"), 0) for _ in procs]
    outs = [None] * world
    payload_bytes = [0] * world
    errors = []

    def run(p):
        try:
            for r in range(rounds):
                base = f"sim/{r}"
                blob = json.dumps(payload_fn(p, r))
                payload_bytes[p] += len(blob)
                if groups is None:
                    got, c = flat_exchange(kv, p, procs, base, blob,
                                           timeout_ms=120_000,
                                           sweep_ms=sweep_ms)
                    out = [json.loads(got[q]) for q in procs]
                else:
                    out, c = hier_exchange(kv, p, procs, base, blob,
                                           groups, timeout_ms=120_000)
                for key, v in c.items():
                    counters[p][key] += v
                outs[p] = out
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            errors.append((p, repr(e)))

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in procs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    hung = [p for p, t in zip(procs, threads) if t.is_alive()]
    if hung:
        # A deadlocked exchange must FAIL the dryrun, not score as a
        # clean run with zeroed counters.
        raise RuntimeError(
            f"simulated exchange deadlocked: {len(hung)} rank(s) still "
            f"blocked after 300s (first: {hung[:8]})")
    if errors:
        raise RuntimeError(f"simulated exchange failed: {errors[:4]}")
    identical = all(o == outs[0] for o in outs)
    leaders = [g[0] for g in groups] if groups else []
    member_gets = [counters[p]["gets"] for p in procs
                   if p not in leaders] if groups else \
        [counters[p]["gets"] for p in procs]
    leader_gets = [counters[p]["gets"] for p in leaders]
    return {
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
    }
