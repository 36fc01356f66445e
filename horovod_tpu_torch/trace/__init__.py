"""Request-level tracing: propagated trace ids and bounded span trees.

Port of the JAX package's ``trace/__init__.py``, the same store, eviction
and capacities. A **trace id** is minted per serving request and carried
from admission through queue wait, chunked prefill, slot install, every
decode step, elastic commit/restore/requeue and stream completion; the id
rides the elastic request snapshot, so one contiguous trace spans an
engine restart. Training steps get a trace each: ``flight.step_marker``
rotates it (:func:`step_trace`) and makes it the thread's ACTIVE ref, so
the dispatch and fusion-flush spans of the ops layer land
under it, and every flight-ring event carries it (its ``trace`` field).

Spans are plain dicts in a bounded per-process store (requests and steps
evict independently). Read them live at ``GET /debug/trace/<rid>`` on the
serving frontend, or dump per-rank shards with :func:`dump` and merge them
with ``python -m horovod_tpu_torch.trace.analyze``.

Span-tree schema (``tree()``): the root is the request/step; its children
are PHASE spans (``queue``, ``prefill``, ``decode``, ``stream``, plus
``requeue``/``restore``/``commit`` instants); phase children are the
fine-grained spans (``chunk``, ``install``, ``decode_step``). A phase that
is never recorded explicitly (``decode``) is synthesized from its
children's envelope. Every write is fail-soft and O(1) under one lock.
"""

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

from horovod_tpu_torch.common.config import _env_bool, _env_int

armed = _env_bool("HOROVOD_TRACE", True)

_counter = itertools.count(1)
# Process-unique salt: rids and step numbers are process-local, so the
# trace id must not collide across workers whose shards get merged.
_SALT = f"{os.getpid():x}"

_lock = threading.Lock()
_traces = {}                  # tid -> record
_rid_index = {}               # str(rid) -> tid
_order = {}                   # kind -> deque of tids (eviction order)
_capacity = {"request": _env_int("HOROVOD_TRACE_CAPACITY", 256),
             "step": 64}
_MAX_SPANS = 4096             # per-trace span cap (drops counted)

_tls = threading.local()      # .tid — the active trace ref


def configure(config):
    """Re-arm from a :class:`~horovod_tpu_torch.common.config.Config`
    (called from ``hvd.init()``)."""
    global armed
    armed = bool(getattr(config, "trace", armed))
    cap = int(getattr(config, "trace_capacity", 0) or 0)
    if cap > 0:
        # _evict_locked reads _capacity under _lock; an unlocked write
        # here could race a concurrent register()'s eviction decision.
        with _lock:
            _capacity["request"] = cap


# --- ids and the active context -----------------------------------------

def mint(kind="request"):
    """A fresh trace id (no registration — cheap enough to mint even
    when tracing is disarmed, so elastic snapshots always carry one)."""
    return f"t{_SALT}-{kind[0]}{next(_counter):x}"


def get_active():
    return getattr(_tls, "tid", None)


def set_active(tid):
    _tls.tid = tid


def clear_active():
    _tls.tid = None


@contextlib.contextmanager
def activate(tid):
    prev = get_active()
    _tls.tid = tid
    try:
        yield
    finally:
        _tls.tid = prev


# --- the span store ------------------------------------------------------

def _evict_locked(kind):
    order = _order.setdefault(kind, deque())
    cap = _capacity.get(kind, 256)
    while len(order) > cap:
        old = order.popleft()
        rec = _traces.pop(old, None)
        if rec is not None and rec.get("rid") is not None \
                and _rid_index.get(str(rec["rid"])) == old:
            del _rid_index[str(rec["rid"])]


def register(tid, rid=None, kind="request", t0=None, args=None):
    """Create (or re-open) the trace record for ``tid``. Idempotent: a
    requeued request re-registers under its original id and keeps every
    span already recorded — that is the continuity the chaos soak
    asserts."""
    if not armed or tid is None:
        return tid
    with _lock:
        rec = _traces.get(tid)
        if rec is None:
            rec = {"tid": tid, "rid": rid, "kind": kind,
                   "t0": time.time() if t0 is None else float(t0),
                   "spans": [], "dropped": 0, "done": False, "dur": None}
            if args:
                rec["args"] = dict(args)
            _traces[tid] = rec
            _order.setdefault(kind, deque()).append(tid)
            _evict_locked(kind)
        if rid is not None:
            rec["rid"] = rid
            _rid_index[str(rid)] = tid
    return tid


def _append_locked(rec, span):
    if len(rec["spans"]) >= _MAX_SPANS:
        rec["dropped"] += 1
        return
    rec["spans"].append(span)


def _parent_index_locked(rec, parent, t0):
    """Resolve a child's parent by name against the CURRENT top-level
    span — phases repeat across elastic incarnations (queue/prefill
    again after a requeue), so "the current one" is the last top-level
    non-instant span unless a barrier instant (requeue/restore) has
    broken the chain since. A missing parent (``decode``) is synthesized
    from its children's envelope."""
    spans = rec["spans"]
    for i in range(len(spans) - 1, -1, -1):
        s = spans[i]
        if s.get("parent") is not None:
            continue
        if s.get("ph") == "instant":
            if s.get("barrier"):
                break                 # requeue/restore: new incarnation
            continue
        if s["name"] == parent:
            return i
        break                         # a different phase started since
    synth = {"name": parent, "t0": float(t0), "dur": 0.0, "synth": True}
    if len(spans) >= _MAX_SPANS:
        rec["dropped"] += 1
        return None
    spans.append(synth)
    return len(spans) - 1


def add_span(tid, name, t0, dur, parent=None, cat=None, args=None):
    """One completed span (wall-clock ``t0``, seconds ``dur``)."""
    if not armed or tid is None:
        return
    with _lock:
        rec = _traces.get(tid)
        if rec is None:
            return
        span = {"name": name, "t0": float(t0), "dur": float(dur)}
        if cat:
            span["cat"] = cat
        if args:
            span["args"] = dict(args)
        if parent is not None:
            pi = _parent_index_locked(rec, parent, t0)
            if pi is None:
                return
            span["parent"] = pi
            p = rec["spans"][pi]
            if p.get("synth"):
                p["t0"] = min(p["t0"], span["t0"])
                p["dur"] = max(p["dur"],
                               span["t0"] + span["dur"] - p["t0"])
        _append_locked(rec, span)


def add_instant(tid, name, t=None, cat=None, args=None, barrier=False):
    """A zero-duration marker. ``barrier=True`` (requeue/restore) closes
    the current phase chain: spans recorded after it start a fresh
    incarnation of their phase."""
    if not armed or tid is None:
        return
    with _lock:
        rec = _traces.get(tid)
        if rec is None:
            return
        span = {"name": name, "t0": time.time() if t is None else float(t),
                "dur": 0.0, "ph": "instant"}
        if cat:
            span["cat"] = cat
        if args:
            span["args"] = dict(args)
        if barrier:
            span["barrier"] = True
        _append_locked(rec, span)


def finish(tid, dur=None):
    """Close the trace root (stream completion / step end)."""
    if not armed or tid is None:
        return
    with _lock:
        rec = _traces.get(tid)
        if rec is None:
            return
        rec["done"] = True
        rec["dur"] = float(dur) if dur is not None \
            else time.time() - rec["t0"]


@contextlib.contextmanager
def span(name, parent=None, cat=None, tid=None):
    """Record a span around a block, into ``tid`` or the active trace.
    No-op (one attribute read) when tracing is off or nothing is
    active — cheap enough for the ops hot path."""
    t = tid if tid is not None else get_active()
    if not armed or t is None:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        add_span(t, name, t0, time.time() - t0, parent=parent, cat=cat)


def step_trace(step):
    """Rotate the per-step training trace (called by
    ``flight.step_marker``): registers a trace for the NEW step and makes
    it the active ref, so ops-layer spans and flight events land under it.
    Returns the tid (None when disarmed)."""
    if not armed:
        return None
    prev = get_active()
    if prev is not None and prev.startswith(f"t{_SALT}-s"):
        finish(prev)
    tid = mint("step")
    register(tid, kind="step",
             args=None if step is None else {"step": int(step)})
    set_active(tid)
    return tid


def for_rid(rid):
    """The trace id serving request ``rid`` (None when unknown or
    evicted)."""
    with _lock:
        return _rid_index.get(str(rid))


def get(tid):
    """The raw trace record (a JSON-able copy; None when unknown)."""
    with _lock:
        rec = _traces.get(tid)
        if rec is None:
            return None
        rec = dict(rec)
        rec["spans"] = [dict(s) for s in rec["spans"]]
        return rec


def tree(tid, now=None):
    """The assembled span tree: root (request/step) -> phase children ->
    fine-grained grandchildren. A live (unfinished) trace reports its
    root duration as elapsed-so-far."""
    rec = get(tid)
    if rec is None:
        return None
    now = time.time() if now is None else now
    root = {"name": rec["kind"], "tid": rec["tid"], "t0": rec["t0"],
            "dur": rec["dur"] if rec["dur"] is not None
            else max(now - rec["t0"], 0.0),
            "done": rec["done"], "children": []}
    if rec.get("rid") is not None:
        root["rid"] = rec["rid"]
    if rec.get("args"):
        root["args"] = rec["args"]
    if rec.get("dropped"):
        root["dropped_spans"] = rec["dropped"]
    nodes = []
    for s in rec["spans"]:
        n = {k: v for k, v in s.items() if k not in ("parent", "barrier")}
        n["children"] = []
        nodes.append(n)
    for s, n in zip(rec["spans"], nodes):
        parent = s.get("parent")
        if parent is None:
            root["children"].append(n)
        else:
            nodes[parent]["children"].append(n)
    for n in nodes:
        if not n["children"]:
            n.pop("children")
    return root


def tree_for_rid(rid, now=None):
    tid = for_rid(rid)
    return None if tid is None else tree(tid, now=now)


def snapshot():
    """Every live trace as one JSON-able shard (the per-rank dump
    payload)."""
    with _lock:
        tids = list(_traces)
    return {"t": time.time(), "pid": os.getpid(),
            "traces": [r for r in (get(t) for t in tids)
                       if r is not None]}


def dump(path, rank=None):
    """Write this process's trace shard to ``path`` (JSON). Returns the
    number of traces written."""
    snap = snapshot()
    if rank is not None:
        snap["rank"] = int(rank)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(snap, f)
    os.replace(tmp, path)
    return len(snap["traces"])


def reset():
    """Drop every trace and the active ref (tests)."""
    with _lock:
        _traces.clear()
        _rid_index.clear()
        _order.clear()
    clear_active()
