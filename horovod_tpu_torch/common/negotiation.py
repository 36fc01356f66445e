"""Host-side metadata negotiation over the process group's store.

Port of the JAX package's ``common/negotiation.py``: ``exchange`` and
``exchange_sizes`` give every participant the list of every participant's
small JSON-serializable payload, ordered by process, over the ``TCPStore``
that ``hvd.init`` opens (the JAX package's rides its coordination service's
key-value store). A per-tag sequence number keeps repeated calls apart, an
epoch namespaces the keys of one store's life, and a round reads its keys
two rounds late for garbage (the lag-2 rule below). With a slice hierarchy
(``HOROVOD_CONTROL_PLANE``) a round decomposes into a slice-local gather,
one leaders-only cross-slice round and a fan-back
(``common/control_plane.py``). A one-process set short-circuits to a local
echo.

Every round counts into ``stats_snapshot()`` (rounds, gets, payload bytes,
the per-tier split) and the metrics registry (``record_negotiation``),
records a ``negotiation`` flight event, books its wall to the step
profiler's ``control_plane`` category, adds a ``negotiation`` span under the
active step trace, and is the ``negotiation.exchange`` chaos site. The
fusion runtime's boundary store traffic reports here through
:func:`record_fusion_kv`, by tier.

Where the port uses it: the order check (``HOROVOD_ORDER_CHECK``,
``ops/collective_ops.py``). The ragged allgather's and the alltoall's sizes
travel in one small int64 all-gather on the process group instead
(``collective_ops.gather_int64``): the JAX package goes through the store
there only because XLA needs the sizes before it builds a program.

SPMD contract: every participant makes the same negotiations in the same
order.
"""

import json
import threading
import time

from horovod_tpu_torch import trace as _trace
from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.profile import ledger as _profile

_counters = {}
_lock = threading.Lock()
# This process's control-plane traffic. ``gets`` is world-1 a flat round
# and the per-tier sum (gets_local + gets_cross + gets_fanback) a
# hierarchical one; the fusion_* entries are the boundary stream's, with
# its reads split by tier: root (process 0's keys: leaders and flat
# followers) and slice (a leader's re-publish: members).
_stats = {"rounds": 0, "gets": 0, "payload_bytes": 0,
          "hier_rounds": 0, "gets_local": 0, "gets_cross": 0,
          "gets_fanback": 0,
          "fusion_sets": 0, "fusion_gets": 0, "fusion_payload_bytes": 0,
          "fusion_root_gets": 0, "fusion_slice_gets": 0}

# The key namespace of one store's life. The port's store is new at every
# hvd.init (rank 0 serves it), so init resets it; bump_epoch is for a store
# that outlives an init and may hold a previous life's last keys.
_epoch = 0

# Timeout for peers to publish their payloads.
_TIMEOUT_MS = 120_000


def stats_snapshot():
    """Copy of this process's cumulative counters: ``rounds`` (exchanges
    that went through the store, one set each), ``gets`` (peer reads),
    ``payload_bytes`` (this process's serialized payloads), the
    hierarchical split (``hier_rounds``, ``gets_local``, ``gets_cross``,
    ``gets_fanback``) and the fusion boundaries' store traffic
    (``fusion_sets``, ``fusion_gets``, ``fusion_payload_bytes``,
    ``fusion_root_gets``, ``fusion_slice_gets``)."""
    with _lock:
        return dict(_stats)


def stats_reset():
    with _lock:
        for k in _stats:
            _stats[k] = 0


def record_fusion_kv(sets=0, gets=0, payload_bytes=0, tier=None):
    """A fusion boundary's store operation (``ops/fusion.py``), into the
    counters above and the registry (``fusion_kv_rpcs_total``,
    ``control_plane_rpcs_total``). ``tier`` ("root" or "slice") books the
    gets against the hierarchical boundary stream's tiers."""
    with _lock:
        _stats["fusion_sets"] += sets
        _stats["fusion_gets"] += gets
        _stats["fusion_payload_bytes"] += payload_bytes
        if tier == "root":
            _stats["fusion_root_gets"] += gets
        elif tier == "slice":
            _stats["fusion_slice_gets"] += gets
    _metrics.record_fusion_kv(sets=sets, gets=gets,
                              payload_bytes=payload_bytes)


def _client():
    """This process's connection to the process group's store: one of its
    own (a clone), so a round never waits behind another thread's store
    call."""
    from horovod_tpu_torch.common import basics
    st = basics._get_state()
    if st.store is None:
        raise RuntimeError(
            "negotiation needs the process group's store; the world was "
            "shut down or aborted")
    if st.negotiation_store is None:
        try:
            st.negotiation_store = st.store.clone()
        except Exception:  # noqa: BLE001 — a store without clone()
            st.negotiation_store = st.store
    return st.negotiation_store


def _next_seq(key):
    with _lock:
        seq = _counters.get(key, 0)
        _counters[key] = seq + 1
    return seq


def reset():
    """Forget the per-tag sequence numbers. Called by ``hvd.shutdown()``:
    after an elastic re-init, survivors and new workers start every tag at
    zero against the new store."""
    with _lock:
        _counters.clear()


def bump_epoch():
    """Move to a fresh key namespace: for a store reused across
    ``hvd.init()`` lives, which may still hold the previous life's keys."""
    global _epoch
    with _lock:
        _epoch += 1


def reset_epoch():
    """A fresh store: every participant (new elastic workers too) starts at
    epoch 0. ``hvd.init`` calls it."""
    global _epoch
    with _lock:
        _epoch = 0


def exchange(tag, payload, procs=None):
    """Exchange a small JSON-serializable ``payload`` among processes.

    ``procs``: the sorted ranks taking part (a process set's ranks);
    default every rank. Returns the payloads ordered by participant. Every
    participant calls with the same ``tag`` in the same order; others do
    not call at all.

    With a slice hierarchy (``HOROVOD_CONTROL_PLANE`` hier, or auto over
    more than one slice) the round is a slice-local gather, ONE
    leaders-only cross-slice round and a fan-back: a member makes one
    blocking get, a leader O(slice_size + num_slices). The result equals
    the flat round's. The strategy is resolved per call from the env and
    the layout, so every participant decomposes alike.
    """
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.common import control_plane as _cp
    if procs is None:
        procs = list(range(basics.size()))
    if len(procs) <= 1:
        return [payload]
    me = basics.rank()
    if me not in procs:
        raise RuntimeError(
            f"process {me} is not a participant of negotiation '{tag}' "
            f"(participants: {procs})")
    proc_tag = ",".join(str(p) for p in procs)
    seq = _next_seq((tag, proc_tag))
    # The whole round, publish and blocking reads, is the step profiler's
    # control-plane time.
    t_cp = time.perf_counter() if _profile.armed else None
    t_round = time.time()
    kv = _cp.CoordKV(_client())
    if _chaos.armed:
        # A delay here holds this rank's publish back, so every peer's
        # blocking get waits: the control-plane straggler.
        _chaos.fire("negotiation.exchange")
    base = f"hvd/neg/e{_epoch}/{tag}/{proc_tag}/{seq}"
    blob = json.dumps(payload)
    groups = _cp.exchange_groups(procs)
    if _flight.armed:
        # Rounds are SPMD-ordered like collectives: a rank wedged inside
        # one shows it as the last event before the gap.
        _flight.record_event("negotiation", name=tag, seq=seq,
                             nbytes=len(blob))
    if groups is None:
        got, counters = _cp.flat_exchange(kv, me, procs, base, blob,
                                          _TIMEOUT_MS)
        out = [payload if p == me else json.loads(got[p]) for p in procs]
    else:
        out, counters = _cp.hier_exchange(kv, me, procs, base, blob,
                                          groups, _TIMEOUT_MS)
    with _lock:
        _stats["rounds"] += 1
        _stats["gets"] += counters["gets"]
        _stats["payload_bytes"] += len(blob)
        if groups is not None:
            _stats["hier_rounds"] += 1
            _stats["gets_local"] += counters["gets_local"]
            _stats["gets_cross"] += counters["gets_cross"]
            _stats["gets_fanback"] += counters["gets_fanback"]
    _metrics.record_negotiation(
        gets=counters["attempts"], payload_bytes=len(blob),
        sets=counters["sets"],
        tier_gets={"local": counters["gets_local"],
                   "cross": counters["gets_cross"],
                   "fanback": counters["gets_fanback"]}
        if groups is not None else None)
    # Lag-2 garbage: reaching seq s means this process read every peer's
    # s-1 key (or the aggregate covering it), so every peer started s-1 and
    # finished s-2: nobody reads an s-2 key any more.
    if seq >= 2:
        _cp.gc_exchange_keys(
            kv, me, f"hvd/neg/e{_epoch}/{tag}/{proc_tag}/{seq - 2}",
            groups)
    if t_cp is not None:
        _profile.record_control_plane(time.perf_counter() - t_cp)
    _trace.add_span(_trace.get_active(), "negotiation", t_round,
                    time.time() - t_round, cat="train",
                    args={"tag": tag, "seq": seq})
    return out


def exchange_sizes(tag, local_sizes, procs=None):
    """Exchange per-process integer size vectors; returns one flat list
    ordered by rank."""
    per_proc = exchange(tag, [int(s) for s in local_sizes], procs=procs)
    flat = []
    for sizes in per_proc:
        flat.extend(int(s) for s in sizes)
    return flat
