"""Tensor fusion (bucketing) runtime for the eager path.

Port of the JAX package's ``ops/fusion.py`` (``FusedHandle``, the pending
list, ``enqueue_allreduce``/``enqueue_grouped_allreduce``, ``flush_all``,
the debounced cycle thread, ``cycle_paused``, ``fence``,
``ensure_flushed``, the flush boundaries process 0 publishes and the other
processes mirror, ``shutdown``), built the way the reference builds it on a
GPU (fusion_buffer_manager.h:30-62, operations.cc:747-853): one persistent
device fusion buffer per dtype, sized to ``HOROVOD_FUSION_THRESHOLD`` and
allocated once. Each bucket is

    pack+prescale kernel -> one allreduce of the buffer -> unpack+postscale kernel

with Average's ``1/n`` folded into the postscale. The unpack writes each
result straight into its output tensor (``p.grad`` for the optimizer).
An Adasum bucket gathers instead of reducing:

    pack+prescale -> one all-gather into (n, total) ->
    ops.adasum.reduce_gathered (the combine kernel, per tensor) ->
    unpack+postscale from row 0

so it keeps one collective per bucket and still takes each tensor's own
norms, the coefficients the JAX fused path gets by reducing each tensor of
an Adasum bucket on its own (``horovod_tpu/ops/fusion.py:226-233``).

The wire (``HOROVOD_WIRE_DTYPE``, ``ops/wire.py``). A flush takes one
snapshot of the wire: the registry's entry for the set (``set_wire_dtype``
pins it), else the runtime's knob; process 0 publishes it with the
boundary and the others adopt it, as JAX's boundaries carry theirs. On a
quantized wire (``int8``/``fp8``) a flat Sum/Average bucket of at least
n×BLOCK elements with no joined rank (JAX's ``_bucket_quant``) rides the
block-scaled exchange instead of the allreduce:

    pack into an fp32 work buffer -> wire.block_scaled_allreduce (the
    prescale, the bucket's residual, / n and the postscale in fp32) ->
    unpack

with error feedback on (``HOROVOD_WIRE_ERROR_FEEDBACK``, the default) the
new residual is kept per bucket layout and membership epoch; a bucket that
closes exact drops its residual. A bf16/fp16 bucket keeps its dtype (the
pack kernel widens it into the work buffer). On a 16-bit cast wire
(``bfloat16``/``float16``) floating buckets are keyed at the wire dtype:
the pack kernel rounds each tensor to the wire dtype and scales it there,
the allreduce sums in it, Average multiplies by 1/n in it (XLA's division
by a constant), and the unpack kernel
scales in it and widens back, JAX's rounding points. Every other bucket
(Adasum, Min/Max/Product, joined ranks, small buckets) stays exact. A
one-shot ``Compression.int8`` request on a runtime whose own wire is not
quantized makes that call's tensors a bucket of their own, closed at once
(trigger ``own``) on that wire, as JAX dispatches such a call by itself;
its residual is kept per call signature (names, shapes and dtypes; JAX's
eager plan key leaves the names out), and an unnamed call keeps none.

Strategies (``parallel/strategies.py``; JAX's fused strategy knob). A
flush also takes one snapshot of the allreduce strategy: ``flat`` (one
allreduce of the bucket), ``hierarchical`` (a full local allreduce, then a
cross one), ``torus`` (local reduce-scatter, cross allreduce of the shard,
local all-gather) or ``torus_qcross`` (torus with the cross leg on the
per-tier wire, ``wire.cross_wire_for``: int8 or fp8 through the
block-scaled exchange, with a residual of the shard's size kept per bucket
layout as the flat wire's is). The knobs choose it
(``HOROVOD_HIERARCHICAL_DISPATCH`` > ``HOROVOD_TORUS_ALLREDUCE`` >
``HOROVOD_HIERARCHICAL_ALLREDUCE``), unless ``hvd.set_dispatch_strategy``
pinned the global set: ``hier`` is torus and ``hier_qcross`` torus_qcross,
as JAX's eager tier, which on a one-slice layout stays flat. Process 0
publishes the snapshot and its cross wire with the boundary, and both ride
the bucket signature. The decomposition is the slice layout, or with one
slice the node layout (``common/topology.py``); torus buckets are packed
into a buffer padded with zeros to a multiple of the local size. JAX's
refusals keep a bucket flat: an op other than Sum and Average, a bucket of
its own (a process set smaller than the world, join armed, a one-shot
``Compression.int8`` request, which rides the flat quantized exchange), and
``torus_qcross`` on a one-slice layout. A torus or torus_qcross bucket over
more than one slice meters its bytes by tier (``flush_stats()['tiers']``,
``wire.hierarchical_wire_bytes``), as the JAX runtime does.

Flushes. Every enqueued tensor gets a sequence number and joins one pending
list, across all keys, in enqueue order. A flush takes a prefix of that
list: all of it when the pending bytes reach the threshold, on a cycle tick,
or on ``poll``/``synchronize``/``flush_all``/``fence``. The cycle thread is
debounced as JAX's ``_cycle_loop``: it flushes only after a whole
``HOROVOD_CYCLE_TIME`` with no enqueue, so a burst of gradient hooks is not
split at arbitrary times (``HOROVOD_CYCLE_TIME=0``: no thread).

Buckets. A flush groups its prefix as the JAX runtime's scheduler does
(``horovod_tpu/native/src/scheduler.cc`` ``hvd_sched_flush``): entries of
one key (process set, op, prescale, postscale, dtype) share a bucket in
order of first appearance, and a bucket closes when the next entry would
take it past the threshold; a group (a grouped call's tensors of one dtype)
is one bucket whatever the threshold. A bucket larger than the threshold
takes a buffer of its own. (JAX registers a group only when all its tensors
share a key; the port splits a group by dtype first, and each part is a
group.)

Boundaries. With more than one process only process 0's triggers flush
(JAX's ``_publish_boundary``; the reference's coordinator, controller.cc:74):
a timer local to each rank would split the same burst differently on
different ranks, and NCCL turns mismatched collectives into a hang. Each of
process 0's flushes publishes ``(boundary seq, last sequence number
covered, trigger)`` and the policy it closed under (wire, strategy, cross
wire, alltoall strategy and alltoall cross wire, which the followers adopt
under their own pins) through the ``TCPStore`` that ``hvd.init`` opened, from
a publisher thread off the runtime lock; the keys carry the membership
version the runtime was built under (its epoch: 0 outside elastic runs)
and are deleted ``_BOUNDARY_GC_LAG`` flushes later. Every other process
flushes exactly the published prefixes, in order: its follower thread waits
on the store for the next key with a bounded wait (not a hot poll), defers
a boundary ahead of its own enqueues until they catch up, and applies it;
``poll`` applies what is already published and ``synchronize`` waits until
its entry is covered, raising ``HorovodInternalError`` after
``BOUNDARY_TIMEOUT_S``. SPMD makes every process enqueue the same sequence,
so a prefix by sequence number is the same tensors everywhere. Tensors of a
process set smaller than the world, and every tensor while join is armed
(``HOROVOD_JOIN_MODE=1``), close at once as a bucket of their own, as the
JAX package dispatches them outside the runtime
(``horovod_tpu/ops/collective_ops.py:2493-2500``): a rank outside the set,
or process 0 inside ``join()``, enqueues none of them.

The hierarchical boundary stream (``HOROVOD_CONTROL_PLANE=hier``, or auto
on a layout of more than one slice; JAX's ``_fetch_boundary``): process 0
still publishes each boundary once; each slice's leader (its lowest process
other than 0, ``control_plane.boundary_role``) reads it and re-publishes it
under the slice's key, and the slice's other members read only that key,
so the store process 0 serves answers a slice's leader, not its every
process. A member holds a lease on its leader (``HOROVOD_CONTROL_LEASE_MS``,
2 s): when the lease expires while process 0's key holds a boundary the
leader has not mirrored, the member takes the re-publish over
(``fusion_boundary_outcomes_total{outcome="takeover"}``). Every boundary
set and get reports through ``negotiation.record_fusion_kv``, by tier (root,
slice). On one slice every follower reads process 0's keys, as before.

Each bucket checks that every rank formed it: the first time a bucket
signature (names, sizes, dtype, op, scales) is seen, ranks exchange its hash
once and cache it, like the reference's response cache, and a mismatch
raises ``TensorShapeMismatchError``. While join is armed every bucket opens
with the join round instead (``collective_ops.join_round``), which carries
that hash: a joined rank mirrors the bucket's collective, Average divides by
the active ranks and an Adasum bucket drops the joined ranks' rows before
the tree. A bucket's collectives run on whichever thread closes it, under
the runtime's one lock, so each rank's communicator sees buckets in flush
order; eager collectives ``fence`` first.

Failures. A bucket's collectives run through ``collective_ops.launch``, so
a backend failure fails its handles with ``HorovodInternalError``. A follower
that loses the store process 0 serves (process 0 died) fails its pending
handles at once rather than after ``BOUNDARY_TIMEOUT_S``. ``abort`` is the
elastic reset's shutdown: it fails every pending handle, stops the threads
and touches no store, since peers may be dead; the next ``hvd.init`` builds
a new runtime over a new store.

The stall inspector (``ops/stall_inspector.py``, off with
``HOROVOD_STALL_CHECK_DISABLE``) records each enqueue and each flush, and
each flush is the ``fusion.flush`` chaos site, under the runtime lock (a
delay there holds every enqueue behind it).

Observability. Every bucket runs inside ``collective_ops._dispatch_op``
(metrics, flight dispatch/complete, timeline span, step profiler,
profiler annotation); each flush records ``fusion_flush`` (metrics,
flight, the step profiler's ``fusion`` category: the flush's wall minus
its buckets' dispatches) and the first enqueue into an empty pending list
a flight ``fusion_enqueue`` (one event a flush, not one a tensor: the ring
keeps its room for the dispatches).
On the GPU, with the step profiler armed, each bucket also records two
CUDA timing events on the fusion stream, which the ledger reads at a
later step boundary once done (never a wait): the bucket's device time.

The cross-leg overlap (``HOROVOD_CROSS_OVERLAP``) has no scheduler here.
JAX leaves a hierarchical bucket's cross leg in flight past its flush and
steers where it is awaited (``_await_cross``, ``_steer_overlap``). On the
GPU every bucket already runs on the side stream and only the stream that
consumes a handle waits, on that bucket's event (``FusedHandle.synchronize``),
so the overlap is there with the knob on or off; on the CPU a bucket is
done when its flush returns. The knob is parsed and changes nothing; the
runtime keeps JAX's ``_overlap``, ``_overlap_mode`` and ``_overlap_pinned``
for the autopilot's overlap lever, whose pin changes nothing either.

Autotune (``HOROVOD_AUTOTUNE``, ``autotune/``). Process 0's runtime holds a
``ParameterManager`` (built by :func:`get_runtime` unless the autopilot is
armed, which tunes the same knobs itself): each flush reports its bytes,
after an ``invalidate_window()`` when a bucket of it fell back to flat, and
a closed sample window returns the threshold, cycle time, strategy and
wire the runtime takes from its next flush. Process 0's threshold rides
every boundary: a follower assembles a published prefix with it, so each
process forms the same buckets whatever the tuner moved.

Streams and threads. On the GPU every bucket runs on one side stream, after
the streams that produced its tensors; buckets therefore run in order and
share one buffer, while the backward pass goes on beside them. A handle's
``synchronize`` makes the caller's stream wait for its bucket. The cycle,
publisher and follower threads enter ``torch.cuda.device(device)`` first:
the current device is per thread. On the CPU (gloo) a bucket is done when
it closes.
"""

import collections
import contextlib
import datetime
import queue
import threading
import time
import types

import torch
import torch.distributed as dist

from horovod_tpu_torch import trace as _trace
from horovod_tpu_torch.chaos import injector as _chaos
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common import negotiation
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 TensorShapeMismatchError)
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.ops.adasum import reduce_gathered
from horovod_tpu_torch.ops.collective_ops import (ADASUM, ALLREDUCE,
                                                  DIST_OPS, ReduceOp,
                                                  _dispatch_op, active_rows,
                                                  all_gather_flat,
                                                  join_armed, join_round,
                                                  launch, rank_digests)
from horovod_tpu_torch.profile import ledger as _profile
from horovod_tpu_torch.ops.kernels.scale_buffers import pack_scale, unpack_scale
from horovod_tpu_torch.parallel import strategies as _strategies

_MAX_SIGNATURES = 4096   # runaway-signature guard for the verified cache
_RECENT = 4096           # closed buckets kept for recent_buckets()
_runtime_lock = threading.Lock()

# What closed a bucket: the pending bytes reached the threshold, a cycle
# tick, a poll/synchronize/flush_all/fence, or its own call (a set smaller
# than the world, or join armed).
TRIGGERS = ("threshold", "cycle", "sync", "own")

STRATEGIES = ("flat", "hierarchical", "torus", "torus_qcross")
# A pinned dispatch strategy (the JAX eager tier's names) as a fused one.
_PINNED = {"flat": "flat", "hier": "torus", "hier_qcross": "torus_qcross"}
# A fused strategy as the registry's (JAX's _EAGER_STRATEGY): the legacy
# "hierarchical" has no eager counterpart.
_EAGER_STRATEGY = {"flat": "flat", "torus": "hier", "hierarchical": "flat",
                   "torus_qcross": "hier_qcross"}


def config_strategy(config):
    """The strategy the knobs choose (JAX's ``FusionRuntime.strategy``)."""
    return ("torus_qcross" if config.hierarchical_dispatch
            else "torus" if config.torus_allreduce
            else "hierarchical" if config.hierarchical_allreduce
            else "flat")


class FusedHandle:
    """Handle for a tensor pending in the fusion queue. Resolves after the
    bucket it lands in is dispatched (reference analog: HandleManager int
    handle + per-entry callback, torch/handle_manager.h)."""

    __slots__ = ("_runtime", "_output", "_event", "_dispatched", "_error",
                 "_seq", "name")

    def __init__(self, runtime, output, name, seq):
        self._runtime = runtime
        self._output = output
        self._event = None        # the bucket's completion event (GPU)
        self._dispatched = False
        self._error = None
        self._seq = seq
        self.name = name

    def _resolve(self, block):
        # Asking about a pending tensor closes its bucket, as a cycle tick;
        # a follower waits for (or, polling, applies) process 0's boundary.
        if not self._dispatched and self._error is None:
            self._runtime.ensure_flushed(self._seq, block=block)
        if self._error is not None:
            raise self._error

    def poll(self):
        self._resolve(block=False)
        if not self._dispatched:
            return False
        return self._event is None or self._event.query()

    def synchronize(self):
        self._resolve(block=True)
        if self._event is not None:
            torch.cuda.current_stream(self._runtime.device).wait_event(
                self._event)
        return self._output

    wait = synchronize


class _Entry:
    __slots__ = ("seq", "key", "tensor", "output", "name", "handle",
                 "stream", "group", "nbytes")

    def __init__(self, seq, key, tensor, output, name, handle, stream,
                 group):
        self.seq = seq
        self.key = key
        self.tensor = tensor
        self.output = output
        self.name = name
        self.handle = handle
        self.stream = stream
        self.group = group
        self.nbytes = tensor.numel() * tensor.element_size()


class FusionRuntime:
    # A follower's wait for the boundary that covers its entry
    # (JAX: ensure_flushed's 120 s).
    BOUNDARY_TIMEOUT_S = 120.0
    # Boundary keys older than this many flushes are deleted (JAX's lag: a
    # follower that far behind has long tripped BOUNDARY_TIMEOUT_S).
    _BOUNDARY_GC_LAG = 4096
    # A follower's bounded wait on the store for the next boundary key.
    _FOLLOWER_WAIT_S = 0.3

    def __init__(self, threshold, device, cycle_time_ms=0.0, rank=0,
                 size=1, store=None, epoch=0, wire_dtype="",
                 wire_error_feedback=True, strategy="flat", wire_dtype_dcn="",
                 topology=None, generation=0, stall_check=None,
                 control_lease_ms=2000.0, cross_overlap=True):
        self.threshold = int(threshold)
        self.device = device
        # The wire knob (process 0's; a follower holds the last one process
        # 0 published) and error feedback for the quantized wire.
        self.wire_dtype = _wire.resolve_wire_dtype(wire_dtype)
        self._wire_ef = bool(wire_error_feedback)
        # The strategy knob (a follower holds what process 0 last
        # published) and the cross leg's wire knob (read through
        # wire.cross_wire_for, which takes this runtime for the config).
        if strategy not in STRATEGIES:
            raise ValueError(f"fusion strategy {strategy!r}: expected one of "
                             f"{STRATEGIES}")
        self.strategy = strategy
        self.wire_dtype_dcn = _wire.resolve_wire_dtype(wire_dtype_dcn)
        # The knobs as configured, which the cross wire falls back to
        # whatever a tuner does to wire_dtype, and the cross wire of the
        # last flush (JAX's ``cross_wire``; a follower's: process 0's).
        self._knobs = types.SimpleNamespace(
            wire_dtype=self.wire_dtype, wire_dtype_dcn=self.wire_dtype_dcn)
        self.cross_wire = _wire.cross_wire_for("global", self._knobs)
        self._topology = topology
        self._lock = threading.RLock()
        self._flushed = threading.Condition(self._lock)
        self._pending = []       # _Entry, in sequence order, across keys
        self._pending_bytes = 0
        self._next_seq = 0
        self._flushed_seq = -1
        self._next_group = 0
        self._last_enqueue = 0.0
        self._buffers = {}       # dtype -> persistent fusion buffer
        self._verified = {}      # bucket signature -> hash all ranks agreed on
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None
        self._rank = rank
        self._world = size
        self._multi = size > 1 and store is not None
        self._coord = rank == 0
        self._store = store
        # The membership version this runtime was built under (elastic
        # launches; 0 otherwise) and the runtime's generation in this world
        # (reset_runtime): its keys never meet another's.
        self._epoch = epoch
        self._ns = f"hvd/fusion/e{epoch}" + (f"/g{generation}"
                                             if generation else "")
        self._client = None      # this runtime's own connection to the store
        self._cycle_s = max(float(cycle_time_ms), 0.0) / 1000.0
        self._cycle_pause = False
        # The flush-window autotuner (process 0; get_runtime builds it) and
        # whether a bucket of the current flush fell back to flat.
        self._parameter_manager = None
        self._downgraded = False
        # JAX's cross-leg overlap point (the autopilot's overlap lever pins
        # it); nothing here reads it (see the module docstring).
        self._overlap = bool(cross_overlap)
        self._overlap_mode = "step"
        self._overlap_pinned = False
        self._stop = threading.Event()
        # An enqueue, for the thread waiting on one: the cycle thread while
        # nothing is pending, a follower's thread holding a boundary ahead.
        self._wake = threading.Event()
        self._threads = []
        # Publisher: the next boundary's seq; follower: the next to apply,
        # and the last fetched boundary still ahead of this process's
        # enqueues, kept so it is fetched from the store once.
        self._boundary_seq = 0
        self._deferred = None
        self._publish_queue = None
        self._fetch_lock = threading.Lock()
        self._stats = {"buckets": 0, "closed_by": dict.fromkeys(TRIGGERS, 0),
                       "new_signatures": 0, "quantized": 0,
                       "wire_bytes": {},
                       "strategies": dict.fromkeys(STRATEGIES, 0),
                       "tiers": {"local": {}, "cross": {}}}
        self._recent = collections.deque(maxlen=_RECENT)
        # The error every handle fails with once the runtime is aborted.
        self._failed = None
        # When the pending list last went from empty to non-empty: the
        # step profiler's fusion_defer_s.
        self._first_enqueue = 0.0
        # The flight signature of each bucket layout, computed once.
        self._flight_sigs = {}
        # The hierarchical boundary stream: this process's slice, its role
        # (root: process 0, or any follower on one slice; leader; member)
        # and how many members a leader re-publishes for; a member's lease
        # on its leader.
        self._cp_slice, self._cp_role, self._cp_members = 0, "root", 0
        self._cp_lease_s = max(float(control_lease_ms), 100.0) / 1000.0
        self._lease_wait0 = None
        if self._multi:
            from horovod_tpu_torch.common import control_plane as _cp
            groups = _cp.exchange_groups(list(range(size)))
            self._cp_slice, self._cp_role, self._cp_members = \
                _cp.boundary_role(rank, groups)
        # (warning seconds, shutdown seconds), or None: no inspector.
        self._stall_inspector = None
        if stall_check is not None:
            from horovod_tpu_torch.ops.stall_inspector import StallInspector
            self._stall_inspector = StallInspector(
                warning_secs=stall_check[0], shutdown_secs=stall_check[1])

    # ---- threads ----------------------------------------------------------

    def start(self):
        """Start the cycle thread (process 0, or the only process) and, with
        more than one process, the publisher (process 0) or the follower."""
        if self._multi:
            try:
                self._client = self._store.clone()
            except Exception:  # noqa: BLE001 — a store without clone()
                self._client = self._store
        if self._multi and not self._coord:
            self._spawn(self._follower_loop, "hvd-fusion-follower")
            return
        if self._multi:
            self._publish_queue = queue.SimpleQueue()
            self._spawn(self._publisher_loop, "hvd-fusion-publish")
        if self._cycle_s > 0:
            self._spawn(self._cycle_loop, "hvd-fusion-cycle")

    def _spawn(self, target, name):
        t = threading.Thread(target=self._on_device, args=(target,),
                             daemon=True, name=name)
        t.start()
        self._threads.append(t)

    def _on_device(self, target):
        # The current CUDA device is per thread: without this, a thread of
        # the process on cuda:1 would launch its buckets on cuda:0.
        ctx = torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()
        with ctx:
            target()

    def threads(self):
        return list(self._threads)

    def _cycle_loop(self):
        # Debounced: a flush only after a whole cycle with no enqueue (the
        # unlocked peeks are re-checked under the lock). Each wake-up takes
        # the interpreter lock from the threads running the step, so the
        # thread sleeps until an enqueue while nothing is pending, and
        # otherwise until a cycle after the last enqueue, rather than
        # waking every cycle as JAX's loop does.
        while not self._stop.is_set():
            s = self._cycle_s
            if s <= 0:
                return
            self._wake.clear()
            if not self._pending:
                self._wake.wait()
                continue
            left = self._last_enqueue + s - time.perf_counter()
            if left > 0 or self._cycle_pause:
                self._stop.wait(left if left > 0 else s)
                continue
            try:
                with self._lock:
                    if self._pending and not self._cycle_pause and \
                            time.perf_counter() - self._last_enqueue >= s:
                        self._flush_locked("cycle")
                        tl = basics.timeline()
                        if tl is not None:
                            tl.mark_cycle()
            except Exception as e:  # noqa: BLE001 — the handles carry it
                hvd_logging.debug("fusion cycle flush failed: %s", e)

    def set_cycle_time_ms(self, ms):
        """Change the cycle (``HOROVOD_CYCLE_TIME``) of a running runtime:
        0 stops the cycle thread at its next tick, a positive value starts
        it if it is not running. Process 0's setting is the one that acts,
        as for the knob."""
        with self._lock:
            self._cycle_s = max(float(ms), 0.0) / 1000.0
            self._wake.set()
            if self._cycle_s <= 0 or (self._multi and not self._coord):
                return
            self._threads = [t for t in self._threads if t.is_alive()]
            if not any(t.name == "hvd-fusion-cycle" for t in self._threads):
                self._spawn(self._cycle_loop, "hvd-fusion-cycle")

    def cycle_paused(self):
        """Context manager: suspend time-triggered flushes (threshold and
        explicit flushes still apply), so a bulk submitter gets exactly the
        buckets of its enqueues."""

        @contextlib.contextmanager
        def _ctx():
            self._cycle_pause = True
            try:
                yield
            finally:
                self._cycle_pause = False

        return _ctx()

    # ---- boundaries -------------------------------------------------------

    def _boundary_key(self, seq):
        return f"{self._ns}/b{seq}"

    def _slice_boundary_key(self, seq):
        return f"{self._ns}/s{self._cp_slice}/b{seq}"

    def _publisher_loop(self):
        """Process 0: the store RPCs of each boundary, off the runtime lock
        and in order (JAX's ``_publisher_loop``)."""
        while True:
            item = self._publish_queue.get()
            if item is None:
                return
            (seq, last, why, wire, strategy, cross, a2a, a2a_cross,
             threshold) = item
            try:
                payload = (f"{last} {why} {wire or '-'} {strategy} "
                           f"{cross or '-'} {a2a or '-'} {a2a_cross or '-'} "
                           f"{threshold}")
                self._client.set(self._boundary_key(seq), payload)
                negotiation.record_fusion_kv(sets=1,
                                             payload_bytes=len(payload))
                if seq >= self._BOUNDARY_GC_LAG:
                    self._client.delete_key(
                        self._boundary_key(seq - self._BOUNDARY_GC_LAG))
            except Exception as e:  # noqa: BLE001 — keep publishing
                hvd_logging.warning("fusion boundary %d not published: %s",
                                    seq, e)

    def _fetch(self, seq, wait_s):
        """Boundary ``seq`` from the store, waiting at most ``wait_s`` (0:
        only if already published); None if there is none yet."""
        got = self._fetch_lock.acquire(timeout=wait_s) if wait_s > 0 \
            else self._fetch_lock.acquire(blocking=False)
        if not got:
            return None
        try:
            raw = self._fetch_raw(seq, wait_s)
            if raw is None:
                return None
            last, why, *rest = raw.decode().split()
            # Process 0's threshold (absent from a payload without it: the
            # follower keeps its own).
            threshold = int(rest.pop()) if len(rest) > 5 else None
            wire, strategy, cross, a2a, a2a_cross = (
                "" if v == "-" else v for v in rest)
            return (int(last), why, wire, strategy, cross, a2a, a2a_cross,
                    threshold)
        except dist.DistNetworkError as e:
            # Process 0 serves the store: no boundary will ever come.
            err = HorovodInternalError(
                f"rank {self._rank} lost the store process 0 serves, so no "
                f"fusion boundary can arrive: {e}")
            err.__cause__ = e
            self.abort(err)
            return None
        finally:
            self._fetch_lock.release()

    def _get_key(self, key, wait_s):
        """``key``'s value, waiting at most ``wait_s`` for it (0: only if
        already set); None if it is not set by then."""
        if wait_s <= 0:
            if not self._client.check([key]):
                return None
        else:
            t0 = time.monotonic()
            try:
                self._client.wait([key], datetime.timedelta(seconds=wait_s))
            except dist.DistNetworkError:
                raise
            except Exception:  # noqa: BLE001 — not set within the wait
                left = wait_s - (time.monotonic() - t0)
                if left > 0:   # the store failed fast: no hot loop
                    time.sleep(min(left, 0.05))
                return None
        return self._client.get(key)

    def _fetch_raw(self, seq, wait_s):
        """The raw boundary ``seq`` by this process's role (JAX's
        ``_fetch_boundary``). A leader, or any follower on one slice, reads
        process 0's key and, a leader, re-publishes it under its slice's
        key. A member reads its slice's key under a lease on its leader:
        past the lease, a short probe of process 0's key; if that holds
        the boundary and the slice key still does not after a short grace,
        the member takes the re-publish over. Otherwise the lease renews."""
        if self._cp_role != "member":
            raw = self._get_key(self._boundary_key(seq), wait_s)
            if raw is not None:
                negotiation.record_fusion_kv(gets=1, payload_bytes=len(raw),
                                             tier="root")
                self._republish(seq, raw)
            return raw
        raw = self._get_key(self._slice_boundary_key(seq), wait_s)
        if raw is not None:
            self._lease_wait0 = None
            negotiation.record_fusion_kv(gets=1, payload_bytes=len(raw),
                                         tier="slice")
            return raw
        now = time.monotonic()
        if self._lease_wait0 is None:
            self._lease_wait0 = now
            return None
        if now - self._lease_wait0 < self._cp_lease_s:
            return None
        # The lease expired: does process 0's key hold a boundary the
        # leader failed to mirror? Nothing there: nothing to mirror, and
        # the lease renews.
        if not self._client.check([self._boundary_key(seq)]):
            self._lease_wait0 = now
            return None
        raw = self._get_key(self._slice_boundary_key(seq), 0.05)
        if raw is not None:      # the leader mirrored it during the grace
            self._lease_wait0 = None
            negotiation.record_fusion_kv(gets=1, payload_bytes=len(raw),
                                         tier="slice")
            return raw
        raw = self._client.get(self._boundary_key(seq))
        negotiation.record_fusion_kv(gets=1, payload_bytes=len(raw),
                                     tier="root")
        # Takeover: this member re-publishes for its slice from now on
        # (members promoting at once is harmless: the same payload
        # overwrites the same key).
        self._cp_role = "leader"
        self._cp_members = max(self._cp_members - 1, 1)
        self._lease_wait0 = None
        _metrics.record_boundary("takeover")
        if _flight.armed:
            _flight.record_event("fusion_flush", seq=seq,
                                 name="boundary_lease_takeover",
                                 what=f"slice{self._cp_slice}")
        hvd_logging.warning(
            "fusion boundary leader for slice %d stale past %.1fs: taking "
            "over the slice re-publish at seq %d", self._cp_slice,
            self._cp_lease_s, seq)
        self._republish(seq, raw)
        return raw

    def _republish(self, seq, raw):
        """A slice leader: mirror process 0's boundary under the slice's key
        so its members never read process 0's. Fail-soft: a failed
        re-publish costs the members one lease."""
        if self._cp_role != "leader" or self._cp_members <= 0:
            return
        try:
            self._client.set(self._slice_boundary_key(seq), raw)
            negotiation.record_fusion_kv(sets=1, payload_bytes=len(raw))
            if seq >= self._BOUNDARY_GC_LAG:
                self._client.delete_key(
                    self._slice_boundary_key(seq - self._BOUNDARY_GC_LAG))
        except dist.DistNetworkError:
            raise
        except Exception as e:  # noqa: BLE001 — the lease covers it
            hvd_logging.debug("fusion boundary %d not re-published: %s",
                              seq, e)

    def _apply_ready_boundaries(self, wait_s):
        """Follower: apply published boundaries in order, waiting at most
        ``wait_s`` for the first. Returns True when the next boundary is
        ahead of this process's enqueues (deferred until they catch up)."""
        while True:
            with self._lock:
                seq, deferred = self._boundary_seq, self._deferred
            if deferred is not None and deferred[0] == seq:
                payload = deferred[1]
            else:
                payload = self._fetch(seq, wait_s)
                if payload is None:
                    return False
            (last, why, wire, strategy, cross, a2a, a2a_cross,
             threshold) = payload
            with self._lock:
                if self._boundary_seq != seq:   # another thread applied it
                    wait_s = 0
                    continue
                if self._next_seq <= last:
                    if self._deferred is None or self._deferred[0] != seq:
                        _metrics.record_boundary("deferred")
                    self._deferred = (seq, payload)
                    return True
                self._deferred = None
                self._boundary_seq += 1
                _metrics.record_boundary("applied")
                # Process 0's wire, strategy and cross wire for this prefix,
                # and its alltoall strategy and cross wire (JAX's boundary
                # "w", "s", "cw", "as" and "acw").
                self.wire_dtype = wire
                if wire:
                    _wire.runtime_sync_wire_dtype(wire, "global")
                self.strategy, self.cross_wire = strategy, cross
                _sync_policy(strategy, cross, a2a, a2a_cross)
                if threshold is not None:
                    # Process 0's buckets: the same prefix is cut at the
                    # same threshold on every process.
                    self.threshold = threshold
                self._flush_locked(why, up_to=last,
                                   policy=(wire, strategy, cross))
            wait_s = 0

    def _follower_loop(self):
        # One bounded wait on the store per turn: the store answers when
        # the key is set, so an idle follower costs a few requests a second
        # and a published boundary is applied at once.
        while not self._stop.is_set():
            self._wake.clear()
            try:
                if self._apply_ready_boundaries(self._FOLLOWER_WAIT_S):
                    self._wake.wait(0.05)
            except Exception as e:  # noqa: BLE001 — the handles carry it
                hvd_logging.debug("fusion boundary flush failed: %s", e)

    def ensure_flushed(self, seq=None, block=True):
        """Make sure the bucket holding ``seq`` (default: the last enqueued)
        has been dispatched. Process 0 or a single process: flush
        everything. A follower waits for the covering boundary, which its
        follower thread applies; ``block=False`` (``poll``) only applies
        what is already published."""
        if not self._multi or self._coord:
            self.flush_all()
            return
        if not block:
            try:
                self._apply_ready_boundaries(0)
            except Exception:  # noqa: BLE001 — the handles carry it
                pass
            return
        deadline = time.monotonic() + self.BOUNDARY_TIMEOUT_S
        t_wait = time.perf_counter()
        try:
            self._wait_covered(seq, deadline)
        finally:
            if _profile.armed:
                # A host wait for rank 0's flush, i.e. for the peers: the
                # step profiler's `collective`.
                _profile.record_collective_wait(
                    time.perf_counter() - t_wait)

    def _wait_covered(self, seq, deadline):
        with self._flushed:
            if seq is None:
                seq = self._next_seq - 1
            while seq > self._flushed_seq:
                if self._failed is not None:
                    raise self._failed
                left = deadline - time.monotonic()
                if left <= 0:
                    raise HorovodInternalError(
                        f"no fusion flush boundary covering sequence number "
                        f"{seq} arrived from process 0 within "
                        f"{self.BOUNDARY_TIMEOUT_S:.0f} s: every process "
                        "must enqueue the same async allreduces in the same "
                        "order (the SPMD contract); did process 0 enqueue "
                        "them?")
                self._flushed.wait(min(left, 0.2))

    def fence(self):
        """Order an eager collective after every bucket in flight, on every
        process (JAX's ``FusionRuntime.fence``): process 0 flushes (and
        publishes), a follower waits until its pending list is empty."""
        self.ensure_flushed()

    # ---- enqueue and flush ------------------------------------------------

    def enqueue(self, tensors, outputs, op, prescale, postscale, process_set,
                names, wire=None):
        """Queue one unit — a tensor, or a group that shares a bucket — of
        one dtype; returns a handle per tensor. ``wire``: a one-shot
        quantized wire for these tensors alone (``Compression.int8``), which
        makes them a bucket of their own, closed at once."""
        key = (process_set, ReduceOp(op), prescale, postscale,
               tensors[0].dtype)
        stream = None if self._stream is None \
            else torch.cuda.current_stream(self.device)
        if self._failed is not None:
            raise self._failed
        own = join_armed() or process_set.size() < self._world \
            or wire is not None
        if own:
            self.fence()
        with self._lock:
            if own:
                # Outside the sequence: the ranks outside the set (or in
                # join()) enqueue none of it.
                entries = [_Entry(None, key, t, out, name,
                                  FusedHandle(self, out, name, None), stream,
                                  None)
                           for t, out, name in zip(tensors, outputs, names)]
                eager = wire is not None
                if not eager:
                    wire = self._wire_snapshot(process_set)
                # A bucket of its own is flat (JAX dispatches it outside the
                # runtime, where the tiers refuse sub-sets, join and a
                # one-shot wire request).
                self._close(_wire_key(key, wire), entries, "own", wire,
                            eager=eager)
                return [e.handle for e in entries]
            # A bucket of its own closes at once, outside the inspector's
            # view (JAX dispatches it outside the runtime).
            if self._stall_inspector is not None:
                self._stall_inspector.record_enqueue(names[0] or "tensor")
            group = None
            if len(tensors) > 1:
                group = self._next_group
                self._next_group += 1
            entries = []
            for t, out, name in zip(tensors, outputs, names):
                seq = self._next_seq
                self._next_seq += 1
                entries.append(_Entry(seq, key, t, out, name,
                                      FusedHandle(self, out, name, seq),
                                      stream, group))
            follower = self._multi and not self._coord
            idle = not self._pending
            if idle:
                self._first_enqueue = time.perf_counter()
                if _flight.armed:
                    # One event per pending window, at its first unit (its
                    # first seq and bytes); the fusion_flush that closes
                    # the window carries its count and bytes. A window
                    # opened and never flushed shows in a dump as an
                    # enqueue with no flush covering its seq.
                    _flight.record_event(
                        "fusion_enqueue", seq=entries[0].seq, name=names[0],
                        nbytes=sum(e.nbytes for e in entries),
                        what=f"group{len(entries)}" if group is not None
                        else None)
            self._pending.extend(entries)
            self._pending_bytes += sum(e.nbytes for e in entries)
            self._last_enqueue = time.perf_counter()
            if follower or idle:    # after the append: no lost wake-up
                self._wake.set()
            # Followers never flush on their own triggers: process 0's
            # threshold fires at the same enqueue (same byte stream).
            if not follower and self._pending_bytes >= self.threshold:
                self._flush_locked("threshold")
        return [e.handle for e in entries]

    def flush_all(self):
        if self._multi and not self._coord:
            self.fence()
            return
        # A thread may hold the lock inside a bucket's collective that the
        # abort cannot end (a gloo peer alive but stuck): give up then.
        while not self._lock.acquire(timeout=0.2):
            if self._failed is not None:
                raise self._failed
        try:
            if self._failed is not None:
                raise self._failed
            self._flush_locked("sync")
        finally:
            self._lock.release()

    def _wire_snapshot(self, ps=None):
        """The wire of the buckets about to close: the registry's entry for
        the set (a user pin, or the knob synced into it), else the knob."""
        if self.wire_dtype and _ps_label(ps) == "global":
            _wire.runtime_sync_wire_dtype(self.wire_dtype, "global")
        return self.wire_for(ps)

    def wire_for(self, ps=None):
        """The wire this runtime's next buckets of ``ps`` would ride."""
        return _wire.wire_dtype_for(_ps_label(ps), self.wire_dtype)

    def _strategy_snapshot(self):
        """The strategy and cross wire of the buckets about to close: a
        user's pinned dispatch strategy, else the knob; the cross wire
        through ``wire.cross_wire_for`` (its ``dcn`` entry, else
        ``wire_dtype_dcn``, else the configured wire knob). Synced into the
        registries as JAX's ``_sync_eager_policy`` does."""
        pin = _wire.pinned_dispatch_strategy("global")
        strategy = self.strategy if pin is None else _PINNED[pin]
        if pin in ("hier", "hier_qcross") and self._slices() <= 1:
            strategy = "flat"     # JAX's eager tier: no slices, no tier
        cross = self.cross_wire = _wire.cross_wire_for("global", self._knobs)
        _sync_policy(strategy, cross)
        return strategy, cross

    def _slices(self):
        return 1 if self._topology is None else self._topology.num_slices

    def _flush_locked(self, why, up_to=None, policy=None):
        """Close the pending prefix (all of it, or a follower's boundary:
        the entries with seq <= ``up_to``) as buckets under ``policy``, a
        (wire, strategy, cross wire) triple (a follower's: process 0's;
        else this runtime's snapshot)."""
        if up_to is None:
            prefix, self._pending = self._pending, []
        else:
            n = 0
            while n < len(self._pending) and self._pending[n].seq <= up_to:
                n += 1
            prefix, self._pending = self._pending[:n], self._pending[n:]
        if not prefix:
            return
        flushed_bytes = sum(e.nbytes for e in prefix)
        self._pending_bytes -= flushed_bytes
        # This flush's threshold: a tuner update recorded below acts from
        # the next flush.
        threshold = self.threshold
        self._downgraded = False
        t_flush_wall = time.time()
        profile_on = _profile.armed
        if profile_on:
            # The flush's wall minus its buckets' dispatches (booked under
            # `collective` by _dispatch_op) is the runtime's own cost.
            t_f0 = time.perf_counter()
            coll0 = _profile.collective_total()
            defer_s = max(t_f0 - self._first_enqueue, 0.0) \
                if self._first_enqueue else 0.0
        if _chaos.armed:
            # A delay here stalls the flush under the runtime lock: every
            # enqueue waits behind it (the fusion-flush stall).
            _chaos.fire("fusion.flush")
        _metrics.record_fusion_flush(len(prefix), flushed_bytes, threshold)
        if _flight.armed:
            _flight.record_event("fusion_flush", seq=prefix[-1].seq,
                                 nbytes=flushed_bytes,
                                 what=f"n{len(prefix)}")
        if policy is None:
            policy = (self._wire_snapshot(),) + self._strategy_snapshot()
        wire, strategy, cross = policy
        if self._multi and self._coord:
            # The alltoall policy rides the same boundary: process 0's
            # registries hold it for this prefix.
            self._publish_queue.put((
                self._boundary_seq, prefix[-1].seq, why, wire, strategy,
                cross, _wire.alltoall_strategy_for("global"),
                _wire.wire_dtype_for("a2a:global", "", tier="dcn"),
                threshold))
            self._boundary_seq += 1
        error = None
        try:
            for key, entries in self._assemble(prefix, wire, threshold):
                try:
                    self._close(key, entries, why, wire, strategy, cross)
                except Exception as exc:  # noqa: BLE001 — its handles hold it
                    error = error or exc
        finally:
            self._flushed_seq = prefix[-1].seq
            self._flushed.notify_all()
            if self._stall_inspector is not None:
                self._stall_inspector.record_flush()
            self._flush_observed(len(prefix), flushed_bytes, wire,
                                 t_flush_wall,
                                 (t_f0, coll0, defer_s) if profile_on
                                 else None)
        if self._parameter_manager is not None:
            self._autotune_record(flushed_bytes)
        if error is not None:
            raise error

    def _autotune_record(self, flushed_bytes):
        """Report the flush to the tuner (JAX's per-flush step): a flush
        with a bucket downgraded to flat first invalidates the window, so
        flat timings are not scored as the configured strategy. A closed
        window's knobs act from the next flush; the cycle thread reads the
        new cycle at its next wake."""
        pm = self._parameter_manager
        if self._downgraded:
            pm.invalidate_window()
        update = pm.record(flushed_bytes)
        if update is None:
            return
        threshold, cycle_ms, cats = update
        self.threshold = int(threshold)
        self._cycle_s = max(float(cycle_ms), 1e-3) / 1000.0
        if "strategy" in cats:
            self.strategy = cats["strategy"]
        if "wire_dtype" in cats:
            self.wire_dtype = _wire._normalize(cats["wire_dtype"])

    def _flush_observed(self, n, nbytes, wire, t_wall, bracket):
        """A flush's records after its buckets: the step profiler's fusion
        bracket, the timeline's counter tracks (throttled) and the
        ``fusion_flush`` span under the active step trace. Never raises."""
        try:
            if bracket is not None:
                t_f0, coll0, defer_s = bracket
                self._first_enqueue = time.perf_counter() \
                    if self._pending else 0.0
                _profile.record_fusion_flush(
                    time.perf_counter() - t_f0,
                    _profile.collective_total() - coll0, defer_s,
                    wire_dtype=wire or None, wire_bytes=nbytes)
            tl = basics.timeline()
            if tl is not None:
                _metrics.maybe_emit_timeline_counters(tl)
            _trace.add_span(_trace.get_active(), "fusion_flush", t_wall,
                            time.time() - t_wall, cat="train",
                            args={"n": n, "bytes": nbytes})
        except Exception:  # noqa: BLE001 — observability must not fail
            pass

    def _assemble(self, prefix, wire="", threshold=None):
        """The prefix's buckets, as [(key, entries)] in order of first
        appearance: one open bucket per key (per group for a group's
        entries), closed when the next entry would take it past the
        threshold (the flush's; default the runtime's). On a cast wire the
        key's dtype is the wire's (JAX's ``_bucket_key``): fp32 and bf16
        tensors then share buckets."""
        threshold = self.threshold if threshold is None else threshold
        buckets, open_ = [], {}
        for e in prefix:
            grouped = e.group is not None
            key = _wire_key(e.key, wire)
            slot = ("group", e.group) if grouped else key
            b = open_.get(slot)
            if b is None or (not grouped and b[2]
                             and b[2] + e.nbytes > threshold):
                b = open_[slot] = [key, [], 0]
                buckets.append(b)
            b[1].append(e)
            b[2] += e.nbytes
        return [(key, entries) for key, entries, _ in buckets]

    def stop_threads(self):
        """Stop and join the cycle and follower threads (the publisher stops
        after the final flush, in ``shutdown``)."""
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            if t.name != "hvd-fusion-publish":
                t.join(timeout=30)

    def shutdown(self):
        """Stop and join the threads, flush what is left (a follower drains
        process 0's last boundaries and fails what none covers), and free
        the buffers. Process 0 then waits, bounded, for the followers to
        have stopped reading the store it serves. After :meth:`abort`
        there is nothing left to do."""
        if self._failed is not None:
            return
        self.stop_threads()
        if self._multi and not self._coord:
            deadline = time.monotonic() + min(30.0, self.BOUNDARY_TIMEOUT_S)
            while self._pending and time.monotonic() < deadline:
                try:
                    self._apply_ready_boundaries(0.5)
                except Exception:  # noqa: BLE001
                    break
            with self._lock:
                leftover, self._pending = self._pending, []
                self._pending_bytes = 0
            for e in leftover:
                e.handle._error = HorovodInternalError(
                    "fusion shutdown: no boundary from process 0 covered "
                    "this tensor")
        else:
            with self._lock:
                self._flush_locked("sync")
        if self._publish_queue is not None:
            # After the final flush, so its boundary reaches the followers.
            self._publish_queue.put(None)
            for t in self._threads:
                if t.name == "hvd-fusion-publish":
                    t.join(timeout=30)
        if self._stall_inspector is not None:
            self._stall_inspector.stop()
        if self._multi:
            done = f"{self._ns}/stopped"
            try:
                if self._coord:
                    self._client.wait(
                        [f"{done}{r}" for r in range(1, self._world)],
                        datetime.timedelta(seconds=10))
                else:
                    self._client.set(f"{done}{self._rank}", "1")
            except Exception:  # noqa: BLE001 — a follower that is gone
                pass
        if self._stream is not None:
            self._stream.synchronize()
        self._buffers.clear()

    def abort(self, error):
        """The elastic reset's shutdown, for when peers may be dead: fail
        every pending handle with ``error`` at once, stop the threads, free
        the buffers, and touch no store (``shutdown`` would wait on process
        0 or the followers). A bucket already closing fails, or completes,
        with its collective. Takes no lock: a thread may hold it inside a
        collective until the process group's abort ends it."""
        if self._failed is not None:
            return
        self._failed = error
        self._stop.set()
        self._wake.set()
        if self._stall_inspector is not None:
            self._stall_inspector.stop()
        if self._publish_queue is not None:
            self._publish_queue.put(None)
        for e in list(self._pending):
            e.handle._error = error
        self._store = self._client = None
        self._buffers = {}

    def verified_signatures(self):
        """The bucket signatures all ranks have agreed on, oldest first:
        (process set id, op, prescale, postscale, dtype, wire, strategy,
        cross wire, ((name, numel), ...)); ``wire`` is the flush's wire
        dtype, '' for full precision; ``strategy`` and ``cross wire`` the
        flush's snapshot (a bucket of its own: flat and '')."""
        with self._lock:
            return list(self._verified)

    def recent_buckets(self, n):
        """The last ``n`` buckets closed (at most the last ``_RECENT``),
        oldest first: (trigger, signature as in
        :meth:`verified_signatures`)."""
        with self._lock:
            return list(self._recent)[-n:] if n > 0 else []

    def flush_stats(self):
        """Buckets closed so far, by trigger (``TRIGGERS``; a follower counts
        process 0's trigger) and by the strategy each ran (after the
        refusals), the new signatures among them, how many rode the
        quantized exchange, the bytes on the wire by wire dtype (the JAX
        formulas: ``wire.exchange_wire_bytes`` for a quantized bucket,
        ``wire.hierarchical_wire_bytes`` for a torus or torus_qcross bucket
        over slices, ``wire.allreduce_wire_bytes`` for the others), and the
        tiered buckets' bytes by tier (``local``, ``cross``) and wire
        dtype."""
        with self._lock:
            return {"buckets": self._stats["buckets"],
                    "closed_by": dict(self._stats["closed_by"]),
                    "strategies": dict(self._stats["strategies"]),
                    "new_signatures": self._stats["new_signatures"],
                    "quantized": self._stats["quantized"],
                    "wire_bytes": dict(self._stats["wire_bytes"]),
                    "tiers": {t: dict(v) for t, v in
                              self._stats["tiers"].items()}}

    def _close(self, key, entries, why, wire="", strategy="flat", cross="",
                eager=False):
        ps, op, prescale, postscale, dtype = key
        sig = (ps.process_set_id, int(op), prescale, postscale, str(dtype),
               wire, strategy, cross,
               tuple((e.name, e.tensor.numel()) for e in entries))
        self._stats["buckets"] += 1
        self._stats["closed_by"][why] += 1
        self._recent.append((why, sig))
        try:
            joined = self._check_signature(key, sig)
            n = ps.size() - len(joined)
            numels = [e.tensor.numel() for e in entries]
            # JAX's refusals: only Sum/Average, and torus_qcross needs slices.
            if strategy != "flat" and (
                    op not in (ReduceOp.SUM, ReduceOp.AVERAGE) or joined or (
                        strategy == "torus_qcross" and self._slices() <= 1)):
                strategy = "flat"
                self._downgraded = True
            self._stats["strategies"][strategy] += 1
            quant = _bucket_quant(wire, op, joined, numels, n) \
                if strategy == "flat" else None
            # The wire this bucket rides: quantized, a cast, or '' (exact).
            ride = quant or ("" if _wire.is_quantized(wire)
                             or op == ReduceOp.ADASUM else wire)
            # The residual's key: the bucket's layout and this runtime's
            # membership epoch, or for a one-shot call its names, shapes and
            # dtypes. JAX's eager plan key leaves the names out, so two
            # same-shaped tensors there share one residual; here each keeps
            # its own, as the fused buckets' keys do. An unnamed one-shot
            # call keeps none (None): nothing ties it to a later call, so
            # each such call starts from zero.
            if not eager:
                res_key = ("fusion", self._epoch) + sig[:5] + sig[8:]
            elif all(e.name is not None for e in entries):
                res_key = ("eager", self._epoch) + sig[:4] + tuple(
                    (e.name, tuple(e.tensor.shape), str(e.tensor.dtype))
                    for e in entries)
            else:
                res_key = None
            tiers = None
            if strategy != "flat":
                tiers = self._topology.tiers(self._topology.strategy_shape())
            plan = (strategy, tiers, cross)
            wire_recs = self._count_wire(ride, dtype, sum(numels), n, plan)
            name = f"fused_allreduce[{len(entries)}]"
            tensors = [e.tensor for e in entries]
            fsig = None
            if _flight.armed:
                fsig = self._flight_sigs.get(sig)
                if fsig is None:
                    if len(self._flight_sigs) >= _MAX_SIGNATURES:
                        self._flight_sigs.clear()
                    fsig = self._flight_sigs[sig] = _flight.signature(
                        tensors)
            event = None
            with _dispatch_op(name, "ALLREDUCE", tensors, ps,
                              wire=wire_recs, sig=fsig):
                if self._stream is None:
                    self._reduce(entries, ps, op, prescale, postscale,
                                 dtype, joined, ride, res_key, plan)
                else:
                    side = self._stream
                    for s in {e.stream.cuda_stream: e.stream
                              for e in entries}.values():
                        side.wait_stream(s)
                    timed = _profile.armed
                    with torch.cuda.stream(side):
                        if timed:
                            start = torch.cuda.Event(enable_timing=True)
                            start.record(side)
                        self._reduce(entries, ps, op, prescale, postscale,
                                     dtype, joined, ride, res_key, plan)
                        event = torch.cuda.Event(enable_timing=timed)
                        event.record(side)
                    if timed:
                        _profile.record_bucket_events(start, event, name)
                    # The caching allocator must not hand these blocks out
                    # again before the side stream is done with them.
                    for e in entries:
                        e.tensor.record_stream(side)
                        e.output.record_stream(side)
        except BaseException as exc:
            for e in entries:
                e.handle._error = exc
            raise
        for e in entries:
            e.handle._event = event
            e.handle._dispatched = True

    def _count_wire(self, label, dtype, total, n, plan):
        """Meter the bucket's wire bytes into ``flush_stats()`` and return
        them as the metrics' wire records: ``[(path, wire dtype, bytes,
        compressed, tiers)]``."""
        by = self._stats["wire_bytes"]
        payload = str(dtype).replace("torch.", "")
        strategy, tiers, cross = plan
        if strategy in ("torus", "torus_qcross") and self._slices() > 1:
            # JAX meters a torus bucket over slices by tier: the local legs
            # at the payload's width, the cross leg at its wire.
            label = label or str(dtype).replace("torch.", "")
            item = torch.empty((), dtype=dtype).element_size()
            h = _wire.hierarchical_wire_bytes(
                total, n, tiers.rows, item,
                cross_wire=cross if strategy == "torus_qcross" else "")
            cross_label = h["cross_label"] or label
            recs = []
            for tier, lab, nbytes, key in (
                    ("local", label, h["ici"], "ici"),
                    ("cross", cross_label, h["dcn"], "dcn")):
                by[lab] = by.get(lab, 0) + nbytes
                t = self._stats["tiers"][tier]
                t[lab] = t.get(lab, 0) + nbytes
                recs.append(("fused", lab, nbytes, lab != payload,
                             {key: nbytes}))
            return recs
        if _wire.is_quantized(label):
            self._stats["quantized"] += 1
            nbytes = _wire.exchange_wire_bytes(total, n)
        else:
            label = label or str(dtype).replace("torch.", "")
            item = torch.empty((), dtype=dtype).element_size()
            nbytes = _wire.allreduce_wire_bytes(n * total * item, item, n,
                                                label)
        by[label] = by.get(label, 0) + nbytes
        return [("fused", label, nbytes, label != payload, None)]

    def _reduce(self, entries, ps, op, prescale, postscale, dtype, joined,
                ride, res_key, plan):
        tensors = [e.tensor for e in entries]
        outputs = [e.output for e in entries]
        total = sum(t.numel() for t in tensors)
        if _wire.is_quantized(ride):
            self._reduce_quantized(tensors, outputs, ps, op, prescale,
                                   postscale, ride, res_key, total)
            return
        cast = bool(ride)
        if cast:
            # JAX's rounding points on the cast wire: the scales in the wire
            # dtype, Average's 1/n as its own product in it.
            prescale, postscale = (
                torch.tensor(v, dtype=dtype).item()
                for v in (prescale, postscale))
        if plan[0] != "flat":
            self._reduce_tiered(tensors, outputs, ps, op, prescale,
                                postscale, dtype, cast, res_key, total, plan)
            return
        # A bucket off the quantized wire drops the residual it may have
        # kept there (a joined rank, a wire flip).
        _wire.ef_pop(res_key)
        buf = self._buffer(dtype, total)
        pack_scale(tensors, buf, prescale)
        if op == ReduceOp.ADASUM:
            # Gather every rank's bucket and run the combine tree on it, per
            # tensor; the result is row 0. Adasum is no average: no 1/n.
            gathered = torch.empty(ps.size() * total, dtype=dtype,
                                   device=self.device)
            launch(all_gather_flat, gathered, buf, group=ps.group,
                   async_op=True)
            buf = reduce_gathered(
                active_rows(gathered.view(ps.size(), total), ps, joined),
                [t.numel() for t in tensors])
        else:
            launch(dist.all_reduce, buf, op=DIST_OPS[op], group=ps.group,
                   async_op=True)
            if op == ReduceOp.AVERAGE:
                n = ps.size() - len(joined)
                if cast:
                    # XLA's y / n: a product with 1/n in the wire dtype.
                    buf.mul_(torch.tensor(1.0 / n, dtype=dtype).item())
                else:
                    postscale = postscale / n
        unpack_scale(buf, outputs, postscale)

    def _reduce_quantized(self, tensors, outputs, ps, op, prescale,
                          postscale, label, res_key, total):
        """The quantized wire: pack (widened to fp32), the block-scaled
        exchange with the bucket's residual, the prescale, Average's 1/n and
        the postscale (in JAX's order and rounding), unpack (rounded to the
        tensors' dtype)."""
        work = self._buffer(torch.float32, total)
        pack_scale(tensors, work, 1.0)
        keep = self._wire_ef and res_key is not None
        residual = None
        if keep:
            # A bucket's first round on this wire starts from zero, as JAX's.
            kept = _wire.ef_get(res_key)
            residual = kept[1] if kept is not None and kept[0] == label \
                else torch.zeros(total, dtype=torch.float32,
                                 device=work.device)
        try:
            out, new_res = _wire.block_scaled_allreduce(
                work, residual=residual, group=ps.group, wire=label,
                average=op == ReduceOp.AVERAGE, prescale_factor=prescale,
                postscale_factor=postscale)
        except BaseException:
            # Never resume error feedback over a failed exchange.
            _wire.ef_pop(res_key)
            raise
        if keep:
            # Made on the side stream, whose allocator pool it belongs to.
            _wire.ef_put(res_key, (label, new_res))
        unpack_scale(out, outputs, 1.0)

    def _reduce_tiered(self, tensors, outputs, ps, op, prescale, postscale,
                       dtype, cast, res_key, total, plan):
        """A bucket on a 2-level strategy: pack into a buffer padded with
        zeros to a multiple of the local size (torus), the schedule of
        ``parallel/strategies.py`` on the layout's subgroups, unpack with
        Average's reciprocal folded into the postscale as XLA folds it (on
        a cast wire, its own product in the wire dtype, as on the flat
        path). torus_qcross keeps a residual of the shard's size per
        bucket layout, under its own kind, so a flip of wire or strategy
        starts it from zero."""
        strategy, tiers, cross = plan
        pad = 0 if strategy == "hierarchical" else (-total) % tiers.cols
        buf = self._buffer(dtype, total + pad)
        pack_scale(tensors, buf[:total], prescale)
        if pad:
            buf[total:].zero_()
        label = None
        if strategy == "torus_qcross":
            label = _strategies.cross_label(
                cross, (total + pad) // tiers.cols, tiers.rows,
                dtype.is_floating_point)
        kind = f"cross:{label}"
        residual = None
        if label is not None and self._wire_ef:
            kept = _wire.ef_get(res_key)
            residual = kept[1] if kept is not None and kept[0] == kind \
                else torch.zeros((total + pad) // tiers.cols,
                                 dtype=torch.float32, device=buf.device)
        else:
            _wire.ef_pop(res_key)
        if strategy == "hierarchical":
            _strategies.hierarchical_(buf, tiers)
        else:
            try:
                buf, new_res = _strategies.torus_(buf, tiers, label,
                                                  residual)
            except BaseException:
                _wire.ef_pop(res_key)
                raise
            if residual is not None:
                _wire.ef_put(res_key, (kind, new_res))
        if op == ReduceOp.AVERAGE:
            if cast:
                buf.mul_(torch.tensor(1.0 / ps.size(), dtype=dtype).item())
            else:
                postscale = _strategies.fold_scale(ps.size(), postscale)
        unpack_scale(buf[:total], outputs, postscale)

    def _buffer(self, dtype, total):
        itemsize = torch.empty((), dtype=dtype).element_size()
        if total * itemsize > self.threshold:
            # A bucket above the threshold: one big tensor, or a group.
            return torch.empty(total, dtype=dtype, device=self.device)
        buf = self._buffers.get(dtype)
        if buf is None or buf.numel() < total:   # first use, or a raised
            buf = self._buffers[dtype] = torch.empty(   # threshold
                self.threshold // itemsize, dtype=dtype, device=self.device)
        return buf[:total]

    def _check_signature(self, key, sig):
        """The bucket's check that every rank formed it; returns the joined
        ranks of its set."""
        ps, op, prescale, postscale, dtype = key
        if join_armed():
            return join_round(ps, ADASUM if op == ReduceOp.ADASUM
                              else ALLREDUCE, op, dtype,
                              sum(n for _, n in sig[-1]), sig=sig)
        if sig in self._verified:
            return frozenset()
        mine, every = rank_digests(sig, ps)
        if any(h != mine for h in every):
            raise TensorShapeMismatchError(
                f"ranks formed different fusion buckets for {len(sig[-1])} "
                f"tensor(s) of {dtype} (op {op.name}, wire "
                f"{sig[5] or 'full precision'}); this rank's bucket: "
                f"{sig[-1][:4]}{'...' if len(sig[-1]) > 4 else ''}; bucket "
                f"hashes by rank: {every}. Every rank must enqueue the same "
                "tensors in the same order, on the same wire.")
        if len(self._verified) >= _MAX_SIGNATURES:
            self._verified.clear()
        self._verified[sig] = mine
        self._stats["new_signatures"] += 1
        return frozenset()


def _ps_label(ps):
    """The wire registry's label of a process set (JAX's ``_ps_label``)."""
    return "global" if ps is None or ps.ranks is None \
        else f"set{ps.process_set_id}"


def _sync_policy(strategy, cross, a2a="", a2a_cross=""):
    """The flush's strategy and cross wire, and a follower's alltoall
    strategy and cross wire from process 0's boundary, into the registries,
    deferring to the user's pins (JAX's ``_sync_eager_policy``). 'flat' is
    synced only over an existing entry, so the default steady state adds
    no registry entry."""
    mapped = _EAGER_STRATEGY[strategy]
    if mapped != "flat" or _wire.dispatch_strategy_for("global"):
        _wire.runtime_sync_dispatch_strategy(mapped, "global")
    if cross:
        _wire.runtime_sync_wire_dtype(cross, "global", tier="dcn")
    if a2a and (a2a != "flat" or _wire.alltoall_strategy_for("global")):
        _wire.runtime_sync_alltoall_strategy(a2a, "global")
    if a2a_cross:
        _wire.runtime_sync_alltoall_cross_dtype(a2a_cross, "global")


def _wire_key(key, wire):
    """A bucket key on ``wire``: a cast wire keys it at the wire dtype, a
    quantized or full-precision wire at the tensors' own. Adasum reduces in
    the tensors' own dtype on any wire, as JAX's fused program does."""
    if not wire or _wire.is_quantized(wire) or key[1] == ReduceOp.ADASUM:
        return key
    return key[:4] + (_wire.wire_torch_type(wire),)


def _bucket_quant(wire, op, joined, numels, n):
    """JAX's ``_bucket_quant``: the quantized label a bucket rides, or None
    for the exact path. Only flat Sum/Average buckets (every fusion dtype is
    a float) with no joined rank and at least n×BLOCK elements."""
    label = _wire.quantized_label(wire)
    if label is None or joined or op not in (ReduceOp.SUM,
                                             ReduceOp.AVERAGE):
        return None
    return label if sum(numels) >= n * _wire.BLOCK else None


def get_runtime():
    st = basics._get_state()
    with _runtime_lock:
        if st.fusion is None:
            rt = FusionRuntime(st.config.fusion_threshold, st.device,
                               cycle_time_ms=st.config.cycle_time_ms,
                               rank=st.rank, size=st.size, store=st.store,
                               epoch=st.config.elastic_init_version,
                               wire_dtype=st.config.wire_dtype,
                               wire_error_feedback=(
                                   st.config.wire_error_feedback),
                               strategy=config_strategy(st.config),
                               wire_dtype_dcn=st.config.wire_dtype_dcn,
                               topology=st.topology,
                               generation=st.fusion_generation,
                               stall_check=None
                               if st.config.stall_check_disable
                               else (st.config.stall_check_time_seconds,
                                     st.config.stall_shutdown_time_seconds),
                               control_lease_ms=st.config.control_lease_ms,
                               cross_overlap=st.config.cross_overlap)
            # The flush-window tuner, process 0's alone (JAX's rule: a
            # manager per process would freeze different winners); the
            # autopilot, when armed, tunes the same knobs itself.
            if st.config.autotune and not st.config.autopilot \
                    and st.rank == 0:
                rt._parameter_manager = build_parameter_manager(st.config,
                                                                rt)
            rt.start()
            st.fusion = rt
        return st.fusion


def build_parameter_manager(config, runtime):
    """The flush-window ``ParameterManager`` of ``runtime`` (JAX's runtime
    constructor): the autotune knobs' windows over the runtime's threshold,
    cycle time and the categorical space of ``sweep_categoricals`` (the
    strategies, ``torus_qcross`` only over slices, and an opted-into
    wire)."""
    from horovod_tpu_torch.autotune import (ParameterManager,
                                            sweep_categoricals)
    from horovod_tpu_torch.common.topology import forced_slices
    has_slices = bool(forced_slices()) or runtime._slices() > 1
    cats = sweep_categoricals(runtime.strategy, config.wire_dtype,
                              has_slices)
    return ParameterManager(
        warmup_samples=config.autotune_warmup_samples,
        steps_per_sample=config.autotune_steps_per_sample,
        bayes_opt_max_samples=config.autotune_bayes_opt_max_samples,
        gaussian_process_noise=config.autotune_gaussian_process_noise,
        log_file=config.autotune_log_file or None,
        initial_threshold=config.fusion_threshold,
        initial_cycle_ms=config.cycle_time_ms,
        categorical_knobs=cats)


def reset_runtime():
    """Shut the running runtime down (what is pending flushes, as at
    ``hvd.shutdown``) and drop it: the next :func:`get_runtime` builds one
    under the knobs as they are then (``HOROVOD_CONTROL_PLANE`` among
    them), in a store namespace of its own. Collective: every rank calls it
    at the same point of the program."""
    st = basics._get_state()
    with _runtime_lock:
        rt, st.fusion = st.fusion, None
        st.fusion_generation += 1
    if rt is not None:
        rt.shutdown()
