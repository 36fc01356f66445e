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
covered, trigger)`` through the ``TCPStore`` that ``hvd.init`` opened, from
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

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 TensorShapeMismatchError)
from horovod_tpu_torch.ops.adasum import reduce_gathered
from horovod_tpu_torch.ops.collective_ops import (ADASUM, ALLREDUCE,
                                                  DIST_OPS, ReduceOp,
                                                  active_rows,
                                                  all_gather_flat,
                                                  join_armed, join_round,
                                                  launch, rank_digests)
from horovod_tpu_torch.ops.kernels.scale_buffers import pack_scale, unpack_scale

_MAX_SIGNATURES = 4096   # runaway-signature guard for the verified cache
_RECENT = 4096           # closed buckets kept for recent_buckets()
_runtime_lock = threading.Lock()

# What closed a bucket: the pending bytes reached the threshold, a cycle
# tick, a poll/synchronize/flush_all/fence, or its own call (a set smaller
# than the world, or join armed).
TRIGGERS = ("threshold", "cycle", "sync", "own")


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
                 size=1, store=None, epoch=0):
        self.threshold = int(threshold)
        self.device = device
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
        # launches; 0 otherwise): its keys never meet another version's.
        self._epoch = epoch
        self._client = None      # this runtime's own connection to the store
        self._cycle_s = max(float(cycle_time_ms), 0.0) / 1000.0
        self._cycle_pause = False
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
                       "new_signatures": 0}
        self._recent = collections.deque(maxlen=_RECENT)
        # The error every handle fails with once the runtime is aborted.
        self._failed = None

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
        return f"hvd/fusion/e{self._epoch}/b{seq}"

    def _publisher_loop(self):
        """Process 0: the store RPCs of each boundary, off the runtime lock
        and in order (JAX's ``_publisher_loop``)."""
        while True:
            item = self._publish_queue.get()
            if item is None:
                return
            seq, last, why = item
            try:
                self._client.set(self._boundary_key(seq), f"{last} {why}")
                if seq >= self._BOUNDARY_GC_LAG:
                    self._client.delete_key(
                        self._boundary_key(seq - self._BOUNDARY_GC_LAG))
            except Exception as e:  # noqa: BLE001 — keep publishing
                hvd_logging.warning("fusion boundary %d not published: %s",
                                    seq, e)

    def _fetch(self, seq, wait_s):
        """Boundary ``seq`` from the store, waiting at most ``wait_s`` (0:
        only if already published); None if there is none yet."""
        key = self._boundary_key(seq)
        got = self._fetch_lock.acquire(timeout=wait_s) if wait_s > 0 \
            else self._fetch_lock.acquire(blocking=False)
        if not got:
            return None
        t0 = time.monotonic()
        try:
            if wait_s <= 0:
                if not self._client.check([key]):
                    return None
            else:
                try:
                    self._client.wait([key],
                                      datetime.timedelta(seconds=wait_s))
                except dist.DistNetworkError:
                    raise
                except Exception:  # noqa: BLE001 — no boundary in the wait
                    left = wait_s - (time.monotonic() - t0)
                    if left > 0:   # the store failed fast: no hot loop
                        time.sleep(min(left, 0.05))
                    return None
            last, why = self._client.get(key).decode().split()
            return int(last), why
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
            last, why = payload
            with self._lock:
                if self._boundary_seq != seq:   # another thread applied it
                    wait_s = 0
                    continue
                if self._next_seq <= last:
                    self._deferred = (seq, payload)
                    return True
                self._deferred = None
                self._boundary_seq += 1
                self._flush_locked(why, up_to=last)
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
                names):
        """Queue one unit — a tensor, or a group that shares a bucket — of
        one dtype; returns a handle per tensor."""
        key = (process_set, ReduceOp(op), prescale, postscale,
               tensors[0].dtype)
        stream = None if self._stream is None \
            else torch.cuda.current_stream(self.device)
        if self._failed is not None:
            raise self._failed
        own = join_armed() or process_set.size() < self._world
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
                self._close(key, entries, "own")
                return [e.handle for e in entries]
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

    def _flush_locked(self, why, up_to=None):
        """Close the pending prefix (all of it, or a follower's boundary:
        the entries with seq <= ``up_to``) as buckets."""
        if up_to is None:
            prefix, self._pending = self._pending, []
        else:
            n = 0
            while n < len(self._pending) and self._pending[n].seq <= up_to:
                n += 1
            prefix, self._pending = self._pending[:n], self._pending[n:]
        if not prefix:
            return
        self._pending_bytes -= sum(e.nbytes for e in prefix)
        if self._multi and self._coord:
            self._publish_queue.put((self._boundary_seq, prefix[-1].seq, why))
            self._boundary_seq += 1
        error = None
        try:
            for key, entries in self._assemble(prefix):
                try:
                    self._close(key, entries, why)
                except Exception as exc:  # noqa: BLE001 — its handles hold it
                    error = error or exc
        finally:
            self._flushed_seq = prefix[-1].seq
            self._flushed.notify_all()
        if error is not None:
            raise error

    def _assemble(self, prefix):
        """The prefix's buckets, as [(key, entries)] in order of first
        appearance: one open bucket per key (per group for a group's
        entries), closed when the next entry would take it past the
        threshold."""
        buckets, open_ = [], {}
        for e in prefix:
            grouped = e.group is not None
            slot = ("group", e.group) if grouped else e.key
            b = open_.get(slot)
            if b is None or (not grouped and b[2]
                             and b[2] + e.nbytes > self.threshold):
                b = open_[slot] = [e.key, [], 0]
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
        if self._multi:
            done = f"hvd/fusion/e{self._epoch}/stopped"
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
        if self._publish_queue is not None:
            self._publish_queue.put(None)
        for e in list(self._pending):
            e.handle._error = error
        self._store = self._client = None
        self._buffers = {}

    def verified_signatures(self):
        """The bucket signatures all ranks have agreed on, oldest first:
        (process set id, op, prescale, postscale, dtype, ((name, numel),
        ...))."""
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
        process 0's trigger), and the new signatures among them."""
        with self._lock:
            return {"buckets": self._stats["buckets"],
                    "closed_by": dict(self._stats["closed_by"]),
                    "new_signatures": self._stats["new_signatures"]}

    def _close(self, key, entries, why):
        ps, op, prescale, postscale, dtype = key
        sig = (ps.process_set_id, int(op), prescale, postscale, str(dtype),
               tuple((e.name, e.tensor.numel()) for e in entries))
        self._stats["buckets"] += 1
        self._stats["closed_by"][why] += 1
        self._recent.append((why, sig))
        try:
            joined = self._check_signature(key, sig)
            event = None
            if self._stream is None:
                self._reduce(entries, ps, op, prescale, postscale, dtype,
                             joined)
            else:
                side = self._stream
                for s in {e.stream.cuda_stream: e.stream
                          for e in entries}.values():
                    side.wait_stream(s)
                with torch.cuda.stream(side):
                    self._reduce(entries, ps, op, prescale, postscale, dtype,
                                 joined)
                    event = torch.cuda.Event()
                    event.record(side)
                # The caching allocator must not hand these blocks out again
                # before the side stream is done with them.
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

    def _reduce(self, entries, ps, op, prescale, postscale, dtype, joined):
        total = sum(e.tensor.numel() for e in entries)
        buf = self._buffer(dtype, total)
        pack_scale([e.tensor for e in entries], buf, prescale)
        if op == ReduceOp.ADASUM:
            # Gather every rank's bucket and run the combine tree on it, per
            # tensor; the result is row 0. Adasum is no average: no 1/n.
            gathered = torch.empty(ps.size() * total, dtype=dtype,
                                   device=self.device)
            launch(all_gather_flat, gathered, buf, group=ps.group,
                   async_op=True)
            buf = reduce_gathered(
                active_rows(gathered.view(ps.size(), total), ps, joined),
                [e.tensor.numel() for e in entries])
        else:
            launch(dist.all_reduce, buf, op=DIST_OPS[op], group=ps.group,
                   async_op=True)
            if op == ReduceOp.AVERAGE:
                postscale = postscale / (ps.size() - len(joined))
        unpack_scale(buf, [e.output for e in entries], postscale)

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
                f"tensor(s) of {dtype} (op {op.name}); this rank's bucket: "
                f"{sig[-1][:4]}{'...' if len(sig[-1]) > 4 else ''}; bucket "
                f"hashes by rank: {every}. Every rank must enqueue the same "
                "tensors in the same order.")
        if len(self._verified) >= _MAX_SIGNATURES:
            self._verified.clear()
        self._verified[sig] = mine
        self._stats["new_signatures"] += 1
        return frozenset()


def get_runtime():
    st = basics._get_state()
    with _runtime_lock:
        if st.fusion is None:
            rt = FusionRuntime(st.config.fusion_threshold, st.device,
                               cycle_time_ms=st.config.cycle_time_ms,
                               rank=st.rank, size=st.size, store=st.store,
                               epoch=st.config.elastic_init_version)
            rt.start()
            st.fusion = rt
        return st.fusion
