"""Slot scheduler: continuous batching over a fixed-slot decode batch.

The decode step has a FIXED batch of ``num_slots`` rows (one cache of
``num_slots`` rows for the engine's lifetime); scheduling is
therefore slot assignment, not batch construction: a finished slot
retires and refills from the FIFO admission queue on the next step
while its neighbours keep decoding (continuous batching, not static
batches — no request ever waits for a stranger's last token).

Pure host-side python (no torch): the slot lifecycle, the requeue
ordering, and the queue-depth accounting are all testable without
touching a device. Port of the JAX package's ``serving/scheduler.py``,
line for line: the same slot table, FIFO and requeue order.
"""

from collections import deque

from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.serving import request as _rq


class QueueFull(RuntimeError):
    """Admission queue at capacity — the caller's backpressure signal."""


class SlotScheduler:
    def __init__(self, num_slots, queue_limit=0):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        self.num_slots = int(num_slots)
        self.queue_limit = int(queue_limit)      # 0 = unbounded
        self._queue = deque()
        self._slots = [None] * self.num_slots    # slot -> Request | None

    # --- admission -------------------------------------------------------

    def submit(self, req):
        """FIFO admission; raises :class:`QueueFull` at the limit (the
        request is marked rejected so a waiting caller unblocks)."""
        if self.queue_limit and len(self._queue) >= self.queue_limit:
            req.reject()
            _metrics.record_serving_request("rejected")
            _metrics.record_serving_queue(len(self._queue))
            raise QueueFull(
                f"serving queue at capacity ({self.queue_limit}); "
                f"request {req.rid} rejected")
        self._queue.append(req)
        _metrics.record_serving_request("submitted")
        _metrics.record_serving_queue(len(self._queue))
        return req

    def enqueue_restored(self, req):
        """Re-materialize a request during an elastic restore: appended in
        snapshot order, past the queue limit (restores must never drop or
        re-count work), no lifecycle metrics."""
        req.state = _rq.QUEUED
        self._queue.append(req)

    def requeue(self, req):
        """Put an in-flight request BACK at the head of the queue (elastic
        disruption / slot eviction): it resumes from its last committed
        token before any younger queued request is admitted, preserving
        FIFO completion order."""
        req.state = _rq.QUEUED
        req.requeues += 1
        self._queue.appendleft(req)
        _metrics.record_serving_request("requeued")
        _metrics.record_serving_queue(len(self._queue))

    def admit(self):
        """Fill free slots from the queue head; returns the new
        ``[(slot, request)]`` assignments (engine prefills each)."""
        placed = []
        for s in range(self.num_slots):
            if self._slots[s] is None and self._queue:
                req = self._queue.popleft()
                req.state = _rq.ACTIVE
                self._slots[s] = req
                placed.append((s, req))
                _metrics.record_serving_request("admitted")
        if placed:
            _metrics.record_serving_queue(len(self._queue))
        return placed

    # --- slot lifecycle ---------------------------------------------------

    def retire(self, slot):
        """Free a slot; returns the request that occupied it."""
        req = self._slots[slot]
        self._slots[slot] = None
        return req

    def evict_active(self):
        """Requeue EVERY active request from its last committed token
        (elastic membership change: slot caches die with the old backend).
        Slot order keeps completion order stable: lower slots were
        admitted earlier, so they re-enter the queue head first."""
        active = [(s, r) for s, r in enumerate(self._slots)
                  if r is not None]
        for s, req in reversed(active):      # appendleft ⇒ reverse order
            self._slots[s] = None
            self.requeue(req)
        return [r for _, r in active]

    # --- introspection ----------------------------------------------------

    def active(self):
        """{slot: request} for occupied slots."""
        return {s: r for s, r in enumerate(self._slots) if r is not None}

    def n_active(self):
        return sum(1 for r in self._slots if r is not None)

    def queue_depth(self):
        return len(self._queue)

    def queued(self):
        return list(self._queue)

    def fill_ratio(self):
        return self.n_active() / float(self.num_slots)

    def idle(self):
        return not self._queue and self.n_active() == 0
