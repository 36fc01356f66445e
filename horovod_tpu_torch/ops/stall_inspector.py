"""Stall inspector: a watchdog for tensors enqueued and never reduced.

Port of the JAX package's ``ops/stall_inspector.py`` (reference:
horovod/common/stall_inspector.cc/.h: the coordinator warns when ranks
submitted a tensor that others did not within
``HOROVOD_STALL_CHECK_TIME_SECONDS``, 60 s, and can shut the job down after
``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``). The fusion runtime builds one
unless ``HOROVOD_STALL_CHECK_DISABLE`` is set: each enqueue records its
tensor, each flush clears the list. A daemon thread checks every
``CHECK_INTERVAL_SECS``: past the warning age it counts
``stall_events_total{kind="warning"}``, dumps the flight ring
(``stall_warning``) and logs the pending names, once until the next flush;
past the shutdown age it raises the flag that makes the next enqueue raise
``HorovodInternalError``. It stops with ``hvd.shutdown`` and with the
elastic reset.
"""

import threading
import time

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics


class StallInspector:
    CHECK_INTERVAL_SECS = 5.0

    def __init__(self, warning_secs=60.0, shutdown_secs=0.0):
        self.warning_secs = warning_secs
        self.shutdown_secs = shutdown_secs
        self._lock = threading.Lock()
        self._oldest_enqueue = None
        self._pending_names = []
        self._warned = False
        self.shutdown_flagged = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        """Terminate the watchdog thread (on hvd.shutdown and the elastic
        reset, so restarts leak no threads)."""
        self._stop.set()

    def record_enqueue(self, name):
        with self._lock:
            if self._oldest_enqueue is None:
                self._oldest_enqueue = time.monotonic()
            self._pending_names.append(name)
            if self.shutdown_flagged:
                raise HorovodInternalError(
                    "collective queue stalled beyond "
                    f"{self.shutdown_secs}s (stall inspector shutdown, "
                    "reference: HOROVOD_STALL_SHUTDOWN_TIME_SECONDS)")

    def record_flush(self):
        with self._lock:
            self._oldest_enqueue = None
            self._pending_names.clear()
            self._warned = False

    def _loop(self):
        while not self._stop.wait(self.CHECK_INTERVAL_SECS):
            with self._lock:
                if self._oldest_enqueue is None:
                    continue
                age = time.monotonic() - self._oldest_enqueue
                names = list(self._pending_names[:8])
                warned = self._warned
                flagged = self.shutdown_flagged
            if age > self.warning_secs and not warned:
                # Counted as well as logged, and the flight ring dumps: the
                # dump holds the pending tensors' enqueue history.
                _metrics.record_stall("warning")
                _flight.dump("stall_warning")
                hvd_logging.warning(
                    "One or more tensors submitted to the fusion queue "
                    "%.0fs ago were never reduced — missing synchronize()? "
                    "Pending: %s (reference: stall_inspector.cc "
                    "CheckForStalledTensors)", age, names)
                # record_flush clears _warned under the lock from caller
                # threads; the set must pair with it (dump/log above stay
                # outside the critical section).
                with self._lock:
                    self._warned = True
            if self.shutdown_secs > 0 and age > self.shutdown_secs:
                if not flagged:
                    _metrics.record_stall("shutdown")
                    _flight.dump("stall_shutdown")
                with self._lock:
                    self.shutdown_flagged = True
