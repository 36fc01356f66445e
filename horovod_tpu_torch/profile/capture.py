"""On-demand ``torch.profiler`` trace capture, aligned with the flight
recorder's clock.

Port of the JAX package's ``profile/capture.py`` (JAX starts and stops a
``jax.profiler`` trace). Two triggers, one implementation:

- ``GET /debug/profile?ms=500`` on the metrics scrape endpoint
  (:mod:`horovod_tpu_torch.metrics.server`) — capture a wall-clock window
  right now, from outside the process;
- ``HOROVOD_PROFILE_STEPS=a:b`` — capture a STEP window: the trace starts
  at the step-``a`` marker and stops at the step-``b`` marker (i.e. it
  covers steps ``a+1..b``), driven by the ledger's step boundaries.

Each capture directory holds the exported Chrome trace (``trace.json``:
the CUDA kernels on the device lanes, the ``hvd::`` annotations of the
dispatches) and a ``clock_sync.json`` recording the wall clock
(``time.time()``, the flight recorder's time base and the timeline's
clock_sync anchor) at trace start/stop, so the trace, the merged flight
Perfetto trace and the Chrome timeline rebase onto one axis offline.

Captures are process-local and serialized by a lock. PyTorch runs one
profiler session at a time: a second request is refused (HTTP 409 on the
endpoint), and so is a capture while a session this module did not open
is running — with a warning naming it, never silently.
"""

import json
import os
import threading
import time

DEFAULT_DIR = "profile_traces"

_lock = threading.Lock()
_active_dir = None
_window = None            # (start_step, stop_step) from HOROVOD_PROFILE_STEPS
_step_capture_dir = None  # the capture the STEP WINDOW owns (on_step must
                          # never stop a /debug/profile capture it didn't
                          # start)
_base_dir = ""
_captures = 0
_MAX_STEP_CAPTURES = 4    # runaway guard for re-entered step windows
_prof = None              # the torch.profiler session of the capture
last_refusal = None       # why the last start() returned None


def trace_dir():
    return _base_dir or os.environ.get("HOROVOD_PROFILE_DIR") \
        or DEFAULT_DIR


def configure_window(spec, base_dir=""):
    """Parse ``HOROVOD_PROFILE_STEPS`` (``a:b``, ints, a < b). Returns
    True when a valid window is armed."""
    global _window, _base_dir
    if base_dir:
        _base_dir = base_dir
    if not spec:
        return False
    try:
        a, b = spec.split(":", 1)
        a, b = int(a), int(b)
    except ValueError:
        return False
    if b <= a:
        return False
    _window = (a, b)
    return True


def _capture_path(tag):
    rank = os.environ.get("HOROVOD_RANK", "0")
    return os.path.join(trace_dir(), f"{tag}_r{rank}_{int(time.time())}")


def _write_clock_sync(d, extra=None):
    try:
        payload = {"wall_s": round(time.time(), 6),
                   "perf_ns": time.perf_counter_ns()}
        if extra:
            payload.update(extra)
        with open(os.path.join(d, "clock_sync.json"), "a") as f:
            f.write(json.dumps(payload) + "\n")
    except OSError:
        pass


def _foreign_session():
    """Whether a profiler session this module did not open is running
    (``torch.profiler`` keeps one per process)."""
    try:
        import torch
        return bool(torch.autograd.profiler._is_profiler_enabled)
    except Exception:  # noqa: BLE001
        return False


def _refuse(why):
    global last_refusal
    last_refusal = why
    try:
        from horovod_tpu_torch.common import logging as hvd_logging
        hvd_logging.warning("profile capture refused: %s", why)
    except Exception:  # noqa: BLE001
        pass
    return None


def start(tag="ondemand"):
    """Start a trace into a fresh capture directory; returns the path, or
    None (and ``last_refusal`` says why, in a warning too) when a capture
    or another profiler session is already running."""
    global _active_dir, _prof, last_refusal
    with _lock:
        if _active_dir is not None:
            return _refuse(f"a capture is already running into "
                           f"{_active_dir}")
        if _foreign_session():
            return _refuse("another torch.profiler session is running in "
                           "this process")
        d = _capture_path(tag)
        try:
            os.makedirs(d, exist_ok=True)
            import torch
            import torch.profiler as tp
            acts = [tp.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(tp.ProfilerActivity.CUDA)
            prof = tp.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 — capture must never fail
            return _refuse(f"torch.profiler did not start: {e}")
        _active_dir, _prof = d, prof
        last_refusal = None
    _write_clock_sync(d, {"event": "start", "tag": tag})
    return d


def stop():
    """Stop the active trace and export it as ``<dir>/trace.json``;
    returns its directory or None."""
    global _active_dir, _prof
    with _lock:
        d, prof = _active_dir, _prof
        if d is None:
            return None
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(d, "trace.json"))
        except Exception:  # noqa: BLE001
            pass
        _active_dir, _prof = None, None
    _write_clock_sync(d, {"event": "stop"})
    return d


def active():
    return _active_dir


MAX_CAPTURE_MS = 60_000


def clamp_ms(ms):
    """The capture-window clamp — shared with the ``/debug/profile``
    handler so the response reports the window that actually ran."""
    return max(1, min(int(ms), MAX_CAPTURE_MS))


def capture_ms(ms, tag="ondemand"):
    """Blocking wall-clock capture (the ``/debug/profile`` handler): start,
    sleep ``ms`` (clamped), stop. Returns the capture directory or None
    when a capture is already running."""
    ms = clamp_ms(ms)
    d = start(tag)
    if d is None:
        return None
    time.sleep(ms / 1000.0)
    stop()
    return d


def on_step(step):
    """Ledger step-boundary hook for the HOROVOD_PROFILE_STEPS window.
    Only ever stops the capture IT started: a concurrent
    ``/debug/profile`` capture occupying the (process-global) profiler
    slot is left alone — the step window then simply never fires."""
    global _window, _captures, _step_capture_dir
    w = _window
    if w is None:
        return
    a, b = w
    if _step_capture_dir is None and _active_dir is None \
            and a <= step < b and _captures < _MAX_STEP_CAPTURES:
        d = start(f"steps{a}_{b}")
        if d is not None:
            _step_capture_dir = d
            _captures += 1
    elif _step_capture_dir is not None and step >= b:
        if _active_dir == _step_capture_dir:
            stop()
        _step_capture_dir = None
        _window = None          # one-shot: the window is consumed


def shutdown():
    """Close any capture still open (called by ``basics.shutdown``): a
    job that ends — or elastically resets — before the step window's stop
    marker must still flush its trace to disk instead of leaking an open
    profiler session; ``stop()`` is a no-op when nothing is active."""
    global _step_capture_dir
    _step_capture_dir = None
    return stop()
