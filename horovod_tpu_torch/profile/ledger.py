"""The per-step performance ledger — where each training step's wall time
goes.

Port of the JAX package's ``profile/ledger.py``: the same windows,
categories, record schema and step-boundary side work (JSONL stream,
metrics, watchdog, capture window, timeline STEP bracket, goodput hand-off).

Hot-path contract (the same budget class as the metrics registry and the
flight recorder, guarded by ``TestStepProfilerOverhead``): instrumentation
sites read one module bool (``ledger.armed``) and, when on, pay a short
lock + a few float adds per event. No allocation beyond small dict
entries, no I/O, nothing held across RPC or flush boundaries. All I/O
(the ``HVD_STEP_REPORT_FILE`` JSONL stream, watchdog KV publishes,
capture start/stop) happens at STEP boundaries only.

Attribution model — a step window runs marker-to-marker (the step markers
the flight recorder already assigns: ``hvd.step_marker``, the torch
optimizer wrapper, elastic ``State.commit``); at the closing marker the
window's accumulators become one record:

- ``host_dispatch`` — Python dispatch-path overhead around eager
  collectives (plan lookup, staging, metrics/flight bookkeeping) — and
  any stall injected there (the chaos ``delay`` site lands here, which is
  what lets the watchdog name a straggler by its own-rank signal);
- ``collective``    — the collective call (on the CPU, gloo runs it to
  completion; on the GPU, NCCL returns at launch) plus every host wait
  for a collective's result: a follower's wait for rank 0's flush
  boundary in ``Handle.synchronize``, the optimizer's ``synchronize`` and
  the fence (multi-process: where a rank blocks on its peers);
- ``fusion``        — fusion-runtime flush assembly/bookkeeping (the
  fused dispatch itself is counted under ``collective``);
- ``control_plane`` — blocking negotiation/KV exchange rounds;
- ``compute``       — the residual: wall minus everything above, clamped
  at zero (fusion flushes on the cycle thread overlap main-thread
  compute, so the categories are attribution, not a strict partition).

On the GPU the device runs after the host, so each fused bucket's device
time comes from two CUDA timing events the fusion runtime records on its
stream (:func:`record_bucket_events`); the ledger reads them at the step
boundary, only once ``query()`` says they are done (never a wait), into
the record's ``device_collective_s`` and ``device_buckets`` — beside the
host's ``collective`` — and, with a timeline running, as its ``execute``
spans. A bucket still running at a boundary is read at a later one.

Records survive elastic resets (the deque is process-global, like the
flight ring); the OPEN window does not — ``reset_window()`` (wired to
``basics.shutdown``) discards in-flight accumulation and bumps the record
``epoch``, so recovery traffic is never attributed to the first
post-restore step and reports cannot double-count across a rendezvous.
"""

import collections
import json
import os
import threading
import time

from horovod_tpu_torch.common.config import Config, _env_bool, _env_int

CATEGORIES = ("host_dispatch", "collective", "fusion", "control_plane",
              "cross_wait")
# ``cross_wait`` — in JAX, the main thread's await of a hierarchical
# bucket's cross-slice leg left in flight by the cross-leg overlap. The
# port has no such await (its buckets are stream-ordered, ops/fusion.py),
# so it books nothing here; the category keeps JAX's record layout.


def median(xs):
    """THE median of the profile subsystem (stdlib statistics.median —
    true mean-of-middle-pair for even n): the watchdog's z-scores, the
    report CLI's tables and summary() must all agree on p50 for the same
    records (the flight analyzer's upper-middle pick once hid a
    straggler — same lesson)."""
    import statistics
    return statistics.median(xs)


def robust_z(x, xs):
    """THE robust z of the profile/autopilot planes: ``x`` against
    median/MAD of ``xs``, denominator floored (5% of the median, 100us
    absolute) so microsecond-noise windows cannot fabricate infinite z.
    Returns ``(z, median)``. One definition — the watchdog's
    regression/straggler naming and the autopilot's
    revert-on-regression/drift checks must score identically."""
    med = median(xs)
    mad = median([abs(v - med) for v in xs])
    denom = max(1.4826 * mad, 0.05 * abs(med), 1e-4)
    return (x - med) / denom, med

DEFAULT_HISTORY = Config.profile_history

# The one-word hot-path gate (the flight-recorder idiom).
armed = _env_bool("HOROVOD_STEP_PROFILER", True)


def _kv_snapshot():
    """The negotiation module's traffic counters, or None (each record
    carries the deltas of its step)."""
    try:
        from horovod_tpu_torch.common import negotiation
        return negotiation.stats_snapshot()
    except Exception:  # noqa: BLE001
        return None


def enabled():
    return armed


def set_enabled(value):
    global armed
    armed = bool(value)


class StepLedger:
    """Accumulators for the open step window + the bounded record deque.
    Normally used through the module-level singleton; tests construct
    small instances directly."""

    def __init__(self, history=None):
        self._lock = threading.Lock()
        self._records = collections.deque(
            maxlen=history or _env_int("HOROVOD_PROFILE_HISTORY",
                                       DEFAULT_HISTORY))
        self._epoch = 0
        self._open = False
        self._t_open = 0.0
        self._acc = dict.fromkeys(CATEGORIES, 0.0)
        self._bytes_by_op = {}
        self._wire_bytes = {}        # wire dtype name -> bytes (fused path)
        self._n_collectives = 0
        self._n_flushes = 0
        self._fusion_defer_s = 0.0
        self._flops_per_step = None
        self._flops_source = None
        self._saw_explicit = False
        self._auto_step = 0
        self._peaks = None
        self._rank = None
        self._kv0 = None              # negotiation counters at window open
        # (start event, end event, name) of fused buckets on the GPU,
        # oldest first, until both events are done.
        self._device_pending = collections.deque(maxlen=4096)

    # --- hot-path recording (module wrappers gate on `armed`) ----------

    def add_dispatch(self, op, collective_s, host_s, nbytes):
        with self._lock:
            self._acc["collective"] += collective_s
            if host_s > 0.0:
                self._acc["host_dispatch"] += host_s
            self._n_collectives += 1
            if nbytes:
                self._bytes_by_op[op] = \
                    self._bytes_by_op.get(op, 0) + nbytes

    def add_fusion_flush(self, wall_s, collective_delta_s, defer_s,
                         wire_dtype=None, wire_bytes=0):
        with self._lock:
            # delta clamped: a step boundary landing mid-flush resets the
            # collective accumulator, which would otherwise make the
            # delta negative and INFLATE the fusion share.
            self._acc["fusion"] += max(
                wall_s - max(collective_delta_s, 0.0), 0.0)
            if defer_s > 0.0:
                self._fusion_defer_s += defer_s
            self._n_flushes += 1
            if wire_bytes:
                key = wire_dtype or "native"
                self._wire_bytes[key] = \
                    self._wire_bytes.get(key, 0) + wire_bytes

    def add_collective_wait(self, dur_s):
        """A host wait for a collective's result outside any dispatch (a
        follower's boundary wait, the fence): booked to ``collective``
        without counting a collective."""
        with self._lock:
            self._acc["collective"] += dur_s

    def add_bucket_events(self, start, end, name):
        with self._lock:
            self._device_pending.append((start, end, name))

    def harvest_device(self):
        """Pop the buckets whose CUDA events are done, oldest first, and
        return ``[(name, start, end, seconds)]``. ``query()`` only — a
        bucket still running stays for a later boundary."""
        done = []
        with self._lock:
            pending = self._device_pending
            while pending:
                start, end, name = pending[0]
                try:
                    if not end.query():
                        break
                    secs = start.elapsed_time(end) / 1e3
                except Exception:  # noqa: BLE001 — a lost stream's events
                    pending.popleft()
                    continue
                pending.popleft()
                done.append((name, start, end, secs))
        return done

    def add_control_plane(self, dur_s):
        with self._lock:
            self._acc["control_plane"] += dur_s

    def add_cross_wait(self, dur_s):
        with self._lock:
            self._acc["cross_wait"] += dur_s

    def collective_total(self):
        """Current window's accumulated collective seconds — the fusion
        flush brackets snapshot this before/after so fused program time is
        not double-counted as flush overhead."""
        with self._lock:
            return self._acc["collective"]

    # --- window bookkeeping --------------------------------------------

    def _reset_acc_locked(self):
        for k in self._acc:
            self._acc[k] = 0.0
        self._bytes_by_op = {}
        self._wire_bytes = {}
        self._n_collectives = 0
        self._n_flushes = 0
        self._fusion_defer_s = 0.0

    def on_step(self, step):
        """Step-boundary marker: close the open window into a record (and
        return it), or open the first window (returns None). ``step`` of
        None is an auto mark (optimizer wrapper) — suppressed once any
        explicit step has been seen, mirroring the flight recorder."""
        now_p = time.perf_counter()
        now_w = time.time()
        with self._lock:
            if step is None:
                if self._saw_explicit:
                    return None
                self._auto_step += 1
                step_val = self._auto_step
            else:
                try:
                    step_val = int(step)
                except (TypeError, ValueError):
                    return None
                self._saw_explicit = True
            if not self._open:
                self._open = True
                self._t_open = now_p
                self._reset_acc_locked()
                window = None
            else:
                # Copy-and-reset under the lock, build OUTSIDE it: the
                # roofline math, the device events and the negotiation
                # counters take other modules' locks and imports, and
                # holding the hot-path lock across them would block every
                # cycle-thread record at each step boundary. Events
                # recorded while we build accrue to the NEW window. (JAX's
                # records also carry the step's plan-cache deltas; the
                # port's eager dispatch has no plan cache.)
                window = {
                    "wall": now_p - self._t_open,
                    "acc": dict(self._acc),
                    "bytes_by_op": self._bytes_by_op,
                    "wire_bytes": self._wire_bytes,
                    "n_collectives": self._n_collectives,
                    "n_flushes": self._n_flushes,
                    "fusion_defer_s": self._fusion_defer_s,
                    "epoch": self._epoch,
                    "kv0": self._kv0,
                }
                self._t_open = now_p
                self._reset_acc_locked()
        kv1 = _kv_snapshot()
        with self._lock:
            self._kv0 = kv1
        if window is None:
            return None
        rec = self._build_record(step_val, now_w, window, kv1)
        if self._device_pending:
            self._add_device(rec)
        with self._lock:
            self._records.append(rec)
        return rec

    def _build_record(self, step, now_w, window, kv1=None):
        """Turn one closed window snapshot into a record. Runs OUTSIDE
        the hot-path lock (the snapshot dict is ours alone)."""
        wall = window["wall"]
        acc = window["acc"]
        att = {k: round(v, 6) for k, v in acc.items()}
        att["compute"] = round(max(wall - sum(acc.values()), 0.0), 6)
        rec = {
            "step": step,
            "epoch": window["epoch"],
            "rank": self._rank if self._rank is not None
            else _env_int("HOROVOD_RANK", 0),
            "t": round(now_w, 6),
            "wall_s": round(wall, 6),
            "attribution": att,
            "collectives": window["n_collectives"],
            "fused_flushes": window["n_flushes"],
            "fusion_defer_s": round(window["fusion_defer_s"], 6),
            "bytes_by_op": dict(window["bytes_by_op"]),
            "wire_bytes_by_dtype": dict(window["wire_bytes"]),
        }
        kv0 = window.get("kv0")
        if kv1 is not None and kv0 is not None:
            # The step's control-plane traffic: negotiation rounds and
            # gets, fusion boundary sets and gets.
            rec["kv"] = {k: kv1[k] - kv0[k]
                         for k in ("rounds", "gets", "fusion_sets",
                                   "fusion_gets")}
        self._add_roofline(rec, wall)
        return rec

    def _add_device(self, rec):
        """Book the fused buckets' device times read at this boundary into
        ``rec``, and paint them on the timeline as ``execute`` spans."""
        done = self.harvest_device()
        if not done:
            return
        rec["device_collective_s"] = round(sum(d[3] for d in done), 6)
        rec["device_buckets"] = len(done)
        try:
            from horovod_tpu_torch.common import basics
            tl = basics.timeline()
            if tl is not None:
                for name, start, end, _ in done:
                    tl.device_span(name, start, end)
        except Exception:  # noqa: BLE001 — profiling must never fail
            pass

    def _add_roofline(self, rec, wall):
        from horovod_tpu_torch.profile import roofline
        if self._peaks is None:
            self._peaks = roofline.chip_peaks()
        rec["chip"] = self._peaks["chip"]
        # _build_record runs outside the hot-path lock by design (see
        # record_step); snapshot the flops pair so a concurrent
        # set_flops_per_step can't tear value/source between reads.
        with self._lock:
            flops_per_step = self._flops_per_step
            flops_source = self._flops_source
        if flops_per_step:
            frac, achieved = roofline.mfu(flops_per_step, wall,
                                          self._peaks)
            rec["flops_per_step"] = flops_per_step
            rec["flops_source"] = flops_source
            if frac is not None:
                rec["mfu"] = round(frac, 5)
            if achieved is not None:
                rec["achieved_tflops"] = round(achieved, 4)
        nbytes = sum(rec["bytes_by_op"].values())
        if nbytes:
            cross = False
            try:
                from horovod_tpu_torch.common import basics
                cross = basics.is_initialized() \
                    and basics._get_state().cross_size > 1
            except Exception:  # noqa: BLE001
                pass
            frac, gbs = roofline.wire_utilization(nbytes, wall,
                                                  self._peaks, cross)
            if gbs is not None:
                rec["wire_gbs"] = round(gbs, 5)
            if frac is not None:
                rec["wire_util"] = round(frac, 5)
        return rec

    # --- reads ----------------------------------------------------------

    def records(self, last=None):
        with self._lock:
            if last is not None and 0 < last < len(self._records):
                # The per-flush overlap steer reads the last record: no
                # copy of the whole history.
                return [self._records[i] for i in
                        range(len(self._records) - last, len(self._records))]
            out = list(self._records)
        return out if last is None else out[-last:]

    def reset_window(self):
        """Discard the OPEN window (recovery traffic must not bleed into
        the first post-restore step) and bump the record epoch; completed
        records are kept — reports survive elastic resets."""
        with self._lock:
            self._open = False
            self._epoch += 1
            self._reset_acc_locked()
            self._device_pending.clear()

    def set_flops_per_step(self, flops, source="explicit"):
        with self._lock:
            self._flops_per_step = float(flops) if flops else None
            self._flops_source = source if flops else None

    def summary(self):
        recs = self.records()
        out = {"enabled": armed, "steps": len(recs)}
        if not recs:
            return out
        walls = [r["wall_s"] for r in recs]
        n = len(walls)
        out["epoch"] = recs[-1]["epoch"]
        out["chip"] = recs[-1].get("chip")
        out["mean_wall_s"] = round(sum(walls) / n, 6)
        out["p50_wall_s"] = round(median(walls), 6)
        att = {}
        for cat in CATEGORIES + ("compute",):
            att[cat] = round(
                sum(r["attribution"].get(cat, 0.0) for r in recs) / n, 6)
        out["attribution_mean_s"] = att
        mfus = [r["mfu"] for r in recs if "mfu" in r]
        if mfus:
            out["mfu_mean"] = round(sum(mfus) / len(mfus), 5)
        return out


_ledger = StepLedger()


def get():
    return _ledger


# --- module-level hot-path API (what the instrumented sites call) ---------

def record_dispatch(op, collective_s, host_s, nbytes=0):
    if not armed:
        return
    _ledger.add_dispatch(op, collective_s, host_s, nbytes)


def record_fusion_flush(wall_s, collective_delta_s, defer_s=0.0,
                        wire_dtype=None, wire_bytes=0):
    if not armed:
        return
    _ledger.add_fusion_flush(wall_s, collective_delta_s, defer_s,
                             wire_dtype, wire_bytes)


def record_collective_wait(dur_s):
    """A host wait for collective results outside a dispatch (a follower's
    boundary wait in ``Handle.synchronize``, the fence)."""
    if not armed:
        return
    _ledger.add_collective_wait(dur_s)


def record_bucket_events(start, end, name):
    """One fused bucket's CUDA timing events on the fusion stream (GPU);
    read at a later step boundary once done."""
    if not armed:
        return
    _ledger.add_bucket_events(start, end, name)


def record_control_plane(dur_s):
    if not armed:
        return
    _ledger.add_control_plane(dur_s)


def collective_total():
    return _ledger.collective_total() if armed else 0.0


_report_path = os.environ.get("HVD_STEP_REPORT_FILE", "")
_capture_armed = False


def on_step(step):
    """The flight recorder's step listener (``recorder.set_step_listener``
    wires it at import). Closes/opens ledger windows and performs the
    step-boundary side work: JSONL stream, metrics, watchdog, capture
    window, timeline step bracket. Never raises into the training loop."""
    if not armed:
        return
    try:
        rec = _ledger.on_step(step)
    except Exception:  # noqa: BLE001 — profiling must never fail the job
        return
    try:
        _step_side_work(step, rec)
    except Exception:  # noqa: BLE001
        pass
    # Hand the boundary to the goodput ledger (its own armed gate +
    # fail-soft wrapper): a closed window's attribution decomposes into
    # productive vs badput; the first open ends the init_compile phase.
    try:
        from horovod_tpu_torch.goodput import ledger as _goodput
        _goodput.on_step_boundary(rec, step=step)
    except Exception:  # noqa: BLE001
        pass


def _step_side_work(step, rec):
    if rec is not None:
        if _report_path:
            try:
                with open(_report_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            except OSError:
                pass
        from horovod_tpu_torch.metrics import instruments as _metrics
        _metrics.record_step(rec["wall_s"])
        from horovod_tpu_torch.profile import watchdog
        watchdog.observe(rec)
    if _capture_armed:
        # The window is keyed on the LEDGER's step clock: auto-marked
        # frontends (torch optimizer wrapper) pass step=None here, but
        # the closed record carries the ledger-assigned step — without
        # this the a:b capture would silently never fire for them.
        if rec is not None:
            eff_step = rec["step"]
        else:
            try:
                eff_step = int(step)
            except (TypeError, ValueError):
                eff_step = None
        if eff_step is not None:
            from horovod_tpu_torch.profile import capture
            capture.on_step(eff_step)
    # Step bracket into the Chrome-trace timeline (aligned with the
    # flight recorder's clock via the timeline's clock_sync metadata).
    # Only for markers the ledger ACCEPTED as a window close: a
    # suppressed auto mark (torch optimizer.step alongside elastic
    # State.commit) must not paint a second STEP instant per step —
    # doubled brackets would halve every apparent step span, the defect
    # class the flight recorder's auto-suppression exists for.
    if rec is not None:
        try:
            from horovod_tpu_torch.common import basics
            tl = basics.timeline()
            if tl is not None:
                tl.mark_step(rec["step"])
        except Exception:  # noqa: BLE001
            pass


def step_report(last=1):
    """The most recent completed step record (``last=1``, default), or the
    latest ``last`` records as a list, or every retained record
    (``last=None``). Returns None / [] before the first completed step."""
    recs = _ledger.records(last=last)
    if last == 1:
        return recs[-1] if recs else None
    return recs


def digest(last=32):
    """Compact beacon fields for the telemetry plane
    (:mod:`horovod_tpu_torch.telemetry.digest`): current step + when it closed,
    recent wall/attribution means — the step-lag and stall inputs of the
    job health model. Bounded to the last ``last`` records."""
    recs = _ledger.records(last=last)
    out = {"enabled": armed, "steps": len(recs)}
    if not recs:
        return out
    latest = recs[-1]
    out["step"] = latest["step"]
    out["step_t"] = latest["t"]
    out["epoch"] = latest["epoch"]
    walls = [r["wall_s"] for r in recs]
    out["wall_mean_s"] = round(sum(walls) / len(walls), 6)
    att = {}
    for cat in CATEGORIES + ("compute",):
        att[cat] = round(
            sum(r["attribution"].get(cat, 0.0) for r in recs) / len(recs),
            6)
    out["attribution_mean_s"] = att
    mfus = [r["mfu"] for r in recs if "mfu" in r]
    if mfus:
        out["mfu_mean"] = round(sum(mfus) / len(mfus), 5)
    return out


def step_report_summary():
    """Aggregate over the retained records: mean/p50 wall, per-category
    attribution means, mean MFU — the bench.py ride-along field."""
    return _ledger.summary()


def set_flops_per_step(flops, source="explicit"):
    """Model FLOPs per training step for the MFU/roofline fields —
    explicit (``hvd.set_flops_per_step(6*N*B*L)``) or counted over one
    step by ``roofline.flops_of_step(fn)``."""
    _ledger.set_flops_per_step(flops, source)


def reset_window():
    if _ledger is not None:
        _ledger.reset_window()
    try:
        from horovod_tpu_torch.profile import watchdog
        watchdog.reset()
    except Exception:  # noqa: BLE001
        pass


def configure(config):
    """Apply a Config's step-profiler knobs (called by ``basics.init``)."""
    global _report_path, _capture_armed
    set_enabled(config.step_profiler)
    if config.step_report_file:
        _report_path = config.step_report_file
    _ledger._rank = _env_int("HOROVOD_RANK", 0)
    hist = config.profile_history
    if hist != _ledger._records.maxlen:
        with _ledger._lock:
            _ledger._records = collections.deque(_ledger._records,
                                                 maxlen=max(hist, 8))
    if config.profile_steps:
        from horovod_tpu_torch.profile import capture
        if capture.configure_window(config.profile_steps,
                                    config.profile_dir):
            _capture_armed = True
    from horovod_tpu_torch.profile import watchdog
    watchdog.configure(config)


# Feed step markers into the ledger regardless of the flight recorder's
# own arming (the profiler and the forensics ring have independent
# switches; the marker call sites are shared).
from horovod_tpu_torch.flight import recorder as _flight_recorder  # noqa: E402

_flight_recorder.set_step_listener(on_step)
