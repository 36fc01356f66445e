"""The per-rank goodput ledger: wall-clock conservation state machine.

Port of the JAX package's ``goodput/ledger.py``: the same categories,
transitions, fake-clock seam and module wrappers.

Decomposes total job wall time into ``productive_compute`` plus seven
named badput categories, every second booked exactly once:

- ``init_compile``        start of accounting -> first step boundary
                          (bootstrap, the kernels' first builds and
                          launches, the first step's setup).
- ``rendezvous_recovery`` elastic reset -> first post-restore step
                          boundary, plus the aborted open window that the
                          failure destroyed (its work is lost — that is
                          what makes it badput, not productive time).
- ``checkpoint_commit``   seconds spent inside elastic ``State.commit`` /
                          checkpoint saves (reported by the commit site,
                          consumed from the window it occurred in).
- ``straggler_wait``      per-step excess of the comm-side attribution
                          (``host_dispatch + collective``) over its own
                          rolling median — the slow-peer tax the step
                          watchdog names ranks for. Floored at
                          ``STRAGGLER_FLOOR_S`` so scheduler jitter on a
                          healthy run does not accumulate into badput.
- ``cross_wait_comm``     the step profiler's ``cross_wait`` attribution:
                          exposed (non-overlapped) cross-slice DCN wait.
- ``autopilot_trial``     step time spent while an autopilot trial/probe
                          had the knobs off their resting point — booked
                          instead of productive_compute for those steps.
- ``wedge_idle``          time in a window the telemetry health model
                          called ``stalled`` (step clock stopped) that
                          never produced a step.

**Conservation guarantee**: ``productive_compute + sum(badput)`` equals
the measured wall (``now - start``) within 1% at every snapshot — by
construction, since every transition books exactly the gap since the
previous mark, and the live tail is attributed virtually at read time.
``snapshot()`` computes the conservation error; ``assert_conservation()``
raises on violation (integration bugs: double-booked gaps, mixed clocks).

The class is a fake clock seam end to end — every mutator takes
``now=None`` (tests drive it with explicit times, production passes
nothing and gets ``time.monotonic()``) — the same pattern as
:class:`horovod_tpu_torch.telemetry.slo.SloEngine`. Module-level wrappers gate
on ``armed`` and never raise (observability must never fail the job).
"""

import threading
import time

from horovod_tpu_torch.common.config import _env_bool, _env_float

PRODUCTIVE = "productive_compute"
BADPUT_CATEGORIES = ("init_compile", "rendezvous_recovery",
                     "checkpoint_commit", "straggler_wait",
                     "cross_wait_comm", "autopilot_trial", "wedge_idle")
CATEGORIES = (PRODUCTIVE,) + BADPUT_CATEGORIES

# Jitter floor for the straggler-wait rule: per-step comm excess below
# this is scheduler noise, not a straggler (the chaos-soak injected
# delays are 30-120ms, an order of magnitude above).
STRAGGLER_FLOOR_S = 0.005

# Rolling comm-baseline history for the straggler excess rule.
_COMM_HISTORY = 64

# Phase -> category a gap is booked to when no step record explains it.
_PHASE_CAT = {"init": "init_compile", "recovery": "rendezvous_recovery",
              "wedge": "wedge_idle", "train": PRODUCTIVE}


def _median(xs):
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


class GoodputLedger:
    """Category state machine over one rank's wall clock."""

    def __init__(self, straggler_floor_s=STRAGGLER_FLOOR_S):
        self._lock = threading.Lock()
        self._floor = float(straggler_floor_s)
        self._t0 = None
        self._mark = None
        self._phase = "init"
        self._acc = dict.fromkeys(CATEGORIES, 0.0)
        self._comm_hist = []
        self._commit_pending = 0.0
        self._trial = False
        self._saw_explicit = False
        self._steps = 0
        self._resets = 0
        self._recoveries = []       # (cause, observed_seconds) cross-check
        self._straggler_named = None

    # --- lifecycle ------------------------------------------------------

    def start(self, now=None):
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None:
                self._t0 = self._mark = now
                self._phase = "init"

    def started(self):
        return self._t0 is not None

    # --- transitions ----------------------------------------------------

    def _book(self, cat, dt):
        if dt > 0.0:
            self._acc[cat] += dt

    def on_step_boundary(self, rec=None, step=True, now=None):
        """One step-profiler boundary. ``rec`` is the closed window record
        (None when the marker only opened the first window); ``step`` is
        the caller's step argument — ``None`` auto marks are suppressed
        once an explicit step has been seen, mirroring the profile
        ledger's own rule so the two state machines agree on boundaries.
        """
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None:
                return
            if rec is None and step is None and self._saw_explicit:
                return
            if step is not None and step is not True:
                self._saw_explicit = True
            gap = max(now - self._mark, 0.0)
            if rec is None:
                # Marker opened a window: the gap is whatever phase we
                # were in (init_compile, rendezvous_recovery, ...).
                self._book(_PHASE_CAT[self._phase], gap)
            else:
                self._book_window_locked(gap, rec)
                self._steps += 1
            self._mark = now
            self._phase = "train"

    def _book_window_locked(self, gap, rec):
        """Decompose one closed step window of measured duration ``gap``
        using the profiler's attribution. Badput parts are clamped so the
        window books exactly ``gap`` — conservation by construction."""
        att = rec.get("attribution") or {}
        cross = max(float(att.get("cross_wait", 0.0)), 0.0)
        comm = max(float(att.get("host_dispatch", 0.0)), 0.0) \
            + max(float(att.get("collective", 0.0)), 0.0)
        straggler = 0.0
        if len(self._comm_hist) >= 8:
            excess = comm - _median(self._comm_hist)
            if excess > self._floor:
                straggler = excess
        self._comm_hist.append(comm)
        if len(self._comm_hist) > _COMM_HISTORY:
            self._comm_hist.pop(0)
        commit = min(self._commit_pending, gap)
        self._commit_pending -= commit
        badput = cross + straggler + commit
        if badput > gap > 0.0:
            scale = gap / badput
            cross, straggler, commit = (cross * scale, straggler * scale,
                                        commit * scale)
            badput = gap
        self._book("cross_wait_comm", cross)
        self._book("straggler_wait", straggler)
        self._book("checkpoint_commit", commit)
        self._book("autopilot_trial" if self._trial else PRODUCTIVE,
                   gap - badput)

    def on_reset(self, now=None):
        """Elastic reset: the open window is lost work. Book the gap to
        the current phase's category — except a live training window,
        whose destroyed partial step is recovery badput, not productive
        time — then enter the recovery phase."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None:
                return
            gap = max(now - self._mark, 0.0)
            cat = _PHASE_CAT[self._phase]
            self._book("rendezvous_recovery" if cat == PRODUCTIVE else cat,
                       gap)
            self._mark = now
            self._phase = "recovery"
            self._resets += 1
            self._comm_hist = []

    def note_recovery(self, cause, seconds):
        """Observed ``elastic_recovery_seconds`` sample — kept as a
        cross-check against the gap-booked ``rendezvous_recovery`` (the
        gap is authoritative; this records what the elastic wrapper saw).
        """
        with self._lock:
            self._recoveries.append((str(cause), float(seconds)))

    def note_commit(self, seconds):
        """Seconds spent in a checkpoint commit; consumed out of the
        window(s) it occurred in at the next boundary."""
        with self._lock:
            if seconds > 0.0:
                self._commit_pending += float(seconds)

    def note_wedge(self, now=None):
        """Telemetry stall verdict (step clock stopped) for this rank:
        the time since the last boundary stops counting as (future)
        productive. A step that still completes overrides this — a
        closed window is authoritative."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None or self._phase != "train":
                return
            self._phase = "wedge"

    def note_unwedged(self, now=None):
        """Health recovered without an elastic reset: book the wedge gap
        and resume training attribution."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None or self._phase != "wedge":
                return
            self._book("wedge_idle", max(now - self._mark, 0.0))
            self._mark = now
            self._phase = "train"

    def set_trial(self, active):
        """Autopilot trial window: step time while a probe has the knobs
        off their resting point books to ``autopilot_trial``."""
        with self._lock:
            self._trial = bool(active)

    def note_straggler(self, rank):
        """A watchdog straggler naming (evidence for the report CLI)."""
        with self._lock:
            self._straggler_named = rank

    # --- reads ----------------------------------------------------------

    def snapshot(self, now=None):
        """Point-in-time decomposition. The live tail (time since the
        last mark) is attributed virtually to the current phase so the
        categories always sum to the measured wall."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._t0 is None:
                return {"enabled": False}
            wall = max(now - self._t0, 0.0)
            acc = dict(self._acc)
            tail_cat = _PHASE_CAT[self._phase]
            if self._phase == "train" and self._trial:
                tail_cat = "autopilot_trial"
            acc[tail_cat] += max(now - self._mark, 0.0)
            steps = self._steps
            resets = self._resets
            recoveries = list(self._recoveries)
            named = self._straggler_named
            phase = self._phase
        accounted = sum(acc.values())
        err = abs(wall - accounted) / wall if wall > 0 else 0.0
        out = {
            "enabled": True,
            "wall_s": round(wall, 6),
            "phase": phase,
            "steps": steps,
            "resets": resets,
            "goodput_ratio": round(acc[PRODUCTIVE] / wall, 6)
            if wall > 0 else 1.0,
            "categories": {k: round(v, 6) for k, v in acc.items()},
            "badput_s": round(accounted - acc[PRODUCTIVE], 6),
            "conservation_error": round(err, 8),
        }
        if recoveries:
            out["recoveries_observed"] = [
                {"cause": c, "seconds": round(s, 6)} for c, s in recoveries]
        if named is not None:
            out["straggler_named"] = named
        return out

    def assert_conservation(self, now=None, tol=0.01):
        snap = self.snapshot(now)
        if not snap.get("enabled"):
            return snap
        err = snap["conservation_error"]
        if err > tol:
            raise AssertionError(
                f"goodput conservation violated: categories sum to "
                f"{sum(snap['categories'].values()):.6f}s vs wall "
                f"{snap['wall_s']:.6f}s (error {err:.4%} > {tol:.2%})")
        return snap


class ServingGoodput:
    """The serving-plane variant: goodput = in-SLO token-seconds.

    Each decode step contributes ``dt * tokens`` token-seconds (step wall
    weighted by tokens committed that step); the contribution counts as
    goodput when the step was taken with every declared SLO burn rate
    <= 1.0 (no SLO declared -> everything is in-SLO). Pure accumulator,
    fake-clock by construction (the caller supplies ``dt``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._token_s = 0.0
        self._in_slo_token_s = 0.0
        self._tokens = 0
        self._steps = 0

    def record_decode_step(self, dt_s, tokens, in_slo):
        if dt_s < 0 or tokens <= 0:
            return
        delta = float(dt_s) * int(tokens)
        with self._lock:
            self._token_s += delta
            if in_slo:
                self._in_slo_token_s += delta
            self._tokens += int(tokens)
            self._steps += 1

    def snapshot(self):
        with self._lock:
            total, good = self._token_s, self._in_slo_token_s
            tokens, steps = self._tokens, self._steps
        return {
            "token_seconds": round(total, 6),
            "in_slo_token_seconds": round(good, 6),
            "tokens": tokens,
            "steps": steps,
            "goodput_ratio": round(good / total, 6) if total > 0 else 1.0,
        }


# --- module singletons + armed-gated fail-soft wrappers -----------------
#
# Same shape as metrics/instruments and telemetry/slo: one bool the hot
# path reads, short critical sections, lazy imports for cross-module
# mirrors, and nothing here may raise into the training loop.

armed = _env_bool("HOROVOD_GOODPUT", True)
_ledger = GoodputLedger()
_serving = ServingGoodput()
_export_last = {}
_export_t = 0.0
_journal_t = 0.0

# Periodic cadences (seconds): metrics-counter export and the durable
# journal heartbeat. The journal flush is what makes a SIGKILLed run
# still leave a goodput summary behind.
_EXPORT_EVERY_S = 1.0
_JOURNAL_EVERY_S = _env_float("HOROVOD_GOODPUT_JOURNAL_S", 10.0)


def get_ledger():
    return _ledger


def reset():
    """Fresh module singletons (tests / forked soak workers)."""
    global _ledger, _serving, _export_last, _export_t, _journal_t, \
        _shutdown_done
    _ledger = GoodputLedger()
    _serving = ServingGoodput()
    _export_last = {}
    _export_t = 0.0
    _journal_t = 0.0
    _shutdown_done = False


def configure(config):
    """Arm the plane from a Config (called by ``basics.init``). Starts
    the wall clock — everything before the first step boundary books to
    ``init_compile``. Start-once: an elastic in-place re-init calls
    ``basics.init`` again, and the accumulated decomposition must
    survive it (the recovery it is accounting for IS the evidence)."""
    global armed
    armed = bool(config.goodput)
    if not armed or _ledger.started():
        return
    _ledger.start()
    # Finalize at true process exit only: basics.shutdown also runs on
    # every elastic in-place reset, where the run (and its journal) must
    # keep going.
    import atexit
    atexit.register(shutdown)
    try:
        from horovod_tpu_torch.flight import recorder as _flight
        if _flight.armed:
            _flight.record_event("goodput", what="armed")
    except Exception:  # noqa: BLE001
        pass


def on_step_boundary(rec, step=True):
    """Fed from the profile ledger's step listener."""
    if not armed:
        return
    try:
        now = time.monotonic()
        _ledger.on_step_boundary(rec, step=step, now=now)
        _export_metrics(now)
        _journal_heartbeat(now)
    except Exception:  # noqa: BLE001 — observability must never fail the job
        pass


def note_reset():
    if not armed:
        return
    try:
        _ledger.on_reset()
        from horovod_tpu_torch.flight import recorder as _flight
        if _flight.armed:
            _flight.record_event("goodput", what="reset")
    except Exception:  # noqa: BLE001
        pass


def note_recovery(cause, seconds):
    if not armed:
        return
    try:
        _ledger.note_recovery(cause, seconds)
    except Exception:  # noqa: BLE001
        pass


def note_commit(seconds):
    if not armed:
        return
    try:
        _ledger.note_commit(seconds)
    except Exception:  # noqa: BLE001
        pass


def note_wedge():
    if not armed:
        return
    try:
        _ledger.note_wedge()
    except Exception:  # noqa: BLE001
        pass


def note_unwedged():
    if not armed:
        return
    try:
        _ledger.note_unwedged()
    except Exception:  # noqa: BLE001
        pass


def set_trial(active):
    if not armed:
        return
    try:
        _ledger.set_trial(active)
    except Exception:  # noqa: BLE001
        pass


def note_straggler(rank):
    if not armed:
        return
    try:
        _ledger.note_straggler(rank)
    except Exception:  # noqa: BLE001
        pass


def record_serving_step(dt_s, tokens, in_slo):
    if not armed:
        return
    try:
        _serving.record_decode_step(dt_s, tokens, in_slo)
    except Exception:  # noqa: BLE001
        pass


def snapshot():
    """Current decomposition, or ``{"enabled": False}`` when off."""
    if not armed:
        return {"enabled": False}
    try:
        return _ledger.snapshot()
    except Exception:  # noqa: BLE001
        return {"enabled": False}


def serving_snapshot():
    if not armed:
        return {}
    try:
        return _serving.snapshot()
    except Exception:  # noqa: BLE001
        return {}


def wedge_from_rows(rows, rank):
    """Apply the telemetry health plane's stall verdicts to this rank's
    ledger: ``rows`` is the classified per-rank list a job view carries
    (each row has ``rank`` and ``state``). Pure decision + local effect;
    called from the telemetry agent tick."""
    if not armed:
        return
    try:
        for row in rows or ():
            if row.get("rank") != rank:
                continue
            if row.get("state") == "stalled":
                note_wedge()
            elif row.get("state") == "healthy":
                note_unwedged()
            return
    except Exception:  # noqa: BLE001
        pass


def _export_metrics(now):
    """Throttled delta export into ``goodput_seconds_total{category}``
    (counters only increment, so export the per-category deltas)."""
    global _export_t, _export_last
    if now - _export_t < _EXPORT_EVERY_S:
        return
    _export_t = now
    snap = _ledger.snapshot()
    if not snap.get("enabled"):
        return
    from horovod_tpu_torch.metrics import instruments as _metrics
    for cat, total in snap["categories"].items():
        delta = total - _export_last.get(cat, 0.0)
        if delta > 0.0:
            _metrics.record_goodput_seconds(cat, delta)
            _export_last[cat] = total


def _journal_heartbeat(now):
    """Throttled goodput summary into the durable run-history journal —
    the record a SIGKILLed run is left holding."""
    global _journal_t
    if now - _journal_t < _JOURNAL_EVERY_S:
        return
    _journal_t = now
    from horovod_tpu_torch.goodput import history as _history
    _history.journal_append("goodput", summary=_ledger.snapshot())


_shutdown_done = False


def shutdown():
    """Final flush: last goodput summary (plus the serving variant when
    it saw traffic) into the journal, optional per-rank summary file,
    run_end marker. Idempotent — a launched worker's clean exit path
    (``runner/task.py``) calls this explicitly before ``hvd.shutdown()``,
    and the atexit registration is the fallback for everything else."""
    global _shutdown_done
    if not armed or _shutdown_done:
        return
    _shutdown_done = True
    try:
        snap = _ledger.snapshot()
        extra = {}
        srv = _serving.snapshot()
        if srv.get("steps"):
            extra["serving"] = srv
        from horovod_tpu_torch.goodput import history as _history
        _history.journal_append("goodput", summary=snap, **extra)
        _history.journal_finalize(snap)
        _dump_rank_summary(snap, extra)
    except Exception:  # noqa: BLE001
        pass


def _dump_rank_summary(snap, extra):
    import json
    import os
    gdir = os.environ.get("HOROVOD_GOODPUT_DIR", "")
    if not gdir:
        return
    try:
        os.makedirs(gdir, exist_ok=True)
        rank = int(os.environ.get("HOROVOD_RANK", "0") or 0)
        path = os.path.join(gdir, f"goodput_r{rank:02d}.json")
        with open(path, "w") as f:
            json.dump({"rank": rank, **snap, **extra}, f, indent=1,
                      sort_keys=True)
    except (OSError, ValueError):
        pass
