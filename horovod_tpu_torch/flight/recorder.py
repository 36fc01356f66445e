"""Always-armed collective flight recorder: a fixed-size ring of structured
events, dumped as JSONL exactly when a run would otherwise leave nothing.

Port of the JAX package's ``flight/recorder.py``: the same ring, event
kinds, dump triggers, file names and JSONL schema, so
``flight.analyze`` of either package reads the other's dumps. An
always-on bounded event recorder whose per-rank dumps are merged after
the fact localizes which rank diverged; :mod:`horovod_tpu_torch.flight.
analyze` is the merge half.

Hot-path contract (the eager collective dispatch and the fusion runtime
call in here):

- one module-level bool gate (``recorder.armed``) — instrumentation sites
  read it and skip everything else when the recorder is off;
- preallocated slots: the ring is ``capacity`` fixed-length lists created
  up front; an append is one short lock, an index bump and field stores —
  no allocation, no I/O, no device read, nothing held across a collective;
- the per-process-set collective sequence number is assigned under the
  same lock as the append (one acquisition per event).

Event kinds: ``dispatch`` / ``complete`` / ``error`` (eager collectives and
fused buckets: op, process set, per-set ``seq``, bytes, signature, host
latency), ``fusion_enqueue`` / ``fusion_flush``, ``elastic``, ``stall``,
``profiler`` (watchdog findings), ``goodput``, ``serving`` and ``step``.
The control-plane (``negotiation``, ``kv_retry``/``kv_error``), ``chaos``
and autopilot kinds keep their JAX names for the analyzer; nothing in the
port records them yet.

Knobs: ``HOROVOD_FLIGHT_RECORDER`` (default on), ``HOROVOD_FLIGHT_CAPACITY``
(default 4096 events), ``HOROVOD_FLIGHT_DIR`` (dump directory, default
``flight_dumps``; ``hvdrun-torch --flight-dir`` propagates it).

Dump triggers (each writes one
``flight_<role>_r<rank>_p<pid>_b<boot>_<n>.jsonl``): the eager/fused
dispatch failure epilogue, the elastic restore and membership removal,
SIGTERM/atexit during an elastic launch, ``SIGUSR2`` on demand, and
``GET /debug/flight`` on the metrics scrape endpoint (no file — the ring
is served directly).

The ring is process-global and survives ``hvd.shutdown()`` / re-``init()``
cycles: elastic recovery re-initializes in place, and the events a
post-mortem needs are the ones from before the failure.
"""

import json
import os
import threading
import time
import zlib

# Shared env parsing (no import cycle: config imports only stdlib) —
# import-time arming and init-time configure() must read
# HOROVOD_FLIGHT_RECORDER identically.
from horovod_tpu_torch.common.config import _env_bool, _env_int
# Trace-context injection (no cycle: trace imports only common.config).
# Every ring event carries the ACTIVE trace ref, so flight.analyze can
# reconstruct one request/step across ranks keyed by the per-process-set
# collective seq.
from horovod_tpu_torch import trace as _trace

DEFAULT_CAPACITY = 4096
DEFAULT_DUMP_DIR = "flight_dumps"
# Runaway guards: a recovery storm may hit one failure epilogue many
# times. The cap is PER REASON (a storm of dispatch_error dumps must not
# spend the budget of the one later membership_abort/stall_shutdown the
# post-mortem actually needs), with a global backstop; every reason is
# also throttled to one dump per second.
MAX_DUMPS_PER_REASON = 8
MAX_DUMPS = 64
_DUMP_MIN_INTERVAL_S = 1.0

# The one-word hot-path gate: sites read
# ``recorder.armed`` and skip everything else when False.
armed = _env_bool("HOROVOD_FLIGHT_RECORDER", True)

# Per-process boot token: process identity for dumps. A pid alone can be
# recycled by the OS within one elastic run — the analyzer would then pin
# the replacement's events to the dead process's rank and drop them as
# ring-index duplicates, and a same-(rank, pid, n) dump file would
# OVERWRITE the victim's crash dump.
_BOOT = format(int(time.time() * 1e6) & 0xffffffff, "08x")

# Slot layout (fixed-length lists, preallocated):
_F_TS, _F_KIND, _F_OP, _F_PS, _F_SEQ, _F_BYTES, _F_SIG, _F_NAME, _F_DUR, \
    _F_WHAT, _F_TRACE = range(11)
_N_FIELDS = 11
_KEYS = ("t", "kind", "op", "ps", "seq", "bytes", "sig", "name", "dur",
         "what", "trace")


def _env_capacity():
    return _env_int("HOROVOD_FLIGHT_CAPACITY", DEFAULT_CAPACITY)


def _rank():
    # One process per rank in the port (JAX's process index is its cross
    # rank): the dumps are named and analyzed by HOROVOD_RANK.
    return _env_int("HOROVOD_RANK", 0)


def _host():
    """Host identity for the dump meta: pids are only unique per host, so
    the analyzer's process key is (host, pid). The launcher's host key
    beats gethostname — loopback multi-"host" launches alias one name."""
    h = os.environ.get("HOROVOD_HOST_KEY")
    if h:
        return h
    import socket
    try:
        return socket.gethostname()
    except OSError:
        return ""


_role = "worker"


def set_role(role):
    """Tag this process's dumps (``worker`` / ``driver``)."""
    global _role
    _role = role


class FlightRecorder:
    """The ring itself. Normally used through the module-level singleton
    (:func:`get`); tests construct small-capacity instances directly."""

    def __init__(self, capacity=None):
        self.capacity = max(int(capacity or _env_capacity()), 8)
        self._slots = [[None] * _N_FIELDS for _ in range(self.capacity)]
        self._idx = 0                   # total appends (monotonic)
        self._lock = threading.Lock()
        self._seq = {}                  # process-set label -> last seq
        self._auto_step = 0             # optimizer-wrapper step counter
        self.saw_explicit_step = False  # explicit marks suppress auto marks

    # --- recording (the hot path) --------------------------------------

    def record_dispatch(self, op, ps, nbytes, sig, name=None):
        """One collective dispatch; assigns and returns the per-process-set
        monotonic sequence number."""
        with self._lock:
            seq = self._seq.get(ps, 0) + 1
            self._seq[ps] = seq
            s = self._slots[self._idx % self.capacity]
            # kind is the slot's commit marker: cleared FIRST, stored
            # LAST. The post-timeout unlocked read in events() may observe
            # a mid-append slot; with kind=None it reads as torn and is
            # dropped — never as a hybrid of this event's leading fields
            # and the previous occupant's trailing ones.
            s[_F_KIND] = None
            self._idx += 1
            s[_F_TS] = time.time()
            s[_F_OP] = op
            s[_F_PS] = ps
            s[_F_SEQ] = seq
            s[_F_BYTES] = nbytes
            s[_F_SIG] = sig
            s[_F_NAME] = name
            s[_F_DUR] = None
            s[_F_WHAT] = None
            s[_F_TRACE] = _trace.get_active()
            s[_F_KIND] = "dispatch"
        return seq

    def record_complete(self, op, ps, seq, dur):
        """Successful completion of the dispatch that got ``seq``; ``dur``
        is the host-side dispatch latency in seconds."""
        self.record_event("complete", op=op, ps=ps, seq=seq, dur=dur)

    def record_event(self, kind, op=None, ps=None, seq=None, nbytes=None,
                     sig=None, name=None, dur=None, what=None, trace=None):
        with self._lock:
            s = self._slots[self._idx % self.capacity]
            s[_F_KIND] = None       # commit marker: see record_dispatch
            self._idx += 1
            s[_F_TS] = time.time()
            s[_F_OP] = op
            s[_F_PS] = ps
            s[_F_SEQ] = seq
            s[_F_BYTES] = nbytes
            s[_F_SIG] = sig
            s[_F_NAME] = name
            s[_F_DUR] = dur
            s[_F_WHAT] = what
            # Explicit ref (the serving engine passes its request's tid —
            # handler threads never hold the active ref) beats the
            # thread-local active trace.
            s[_F_TRACE] = trace if trace is not None \
                else _trace.get_active()
            s[_F_KIND] = kind

    # --- reading -------------------------------------------------------

    def events(self):
        """Ring contents oldest-first as dicts (None fields omitted), each
        carrying its global append index ``i`` so overlapping dumps from
        one process can be merged without double counting.

        Bounded, not blocking: dumps run from signal handlers, which the
        interpreter executes on the MAIN thread between bytecodes — if the
        signal landed while that same thread held ``_lock`` inside an
        append, a blocking acquire would self-deadlock. After the timeout
        the ring is read unlocked: a torn in-progress row is acceptable
        forensics, a wedged shutdown handler is not."""
        locked = self._lock.acquire(timeout=0.5)
        try:
            idx = self._idx
            count = min(idx, self.capacity)
            rows = [list(self._slots[(idx - count + j) % self.capacity])
                    for j in range(count)]
        finally:
            if locked:
                self._lock.release()
        out = []
        for j, row in enumerate(rows):
            e = {"i": idx - count + j}
            for k, v in zip(_KEYS, row):
                if v is not None:
                    e[k] = v
            out.append(e)
        return out

    def max_seq(self):
        # Same bounded-acquire discipline as events() (signal-handler
        # dumps); an unlocked dict copy can race a concurrent insert, so
        # retry once on the (rare) mutation error.
        locked = self._lock.acquire(timeout=0.5)
        try:
            for _ in range(2):
                try:
                    return dict(self._seq)
                except RuntimeError:
                    continue
            return {}
        finally:
            if locked:
                self._lock.release()

    def appended(self):
        # A torn-read-tolerant peek: dump()'s emptiness check runs from
        # signal handlers and must not acquire the lock.
        return self._idx

    def dropped(self):
        return max(0, self._idx - self.capacity)

    def next_auto_step(self):
        with self._lock:
            self._auto_step += 1
            return self._auto_step

    def meta(self, reason=None):
        m = {"kind": "meta", "rank": _rank(), "pid": os.getpid(),
             "host": _host(), "boot": _BOOT, "role": _role,
             "capacity": self.capacity,
             "appended": self.appended(), "dropped": self.dropped(),
             "max_seq": self.max_seq(), "ts": round(time.time(), 6)}
        if reason is not None:
            m["reason"] = reason
        return m

    def summary(self):
        """Compact evidence dict for bench records / progress streams:
        event counts by kind, per-set max seq, step-span stats."""
        events = self.events()
        by_kind = {}
        step_ts = []
        for e in events:
            # .get: a torn (mid-append, lock-timeout) row may lack fields.
            kind = e.get("kind")
            if kind is None:
                continue
            by_kind[kind] = by_kind.get(kind, 0) + 1
            if kind == "step" and "t" in e:
                step_ts.append((e["t"], e.get("what") == "auto"))
        # Explicit marks win over auto ones (see step_marker) — mixing
        # the two counters would split spans.
        explicit = [t for t, auto in step_ts if not auto]
        step_ts = explicit if explicit else [t for t, _ in step_ts]
        spans = [b - a for a, b in zip(step_ts, step_ts[1:])]
        return {
            "enabled": armed,
            "appended": self.appended(),
            "dropped": self.dropped(),
            "capacity": self.capacity,
            "by_kind": by_kind,
            "max_seq": self.max_seq(),
            "steps": {"count": len(step_ts),
                      "mean_span_s": round(sum(spans) / len(spans), 6)
                      if spans else None},
        }


_recorder = None
_recorder_lock = threading.Lock()


def get():
    """The process-global recorder (created on first use so the capacity
    env is read when the process actually records)."""
    global _recorder
    r = _recorder
    if r is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
            r = _recorder
    return r


def set_enabled(value):
    global armed
    armed = bool(value)


def enabled():
    return armed


# --- module-level recording API (what the instrumented sites call) --------

def record_dispatch(op, ps, nbytes, sig, name=None):
    if not armed:
        return None
    return get().record_dispatch(op, ps, nbytes, sig, name)


def record_complete(op, ps, seq, dur):
    if not armed:
        return
    get().record_complete(op, ps, seq, dur)


def record_event(kind, **fields):
    if not armed:
        return
    get().record_event(kind, **fields)


# Step-boundary listener (the step profiler's ledger registers here):
# step markers are the shared step-clock call sites, and the profiler has
# its own arming switch independent of the forensics ring — so the
# listener fires BEFORE the `armed` gate. One slot, set at import by
# horovod_tpu_torch.profile.ledger; a listener that raises is the listener's
# bug to contain (the ledger wraps itself in try/except).
_step_listener = None


def set_step_listener(fn):
    global _step_listener
    _step_listener = fn


def step_marker(step=None):
    """User/optimizer step annotation: ``hvd.step_marker(step)``. With no
    argument an internal monotonic counter supplies the step (the
    optimizer-wrapper auto-annotation path). Once any explicit step has
    been marked, auto marks are suppressed — under torch+elastic both the
    optimizer's ``step()`` and ``State.commit`` fire per training step,
    and interleaving two counters would halve every analyzed step span."""
    listener = _step_listener
    if listener is not None:
        listener(step)
    if not armed:
        return
    r = get()
    if step is None:
        if r.saw_explicit_step:
            return
        # Tagged so analyzers can drop auto marks when explicit ones
        # exist: under torch+elastic the optimizer's auto mark for step 1
        # lands BEFORE the first commit sets saw_explicit_step.
        seq = r.next_auto_step()
        # Rotate the per-step training trace BEFORE recording the marker,
        # so the step event itself (and every ops-layer span/dispatch
        # until the next marker) lands under the NEW step's trace.
        _trace.step_trace(seq)
        r.record_event("step", seq=seq, what="auto")
    else:
        try:
            step = int(step)
        except (TypeError, ValueError):
            return          # forensics must never fail the job
        r.saw_explicit_step = True
        _trace.step_trace(step)
        r.record_event("step", seq=step)


def dtype_name(dtype):
    """A dtype spelled as JAX spells it (``float32``, ``bfloat16``):
    ``str(torch.float32)`` is ``torch.float32``, and the signature hash
    must be the same in both packages for the same shapes and dtypes."""
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


def signature(tensors):
    """Stable (cross-process, PYTHONHASHSEED-proof) signature hash of a
    tensor set: crc32 over the (shape, dtype) string, the dtype spelled as
    JAX spells it — equal shapes and dtypes hash equal in both packages."""
    s = ";".join(f"{tuple(getattr(t, 'shape', ()))}:"
                 f"{dtype_name(getattr(t, 'dtype', ''))}" for t in tensors)
    return format(zlib.crc32(s.encode()), "08x")


def events():
    return get().events()


def summary():
    return get().summary()


# Includes "chaos": a run that only saw injections still deserves an
# atexit dump. analyze.py keeps a narrower set under the same name —
# there, injections must not match themselves as downstream anomalies.
# "autopilot_remediate" likewise: a controller-initiated removal is
# post-mortem material, and the driver's ring may hold ONLY its ack
# trail (no crash/stall) — without this the runbook's rejected_*/applied
# evidence never reaches disk on a remediation-only run.
_ANOMALY_KINDS = ("error", "stall", "kv_error", "chaos",
                  "autopilot_remediate")
_ANOMALY_ELASTIC = ("abort", "restore")


def has_anomaly():
    """Does the ring hold anything a post-mortem would care about?
    Gates the atexit dump: a CLEAN elastic teardown needs no forensics
    file, a teardown after an abort/restore/error/stall does."""
    r = _recorder
    if r is None:
        return False
    for e in r.events():
        # .get: events() may surface a torn (mid-append, lock-timeout)
        # row with no "kind" — the atexit gate must never raise.
        kind = e.get("kind")
        if kind in _ANOMALY_KINDS:
            return True
        if kind == "elastic" and e.get("what") in _ANOMALY_ELASTIC:
            return True
    return False


def digest():
    """Compact beacon fields for the cluster telemetry plane's digest
    (ROADMAP: A16's second half): anomaly counts by kind plus the
    per-process-set max collective seq — the cross-rank desync key the
    job health model compares against the fleet median. Reads the live
    ring off the hot path (the beacon thread), never raises."""
    r = _recorder
    if r is None or not armed:
        return {"enabled": armed, "anomalies": 0}
    anomalies = 0
    by_kind = {}
    for e in r.events():
        kind = e.get("kind")
        if kind in _ANOMALY_KINDS:
            key = kind
        elif kind == "elastic" and e.get("what") in _ANOMALY_ELASTIC:
            key = f"elastic_{e.get('what')}"
        else:
            continue
        anomalies += 1
        by_kind[key] = by_kind.get(key, 0) + 1
    return {"enabled": True, "anomalies": anomalies, "by_kind": by_kind,
            "max_seq": r.max_seq(), "dropped": r.dropped()}


def render_jsonl(reason=None):
    """Meta line + every ring event as JSONL (the ``/debug/flight``
    payload and the dump file body)."""
    return _render(get(), reason)


def _render(r, reason=None):
    # Renders from a recorder reference the caller already holds: dump()
    # runs from signal handlers, and routing it through get() would reach
    # the unbounded `with _recorder_lock:` in the create-on-first-use
    # path — a self-deadlock if the signal lands while the main thread
    # holds _recorder_lock inside configure().
    lines = [json.dumps(r.meta(reason))]
    lines.extend(json.dumps(e) for e in r.events())
    return "\n".join(lines) + "\n"


# --- dumps ----------------------------------------------------------------

_dump_lock = threading.Lock()
_dump_count = 0                 # BUDGET: non-forced dumps charged vs MAX_DUMPS
_dump_seq = 0                   # FILENAME ordinal: monotonic, never reused
_dump_counts = {}               # reason -> dumps written for it
_last_dump = {}                 # reason -> monotonic time of last dump


def dump_dir():
    return os.environ.get("HOROVOD_FLIGHT_DIR") or DEFAULT_DUMP_DIR


def default_collection_dir(output_filename=None):
    """The defaulted elastic collection directory. ONE definition: the
    driver's disruption markers and every worker's dumps must resolve the
    same directory (launch.build_worker_env and the elastic driver both
    call this) or the analyzer loses the kill-to-membership-change
    correlation."""
    return os.path.join(output_filename or ".", DEFAULT_DUMP_DIR)


def dump(reason, directory=None, force=False):
    """Write the ring to
    ``<dir>/flight_<role>_r<rank>_p<pid>_b<boot>_<n>.jsonl``.
    Returns the path, or None when skipped (recorder off, empty ring,
    per-reason throttle, or the MAX_DUMPS runaway guard). Never raises —
    a dump is forensics, not a failure path of its own."""
    global _dump_count, _dump_seq
    r = _recorder
    if r is None or r.appended() == 0:
        return None
    if not armed and not force:
        # The off switch covers the dump sites too (stall/abort/error
        # paths call this unconditionally); an explicit force (SIGUSR2,
        # the chaos-crash last words, tests) still writes.
        return None
    try:
        now = time.monotonic()
        # Bounded for the same signal-handler reason as events(): a
        # SIGTERM landing inside another dump must not self-deadlock —
        # losing one overlapping dump is fine.
        if not _dump_lock.acquire(timeout=0.5):
            return None
        try:
            prev_last = _last_dump.get(reason)
            if not force:
                # Forced dumps (SIGUSR2, chaos-crash last words, tests)
                # are operator/crash-driven and never charged: a runbook
                # kill -USR2 loop must not exhaust MAX_DUMPS and starve
                # the one later membership_abort the post-mortem needs.
                if _dump_count >= MAX_DUMPS \
                        or _dump_counts.get(reason, 0) \
                        >= MAX_DUMPS_PER_REASON:
                    return None
                if prev_last is not None \
                        and now - prev_last < _DUMP_MIN_INTERVAL_S:
                    return None
                _dump_counts[reason] = _dump_counts.get(reason, 0) + 1
                _dump_count += 1
            _last_dump[reason] = now
            # Filename ordinal is separate from the budget counter and is
            # never rolled back: reusing an index after a failed write
            # would open(path, "w") over a concurrent dump's file.
            n = _dump_seq
            _dump_seq += 1
        finally:
            _dump_lock.release()
        try:
            d = directory or dump_dir()
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{_role}_r{_rank()}_p{os.getpid()}"
                   f"_b{_BOOT}_{n:02d}.jsonl")
            with open(path, "w") as f:
                f.write(_render(r, reason))
            return path
        except Exception:  # noqa: BLE001
            # Failed writes must not burn the dump budget or the 1s
            # throttle window: a temporarily full/unwritable volume would
            # otherwise silence the one later dump (membership_abort,
            # stall_shutdown) the post-mortem needs. Bounded acquire,
            # same rationale as above.
            if _dump_lock.acquire(timeout=0.5):
                try:
                    if not force:
                        _dump_count = max(0, _dump_count - 1)
                        _dump_counts[reason] = max(
                            0, _dump_counts.get(reason, 1) - 1)
                    if prev_last is None:
                        _last_dump.pop(reason, None)
                    else:
                        _last_dump[reason] = prev_last
                finally:
                    _dump_lock.release()
            return None
    except Exception:  # noqa: BLE001 — forensics must never fail the job
        return None


def driver_mark(version, removed, hosts, directory=None):
    """Driver-side disruption marker appended to ``driver_events.jsonl``
    in the collection directory: the analyzer correlates worker dumps with
    the membership change that triggered them (which hosts left, when)."""
    if not armed:
        # --no-flight-recorder must not leave a flight_dumps/ directory
        # behind: workers record nothing, so the marker has nothing to
        # correlate anyway.
        return
    try:
        d = directory or dump_dir()
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "driver_events.jsonl"), "a") as f:
            f.write(json.dumps({
                "kind": "driver_disruption", "version": int(version),
                "removed": sorted(removed), "hosts": sorted(hosts),
                "t": round(time.time(), 6)}) + "\n")
    except OSError:
        pass


# --- configuration + crash hooks ------------------------------------------

def configure(config):
    """Apply a :class:`horovod_tpu_torch.common.config.Config`'s flight knobs
    (called by ``basics.init``). The ring itself is never cleared here —
    elastic in-place re-init must keep pre-failure events; a CHANGED
    capacity reallocates (fresh ring)."""
    global _recorder
    set_enabled(config.flight)
    if config.flight_dir:
        os.environ["HOROVOD_FLIGHT_DIR"] = config.flight_dir
    with _recorder_lock:
        cap = max(int(config.flight_capacity), 8)
        if _recorder is not None and _recorder.capacity != cap:
            _recorder = FlightRecorder(capacity=cap)
        elif _recorder is None:
            _recorder = FlightRecorder(capacity=cap)
    if config.flight:
        install_crash_hooks(elastic=bool(os.environ.get("HOROVOD_ELASTIC")))


_hooks_installed = False


def install_crash_hooks(elastic=False):
    """SIGUSR2 → on-demand dump (always). Under an elastic launch also
    SIGTERM (the driver terminates removed-host workers with it — today
    they die silent) and atexit (elastic teardown paths that do reach
    interpreter finalization). Idempotent; signal installation is
    best-effort — only the main thread may install handlers, and an
    embedded interpreter may refuse."""
    global _hooks_installed
    if _hooks_installed:
        return
    _hooks_installed = True
    import signal

    try:
        def _on_usr2(signum, frame):
            dump("sigusr2", force=True)

        signal.signal(signal.SIGUSR2, _on_usr2)
    except (ValueError, OSError, AttributeError):
        pass
    if not elastic:
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            dump("sigterm")
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                # A supervisor that deliberately ignored SIGTERM must
                # keep that behavior — dump, swallow, survive.
                return
            else:
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
    except (ValueError, OSError):
        pass
    import atexit
    atexit.register(lambda: dump("atexit") if has_anomaly() else None)
