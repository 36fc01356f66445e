"""Horovod Timeline: Chrome-tracing profile of collective activity.

Port of the JAX package's ``timeline.py`` (reference:
horovod/common/timeline.cc + docs/timeline.rst): one chrome://tracing JSON
per process covering the collectives it dispatches, started and stopped at
run time (``hvd.start_timeline`` / ``hvd.stop_timeline``, or
``HOROVOD_TIMELINE`` at ``hvd.init()``), and written by Python when it
stops; the native writer is ROADMAP A19. JAX feeds a queue that a writer
thread moves into the event list until the file is written; here an event
is one append to that list (atomic under the GIL), so no other thread
wakes for it on the dispatch path.

Phases: the host span of every eager collective and fused bucket (``X``
events, category = the op kind, e.g. ``ALLREDUCE``), the STEP instants the
step profiler paints at each step boundary, cycle marks
(``--timeline-mark-cycles``), negotiate spans, the metrics registry's
totals as counter events (``ph: "C"``), and, on the GPU, each fused
bucket's device span (category ``execute``) from the CUDA events recorded
on the fusion stream, read at the step boundary and placed on this
timeline's perf-counter axis through a device anchor taken when the
timeline starts. The first event is always ``clock_sync``: the wall-clock
anchor of ts = 0 that ``flight.analyze --merge-timeline`` rebases on.

:meth:`Timeline.profile` captures a ``torch.profiler`` window around the
enclosed steps and ingests the exported Chrome trace's device kernels and
``hvd::`` annotations into this timeline (JAX ingests its XPlane trace).
"""

import collections
import json
import os
import threading
import time
from contextlib import contextmanager


class Timeline:
    def __init__(self, file_path, mark_cycles=False, device=None):
        self.file_path = file_path
        self.mark_cycles = mark_cycles
        self._closed = False
        self._t0 = time.perf_counter_ns()
        # Wall-clock anchor of ts=0, captured at the same instant as _t0:
        # the flight recorder's events run on time.time(), this timeline
        # on perf_counter — the clock_sync metadata event below is what
        # lets the two merge onto one axis (flight.analyze --merge-timeline).
        self.wall_t0_us = time.time() * 1e6
        self._events = collections.deque()
        self._emit_clock_sync()
        # Device anchor (GPU): a timing event and the host instant it
        # completed at, taken once here — the one wait this plane makes,
        # at start, never per event. Device spans are placed at
        # anchor_us + anchor.elapsed_time(event).
        self._anchor = None
        if device is not None and getattr(device, "type", "") == "cuda":
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            ev.synchronize()
            self._anchor = (ev, self._now_us())

    def _emit_clock_sync(self):
        """First event of every trace: the wall-clock anchor, a metadata
        event (invisible as a span, machine-readable by the merge)."""
        self._events.append({"name": "clock_sync", "ph": "M", "cat": "clock",
                         "ts": 0.0, "pid": 0, "tid": 0,
                         "args": {"wall_t0_us": self.wall_t0_us}})

    # --- recording -----------------------------------------------------
    def _now_us(self):
        return (time.perf_counter_ns() - self._t0) / 1000.0

    def record(self, name, phase, cat, ts_us, dur_us=None, args=None,
               tid=None):
        if self._closed:
            return
        if tid is None:
            tid = threading.get_ident() % 100000
        ev = {"name": name, "ph": phase, "cat": cat, "ts": ts_us,
              "pid": 0, "tid": tid}
        if dur_us is not None:
            ev["dur"] = dur_us
        if args:
            ev["args"] = args
        self._events.append(ev)

    @contextmanager
    def op_span(self, name, op_kind):
        """Complete-event span around one eager collective dispatch."""
        start = self._now_us()
        try:
            yield
        finally:
            self.record(name or op_kind, "X", op_kind, start,
                        dur_us=self._now_us() - start)

    def device_span(self, name, start_event, end_event, args=None):
        """A fused bucket's device span from its two completed CUDA timing
        events (the step profiler reads them at the step boundary, after
        ``query()`` says they are done — never a wait), placed on this
        timeline's axis through the start anchor. Category ``execute``,
        on a device row of its own. Returns False without an anchor."""
        if self._anchor is None or self._closed:
            return False
        ev0, t0_us = self._anchor
        ts = t0_us + ev0.elapsed_time(start_event) * 1e3
        dur = start_event.elapsed_time(end_event) * 1e3
        self.record(name, "X", "execute", ts, dur_us=dur, args=args,
                    tid=100000)
        return True

    def mark_cycle(self):
        if self.mark_cycles:
            self.record("CYCLE", "i", "cycle", self._now_us(),
                        args={"s": "g"})

    def mark_step(self, step):
        """Step bracket: one instant per training-step boundary (the step
        profiler's marker sites feed this), so op spans group by step in
        the same view as the flight analyzer's per-step reconstruction."""
        self.record(f"STEP {step}" if step is not None else "STEP", "i",
                    "step", self._now_us(), tid=0)

    def record_counter(self, name, value, ts_us=None):
        """Chrome-trace COUNTER event ("ph": "C"): one sample of a named
        series, rendered by chrome://tracing / Perfetto as a counter track
        alongside the op spans. The metrics registry emits its totals
        through this (metrics.emit_timeline_counters)."""
        if self._closed:
            return
        ts = ts_us if ts_us is not None else self._now_us()
        self.record(name, "C", "metrics", ts, args={"value": value}, tid=0)

    def negotiate(self, name, op_kind, dur_us):
        """Host-side coordination time (size exchange for ragged ops etc.) —
        the surviving analog of NEGOTIATE_* (reference: timeline.cc)."""
        self.record(f"NEGOTIATE_{op_kind}:{name}", "X", "negotiate",
                    self._now_us() - dur_us, dur_us=dur_us)

    # --- the profiler's trace ------------------------------------------
    #
    # The eager spans above are the host side. torch.profiler sees the
    # device: the CUDA kernels of each step (the flash kernels, the
    # scale pack/unpack kernels, NCCL's) and the hvd:: record_function
    # annotations every dispatch opens while a profiler runs. profile()
    # captures such a trace and merges the relevant events into THIS
    # timeline, rebased onto its clock — one chrome://tracing file for
    # the host spans and the device lanes.

    @contextmanager
    def profile(self, logdir=None):
        """Capture a ``torch.profiler`` trace around the enclosed steps and
        ingest its device and ``hvd::`` spans into this timeline."""
        import tempfile

        import torch.profiler as tp

        own_dir = logdir is None
        logdir = logdir or tempfile.mkdtemp(prefix="hvd_torch_trace_")
        os.makedirs(logdir, exist_ok=True)
        activities = [tp.ProfilerActivity.CPU]
        import torch
        if torch.cuda.is_available():
            activities.append(tp.ProfilerActivity.CUDA)
        start_us = self._now_us()
        path = os.path.join(logdir, "trace.json")
        try:
            with tp.profile(activities=activities) as prof:
                yield
            prof.export_chrome_trace(path)
            self.ingest_profiler_trace(path, reference_us=start_us)
        finally:
            if own_dir:
                import shutil
                shutil.rmtree(logdir, ignore_errors=True)

    def ingest_profiler_trace(self, path, reference_us=None):
        """Merge an exported ``torch.profiler`` Chrome trace (a file, or a
        directory holding ``*.json``) into this timeline.

        Keeps the ``hvd::`` annotations and the device-lane events
        (kernels, memcpys, NCCL), drops the Python and ATen host noise.
        Timestamps are rebased so the trace's first kept event lands at
        ``reference_us`` on this timeline's clock. Returns the number of
        events ingested."""
        import glob

        if os.path.isdir(path):
            paths = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                     recursive=True))
            if not paths:
                return 0
            path = paths[-1]
        with open(path) as f:
            trace = json.load(f)
        events = trace.get("traceEvents", []) if isinstance(trace, dict) \
            else trace
        picked = []
        for e in events:
            if e.get("ph") != "X":
                continue
            name = str(e.get("name", ""))
            cat = str(e.get("cat", ""))
            device_lane = cat in ("kernel", "gpu_memcpy", "gpu_memset",
                                  "gpu_user_annotation")
            if not (name.startswith("hvd::") or device_lane):
                continue
            picked.append((e, cat, name))
        if not picked:
            return 0
        t_min = min(float(e.get("ts", 0.0)) for e, _, _ in picked)
        offset = (reference_us if reference_us is not None
                  else self._now_us()) - t_min
        for e, cat, name in picked:
            label = f"{cat}: {name}" if cat else name
            # stable per-lane tid so chrome://tracing keeps device lanes
            # apart from the host rows
            tid = (hash((e.get("pid"), e.get("tid"))) % 90000) + 100001
            self.record(label, "X", "profiler",
                        float(e.get("ts", 0.0)) + offset,
                        dur_us=float(e.get("dur", 0.0)), tid=tid)
        return len(picked)

    # --- writer --------------------------------------------------------
    def close(self):
        if self._closed:
            return
        self._closed = True
        os.makedirs(os.path.dirname(os.path.abspath(self.file_path)),
                    exist_ok=True)
        with open(self.file_path, "w") as f:
            json.dump({"traceEvents": list(self._events),
                       "displayTimeUnit": "ms"}, f)
