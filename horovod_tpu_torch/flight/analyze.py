"""Flight-dump forensics: merge per-rank rings, localize the failure.

``python -m horovod_tpu_torch.flight.analyze <dir>`` merges every per-rank dump
(``flight_*.jsonl``, written by :mod:`horovod_tpu_torch.flight.recorder`) plus any
chaos ledgers / driver disruption markers in the directory, and reports:

- **desync**: per process set, each rank's max collective sequence number;
  when they differ, the lagging ranks, the first unmatched sequence number
  and the first diverging collective (op/name/signature) are named — the
  per-rank-merge analysis arxiv 2510.20171 describes as the load-bearing
  tool at scale;
- **killed**: ranks whose dumps end in a chaos ``crash`` (the victim dumps
  its ring as its last act) or that a driver disruption marker removed;
- **stragglers**: per-op host-latency skew across ranks (mean dispatch
  latency vs the cross-rank median), ranked;
- **steps**: per-step time breakdown reconstructed from step markers
  (wall span, collective count/bytes/host-latency within each span);
- **chaos**: every injection correlated with the first downstream anomaly
  (dispatch error, stall finding, elastic abort/restore) across all ranks.

``--trace out.json`` additionally writes a merged Chrome trace — one track
per rank — loadable in Perfetto / chrome://tracing.

Port of the JAX package's ``flight/analyze.py``, line for line: both
packages' recorders write the same schema and signatures, so either
analyzer reads either package's dumps. The module is dependency-free and
importable: callers use :func:`load_dir` / :func:`analyze` /
:func:`write_trace` directly.
"""

import argparse
import json
import os
import re
import sys

# Deliberately NARROWER than recorder._ANOMALY_KINDS: "chaos" is excluded
# here because causation matching scans for the first anomaly AFTER an
# injection — if injections themselves counted as anomalies, each one would
# match itself (or a sibling injection) as its own downstream effect.
_ANOMALY_KINDS = ("error", "stall", "kv_error")
_ANOMALY_ELASTIC = ("abort", "restore")


# The autopilot's remediation causes (JAX: horovod_tpu/autopilot/
# remediate.py CAUSES). The port has no autopilot until ROADMAP A17's
# second half; the analyzer keeps its own copy of the names so it reads
# JAX dumps that carry them.
CAUSES = ("dead", "stalled", "straggler")

def _read_jsonl(path):
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except ValueError:
                        continue            # truncated mid-crash line
    except OSError:
        pass
    return out


def _dump_ordinal(name, meta):
    """Per-process dump order: the trailing ``_<n>`` of the file name
    (recorder.dump numbers a process's dumps), falling back to the meta
    timestamp for hand-built dumps."""
    stem = name[:-len(".jsonl")]
    tail = stem.rsplit("_", 1)[-1]
    if tail.isdigit():
        return int(tail)
    return meta.get("ts", 0)


def load_dir(directory, ledger_dir=None):
    """Load every flight dump (merged + deduped), chaos-ledger entry and
    driver marker under ``directory``. Returns
    ``(events, metas, driver_marks)`` where each event carries ``rank`` /
    ``role`` / ``pid`` and events overlapping between a process's
    successive dumps are deduplicated by (pid, ring index).

    Rank identity is pinned per pid to the process's EARLIEST dump:
    elastic recovery renumbers surviving ranks (refresh_assignment_env),
    so a later atexit dump may carry a different rank than the same
    process's failure-time dump — the failure-time rank is the one the
    post-mortem is about."""
    events, metas, driver_marks = [], [], []
    seen = set()
    names = sorted(os.listdir(directory)) if os.path.isdir(directory) else []
    dumps = []
    for name in names:
        path = os.path.join(directory, name)
        if name == "driver_events.jsonl":
            driver_marks.extend(_read_jsonl(path))
            continue
        if name.startswith("flight_") and name.endswith(".jsonl"):
            rows = _read_jsonl(path)
            if not rows:
                continue
            meta = rows[0] if rows[0].get("kind") == "meta" else {}
            if meta:
                meta = dict(meta, file=name)
                rows = rows[1:]
            else:
                # Torn/missing meta line (mid-crash truncation): synthesize
                # identity from the filename — flight_<role>_r<rank>_
                # p<pid>_b<boot>_<n>.jsonl. A shared empty identity would
                # pin every meta-less dump to one process and silently
                # drop all but the first as ring-index duplicates.
                meta = {"file": name, "meta_torn": True, "boot": name}
                m = re.search(r"_r(\d+)_p(\d+)", name)
                if m:
                    meta["rank"] = int(m.group(1))
                    meta["pid"] = int(m.group(2))
            metas.append(meta)
            dumps.append((name, meta, rows))
    # Process identity is (host, pid, boot): pids are only unique per host
    # AND get recycled across an elastic run's lifetime (the boot token in
    # the dump meta disambiguates) — attributing one process's events to
    # another would name the wrong rank, the one answer the post-mortem
    # must get right.
    proc_rank = {}
    for name, meta, _ in sorted(
            dumps, key=lambda d: _dump_ordinal(d[0], d[1])):
        proc = (meta.get("host", ""), meta.get("pid", 0),
                meta.get("boot", ""))
        proc_rank.setdefault(proc, meta.get("rank", 0))
    # Metas carry the canonical (earliest-dump) rank too: killed_ranks is
    # derived from events and crash_dump_ranks from metas, and one process
    # reported under two rank labels after an elastic renumbering would
    # give the post-mortem two conflicting answers.
    for meta in metas:
        proc = (meta.get("host", ""), meta.get("pid", 0),
                meta.get("boot", ""))
        canon = proc_rank.get(proc, meta.get("rank", 0))
        if canon != meta.get("rank"):
            meta["rank_at_dump"] = meta.get("rank")
            meta["rank"] = canon
    for name, meta, rows in dumps:
        pid = meta.get("pid", 0)
        proc = (meta.get("host", ""), pid, meta.get("boot", ""))
        rank = proc_rank.get(proc, meta.get("rank", 0))
        role = meta.get("role", "worker")
        for e in rows:
            if "kind" not in e:
                # Torn row: a signal-handler dump that timed out the ring
                # lock read a slot mid-append ({"i": N}, fields omitted).
                # Nothing to analyze — and every consumer keys on "kind".
                continue
            key = (proc, e.get("i"))
            if e.get("i") is not None and key in seen:
                continue
            seen.add(key)
            e = dict(e, rank=rank, role=role, pid=pid)
            events.append(e)
    # Chaos ledgers double as flight evidence: the injector writes them
    # before applying the effect, so even a rank killed with os._exit
    # leaves its injection on disk twice (ledger + pre-crash dump). The
    # ring already mirrors every firing as a ``chaos`` event, so a ledger
    # entry is merged only when no ring event evidences the same firing
    # (same rank/site/kind within 2s) — rings may wrap, ledgers don't.
    ring_chaos = [e for e in events if e["kind"] == "chaos"]
    matched_ring = set()

    def _ledger_rank(fname, entry):
        # Ledger files are ``{role}_r{rank}_p{pid}.jsonl``: resolve the
        # writing process's canonical rank the way dumps do (earliest-dump
        # pinning via its pid) so an elastic renumbering between a dump and
        # an injection can't split one process across two rank labels —
        # that mismatch would fail the twin-match below and duplicate the
        # injection under a second rank.
        stem = fname[:-len(".jsonl")]
        head, _, tail = stem.rpartition("_p")
        if head and tail.isdigit():
            hits = {r for (h, p, b), r in proc_rank.items()
                    if p == int(tail)}
            if len(hits) == 1:
                return hits.pop()
        return entry.get("rank", 0)

    for d in {directory, ledger_dir} - {None}:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.endswith(".jsonl") or name.startswith("flight_") \
                    or name == "driver_events.jsonl":
                continue
            for entry in _read_jsonl(os.path.join(d, name)):
                if "site" not in entry or "kind" not in entry:
                    continue
                key = ("ledger", entry.get("rank"), entry.get("site"),
                       entry.get("spec"), entry.get("fire"))
                if key in seen:
                    continue
                seen.add(key)
                ts = entry.get("ts")
                lrank = _ledger_rank(name, entry)
                twin = next(
                    (i for i, e in enumerate(ring_chaos)
                     if i not in matched_ring
                     and e.get("rank") == lrank
                     and e.get("name") == entry["site"]
                     and e.get("what") == entry["kind"]
                     and (ts is None or e.get("t") is None
                          or abs(e["t"] - ts) < 2.0)), None)
                if twin is not None:
                    matched_ring.add(twin)
                    continue
                events.append({"kind": "chaos", "what": entry["kind"],
                               "name": entry["site"],
                               "seq": entry.get("step"),
                               "t": entry.get("ts"),
                               "rank": lrank,
                               "role": entry.get("role", "worker"),
                               "from_ledger": True})
    events.sort(key=lambda e: (e.get("t") or 0.0, e.get("rank", 0)))
    return events, metas, driver_marks


def _is_anomaly(e):
    return e["kind"] in _ANOMALY_KINDS or (
        e["kind"] == "elastic" and e.get("what") in _ANOMALY_ELASTIC)


def analyze_desync(events):
    """Per process set: each rank's max dispatch seq; lagging ranks; the
    first unmatched sequence number and the collective dispatched there."""
    per_ps = {}
    for e in events:
        if e["kind"] != "dispatch" or "seq" not in e or "ps" not in e:
            continue
        by_rank = per_ps.setdefault(e["ps"], {})
        r = e["rank"]
        if e["seq"] > by_rank.get(r, 0):
            by_rank[r] = e["seq"]
    # Every worker belongs to the global set: a rank that wedged before
    # its FIRST dispatch (killed in rendezvous — its dump holds only
    # negotiation/kv/elastic events) must show up lagging at seq 0, not
    # silently vanish from the one report meant to name it. Named subset
    # membership is unknowable from dumps, so only "global" gets this.
    if "global" in per_ps:
        for e in events:
            if e.get("role") != "driver" and not e.get("from_ledger"):
                per_ps["global"].setdefault(e["rank"], 0)
    report = {}
    for ps, by_rank in per_ps.items():
        mx = max(by_rank.values())
        lagging = {r: s for r, s in by_rank.items() if s < mx}
        entry = {"max_seq_by_rank": {str(r): s for r, s
                                     in sorted(by_rank.items())},
                 "desynced": bool(lagging)}
        if lagging:
            first_unmatched = min(lagging.values()) + 1
            entry["lagging_ranks"] = sorted(lagging)
            entry["first_unmatched_seq"] = first_unmatched
            # seq is arrival-ordered per rank, and an async fusion flush
            # can interleave differently against eager dispatches on
            # different ranks — corroborate by taking the MAJORITY
            # (op, sig) among the ranks that did reach this seq, and
            # report how many agree.
            at_seq = [e for e in events
                      if e["kind"] == "dispatch" and e.get("ps") == ps
                      and e.get("seq") == first_unmatched]
            if at_seq:
                tally = {}
                for e in at_seq:
                    tally.setdefault((e.get("op"), e.get("sig")),
                                     []).append(e)
                majority = max(tally.values(), key=len)
                diverging = majority[0]
                entry["first_diverging"] = {
                    k: diverging.get(k)
                    for k in ("op", "name", "sig", "rank", "t")
                    if diverging.get(k) is not None}
                entry["first_diverging"]["agreeing_ranks"] = \
                    len({e["rank"] for e in majority})
        report[ps] = entry
    return report


def analyze_stragglers(events, min_events=3):
    """Per op: mean host dispatch latency per rank vs the cross-rank
    median — the rank whose enqueues consistently take longest is the
    straggler (chaos ``delay`` on one rank shows up exactly here)."""
    lat = {}
    for e in events:
        if e["kind"] != "complete" or e.get("dur") is None \
                or e.get("op") is None:
            continue
        lat.setdefault(e["op"], {}).setdefault(e["rank"], []).append(e["dur"])
    report = {}
    for op, by_rank in lat.items():
        means = {r: sum(v) / len(v) for r, v in by_rank.items()
                 if len(v) >= min_events}
        if len(means) < 2:
            continue
        ordered = sorted(means.values())
        # True median (mean of middles when even): the upper-middle pick
        # would BE the slow rank whenever half or more ranks are slow —
        # e.g. a 2-rank run with one chaos-delayed rank, the exact case
        # this report exists for — giving it skew 1.0 and hiding it.
        mid = len(ordered) // 2
        median = ordered[mid] if len(ordered) % 2 \
            else (ordered[mid - 1] + ordered[mid]) / 2.0
        rows = sorted(
            ({"rank": r, "mean_s": round(m, 6), "n": len(by_rank[r]),
              "skew": round(m / median, 3) if median > 0 else None}
             for r, m in means.items()),
            key=lambda row: -(row["skew"] or 0))
        report[op] = {"ranked": rows,
                      "top_straggler": rows[0]["rank"]
                      if rows and (rows[0]["skew"] or 0) > 1.5 else None}
    return report


def analyze_steps(events):
    """Per rank: spans between consecutive step markers, with the
    collective work inside each span (count, bytes, summed host latency)."""
    by_rank = {}
    for e in events:
        by_rank.setdefault(e["rank"], []).append(e)
    report = {}
    for rank, evs in by_rank.items():
        marks = [e for e in evs if e["kind"] == "step" and "t" in e]
        # Explicit marks win: auto marks (what=auto) only exist before a
        # rank's first explicit mark (torch optimizer.step() firing ahead
        # of the first elastic commit) — mixing the two counters would
        # split that first span in two.
        explicit = [e for e in marks if e.get("what") != "auto"]
        if explicit and len(explicit) != len(marks):
            marks = explicit
        spans = []
        for a, b in zip(marks, marks[1:]):
            inside = [e for e in evs if a["t"] <= e.get("t", 0) < b["t"]]
            disp = [e for e in inside if e["kind"] == "dispatch"]
            comp = [e for e in inside if e["kind"] == "complete"]
            spans.append({
                "step": a.get("seq"),
                "span_s": round(b["t"] - a["t"], 6),
                "collectives": len(disp),
                "bytes": sum(e.get("bytes") or 0 for e in disp),
                "dispatch_s": round(sum(e.get("dur") or 0.0
                                        for e in comp), 6),
            })
        if marks:
            report[str(rank)] = {"steps_marked": len(marks), "spans": spans}
    return report


def analyze_chaos(events):
    """Correlate each injection with the first downstream anomaly (any
    rank): the "this fault caused that failure" line of the post-mortem."""
    injections = [e for e in events if e["kind"] == "chaos"]
    out = []
    for c in injections:
        t0 = c.get("t") or 0.0
        downstream = next(
            (e for e in events
             if (e.get("t") or 0.0) >= t0 and _is_anomaly(e)), None)
        row = {"site": c.get("name"), "what": c.get("what"),
               "rank": c.get("rank"), "step": c.get("seq"), "t": c.get("t")}
        if downstream is not None:
            row["first_anomaly"] = {
                "kind": downstream["kind"],
                "what": downstream.get("what"),
                "op": downstream.get("op"),
                "rank": downstream["rank"],
                "gap_s": round((downstream.get("t") or t0) - t0, 6)}
        out.append(row)
    return out


def analyze_autopilot(events, driver_marks=()):
    """The autopilot's decision trail: tuning decisions summarized per
    (lever, outcome), remediations listed with the rank/cause the
    controller named — and, when the driver's disruption markers are
    available, each remediation correlated with the membership change
    that executed it (the "the controller removed my rank — why?"
    runbook's evidence, docs/troubleshooting.md)."""
    decisions = [e for e in events if e["kind"] == "autopilot_decision"]
    remediations = [e for e in events
                    if e["kind"] == "autopilot_remediate"]
    by_lever = {}
    for e in decisions:
        key = f"{e.get('name')}:{e.get('what')}"
        by_lever[key] = by_lever.get(key, 0) + 1

    def _rank_of(e):
        name = e.get("name") or ""
        if name.startswith("rank"):
            try:
                return int(name[4:])
            except ValueError:
                pass
        return None

    # Two event flavors share the kind: coordinator REQUESTS carry the
    # cause in `what`; driver-arm ACKS carry the outcome. One removal =
    # one row — the ack attaches to the newest outcome-less request for
    # the same rank instead of fabricating a second remediation. Sorted
    # by wall time first: load_dir emits events grouped per dump FILE
    # (a driver dump sorts before the worker dumps), which would
    # otherwise iterate acks before their requests.
    rows = []
    for e in sorted(remediations, key=lambda e: e.get("t") or 0.0):
        what = e.get("what")
        rank = _rank_of(e)
        if what in CAUSES:
            row = {"rank": rank, "cause": what,
                   "host": e.get("op"), "epoch": e.get("seq"),
                   "observer": e.get("rank"), "t": e.get("t")}
            # The membership change that executed this request: the
            # first driver disruption marker at or after it.
            t0 = e.get("t") or 0.0
            mark = next((m for m in driver_marks
                         if (m.get("t") or 0.0) >= t0), None)
            if mark is not None:
                row["disruption"] = {
                    "version": mark.get("version"),
                    "removed_hosts": mark.get("removed"),
                    "gap_s": round((mark.get("t") or t0) - t0, 3)}
            rows.append(row)
            continue
        target = next((r for r in reversed(rows)
                       if r["rank"] == rank and "outcome" not in r), None)
        if target is not None:
            target["outcome"] = what
        else:
            # an ack whose request event was lost (ring wrap): still a
            # row, explicitly outcome-only
            rows.append({"rank": rank, "cause": None, "outcome": what,
                         "host": e.get("op"), "t": e.get("t")})
    return {"decisions": len(decisions), "by_lever": by_lever,
            "frozen": any(e.get("name") == "tuner"
                          and e.get("what") == "frozen"
                          for e in decisions),
            "remediations": rows}


def analyze(events, metas=(), driver_marks=()):
    killed = sorted({e["rank"] for e in events
                     if e["kind"] == "chaos" and e.get("what") == "crash"})
    crash_dumped = sorted({m.get("rank") for m in metas
                           if m.get("reason") == "chaos_crash"})
    report = {
        "ranks": sorted({e["rank"] for e in events}),
        "dumps": [{k: m.get(k) for k in ("file", "rank", "pid", "role",
                                         "reason", "appended", "dropped")}
                  for m in metas],
        "desync": analyze_desync(events),
        "killed_ranks": killed,
        "crash_dump_ranks": crash_dumped,
        "stragglers": analyze_stragglers(events),
        "steps": analyze_steps(events),
        "chaos": analyze_chaos(events),
        "driver_disruptions": list(driver_marks),
        "autopilot": analyze_autopilot(events, driver_marks),
        "traces": analyze_traces(events),
    }
    return report


def analyze_traces(events):
    """Reconstruct one request/step per trace ref across ranks: every
    ring event now carries the ACTIVE trace id (``trace``), so grouping
    by it recovers which ranks touched a request (or which collectives a
    training step dispatched) without any per-request logging. Keyed
    summaries only — the span trees themselves live in the trace shards
    (``python -m horovod_tpu_torch.trace.analyze``)."""
    by_trace = {}
    for e in events:
        tid = e.get("trace")
        if tid is None:
            continue
        rec = by_trace.setdefault(tid, {
            "trace": tid, "ranks": set(), "events": 0, "kinds": {},
            "t_first": e.get("t"), "t_last": e.get("t"), "seq_span": {}})
        rec["ranks"].add(e.get("rank"))
        rec["events"] += 1
        rec["kinds"][e["kind"]] = rec["kinds"].get(e["kind"], 0) + 1
        t = e.get("t")
        if t is not None:
            rec["t_first"] = t if rec["t_first"] is None \
                else min(rec["t_first"], t)
            rec["t_last"] = t if rec["t_last"] is None \
                else max(rec["t_last"], t)
        # Per-process-set collective seq window: the cross-rank join key
        # (a desync inside one request shows as unequal windows).
        if e["kind"] in ("dispatch", "complete") and e.get("seq") \
                is not None:
            ps = e.get("ps")
            lo, hi = rec["seq_span"].get(ps, (e["seq"], e["seq"]))
            rec["seq_span"][ps] = (min(lo, e["seq"]), max(hi, e["seq"]))
    out = []
    for tid in sorted(by_trace):
        rec = by_trace[tid]
        rec["ranks"] = sorted(r for r in rec["ranks"] if r is not None)
        rec["seq_span"] = {str(ps): list(span)
                           for ps, span in rec["seq_span"].items()}
        if rec["t_first"] is not None and rec["t_last"] is not None:
            rec["span_s"] = round(rec["t_last"] - rec["t_first"], 6)
        out.append(rec)
    return out


def write_trace(events, path):
    """Merged Chrome trace, one track (pid) per rank, loadable in
    Perfetto: completes render as duration spans (anchored at dispatch
    time = completion minus host latency), everything else as instants."""
    ts0 = min((e["t"] for e in events if "t" in e), default=0.0)
    completed = {(e["rank"], e.get("ps"), e.get("seq"))
                 for e in events if e["kind"] == "complete"}
    trace_events = []
    # Wall-clock anchor of ts=0 (event times are time.time() seconds):
    # the same convention as the Timeline's clock_sync metadata, so a
    # Chrome timeline and this trace can be rebased onto one axis
    # (--merge-timeline does exactly that).
    trace_events.append({"ph": "M", "name": "clock_sync", "pid": 0,
                         "args": {"wall_t0_us": ts0 * 1e6}})
    for rank in sorted({e["rank"] for e in events}):
        trace_events.append({"ph": "M", "name": "process_name", "pid": rank,
                             "args": {"name": f"rank {rank}"}})
    for e in events:
        if "t" not in e:
            continue
        rank = e["rank"]
        ts_us = (e["t"] - ts0) * 1e6
        if e["kind"] == "complete" and e.get("dur"):
            dur_us = e["dur"] * 1e6
            trace_events.append({
                "ph": "X", "pid": rank, "tid": 0, "cat": "collective",
                "name": f"{e.get('op', '?')}#{e.get('seq', '?')}",
                "ts": ts_us - dur_us, "dur": dur_us,
                "args": {k: e[k] for k in ("ps", "sig", "trace")
                         if k in e}})
        elif e["kind"] == "dispatch":
            # Matched dispatches ride their complete's span; an UNMATCHED
            # one is the wedged collective the post-mortem is after —
            # render it so the victim's track shows the op it died in.
            if (rank, e.get("ps"), e.get("seq")) in completed:
                continue
            trace_events.append({
                "ph": "i", "s": "p", "pid": rank, "tid": 0,
                "cat": "collective",
                "name": f"unfinished:{e.get('op', '?')}#{e.get('seq', '?')}",
                "ts": ts_us,
                "args": {k: e[k] for k in ("ps", "sig", "trace")
                         if k in e}})
        else:
            trace_events.append({
                "ph": "i", "s": "p", "pid": rank, "tid": 0,
                "cat": e["kind"], "ts": ts_us,
                "name": f"{e['kind']}:"
                        f"{e.get('what') or e.get('name') or e.get('seq')}",
                "args": {k: e[k] for k in ("op", "seq", "what", "name",
                                           "trace") if k in e}})
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events, "displayTimeUnit": "ms"}, f)
    return len(trace_events)


def merge_timeline(trace_path, timeline_path):
    """Merge a :mod:`horovod_tpu_torch.timeline` Chrome trace into a trace
    written by :func:`write_trace`, rebasing the timeline's
    perf_counter-based timestamps onto the flight trace's wall-clock axis
    via both files' ``clock_sync`` metadata. Timeline tracks land under a
    distinct pid block (10000 + original pid) so rank tracks stay
    separate. Returns the number of events merged; 0 when either side
    lacks its clock_sync anchor (pre-alignment trace files)."""
    with open(trace_path) as f:
        trace = json.load(f)
    with open(timeline_path) as f:
        tl = json.load(f)

    def _anchor(events):
        for e in events:
            name = str(e.get("name", ""))
            if name == "clock_sync" and e.get("ph") == "M":
                return float(e.get("args", {}).get("wall_t0_us", 0.0))
            if name.startswith("clock_sync="):
                # native-writer form: the fixed record signature carries
                # no args, so the anchor is folded into the name.
                try:
                    return float(name.split("=", 1)[1])
                except ValueError:
                    continue
        return None

    flight_t0 = _anchor(trace.get("traceEvents", []))
    tl_t0 = _anchor(tl.get("traceEvents", []))
    if flight_t0 is None or tl_t0 is None:
        return 0
    offset = tl_t0 - flight_t0
    merged = 0
    for e in tl.get("traceEvents", []):
        name = str(e.get("name", ""))
        if name == "clock_sync" or name.startswith("clock_sync="):
            # both anchor forms (python metadata / native folded-name
            # instant) are consumed, never copied — a stale rebased
            # anchor in the merged file would poison a later merge pass.
            continue
        e = dict(e)
        e["ts"] = float(e.get("ts", 0.0)) + offset
        e["pid"] = 10000 + int(e.get("pid", 0))
        trace["traceEvents"].append(e)
        merged += 1
    trace["traceEvents"].append({
        "ph": "M", "name": "process_name", "pid": 10000,
        "args": {"name": f"timeline {timeline_path}"}})
    with open(trace_path, "w") as f:
        json.dump(trace, f)
    return merged


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.flight.analyze",
        description="Merge per-rank flight-recorder dumps and localize "
                    "desyncs, stragglers and fault causation.")
    p.add_argument("directory", help="dump directory (per-rank "
                                     "flight_*.jsonl files)")
    p.add_argument("--ledger", help="chaos-ledger directory to correlate "
                                    "(defaults to the dump directory)")
    p.add_argument("--trace", help="also write a merged Chrome trace "
                                   "(Perfetto-loadable) to this path")
    p.add_argument("--merge-timeline",
                   help="a horovod_tpu_torch.timeline Chrome-trace file to merge "
                        "into --trace, rebased via both files' clock_sync "
                        "anchors (one view: timeline spans + flight "
                        "forensics)")
    args = p.parse_args(argv)
    events, metas, driver_marks = load_dir(args.directory,
                                           ledger_dir=args.ledger)
    if not events:
        print(json.dumps({"error": f"no flight dumps under "
                                   f"{args.directory}"}))
        return 1
    report = analyze(events, metas, driver_marks)
    if args.trace:
        report["trace_events_written"] = write_trace(events, args.trace)
        report["trace_path"] = args.trace
        if args.merge_timeline:
            report["timeline_events_merged"] = merge_timeline(
                args.trace, args.merge_timeline)
    json.dump(report, sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
