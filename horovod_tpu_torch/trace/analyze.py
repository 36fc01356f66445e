"""``python -m horovod_tpu_torch.trace.analyze`` — merge per-rank trace shards.

Inputs are JSON shards written by :func:`horovod_tpu_torch.trace.dump` (or
saved ``GET /debug/trace/<rid>`` bodies): point it at files or at a
directory of ``trace_*.json``. Output: a JSON report of per-trace phase
fractions (queue / prefill / decode / stream of the root duration —
"where did my request's latency go?", docs/troubleshooting.md) and,
with ``--trace``, ONE merged Perfetto-loadable Chrome trace — one
process track per rank, one thread track per request/step, spans
nested exactly like the live span tree. The ``clock_sync`` metadata
anchor matches ``flight.analyze --trace``'s convention, so a flight
forensics trace and this view rebase onto one axis. Port of the JAX
package's ``trace/analyze.py``, line for line.
"""

import argparse
import glob
import json
import os
import sys


def load(paths):
    """Shards from files and/or directories (``trace_*.json``)."""
    shards = []
    for p in paths:
        files = sorted(glob.glob(os.path.join(p, "trace_*.json"))) \
            if os.path.isdir(p) else [p]
        for f in files:
            try:
                with open(f) as fh:
                    shard = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            if "traces" in shard:
                shard["file"] = f
                shards.append(shard)
    return shards


def merge(shards):
    """Flatten shards into trace records, each stamped with the rank (or
    pid) of its shard. The SAME tid can appear in several shards — each
    rank holds the spans it recorded locally (a request that migrated
    across an elastic kill leaves a shard per incarnation host); the
    merged view keeps them as separate rows under one id."""
    rows = []
    for shard in shards:
        who = shard.get("rank", shard.get("pid"))
        for rec in shard.get("traces", ()):
            rec = dict(rec)
            rec["rank"] = who
            rows.append(rec)
    return rows


def _windows(rec, names):
    """Top-level span windows grouped by name (from a RAW record: spans
    whose parent is unset and which are not instants)."""
    out = {}
    for s in rec.get("spans", ()):
        if s.get("parent") is not None or s.get("ph") == "instant":
            continue
        out.setdefault(s["name"], []).append(
            (s["t0"], s["t0"] + s.get("dur", 0.0)))
    return {n: out.get(n, []) for n in names} if names else out


def _union(intervals):
    # Plain sweep: merge overlapping [t0, t1) intervals.
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    return sum(t1 - t0 for t0, t1 in merged)


PHASES = ("queue", "prefill", "decode", "stream")


def summarize(rec):
    """Phase fractions of one RAW trace record: the union of each
    phase's windows over the root duration, plus coverage (union of ALL
    four phases — the end-to-end guard asserts >= 0.95) and the elastic
    disruption markers."""
    dur = rec.get("dur")
    spans = rec.get("spans", ())
    if dur is None:
        ends = [s["t0"] + s.get("dur", 0.0) for s in spans]
        dur = max(ends) - rec["t0"] if ends else 0.0
    wins = _windows(rec, PHASES)
    fractions = {n: round(_union(w) / dur, 4) if dur else 0.0
                 for n, w in wins.items()}
    all_wins = [iv for w in wins.values() for iv in w]
    out = {"tid": rec.get("tid"), "rid": rec.get("rid"),
           "kind": rec.get("kind"), "dur_s": round(dur, 6),
           "done": rec.get("done", False), "fractions": fractions,
           "coverage": round(_union(all_wins) / dur, 4) if dur else 0.0,
           "requeues": sum(1 for s in spans if s["name"] == "requeue"),
           "restores": sum(1 for s in spans if s["name"] == "restore"),
           "spans": len(spans)}
    if rec.get("dropped"):
        out["dropped_spans"] = rec["dropped"]
    return out


def write_perfetto(rows, path):
    """Merged Chrome trace: pid = rank track, tid = one row per
    trace id (requests and steps side by side), spans as complete
    events, instants as instant events."""
    t0s = [r["t0"] for r in rows if "t0" in r]
    ts0 = min(t0s, default=0.0)
    events = [{"ph": "M", "name": "clock_sync", "pid": 0,
               "args": {"wall_t0_us": ts0 * 1e6}}]
    tids = {}
    for r in rows:
        pid = r.get("rank") or 0
        if not any(e.get("pid") == pid and e["name"] == "process_name"
                   for e in events):
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": f"rank {pid}"}})
        row = tids.setdefault((pid, r["tid"]), len(tids) + 1)
        label = f"r{r['rid']}" if r.get("rid") is not None \
            else r.get("kind", "trace")
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": row,
                       "args": {"name": f"{label} {r['tid']}"}})
        dur = r.get("dur")
        root = {"ph": "X", "pid": pid, "tid": row, "cat": r.get("kind"),
                "name": r.get("kind", "trace"),
                "ts": (r["t0"] - ts0) * 1e6,
                "args": {"tid": r["tid"]}}
        if dur is not None:
            root["dur"] = dur * 1e6
            events.append(root)
        for s in r.get("spans", ()):
            ts = (s["t0"] - ts0) * 1e6
            if s.get("ph") == "instant":
                events.append({"ph": "i", "s": "t", "pid": pid,
                               "tid": row, "name": s["name"],
                               "cat": s.get("cat", "trace"), "ts": ts,
                               "args": s.get("args", {})})
            else:
                events.append({"ph": "X", "pid": pid, "tid": row,
                               "name": s["name"],
                               "cat": s.get("cat", "trace"), "ts": ts,
                               "dur": s.get("dur", 0.0) * 1e6,
                               "args": s.get("args", {})})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return len(events)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.trace.analyze",
        description="Merge per-rank request/step trace shards into one "
                    "report and a Perfetto-loadable view.")
    p.add_argument("inputs", nargs="+",
                   help="trace shard files or directories of "
                        "trace_*.json")
    p.add_argument("--trace", help="write the merged Chrome trace here")
    p.add_argument("--rid", help="only report the trace(s) of this "
                                 "request id")
    args = p.parse_args(argv)
    rows = merge(load(args.inputs))
    if args.rid is not None:
        rows = [r for r in rows if str(r.get("rid")) == str(args.rid)]
    if not rows:
        print(json.dumps({"error": "no traces found"}))
        return 1
    report = {"traces": [summarize(r) for r in rows],
              "ranks": sorted({r.get("rank") for r in rows
                               if r.get("rank") is not None})}
    if args.trace:
        report["trace_events_written"] = write_perfetto(rows, args.trace)
        report["trace_path"] = args.trace
    json.dump(report, sys.stdout, indent=1)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
