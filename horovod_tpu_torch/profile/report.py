"""``python -m horovod_tpu_torch.profile.report`` — render the step-report JSONL
stream (``HVD_STEP_REPORT_FILE``) as per-step attribution tables, per-rank
aggregates, and top step-time regressions.

Stdlib only in its own logic (like flight.analyze); the records are plain
JSON, so the tables need no live backend — the stream from a crashed run
renders the same as a healthy one's.
"""

import argparse
import json
import os
import sys

from horovod_tpu_torch.profile.ledger import CATEGORIES
from horovod_tpu_torch.profile.ledger import median as _median

_COLS = CATEGORIES + ("compute",)


def load(paths):
    """Records from one or more JSONL files, sorted by (rank, epoch,
    step). Lines that do not parse (torn writes) are skipped."""
    recs = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "wall_s" in rec \
                        and "attribution" in rec:
                    recs.append(rec)
    recs.sort(key=lambda r: (r.get("rank", 0), r.get("epoch", 0),
                             r.get("step", 0)))
    return recs


def _ms(x):
    return f"{x * 1e3:9.3f}"


def render_steps(recs, out=sys.stdout, limit=None):
    """Per-step attribution table (ms per category + share of wall)."""
    rows = recs[-limit:] if limit else recs
    head = (f"{'rank':>4} {'ep':>2} {'step':>6} {'wall_ms':>9} "
            + " ".join(f"{c:>13}" for c in _COLS)
            + f" {'coll':>5} {'mfu':>6}")
    print(head, file=out)
    print("-" * len(head), file=out)
    for r in rows:
        att = r["attribution"]
        cells = " ".join(f"{att.get(c, 0.0) * 1e3:13.3f}" for c in _COLS)
        mfu = f"{r['mfu']:6.3f}" if "mfu" in r else "     -"
        print(f"{r.get('rank', 0):>4} {r.get('epoch', 0):>2} "
              f"{r.get('step', 0):>6} {_ms(r['wall_s'])} {cells} "
              f"{r.get('collectives', 0):>5} {mfu}", file=out)


def render_summary(recs, out=sys.stdout):
    by_rank = {}
    for r in recs:
        by_rank.setdefault(r.get("rank", 0), []).append(r)
    print(f"\nper-rank summary ({len(recs)} records)", file=out)
    head = (f"{'rank':>4} {'steps':>6} {'p50_wall_ms':>12} "
            + " ".join(f"{'med_' + c[:7]:>11}" for c in _COLS))
    print(head, file=out)
    print("-" * len(head), file=out)
    for rank in sorted(by_rank):
        rows = by_rank[rank]
        p50 = _median([r["wall_s"] for r in rows])
        meds = " ".join(
            f"{_median([r['attribution'].get(c, 0.0) for r in rows]) * 1e3:11.3f}"
            for c in _COLS)
        print(f"{rank:>4} {len(rows):>6} {p50 * 1e3:12.3f} {meds}",
              file=out)


def top_regressions(recs, k=5):
    """Steps whose wall time most exceeds their rank's median (the
    offline mirror of the online watchdog's regression detector)."""
    by_rank = {}
    for r in recs:
        by_rank.setdefault(r.get("rank", 0), []).append(r)
    scored = []
    for rank, rows in by_rank.items():
        if len(rows) < 4:
            continue
        med = _median([r["wall_s"] for r in rows])
        for r in rows:
            if r["wall_s"] > med > 0:
                scored.append((r["wall_s"] / med, r))
    scored.sort(key=lambda x: -x[0])
    return scored[:k]


def render_regressions(recs, out=sys.stdout, k=5):
    top = top_regressions(recs, k)
    if not top:
        return
    print(f"\ntop step-time regressions (vs per-rank median)", file=out)
    for ratio, r in top:
        att = r["attribution"]
        dominant = max(att, key=att.get)
        print(f"  rank {r.get('rank', 0)} step {r.get('step', 0)}: "
              f"{r['wall_s'] * 1e3:.3f} ms ({ratio:.1f}x median), "
              f"dominant category: {dominant} "
              f"({att[dominant] * 1e3:.3f} ms)", file=out)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.profile.report",
        description="Render step-profiler JSONL (HVD_STEP_REPORT_FILE) as "
                    "attribution tables and top regressions.")
    p.add_argument("files", nargs="+", help="step-report JSONL file(s)")
    p.add_argument("--last", type=int, default=None,
                   help="only the last N step rows in the table")
    p.add_argument("--json", action="store_true",
                   help="machine-readable: one summary JSON object")
    args = p.parse_args(argv)
    recs = load(args.files)
    if not recs:
        print(json.dumps({"error": "no step records found"}))
        return 1
    if args.json:
        by_rank = {}
        for r in recs:
            by_rank.setdefault(r.get("rank", 0), []).append(r)
        json.dump({
            "records": len(recs),
            "ranks": sorted(by_rank),
            "p50_wall_s": _median([r["wall_s"] for r in recs]),
            "attribution_median_s": {
                c: _median([r["attribution"].get(c, 0.0) for r in recs])
                for c in _COLS},
            "regressions": [
                {"ratio": round(ratio, 3), "step": r.get("step"),
                 "rank": r.get("rank"), "wall_s": r["wall_s"]}
                for ratio, r in top_regressions(recs)],
        }, sys.stdout, indent=1)
        print()
        return 0
    render_steps(recs, limit=args.last)
    render_summary(recs)
    render_regressions(recs)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # `... | head` closing the pipe is a normal way to read a table;
        # devnull keeps interpreter shutdown from re-raising on flush.
        sys.stdout = open(os.devnull, "w")
        sys.exit(0)
