"""Durable cross-run history: append-only per-run JSONL journals.

Port of the JAX package's ``goodput/history.py``; ``hvd.shutdown`` appends
the ``cluster`` record while the telemetry agent runs.

One file per run (``run_<id>.jsonl`` under ``HOROVOD_RUN_HISTORY_DIR``),
one JSON object per line, appended with an open/write/close per record —
the ``HVD_BENCH_PROGRESS_FILE`` discipline. Nothing is buffered in the
process, so a run killed mid-flight (SIGKILL a worker, then the
launcher) still leaves a parseable journal whose last goodput heartbeat
is at most ``HOROVOD_GOODPUT_JOURNAL_S`` old.

Record kinds:

- ``run_start``  run id, config fingerprint, world size, argv.
- ``goodput``    a goodput ledger summary (periodic heartbeat + final).
- ``bench``      a BENCH record ride-along from :mod:`bench`.
- ``cluster``    final cluster view (telemetry job view, when present).
- ``run_end``    clean-shutdown marker with the final goodput ratio — a
                 journal without one is a killed run, by definition.

Only the coordinator rank (cross rank 0) journals by default: the
journal is *job*-level evidence, and per-rank detail rides in through
the cluster view. Tests and the twin construct :class:`RunJournal`
directly.
"""

import hashlib
import json
import os
import threading
import time

_lock = threading.Lock()
_journal = None


def config_fingerprint(config):
    """Stable hash of the effective config — lets the report CLI group
    and diff runs that ran the same shape."""
    try:
        import dataclasses
        d = dataclasses.asdict(config)
    except (TypeError, ValueError):
        d = dict(getattr(config, "__dict__", {}) or {})
    blob = json.dumps(d, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class RunJournal:
    """Append-only JSONL journal for ONE run."""

    def __init__(self, root, run_id=None, fingerprint=""):
        self.root = str(root)
        self.run_id = run_id or time.strftime("%Y%m%d-%H%M%S") \
            + f"-{os.getpid()}"
        self.fingerprint = fingerprint
        self.path = os.path.join(self.root, f"run_{self.run_id}.jsonl")
        os.makedirs(self.root, exist_ok=True)

    def append(self, kind, **payload):
        """One flushed line; IO errors are the caller's concern only in
        tests — production goes through the fail-soft module wrapper."""
        line = json.dumps({"t": round(time.time(), 3), "run": self.run_id,
                           "kind": kind, **payload}, default=str)
        with open(self.path, "a") as f:
            f.write(line + "\n")
            f.flush()


def journal_configure(config, rank=0, world=1, run_id=None):
    """Arm the module journal (called by ``basics.init`` on rank 0 when
    ``run_history_dir`` is set)."""
    global _journal
    root = getattr(config, "run_history_dir", "") or ""
    if not root or rank != 0:
        _journal = None
        return None
    try:
        j = RunJournal(root, run_id=run_id or os.environ.get(
            "HOROVOD_RUN_ID") or None,
            fingerprint=config_fingerprint(config))
        j.append("run_start", fingerprint=j.fingerprint, world=world,
                 rank=rank, pid=os.getpid())
        with _lock:
            _journal = j
        return j
    except (OSError, ValueError):
        _journal = None
        return None


def get_journal():
    return _journal


def journal_append(kind, **payload):
    """Fail-soft append to the armed journal (no-op when unarmed)."""
    j = _journal
    if j is None:
        return
    try:
        j.append(kind, **payload)
    except Exception:  # noqa: BLE001 — history must never fail the job
        pass


def journal_finalize(goodput_summary):
    """Clean-shutdown marker: run_end."""
    j = _journal
    if j is None:
        return
    try:
        j.append("run_end",
                 goodput_ratio=goodput_summary.get("goodput_ratio"),
                 wall_s=goodput_summary.get("wall_s"))
    except Exception:  # noqa: BLE001
        pass


# --- readers (report CLI, tests) ----------------------------------------

def read_journal(path):
    """All parseable records of one journal file, in order. Tolerates a
    torn final line (the SIGKILL case this store exists for)."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out


def read_runs(root):
    """-> {run_id: summary} for every journal under ``root``. Each
    summary: start record, last goodput record, bench records, cluster
    view, whether the run ended cleanly."""
    runs = {}
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return runs
    for name in names:
        if not (name.startswith("run_") and name.endswith(".jsonl")):
            continue
        recs = read_journal(os.path.join(root, name))
        if not recs:
            continue
        run_id = recs[0].get("run") or name[4:-6]
        summary = {"run": run_id, "path": os.path.join(root, name),
                   "records": len(recs), "bench": [], "goodput": None,
                   "cluster": None, "start": None, "ended": False}
        for rec in recs:
            kind = rec.get("kind")
            if kind == "run_start":
                summary["start"] = rec
            elif kind == "goodput":
                summary["goodput"] = rec
            elif kind == "bench":
                summary["bench"].append(rec)
            elif kind == "cluster":
                summary["cluster"] = rec.get("view")
            elif kind == "run_end":
                summary["ended"] = True
        summary["t0"] = recs[0].get("t")
        summary["t1"] = recs[-1].get("t")
        runs[run_id] = summary
    return runs
