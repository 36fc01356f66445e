"""The job health model: per-rank states from merged slice summaries.

Port of the JAX package's ``telemetry/health.py``, whole.

States, most-severe first (one per rank, the first matching rule wins):

- ``dead``       — beacon missing or older than ``dead_after``. A rank
  that never beaconed at all is dead with ``why="never_reported"``.
- ``stalled``    — beacon fresh (the process is alive) but its step clock
  stopped for ``stall_after`` while the job median advanced past it: the
  classic wedged-in-a-collective signature.
- ``desynced``   — alive and stepping, but its global-process-set
  collective sequence number lags the fleet median by more than
  ``seq_lag``: it is issuing different/fewer collectives than its peers
  (the flight recorder's cross-rank desync key, surfaced live).
- ``straggling`` — step count lags the job median by more than
  ``step_lag``, or the step-profiler watchdog recently named it.
- ``healthy``    — everything else, including ranks with no step data at
  all (not every process runs a marked training loop).

Thresholds come from :class:`horovod_tpu_torch.common.config.Config`
(``HOROVOD_TELEMETRY_*``); the defaults are deliberately conservative —
a health plane that cries wolf gets ignored. All classification is pure
(rows + now + thresholds in, states out) so tests drive it with
synthetic rows and a fake clock.
"""

STATES = ("healthy", "straggling", "desynced", "stalled", "dead")

# The flight recorder's global process set key in max_seq maps.
_GLOBAL_PS = "global"


def _median(xs):
    import statistics
    return statistics.median(xs)


def thresholds(interval=2.0, dead_after=None, stall_after=None,
               step_lag=None, seq_lag=None):
    """Resolve the health thresholds from an interval + explicit
    overrides (the aggregator feeds Config/env values through here).
    The derived ``dead_after`` is floored at 1.5 s: beacon threads on a
    loaded host routinely slip hundreds of ms, and a sub-second liveness
    window makes every rank flap dead↔healthy on a loaded 2-core host at
    interval=0.1; an explicit override can still go lower."""
    return {
        "dead_after": dead_after if dead_after is not None
        else max(3.0 * interval, 1.5),
        "stall_after": stall_after if stall_after is not None
        else max(15.0 * interval, 30.0),
        "step_lag": step_lag if step_lag is not None else 5,
        "seq_lag": seq_lag if seq_lag is not None else 64,
    }


def job_progress(rows, now, thr):
    """Fleet step/seq medians over LIVE rows (dead ranks must not drag
    the median toward their frozen counters)."""
    steps, seqs = [], []
    for row in rows.values():
        if row is None or row.get("t") is None:
            continue
        if now - row["t"] > thr["dead_after"]:
            continue
        if row.get("step") is not None:
            steps.append(row["step"])
        seq = (row.get("max_seq") or {}).get(_GLOBAL_PS)
        if seq is not None:
            seqs.append(seq)
    out = {}
    if steps:
        out["median_step"] = _median(steps)
        out["min_step"] = min(steps)
        out["max_step"] = max(steps)
    if seqs:
        out["median_seq"] = _median(seqs)
    return out


def _recent_straggler_namings(rows):
    """rank -> times the watchdog named it a straggler in any live rank's
    recent findings (cross-rank corroboration rides along for free: every
    observer publishes its own findings list)."""
    named = {}
    for row in rows.values():
        if row is None:
            continue
        for f in row.get("findings") or ():
            if f.get("kind") == "straggler" and f.get("rank") is not None:
                named[f["rank"]] = named.get(f["rank"], 0) + 1
    return named


def classify(rows, now, thr):
    """``rows``: {rank(int) -> health_row dict or None (never beaconed)}.
    Returns ({rank -> {"state", "why", ...}}, job_progress_dict)."""
    progress = job_progress(rows, now, thr)
    named = _recent_straggler_namings(rows)
    median_step = progress.get("median_step")
    median_seq = progress.get("median_seq")
    out = {}
    for rank, row in rows.items():
        out[rank] = _classify_one(rank, row, now, thr, median_step,
                                  median_seq, named)
    return out, progress


def _classify_one(rank, row, now, thr, median_step, median_seq, named):
    if row is None or row.get("t") is None:
        return {"state": "dead", "why": "never_reported"}
    age = now - row["t"]
    if age > thr["dead_after"]:
        return {"state": "dead", "why": "beacon_stale",
                "age_s": round(age, 3), "host": row.get("host"),
                "step": row.get("step")}
    info = {"age_s": round(age, 3), "step": row.get("step"),
            "host": row.get("host")}
    step, step_t = row.get("step"), row.get("step_t")
    if step is not None and step_t is not None and median_step is not None \
            and median_step > step and now - step_t > thr["stall_after"]:
        return {"state": "stalled", "why": "step_clock_stopped",
                "stalled_s": round(now - step_t, 3), **info}
    seq = (row.get("max_seq") or {}).get(_GLOBAL_PS)
    if seq is not None and median_seq is not None \
            and median_seq - seq > thr["seq_lag"]:
        return {"state": "desynced", "why": "collective_seq_lag",
                "seq": seq, "median_seq": median_seq, **info}
    if step is not None and median_step is not None \
            and median_step - step > thr["step_lag"]:
        return {"state": "straggling", "why": "step_lag",
                "median_step": median_step, **info}
    if named.get(rank):
        return {"state": "straggling", "why": "watchdog_named",
                "namings": named[rank], **info}
    return {"state": "healthy", **info}


def counts(states):
    """{state: n} over a classify() result, every state present."""
    out = dict.fromkeys(STATES, 0)
    for s in states.values():
        out[s["state"]] = out.get(s["state"], 0) + 1
    return out
