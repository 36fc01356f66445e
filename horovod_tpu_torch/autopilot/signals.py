"""The autopilot's signal plane: one coherent per-epoch frame.

Port of the JAX package's ``autopilot/signals.py``, reading the port's
planes: the metrics registry (``metrics/instruments.py``), the step
ledger (``profile/ledger.py``: ``CATEGORIES``, ``step_report``), the
watchdog's findings, the SLO burn rates, the goodput ledger and the
telemetry job view. The frame's keys and arithmetic are JAX's.

Everything the controller steers on already exists somewhere in the
stack — step-profiler attribution, fusion fill ratios, per-tier wire
bytes, telemetry health, watchdog findings — but as cumulative counters
and bounded rings with per-subsystem schemas. This module snapshots all of
them at a decision-epoch boundary and diffs two snapshots into a
:class:`SignalFrame`: the DELTAS for exactly one epoch, in one dict, with
every read fail-soft (a signal source that is off or mid-reset
contributes nothing, never an exception — the controller must keep
deciding on whatever signal survives). The port's eager dispatch keeps no
plan cache, so ``plan_hits``/``plan_misses`` read zero.

The frame is deliberately plain data (no live references into the
subsystems) so decisions are post-mortem-able: the controller attaches
the frame it decided on to each decision record.
"""

import time

from horovod_tpu_torch.profile.ledger import CATEGORIES

# Counter families diffed value-wise per (sorted label items) series.
_COUNTER_FAMILIES = (
    "fusion_boundary_outcomes_total",
    "dispatch_plan_events_total",
    "wire_bytes_total",
    "collective_bytes_total",
    "step_profiler_events_total",
)
# Histogram families diffed as (count, sum) pairs.
_HISTOGRAM_FAMILIES = (
    "fusion_fill_ratio",
    "fusion_flush_bytes",
    "collective_latency_seconds",
)


def _series_map(snap, name):
    out = {}
    for s in snap.get(name, {}).get("series", ()):
        key = tuple(sorted(s["labels"].items()))
        if "value" in s:
            out[key] = float(s["value"])
        else:
            out[key] = (float(s.get("count", 0)), float(s.get("sum", 0.0)))
    return out


def snapshot():
    """Cumulative view of every signal source at one instant. Cheap: one
    registry snapshot + bounded ring reads; safe to call from the
    controller thread at any time."""
    snap = {"t": time.perf_counter(), "wall_t": time.time()}
    try:
        from horovod_tpu_torch.metrics.instruments import REGISTRY
        reg = REGISTRY.snapshot()
        snap["counters"] = {n: _series_map(reg, n)
                            for n in _COUNTER_FAMILIES}
        snap["histograms"] = {n: _series_map(reg, n)
                              for n in _HISTOGRAM_FAMILIES}
    except Exception:  # noqa: BLE001 — registry off/mid-reset
        snap["counters"], snap["histograms"] = {}, {}
    try:
        from horovod_tpu_torch.profile import ledger as _ledger
        recs = _ledger.step_report(last=None) or []
        snap["last_step_key"] = (recs[-1]["epoch"], recs[-1]["step"],
                                 recs[-1]["t"]) if recs else None
        snap["step_records"] = recs
    except Exception:  # noqa: BLE001
        snap["last_step_key"], snap["step_records"] = None, []
    try:
        from horovod_tpu_torch.profile import watchdog as _watchdog
        snap["findings"] = list(_watchdog.findings())
    except Exception:  # noqa: BLE001
        snap["findings"] = []
    try:
        # Declared-SLO burn (absolute, not a delta: a burn rate is
        # already windowed) — ROADMAP item 1's resize-on-SLO input.
        from horovod_tpu_torch.telemetry import slo as _slo
        snap["slo_burn"] = _slo.burn_rates()
    except Exception:  # noqa: BLE001
        snap["slo_burn"] = {}
    try:
        # Goodput decomposition (cumulative; frame() diffs the category
        # seconds) — lets the controller see efficiency, not just
        # bytes/sec: a tuning trial that moves bytes but grows
        # straggler_wait is a loss.
        from horovod_tpu_torch.goodput import ledger as _goodput
        snap["goodput"] = _goodput.snapshot()
    except Exception:  # noqa: BLE001
        snap["goodput"] = {}
    return snap


def _delta_counters(prev, cur):
    out = {}
    for name, series in cur.items():
        p = prev.get(name, {})
        d = {}
        for key, v in series.items():
            dv = v - p.get(key, 0.0)
            if dv:
                d[key] = dv
        out[name] = d
    return out


def _delta_hist(prev, cur):
    out = {}
    for name, series in cur.items():
        p = prev.get(name, {})
        d = {}
        for key, (cnt, tot) in series.items():
            p_cnt, p_tot = p.get(key, (0.0, 0.0))
            if cnt - p_cnt:
                d[key] = (cnt - p_cnt, tot - p_tot)
        out[name] = d
    return out


class SignalFrame(dict):
    """One decision epoch's signal deltas (a dict subclass so records
    serialize straight into flight/bench evidence). Keys:

    - ``elapsed_s``           wall of the epoch (perf_counter delta)
    - ``steps``               step records closed this epoch
    - ``wall_mean_s``         mean step wall over those records
    - ``attribution_mean_s``  per-category means incl. ``cross_wait``
    - ``reduced_bytes``       collective payload bytes this epoch
    - ``flushes`` / ``flush_bytes`` / ``fill_ratio_mean``
    - ``boundary_deferred``   follower boundaries deferred
    - ``plan_hits`` / ``plan_misses``
    - ``wire_bytes``          {"dtype|tier": bytes} deltas
    - ``dcn_bytes`` / ``ici_bytes``
    - ``health_counts``       live telemetry state counts (absolute)
    - ``unhealthy``           {rank: {"state", "why"}} non-healthy ranks
    - ``straggler_namings``   {rank: count} new watchdog namings
    - ``slo_burn``            {objective: burn} declared-SLO burn rates
                              (absolute; {} when no SLO is declared)
    - ``goodput_ratio``       cumulative job goodput ratio (absolute;
                              None when accounting is off)
    - ``badput_delta_s``      {category: seconds} badput booked this
                              epoch (goodput-ledger category deltas)
    """


def frame(prev, cur, cluster_view=None):
    """Diff two :func:`snapshot` results into a :class:`SignalFrame`.
    ``cluster_view`` (a ``cluster_snapshot()`` dict) is absolute state,
    not a delta — it rides along for the remediation arm."""
    f = SignalFrame()
    f["elapsed_s"] = max(cur["t"] - prev["t"], 1e-9)
    counters = _delta_counters(prev.get("counters", {}),
                               cur.get("counters", {}))
    hists = _delta_hist(prev.get("histograms", {}),
                        cur.get("histograms", {}))

    # Step records closed during this epoch (ledger keeps a bounded ring;
    # the (epoch, step, t) key of the previous frame's last record marks
    # the cut).
    recs = cur.get("step_records", [])
    prev_key = prev.get("last_step_key")
    if prev_key is not None:
        recs = [r for r in recs
                if (r["epoch"], r["step"], r["t"]) > prev_key]
    f["steps"] = len(recs)
    if recs:
        walls = [r["wall_s"] for r in recs]
        f["wall_mean_s"] = round(sum(walls) / len(walls), 6)
        att = {}
        for cat in CATEGORIES + ("compute",):
            att[cat] = round(sum(r["attribution"].get(cat, 0.0)
                                 for r in recs) / len(recs), 6)
        f["attribution_mean_s"] = att
    else:
        f["wall_mean_s"] = None
        f["attribution_mean_s"] = {}

    f["reduced_bytes"] = sum(
        counters.get("collective_bytes_total", {}).values())
    fl = hists.get("fusion_flush_bytes", {})
    f["flushes"] = int(sum(c for c, _ in fl.values()))
    f["flush_bytes"] = sum(s for _, s in fl.values())
    fr = hists.get("fusion_fill_ratio", {})
    n_fr = sum(c for c, _ in fr.values())
    f["fill_ratio_mean"] = round(
        sum(s for _, s in fr.values()) / n_fr, 6) if n_fr else None
    f["boundary_deferred"] = sum(
        v for k, v in counters.get("fusion_boundary_outcomes_total",
                                   {}).items()
        if dict(k).get("outcome") == "deferred")
    plan = counters.get("dispatch_plan_events_total", {})
    f["plan_hits"] = sum(v for k, v in plan.items()
                         if dict(k).get("event") == "hit")
    f["plan_misses"] = sum(v for k, v in plan.items()
                           if dict(k).get("event") == "miss")
    wire = {}
    for key, v in counters.get("wire_bytes_total", {}).items():
        lab = dict(key)
        wire[f"{lab.get('dtype')}|{lab.get('tier')}"] = v
    f["wire_bytes"] = wire
    f["dcn_bytes"] = sum(v for k, v in wire.items()
                         if k.endswith("|dcn"))
    f["ici_bytes"] = sum(v for k, v in wire.items()
                         if k.endswith("|ici"))

    # New watchdog straggler namings this epoch: findings present in cur
    # but not in prev (keyed by (kind, rank, step) — the bounded deque may
    # have evicted old entries, which only ever UNDER-counts).
    seen = {(e.get("kind"), e.get("rank"), e.get("step"))
            for e in prev.get("findings", [])}
    namings = {}
    for e in cur.get("findings", []):
        if e.get("kind") != "straggler":
            continue
        if (e.get("kind"), e.get("rank"), e.get("step")) in seen:
            continue
        r = e.get("rank")
        if r is not None:
            namings[int(r)] = namings.get(int(r), 0) + 1
    f["straggler_namings"] = namings

    f["slo_burn"] = dict(cur.get("slo_burn", {}))

    # Goodput: ratio rides absolute (it is already cumulative and the
    # controller wants the level), badput as per-category deltas so a
    # trial's verdict can charge exactly the badput it caused.
    gp_cur, gp_prev = cur.get("goodput") or {}, prev.get("goodput") or {}
    f["goodput_ratio"] = gp_cur.get("goodput_ratio") \
        if gp_cur.get("enabled") else None
    deltas = {}
    if gp_cur.get("enabled"):
        c_cats = gp_cur.get("categories") or {}
        p_cats = gp_prev.get("categories") or {}
        for cat, v in c_cats.items():
            if cat == "productive_compute":
                continue
            dv = float(v) - float(p_cats.get(cat, 0.0))
            if dv > 0.0:
                deltas[cat] = round(dv, 6)
    f["badput_delta_s"] = deltas

    f["health_counts"] = {}
    f["unhealthy"] = {}
    if cluster_view:
        f["health_counts"] = dict(cluster_view.get("counts", {}))
        for r_str, st in (cluster_view.get("health") or {}).items():
            if st.get("state") not in (None, "healthy"):
                f["unhealthy"][int(r_str)] = {
                    "state": st.get("state"), "why": st.get("why"),
                    "host": st.get("host")}
    return f


def cluster_view():
    """The telemetry job view for the remediation arm (fail-soft: the
    local fallback or None when telemetry is entirely absent)."""
    try:
        from horovod_tpu_torch.telemetry import aggregator as _agg
        return _agg.cluster_snapshot()
    except Exception:  # noqa: BLE001
        return None
