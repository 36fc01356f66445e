"""Mergeable metrics snapshots: the serialization half of the telemetry
plane. Port of the JAX package's ``metrics/merge.py``, line for line (the
cluster aggregator that merges beacons comes with A16's second half).

``MetricsRegistry.snapshot()`` is a per-process view. The cluster view
needs those snapshots combined across ranks and slices without shipping
the registry objects themselves, so this module works on the snapshot
*dicts* (JSON round-trippable by construction):

- counters merge by summing per labelled series,
- gauges merge by max (a gauge is a level, not a flow — summing
  ``metrics_port``-style values would be nonsense),
- histograms merge bucket-wise when the bucket edges agree (they do: the
  whole fleet shares one catalogue, :mod:`horovod_tpu_torch.metrics.instruments`);
  on an edge mismatch (mixed framework versions mid-elastic-upgrade) the
  merge degrades to sum/count only rather than fabricating a distribution.

``compact()`` strips the HELP text for the wire (digests are published
every beacon interval); ``render_text()`` turns any snapshot — merged or
not — back into Prometheus exposition format, optionally stamping an
extra label set (the per-slice labels on ``GET /cluster/metrics``).
"""

from horovod_tpu_torch.metrics.registry import _escape_label_value, _fmt


def compact(snapshot, drop_empty=True):
    """Wire form of a ``registry.snapshot()``: HELP text removed and
    (by default) never-observed series dropped — the catalogue registers
    every family eagerly, so a fresh process would otherwise beacon ~40
    empty families every interval. Gauge series are always kept: a gauge
    AT zero is an observed level (its child only exists because someone
    set it), not an unobserved series."""
    out = {}
    for name, fam in snapshot.items():
        series = fam["series"]
        if drop_empty and fam["type"] != "gauge":
            series = [s for s in series
                      if s.get("count") or s.get("value")]
        if not series:
            continue
        out[name] = {"type": fam["type"], "series": series}
    return out


def _series_key(labels):
    return tuple(sorted(labels.items()))


def _merge_histogram(acc, s):
    acc["sum"] = acc.get("sum", 0.0) + s.get("sum", 0.0)
    acc["count"] = acc.get("count", 0) + s.get("count", 0)
    a, b = acc.get("buckets"), s.get("buckets")
    if a is None or b is None:
        acc.pop("buckets", None)
        return
    if [le for le, _ in a] != [le for le, _ in b]:
        # Edge mismatch: a summed distribution over different boundaries
        # would be fiction; keep sum/count (still a valid mean).
        acc.pop("buckets", None)
        return
    acc["buckets"] = [[le, na + nb] for (le, na), (_, nb) in zip(a, b)]


def merge_snapshots(snapshots):
    """Merge snapshot dicts (``registry.snapshot()`` / ``compact()`` /
    prior merges — the operation is associative) into one. Series align
    on (family name, label set); families whose *type* disagrees across
    inputs keep the first-seen type and skip conflicting inputs."""
    merged = {}
    for snap in snapshots:
        if not snap:
            continue
        for name, fam in snap.items():
            entry = merged.get(name)
            if entry is None:
                entry = merged[name] = {"type": fam["type"], "series": {}}
            elif entry["type"] != fam["type"]:
                continue
            for s in fam["series"]:
                key = _series_key(s.get("labels", {}))
                acc = entry["series"].get(key)
                if acc is None:
                    acc = entry["series"][key] = \
                        {"labels": dict(s.get("labels", {}))}
                    if entry["type"] == "histogram":
                        acc["sum"] = 0.0
                        acc["count"] = 0
                        if s.get("buckets") is not None:
                            acc["buckets"] = [[le, 0]
                                              for le, _ in s["buckets"]]
                    elif entry["type"] == "gauge":
                        # Seed from the first observation, NOT 0.0 — an
                        # all-negative gauge (skew, drift) must not merge
                        # to a fabricated 0.
                        acc["value"] = s.get("value", 0.0)
                        continue
                    else:
                        acc["value"] = 0.0
                if entry["type"] == "histogram":
                    _merge_histogram(acc, s)
                elif entry["type"] == "gauge":
                    acc["value"] = max(acc["value"], s.get("value", 0.0))
                else:
                    acc["value"] += s.get("value", 0.0)
    return {name: {"type": fam["type"],
                   "series": [fam["series"][k]
                              for k in sorted(fam["series"])]}
            for name, fam in merged.items()}


def add_labels(snapshot, **labels):
    """A copy of ``snapshot`` with ``labels`` stamped onto every series
    (e.g. ``slice="1"`` before a cross-slice merge, so the job-level
    exposition keeps per-slice series distinct)."""
    out = {}
    for name, fam in snapshot.items():
        series = []
        for s in fam["series"]:
            s2 = dict(s)
            s2["labels"] = {**s.get("labels", {}),
                            **{k: str(v) for k, v in labels.items()}}
            series.append(s2)
        out[name] = {"type": fam["type"], "series": series}
    return out


def render_text(snapshot, prefix="horovod", help_map=None):
    """Prometheus text exposition 0.0.4 from a snapshot dict (the
    registry-free twin of ``MetricsRegistry.render_text`` — the job
    aggregator renders views merged from OTHER processes' registries).
    ``help_map``: optional {family: help text} (defaults to a generic
    aggregation note)."""
    lines = []
    pfx = f"{prefix}_" if prefix else ""
    for name in sorted(snapshot):
        fam = snapshot[name]
        full = pfx + name
        doc = (help_map or {}).get(
            name, fam.get("help", "aggregated across ranks"))
        lines.append(f"# HELP {full} {doc}")
        lines.append(f"# TYPE {full} {fam['type']}")
        for s in fam["series"]:
            base_lab = ",".join(
                f'{k}="{_escape_label_value(v)}"'
                for k, v in s.get("labels", {}).items())
            if fam["type"] == "histogram":
                for le, n in s.get("buckets") or ():
                    le_s = "+Inf" if le == "+Inf" else _fmt(le)
                    lab = (base_lab + "," if base_lab else "") \
                        + f'le="{le_s}"'
                    lines.append(f"{full}_bucket{{{lab}}} {n}")
                suffix = f"{{{base_lab}}}" if base_lab else ""
                lines.append(f"{full}_sum{suffix} {_fmt(s.get('sum', 0))}")
                lines.append(f"{full}_count{suffix} {s.get('count', 0)}")
            else:
                suffix = f"{{{base_lab}}}" if base_lab else ""
                lines.append(f"{full}{suffix} {_fmt(s.get('value', 0))}")
    return "\n".join(lines) + "\n"
