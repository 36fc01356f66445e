"""Dependency-free metrics registry: Counter / Gauge / Histogram.

Port of the JAX package's ``metrics/registry.py``, whole: the same
families, label handling and text exposition, so both packages render the
same ``/metrics`` text for the same observations.

The reference framework has no aggregate metrics layer — its observability
stops at the Chrome-trace timeline and the stall inspector (PAPER §5.1-5.2).
This module is the always-on complement: cheap process-local counters the
rest of the stack increments on every collective dispatch, fusion flush,
control-plane RPC and elastic event, exposed as a snapshot dict and in
Prometheus text exposition format (``render_text``).

Design constraints (the hot path is the eager collective enqueue):

- O(1) recording: one dict lookup for the labelled child (cached), one
  short per-child lock around the float add. No allocation after the first
  observation of a label set, no I/O, nothing held across RPC or flush
  boundaries.
- No third-party deps: ``prometheus_client`` is deliberately not required —
  the text format is small and stable (version 0.0.4), and the container
  must not grow dependencies.
- Histograms use exponential bucket boundaries (latencies and byte sizes
  both span decades); cumulative bucket counts are computed at render time
  so ``observe`` touches exactly one bucket slot.
"""

import bisect
import threading


def exponential_buckets(start, factor, count):
    """``count`` upper bounds ``start * factor**i`` — the +Inf bucket is
    implicit. Mirrors prometheus_client's helper of the same name."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("exponential_buckets needs start>0, factor>1, "
                         "count>=1")
    return tuple(start * factor ** i for i in range(count))


def _validate_name(name):
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label_value(v):
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(v):
    """Prometheus sample value: integers render without a trailing .0."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Value:
    """One labelled series of a counter or gauge."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount=1.0):
        with self._lock:
            self._value += amount

    def set(self, value):
        with self._lock:
            self._value = float(value)

    def get(self):
        with self._lock:
            return self._value


class _HistogramValue:
    """One labelled series of a histogram: per-bucket counts + sum."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum")

    def __init__(self, bounds):
        self._bounds = bounds
        self._lock = threading.Lock()
        self._counts = [0] * (len(bounds) + 1)   # last slot = +Inf
        self._sum = 0.0

    def observe(self, value):
        value = float(value)
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def get(self):
        """(cumulative [(le, count), ..., ('+Inf', total)], sum, count)."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        cum, acc = [], 0
        for bound, c in zip(self._bounds, counts[:-1]):
            acc += c
            cum.append((bound, acc))
        acc += counts[-1]
        cum.append(("+Inf", acc))
        return cum, total_sum, acc


class _Family:
    """A named metric with a fixed label schema; children are the labelled
    series. ``labels(...)`` is the hot path: one dict lookup by the values
    as passed where they are strings and have been seen (else a tuple
    build of their strings and a lookup by it)."""

    kind = None

    def __init__(self, name, documentation, labelnames=()):
        self.name = _validate_name(name)
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children = {}
        # The values as passed -> child, for all-string values only: a
        # tuple holding a number never equals one of strings, so 1 and
        # True (equal as keys) still reach "1" and "True" apart.
        self._by_values = {}
        self._lock = threading.Lock()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kv):
        if not kv:
            try:
                child = self._by_values.get(values)
            except TypeError:                 # an unhashable value
                child = None
            if child is not None:
                return child
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            values = tuple(kv[n] for n in self.labelnames)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, got "
                f"{values!r}")
        key = tuple(str(v) for v in values)
        child = self._children.get(key)       # GIL-safe dict read
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        if not kv and all(type(v) is str for v in values):
            self._by_values[values] = child
        return child

    def _default(self):
        """The label-less child (only valid when the family has no labels) —
        lets ``counter.inc()`` work directly for unlabelled metrics."""
        if self.labelnames:
            raise ValueError(f"{self.name} requires labels {self.labelnames}")
        return self.labels()

    def series(self):
        """[(labels_dict, child)] sorted for deterministic exposition."""
        with self._lock:
            items = sorted(self._children.items())
        return [(dict(zip(self.labelnames, key)), child)
                for key, child in items]

    def clear(self):
        with self._lock:
            self._by_values.clear()
            self._children.clear()


class Counter(_Family):
    kind = "counter"

    def _new_child(self):
        return _Value()

    def inc(self, amount=1.0):
        self._default().inc(amount)


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _Value()

    def set(self, value):
        self._default().set(value)

    def inc(self, amount=1.0):
        self._default().inc(amount)


class Histogram(_Family):
    kind = "histogram"

    DEFAULT_BUCKETS = exponential_buckets(1e-5, 2.0, 22)  # 10us .. ~21s

    def __init__(self, name, documentation, labelnames=(), buckets=None):
        super().__init__(name, documentation, labelnames)
        b = tuple(float(x) for x in (buckets or self.DEFAULT_BUCKETS))
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError("histogram buckets must be strictly increasing")
        self.buckets = b

    def _new_child(self):
        return _HistogramValue(self.buckets)

    def observe(self, value):
        self._default().observe(value)


class MetricsRegistry:
    """Name -> family registry with idempotent getters (a second
    ``counter()`` call with the same schema returns the existing family —
    instrumentation sites don't coordinate creation order)."""

    def __init__(self, prefix="horovod"):
        self.prefix = prefix
        self._families = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, documentation, labelnames, **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) \
                        or fam.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} re-registered with a different "
                        f"type/label schema ({fam.kind}{fam.labelnames} vs "
                        f"{cls.kind}{tuple(labelnames)})")
                return fam
            fam = cls(name, documentation, labelnames, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name, documentation, labelnames=()):
        return self._get_or_create(Counter, name, documentation, labelnames)

    def gauge(self, name, documentation, labelnames=()):
        return self._get_or_create(Gauge, name, documentation, labelnames)

    def histogram(self, name, documentation, labelnames=(), buckets=None):
        return self._get_or_create(Histogram, name, documentation,
                                   labelnames, buckets=buckets)

    def families(self):
        with self._lock:
            return list(self._families.values())

    def reset(self):
        """Zero every series (keep the registered families) — test/bench
        hygiene."""
        for fam in self.families():
            fam.clear()

    # --- exposition ----------------------------------------------------

    def snapshot(self):
        """JSON-able nested dict of every series' current value. Counters/
        gauges: ``{"labels": {...}, "value": v}``; histograms additionally
        carry cumulative ``buckets`` ([le, count] pairs), ``sum`` and
        ``count``."""
        out = {}
        for fam in self.families():
            series = []
            for labels, child in fam.series():
                if fam.kind == "histogram":
                    cum, s, c = child.get()
                    series.append({"labels": labels,
                                   "buckets": [[le, n] for le, n in cum],
                                   "sum": s, "count": c})
                else:
                    series.append({"labels": labels, "value": child.get()})
            out[fam.name] = {"type": fam.kind,
                             "help": fam.documentation,
                             "series": series}
        return out

    def render_text(self):
        """Prometheus text exposition format 0.0.4 of the whole registry."""
        lines = []
        prefix = f"{self.prefix}_" if self.prefix else ""
        for fam in self.families():
            full = prefix + fam.name
            lines.append(f"# HELP {full} {fam.documentation}")
            lines.append(f"# TYPE {full} {fam.kind}")
            for labels, child in fam.series():
                base_lab = ",".join(
                    f'{k}="{_escape_label_value(v)}"'
                    for k, v in labels.items())
                if fam.kind == "histogram":
                    cum, s, c = child.get()
                    for le, n in cum:
                        le_s = "+Inf" if le == "+Inf" else _fmt(le)
                        lab = (base_lab + "," if base_lab else "") \
                            + f'le="{le_s}"'
                        lines.append(f"{full}_bucket{{{lab}}} {n}")
                    suffix = f"{{{base_lab}}}" if base_lab else ""
                    lines.append(f"{full}_sum{suffix} {_fmt(s)}")
                    lines.append(f"{full}_count{suffix} {c}")
                else:
                    suffix = f"{{{base_lab}}}" if base_lab else ""
                    lines.append(f"{full}{suffix} {_fmt(child.get())}")
        return "\n".join(lines) + "\n"
