"""The serving and SLO series of the metrics catalogue, and their recorders.

Port of the part of the JAX package's ``metrics/instruments.py`` that the
serving path reaches: the registry, the enable and prefix switches, the
bucket helpers, the serving and SLO series and their ``record_*``
functions, with JAX's names, labels, units and buckets. The training
series and their hooks at the dispatch sites come with the rest of the
observability planes (ROADMAP A16), as do the flight-recorder events that
JAX's ``record_serving_request`` adds for requeues and rejections.

Catalogue (names shown without the ``HOROVOD_METRICS_PREFIX``, default
``horovod``):

- ``serving_requests_total{event}``                 request lifecycle
  (event=submitted|admitted|completed|requeued|rejected; counter)
- ``serving_ttft_seconds``                          submit → first
  generated token (histogram; the SLO p50/p99 source)
- ``serving_token_latency_seconds``                 decode-step wall time
  = inter-token latency for every active request (histogram)
- ``serving_tokens_total``                          generated tokens
  (counter; rate() = tokens/sec)
- ``serving_queue_depth``                           admission queue depth
  (gauge)
- ``serving_batch_fill_ratio``                      active slots / total
  slots per decode step (histogram)
- ``slo_burn_rate{objective}``                      rolling-window SLO
  error-budget burn (objective=ttft_p99|tps; gauge; computed by
  ``telemetry/slo.py`` from HOROVOD_SLO_TTFT_P99_MS / HOROVOD_SLO_TPS)

Every recorder is a no-op when metrics are disabled (``HOROVOD_METRICS=0``)
and never raises into the hot path.
"""

import os

from horovod_tpu_torch.metrics.registry import (MetricsRegistry,
                                                exponential_buckets)

_enabled = os.environ.get("HOROVOD_METRICS", "1").lower() \
    not in ("0", "false", "no", "off")

REGISTRY = MetricsRegistry(
    prefix=os.environ.get("HOROVOD_METRICS_PREFIX", "horovod"))


def get_registry():
    return REGISTRY


def enabled():
    return _enabled


def set_enabled(value):
    global _enabled
    _enabled = bool(value)


def set_prefix(prefix):
    REGISTRY.prefix = prefix


# --- the catalogue (created eagerly so HELP/TYPE lines are always part of
# the exposition, observed or not) --------------------------------------

_RATIO_BUCKETS = exponential_buckets(1.0 / 64, 2.0, 9)     # ~0.016 .. 4

SERVING_REQUESTS = REGISTRY.counter(
    "serving_requests_total",
    "Serving-engine request lifecycle events (horovod_tpu/serving): "
    "submitted|admitted|completed|requeued (re-queued from the last "
    "committed token after an elastic disruption)|rejected (queue full).",
    ("event",))
SERVING_TTFT = REGISTRY.histogram(
    "serving_ttft_seconds",
    "Time-to-first-token per request: submit() to the first generated "
    "token's commit (includes queue wait + prefill — the user-facing "
    "p50/p99 SLO).",
    buckets=exponential_buckets(1e-4, 2.0, 22))        # 100us .. ~3.5min
SERVING_TOKEN_LATENCY = REGISTRY.histogram(
    "serving_token_latency_seconds",
    "Decode-step wall time — the inter-token latency every active "
    "request observed on that step (admission/prefill excluded; they "
    "land in serving_ttft_seconds).",
    buckets=exponential_buckets(1e-5, 2.0, 22))        # 10us .. ~21s
SERVING_TOKENS = REGISTRY.counter(
    "serving_tokens_total",
    "Generated tokens committed by the serving engine (rate() is the "
    "fleet tokens/sec).")
SERVING_QUEUE_DEPTH = REGISTRY.gauge(
    "serving_queue_depth",
    "Requests waiting for a slot in the serving admission queue "
    "(sampled at every submit/admit; the first thing to read when "
    "requests time out — docs/troubleshooting.md).")
SLO_BURN = REGISTRY.gauge(
    "slo_burn_rate",
    "Rolling-window SLO error-budget burn per declared objective "
    "(objective=ttft_p99|tps; horovod_tpu/telemetry/slo.py). 0 = inside "
    "the SLO, 1.0 = consuming the error budget exactly, > 1 = burning "
    "it — the admission/scale-up signal the autopilot SignalFrame and "
    "`telemetry top --serving` read.",
    ("objective",))
SERVING_FILL = REGISTRY.histogram(
    "serving_batch_fill_ratio",
    "Active slots / total slots at each decode step (1.0 = the "
    "continuous batch is full; persistently low fill under a deep queue "
    "means admission is starved — a scheduler bug).",
    buckets=_RATIO_BUCKETS)


def record_serving_request(event):
    """One serving request lifecycle event (event=submitted|admitted|
    completed|requeued|rejected)."""
    if not _enabled:
        return
    SERVING_REQUESTS.labels(event).inc()


def record_serving_ttft(seconds):
    if not _enabled:
        return
    SERVING_TTFT.observe(seconds)


def record_serving_step(seconds, active, slots, tokens=0):
    """One serving decode step: inter-token latency, fill ratio, and the
    tokens it committed."""
    if not _enabled:
        return
    SERVING_TOKEN_LATENCY.observe(seconds)
    if slots:
        SERVING_FILL.observe(active / float(slots))
    if tokens:
        SERVING_TOKENS.inc(tokens)


def record_serving_queue(depth):
    if not _enabled:
        return
    SERVING_QUEUE_DEPTH.set(depth)


def record_slo_burn(objective, burn):
    """Current burn rate of one declared SLO objective (set by
    telemetry/slo.py whenever a window is recomputed)."""
    if not _enabled:
        return
    SLO_BURN.labels(objective).set(float(burn))
