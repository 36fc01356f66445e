"""Metrics: a process-local registry of counters, gauges and histograms, and
a Prometheus-style scrape endpoint.

Port of the JAX package's ``metrics/`` package: every eager collective,
fused bucket, fusion flush, elastic lifecycle event, goodput delta, step
record, watchdog finding and serving event is counted into one registry
(:mod:`horovod_tpu_torch.metrics.instruments`, JAX's catalogue whole),
exposed three ways —

- :func:`snapshot` / :func:`render_text` (Prometheus text exposition),
- an optional background HTTP scrape endpoint (``HOROVOD_METRICS_PORT``,
  started by ``hvd.init()``, or :func:`start_http_server`), which also
  serves ``/serving/health`` and the ``/debug/profile``, ``/debug/steps``
  and ``/debug/flight`` routes,
- Chrome-trace counter events merged into the timeline
  (:func:`emit_timeline_counters`).

:mod:`horovod_tpu_torch.metrics.merge` combines snapshots across ranks.
Knobs: ``HOROVOD_METRICS`` (default on), ``HOROVOD_METRICS_PORT`` (default
off), ``HOROVOD_METRICS_ADDR``, ``HOROVOD_METRICS_PREFIX`` (default
``horovod``).
"""

from horovod_tpu_torch.metrics.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, exponential_buckets,
)
from horovod_tpu_torch.metrics.instruments import (  # noqa: F401
    REGISTRY, enabled, set_enabled, set_prefix, get_registry,
    emit_timeline_counters, maybe_emit_timeline_counters,
    record_boundary, record_chaos, record_collective,
    record_collective_error, record_collective_latency,
    record_compile_cache, record_elastic_event, record_elastic_recovery,
    record_fusion_flush, record_fusion_kv, record_http_kv, record_kv_retry,
    record_negotiation, record_plan_cache, record_serving_queue,
    record_serving_request, record_serving_step, record_serving_ttft,
    record_slo_burn, record_stall,
)
from horovod_tpu_torch.metrics.server import (  # noqa: F401
    MetricsServer, http_server_port, start_http_server, stop_http_server,
)
from horovod_tpu_torch.metrics import merge  # noqa: F401  (mergeable snapshots)


def snapshot():
    """JSON-able dict of every series' current value."""
    return REGISTRY.snapshot()


def render_text():
    """Prometheus text exposition (format 0.0.4) of the whole registry."""
    return REGISTRY.render_text()


def reset():
    """Zero every series (registered families survive) — test hygiene."""
    return REGISTRY.reset()
