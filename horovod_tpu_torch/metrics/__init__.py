"""Metrics: a process-local registry of counters, gauges and histograms, and
a Prometheus-style scrape endpoint.

Port of the JAX package's ``metrics/`` package for the series the serving
path records (:mod:`horovod_tpu_torch.metrics.instruments`), exposed as

- :func:`snapshot` / :func:`render_text` (Prometheus text exposition),
- an optional background HTTP scrape endpoint (``HOROVOD_METRICS_PORT``,
  started by ``hvd.init()``, or :func:`start_http_server`), which also
  serves the serving engine's ``/serving/health``.

Knobs: ``HOROVOD_METRICS`` (default on), ``HOROVOD_METRICS_PORT`` (default
off), ``HOROVOD_METRICS_ADDR``, ``HOROVOD_METRICS_PREFIX`` (default
``horovod``). The training series, the timeline counters and the mergeable
snapshots (``merge.py``) come with ROADMAP A16.
"""

from horovod_tpu_torch.metrics.registry import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, exponential_buckets,
)
from horovod_tpu_torch.metrics.instruments import (  # noqa: F401
    REGISTRY, enabled, get_registry, record_serving_queue,
    record_serving_request, record_serving_step, record_serving_ttft,
    record_slo_burn, set_enabled, set_prefix,
)
from horovod_tpu_torch.metrics.server import (  # noqa: F401
    MetricsServer, http_server_port, start_http_server, stop_http_server,
)


def snapshot():
    """JSON-able dict of every series' current value."""
    return REGISTRY.snapshot()


def render_text():
    """Prometheus text exposition (format 0.0.4) of the whole registry."""
    return REGISTRY.render_text()


def reset():
    """Zero every series (registered families survive) — test hygiene."""
    return REGISTRY.reset()
