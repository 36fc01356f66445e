"""The cluster telemetry plane, and the declared serving SLOs.

Port of the JAX package's ``telemetry/``: the plane that composes the
per-rank planes into one job-level answer to "is this job healthy, and
which slice or rank is the problem?", without scraping every rank:

- every process publishes a compact **digest** (liveness beacon, step and
  attribution means, flight-recorder anomaly counts, watchdog findings,
  a mergeable metrics snapshot) to the launcher's HTTP-KV store
  (:mod:`horovod_tpu_torch.telemetry.digest`);
- each **slice leader** merges its slice's digests into one slice summary
  (:mod:`horovod_tpu_torch.telemetry.aggregator`), so the fan-in above the
  slice scales with the slice count, not the world;
- the **job leader** (the lowest live slice's leader) composes the slice
  summaries into the job view: per-rank health (healthy, straggling,
  desynced, stalled, dead; :mod:`horovod_tpu_torch.telemetry.health`), the
  job's step medians and a bounded transition log.

Read it with ``hvd.cluster_snapshot()``, the scrape endpoint's
``/cluster/health``, ``/cluster/steps`` and ``/cluster/metrics``, or
``python -m horovod_tpu_torch.telemetry.top``. Leadership is leased by
freshness: a leader that stops beaconing is replaced within a couple of
intervals. Knobs: ``HOROVOD_TELEMETRY`` (default on),
``HOROVOD_TELEMETRY_INTERVAL`` and the health thresholds
(``HOROVOD_TELEMETRY_*``, ``common/config.py``). The declared serving SLOs
and their burn rates are :mod:`horovod_tpu_torch.telemetry.slo`.
"""

from horovod_tpu_torch.telemetry.aggregator import (  # noqa: F401
    TelemetryAgent, cluster_snapshot, get_agent, start_from_config, stop,
)
from horovod_tpu_torch.telemetry import digest, health  # noqa: F401
from horovod_tpu_torch.telemetry import slo  # noqa: F401
