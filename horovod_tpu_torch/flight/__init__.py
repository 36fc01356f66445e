"""Collective flight recorder: always-armed crash forensics.

Port of the JAX package's ``flight/`` package, its two halves with the
same names:

- :mod:`horovod_tpu_torch.flight.recorder` — a per-rank, default-on,
  fixed-size ring buffer of structured events (collective dispatches and
  completions with per-process-set sequence numbers, fusion enqueues and
  flushes, elastic transitions, stalls, step markers), recorded
  lock-cheap and dumped as JSONL on the paths where a run would otherwise
  leave nothing: the dispatch failure epilogue, the elastic restore and
  removal, SIGTERM/atexit during an elastic teardown, ``SIGUSR2``, and on
  demand via ``GET /debug/flight`` on the metrics endpoint.
- :mod:`horovod_tpu_torch.flight.analyze` — the post-mortem CLI
  (``python -m horovod_tpu_torch.flight.analyze <dir>``): merge per-rank
  dumps, name the first diverging collective, rank stragglers by
  host-latency skew, rebuild per-step breakdowns and emit a merged
  Perfetto-loadable Chrome trace. It reads dumps of either package: both
  write the same schema and the same signatures.

Knobs: ``HOROVOD_FLIGHT_RECORDER`` (default 1), ``HOROVOD_FLIGHT_CAPACITY``
(default 4096), ``HOROVOD_FLIGHT_DIR`` / ``hvdrun-torch --flight-dir``.
"""

from horovod_tpu_torch.flight import recorder  # noqa: F401
from horovod_tpu_torch.flight.recorder import (  # noqa: F401
    FlightRecorder, configure, dump, dump_dir, driver_mark, enabled, events,
    record_dispatch, record_complete, record_event, render_jsonl, set_enabled,
    set_role, signature, step_marker, summary,
)
# Not imported eagerly: `python -m horovod_tpu_torch.flight.analyze` would
# then find the module pre-imported by its own package and warn (runpy);
# the analyzer is import-on-use (`from horovod_tpu_torch.flight import
# analyze`).
