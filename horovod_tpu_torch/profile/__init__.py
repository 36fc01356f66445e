"""Step profiler: per-step time attribution, MFU/roofline accounting, and
on-demand trace capture.

Port of the JAX package's ``profile/`` package: every training step closes
into ONE structured record attributing its wall time to compute vs
collective vs host-dispatch vs fusion vs control-plane, plus roofline
context (achieved TFLOP/s against the device's peak, bytes/s against the
link roof) and, on the GPU, the fused buckets' device time from CUDA
events.

Modules:

- :mod:`horovod_tpu_torch.profile.ledger`   — the per-step performance
  ledger (the hot-path instrumentation target; ``hvd.step_report()``)
- :mod:`horovod_tpu_torch.profile.roofline` — per-device peak tables + MFU
  math (an H100 SXM row and the CPU placeholder)
- :mod:`horovod_tpu_torch.profile.watchdog` — online straggler/regression
  detection (rolling robust z-score, low-cadence cross-rank store publish)
- :mod:`horovod_tpu_torch.profile.capture`  — on-demand ``torch.profiler``
  trace windows (``GET /debug/profile``, ``HOROVOD_PROFILE_STEPS=a:b``)
- :mod:`horovod_tpu_torch.profile.report`   — ``python -m
  horovod_tpu_torch.profile.report`` CLI over the ``HVD_STEP_REPORT_FILE``
  JSONL

Knobs: ``HOROVOD_STEP_PROFILER`` (default on), ``HVD_STEP_REPORT_FILE``
(JSONL stream), ``HOROVOD_PROFILE_STEPS``, ``HOROVOD_PROFILE_DIR``,
``HOROVOD_PROFILE_PUBLISH_STEPS``.
"""

from horovod_tpu_torch.profile.ledger import (  # noqa: F401
    step_report, step_report_summary, set_flops_per_step, reset_window,
    configure, enabled, set_enabled,
)
from horovod_tpu_torch.profile.roofline import (  # noqa: F401
    chip_peaks, detect_chip,
)
from horovod_tpu_torch.profile.watchdog import findings as watchdog_findings  # noqa: F401
