"""Autopilot: the online self-driving controller.

Port of the JAX package's ``autopilot/``, steering the port's fusion
runtime and elastic driver.

Closes the loop from the signal plane the repo already carries —
step-profiler attribution, fusion fill ratios, dispatch-plan hit rates,
per-tier wire bytes, telemetry health, watchdog findings — to the
runtime's knobs, and from health verdicts to the elastic driver:

- :mod:`horovod_tpu_torch.autopilot.signals` — per-decision-epoch
  :class:`SignalFrame` deltas over every signal source, fail-soft.
- :mod:`horovod_tpu_torch.autopilot.controller` — the coordinator-rank
  control loop: the :class:`~horovod_tpu_torch.autotune.parameter_manager.
  ParameterManager` BO driven online (``suggest``/``observe``) over
  fusion threshold + cycle time + strategy + wire dtype, the cross-leg
  overlap point and the per-tier (DCN) wire as controller-owned levers,
  guarded by bounded moves, revert-on-regression (step-profiler
  robust-z) and converge-then-freeze. Followers adopt flips at flush
  boundaries.
- :mod:`horovod_tpu_torch.autopilot.remediate` — watchdog/telemetry verdicts
  → blacklist + re-rendezvous through the elastic driver, with
  hysteresis, a removal rate limit, a do-not-shrink floor, and the
  existing blacklist cooldown governing re-admission.

Armed by ``HOROVOD_AUTOPILOT=1`` / ``hvdrun-torch --autopilot``; every
decision and remediation is an ``autopilot_decision`` /
``autopilot_remediate`` flight event plus
``autopilot_decisions_total{lever,outcome}`` /
``autopilot_remediations_total{cause,outcome}`` metrics, so the whole
trail is post-mortem-able via ``python -m horovod_tpu_torch.flight.analyze``.
"""

from horovod_tpu_torch.autopilot.controller import (  # noqa: F401
    AutopilotController, get_controller, start_from_config, stop,
)
from horovod_tpu_torch.autopilot.remediate import (  # noqa: F401
    DriverArm, RemediationPolicy,
)
from horovod_tpu_torch.autopilot.signals import (  # noqa: F401
    SignalFrame, cluster_view, frame, snapshot,
)
