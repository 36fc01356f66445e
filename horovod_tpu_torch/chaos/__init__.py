"""Chaos: deterministic, seeded fault injection.

Port of the JAX package's ``chaos/``:

- :mod:`horovod_tpu_torch.chaos.plan`: declarative, seeded fault plans
  (kind x site x trigger), parsed from JSON (YAML with PyYAML) or the
  ``HOROVOD_CHAOS_PLAN`` / ``HOROVOD_CHAOS_SEED`` env (``hvdrun-torch
  --chaos-plan`` sets them).
- :mod:`horovod_tpu_torch.chaos.injector`: the process-local runtime behind
  the named sites of the KV client, negotiation, the dispatch, the fusion
  flush, elastic commit and rendezvous, the elastic driver's discovery and
  the telemetry tick. Off by default: each site is one bool check. Every
  firing counts into ``chaos_injections_total{site,kind}`` and appends to a
  per-rank JSONL ledger.
- :mod:`horovod_tpu_torch.chaos.soak`: the elastic-recovery soaks (a kill,
  a KV drop and a straggler; a telemetry leader's kill; the autopilot's
  straggler removal; goodput's badput brackets) over the elastic launcher
  with CPU (gloo) workers.
"""

from horovod_tpu_torch.chaos.plan import (  # noqa: F401
    KINDS, SITES, ChaosPlan, FaultSpec,
)
from horovod_tpu_torch.chaos.injector import (  # noqa: F401
    filter_hosts, fire, install, install_from_env, ledger_path,
    ledger_schedule, plan, read_ledger, set_role, set_step, stats,
    uninstall,
)
from horovod_tpu_torch.chaos import injector  # noqa: F401


def armed():
    """Whether a plan is armed in this process (a live view: the module
    attribute ``injector.armed`` is the hot-path gate)."""
    return injector.armed
