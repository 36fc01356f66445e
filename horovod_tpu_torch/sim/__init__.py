"""hvdsim — the event-driven scale digital twin (port of the JAX
package's ``sim/``).

Virtual ranks as generators over a deterministic event heap
(:mod:`~horovod_tpu_torch.sim.core`), control-plane programs that mirror the
real exchange math (:mod:`~horovod_tpu_torch.sim.control`), and a
twin-pretrained autopilot prior (:mod:`~horovod_tpu_torch.sim.autopilot`).
``python -m horovod_tpu_torch.sim`` runs the scale-guard battery with
lint-style exit codes; ``--pretrain PATH`` writes the prior."""

from horovod_tpu_torch.sim.core import LatencyModel, Simulator, SimTimeout
from horovod_tpu_torch.sim.control import (FLAT_WORLD_CAP, TwinJob,
                                           flat_reference, twin_exchange)

__all__ = [
    "FLAT_WORLD_CAP", "LatencyModel", "SimTimeout", "Simulator",
    "TwinJob", "flat_reference", "twin_exchange",
]
