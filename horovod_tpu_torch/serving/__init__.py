"""Continuous-batching inference for the PyTorch/CUDA port.

Port of the JAX package's ``serving/``: a request queue and slot scheduler
front a causal LM; admitted requests pack into a fixed-slot decode batch
with a per-slot KV cache, slots retire and refill independently, and the
whole state rides the elastic machinery (``ServingState``), so a scale
change or a worker kill drops no in-flight request. The serving and SLO
series land on the metrics endpoint, whose ``/serving/health`` is the
readiness frame. ``soak.py``, the chaos soak, comes with the chaos
harness's soak (ROADMAP A17's second half).
"""

from horovod_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine, get_engine, sample_token, serving_snapshot,
)
from horovod_tpu_torch.serving.request import Request  # noqa: F401
from horovod_tpu_torch.serving.scheduler import (  # noqa: F401
    QueueFull, SlotScheduler,
)
from horovod_tpu_torch.serving.state import ServingState  # noqa: F401
