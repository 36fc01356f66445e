"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` works like ``import horovod.torch as
hvd``: collectives run over NCCL on the GPU (gloo on the CPU), and every
TPU kernel of the JAX package on the ported path is a CUDA kernel written
for Hopper (``ops/kernels/csrc``). The package imports PyTorch and never JAX
or the JAX package. As the JAX package does, it also exports the quantized
wire tier (``hvd.wire``, ``hvd.set_wire_dtype``, ``hvd.wire_dtype_for``)
the hierarchical tiers' strategy pin (``hvd.set_dispatch_strategy``) and
the hierarchical alltoall's pins (``hvd.set_alltoall_strategy``,
``hvd.set_alltoall_cross_dtype``), and the per-rank observability planes:
``hvd.metrics``, ``hvd.trace``, ``hvd.flight`` (``hvd.step_marker``,
``hvd.flight_summary``), ``hvd.profile`` (``hvd.step_report``,
``hvd.step_report_summary``, ``hvd.set_flops_per_step``),
``hvd.goodput``, ``hvd.metrics_snapshot`` and ``hvd.metrics_text``, and
the cluster telemetry plane and the control plane's chaos injection:
``hvd.telemetry``, ``hvd.cluster_snapshot`` and ``hvd.chaos``.

``HVD_LOCK_WITNESS=1`` at import installs hvdrace's acquisition witness
(``horovod_tpu_torch.analysis.race``) before any of the package's modules
allocates a lock; ``HVD_LOCK_WITNESS_FILE=<path>`` dumps the edges it saw
there when the process exits.
"""

# HVD_LOCK_WITNESS=1: swap threading.Lock/RLock for hvdrace's recording
# proxies BEFORE any package module allocates a lock, so every acquisition
# edge lands in the witness log.
import os as _os  # noqa: E402

if _os.environ.get("HVD_LOCK_WITNESS", "").strip() in ("1", "true", "on"):
    from horovod_tpu_torch.analysis import race as _race

    _race.maybe_install_from_env()
del _os

from horovod_tpu_torch.torch import *  # noqa: F401,F403,E402
from horovod_tpu_torch.torch import __all__  # noqa: F401
from horovod_tpu_torch.ops import wire  # noqa: F401
from horovod_tpu_torch.ops.wire import (set_dispatch_strategy,  # noqa: F401
                                        set_wire_dtype, wire_dtype_for,
                                        set_alltoall_strategy,
                                        set_alltoall_cross_dtype)
from horovod_tpu_torch.common.basics import (  # noqa: F401
    metrics_snapshot, metrics_text)
from horovod_tpu_torch import metrics  # noqa: F401
from horovod_tpu_torch import trace  # noqa: F401
from horovod_tpu_torch import flight  # noqa: F401
from horovod_tpu_torch import profile  # noqa: F401
from horovod_tpu_torch import goodput  # noqa: F401
from horovod_tpu_torch import telemetry  # noqa: F401
from horovod_tpu_torch.telemetry import cluster_snapshot  # noqa: F401
from horovod_tpu_torch import chaos  # noqa: F401
from horovod_tpu_torch.flight.recorder import step_marker  # noqa: F401
from horovod_tpu_torch.flight.recorder import summary as flight_summary  # noqa: F401
from horovod_tpu_torch.profile import (  # noqa: F401
    step_report, step_report_summary, set_flops_per_step,
)
