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
``hvd.goodput``, ``hvd.metrics_snapshot`` and ``hvd.metrics_text``.
"""

from horovod_tpu_torch.torch import *  # noqa: F401,F403
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
from horovod_tpu_torch.flight.recorder import step_marker  # noqa: F401
from horovod_tpu_torch.flight.recorder import summary as flight_summary  # noqa: F401
from horovod_tpu_torch.profile import (  # noqa: F401
    step_report, step_report_summary, set_flops_per_step,
)
