"""horovod_tpu_torch — the PyTorch/CUDA port of horovod_tpu.

``import horovod_tpu_torch as hvd`` works like ``import horovod.torch as
hvd``: collectives run over NCCL on the GPU (gloo on the CPU), and every
TPU kernel of the JAX package on the ported path is a CUDA kernel written
for Hopper (``ops/kernels/csrc``). The package imports PyTorch and never JAX
or the JAX package. As the JAX package does, it also exports the quantized
wire tier (``hvd.wire``, ``hvd.set_wire_dtype``, ``hvd.wire_dtype_for``)
the hierarchical tiers' strategy pin (``hvd.set_dispatch_strategy``) and
the hierarchical alltoall's pins (``hvd.set_alltoall_strategy``,
``hvd.set_alltoall_cross_dtype``).
"""

from horovod_tpu_torch.torch import *  # noqa: F401,F403
from horovod_tpu_torch.torch import __all__  # noqa: F401
from horovod_tpu_torch.ops import wire  # noqa: F401
from horovod_tpu_torch.ops.wire import (set_dispatch_strategy,  # noqa: F401
                                        set_wire_dtype, wire_dtype_for,
                                        set_alltoall_strategy,
                                        set_alltoall_cross_dtype)
