"""The ``horovod.torch`` API surface of the PyTorch/CUDA port.

Port of the JAX package's ``torch/__init__.py``: the same names and
signatures for init and the rank/size family (``ici_built`` among the
capability queries), process sets, the allreduce (Sum, Average, Min, Max,
Product, Adasum), allgather (ragged first dims too), alltoall,
reducescatter and broadcast families with their async handles,
``sparse_allreduce_async``, ``join``, barrier, compression, the parameter,
optimizer-state and object broadcasts, ``allgather_object`` and
``DistributedOptimizer``, elastic training (``elastic.run``,
``TorchState``, ``ElasticSampler``, ``mark_new_rank_ready``,
``read_new_rank_ready``), ``SyncBatchNorm`` and the int8 wire's
``Int8Compressor``. The timeline (``start_timeline``/``stop_timeline``,
ROADMAP A16) is the only part of the reference surface still to port.
"""

from horovod_tpu_torch.common.basics import (
    ccl_built, cross_rank, cross_size, cuda_built, ddl_built, device,
    gloo_built, gloo_enabled, ici_built, init, is_homogeneous, is_initialized,
    local_rank, local_size, mpi_built, mpi_enabled, mpi_threads_supported,
    nccl_built, rank, rocm_built, shutdown, size, xla_built)
from horovod_tpu_torch.common.exceptions import HorovodInternalError
from horovod_tpu_torch.common.process_sets import (ProcessSet,
                                                   add_process_set,
                                                   global_process_set,
                                                   process_set_by_id,
                                                   remove_process_set)
from horovod_tpu_torch.elastic.worker import (mark_new_rank_ready,
                                              read_new_rank_ready)
from horovod_tpu_torch.common.util import (check_extension,
                                           check_installed_version,
                                           gpu_available,
                                           num_rank_is_power_2, split_list)
from horovod_tpu_torch.torch.compression import (BF16Compressor, Compression,
                                                 Compressor, FP16Compressor,
                                                 Int8Compressor,
                                                 NoneCompressor)
from horovod_tpu_torch.torch.functions import (allgather_object,
                                               broadcast_object,
                                               broadcast_optimizer_state,
                                               broadcast_parameters)
from horovod_tpu_torch.torch.mpi_ops import (
    Adasum, Average, Max, Min, Product, ReduceOp, Sum, allgather,
    allgather_async, allreduce, allreduce_, allreduce_async, allreduce_async_,
    alltoall, alltoall_async, barrier, broadcast, broadcast_, broadcast_async,
    broadcast_async_, grouped_allgather, grouped_allgather_async,
    grouped_allreduce, grouped_allreduce_, grouped_allreduce_async,
    grouped_allreduce_async_, grouped_reducescatter,
    grouped_reducescatter_async, join, poll, reducescatter,
    reducescatter_async, sparse_allreduce_async, synchronize)
from horovod_tpu_torch.torch import elastic
from horovod_tpu_torch.torch.elastic import ElasticSampler, TorchState
from horovod_tpu_torch.torch.optimizer import DistributedOptimizer
from horovod_tpu_torch.torch.sync_batch_norm import SyncBatchNorm

__all__ = [
    "init", "shutdown", "is_initialized", "rank", "local_rank", "cross_rank",
    "size", "local_size", "cross_size", "device", "is_homogeneous",
    "mpi_threads_supported", "mpi_enabled", "mpi_built", "gloo_enabled",
    "gloo_built", "nccl_built", "ddl_built", "ccl_built", "cuda_built",
    "rocm_built", "xla_built", "ici_built",
    "ProcessSet", "add_process_set", "global_process_set",
    "process_set_by_id", "remove_process_set",
    "ReduceOp", "Average", "Sum", "Adasum", "Min", "Max", "Product",
    "Compression", "Compressor", "NoneCompressor", "FP16Compressor",
    "BF16Compressor", "Int8Compressor", "SyncBatchNorm",
    "allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
    "grouped_allreduce", "grouped_allreduce_", "grouped_allreduce_async",
    "grouped_allreduce_async_", "allgather", "allgather_async",
    "grouped_allgather", "grouped_allgather_async", "alltoall",
    "alltoall_async", "reducescatter", "reducescatter_async",
    "grouped_reducescatter", "grouped_reducescatter_async",
    "sparse_allreduce_async", "broadcast", "broadcast_", "broadcast_async",
    "broadcast_async_", "barrier", "join", "poll", "synchronize",
    "broadcast_parameters", "broadcast_optimizer_state", "broadcast_object",
    "allgather_object",
    "DistributedOptimizer", "HorovodInternalError", "elastic",
    "TorchState", "ElasticSampler", "mark_new_rank_ready",
    "read_new_rank_ready", "check_extension",
    "check_installed_version", "gpu_available", "num_rank_is_power_2",
    "split_list",
]
