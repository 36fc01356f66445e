"""The ``horovod.torch`` collectives on the port's runtime.

Port of the JAX package's ``torch/mpi_ops.py`` (reference:
horovod/torch/mpi_ops.py sync + async wrappers, handles :1245-1283): the
allreduce family with compression (Adasum included), the legacy
``average=`` flag and the in-place ``*_`` variants, allgather (ragged first
dims too), alltoall (with splits), the reducescatter family, the broadcast
family, ``sparse_allreduce_async``, ``join``, ``poll``, ``synchronize`` and
``barrier``. Where the JAX frontend moves torch tensors through numpy into
XLA, the port keeps them on the device: an in-place allreduce is unpacked
straight into the caller's tensor.
"""

from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average, Max, Min,
                                                  Product, ReduceOp, Sum)
from horovod_tpu_torch.ops.compression import Compression

__all__ = ["allreduce", "allreduce_", "allreduce_async", "allreduce_async_",
           "grouped_allreduce", "grouped_allreduce_",
           "grouped_allreduce_async", "grouped_allreduce_async_",
           "allgather", "allgather_async", "grouped_allgather",
           "grouped_allgather_async", "alltoall", "alltoall_async",
           "reducescatter", "reducescatter_async", "grouped_reducescatter",
           "grouped_reducescatter_async", "sparse_allreduce_async",
           "broadcast", "broadcast_", "broadcast_async", "broadcast_async_",
           "barrier", "join", "poll", "synchronize",
           "Average", "Sum", "Adasum", "Min", "Max", "Product", "ReduceOp"]


class _TorchHandle:
    """Runtime handle plus the frontend's post-processing: decompress, and
    for the in-place ``*_async_`` contract copy into the caller's tensor
    when the reduction did not already land there."""

    __slots__ = ("_inner", "_compression", "_ctx", "_target", "_output",
                 "_done")

    def __init__(self, inner, compression, ctx, target=None):
        self._inner = inner
        self._compression = compression
        self._ctx = ctx
        self._target = target
        self._output = None
        self._done = False

    def poll(self):
        return self._inner.poll()

    def synchronize(self):
        if not self._done:
            out = self._compression.decompress(self._inner.synchronize(),
                                               self._ctx)
            if self._target is not None and out is not self._target:
                self._target.copy_(out)
                out = self._target
            self._output = out
            self._done = True
        return self._output

    wait = synchronize


def poll(handle):
    return handle.poll()


def synchronize(handle):
    return handle.synchronize()


def _resolve_op(average, op):
    if op is not None and average is not None:
        raise ValueError("specify either op or the legacy average flag, "
                         "not both (matches reference check)")
    if op is None:
        op = Average if (average is None or average) else Sum
    return op


def _grouped_async(tensors, average, name, compression, op, prescale_factor,
                   postscale_factor, process_set, inplace):
    op = _resolve_op(average, op)
    compression = compression or Compression.none
    pairs = [compression.compress(t) for t in tensors]
    # In place: reduce straight into the (compressed) tensor when it is
    # contiguous; otherwise into a new tensor copied back on synchronize.
    outputs = [c if inplace and c.is_contiguous() else None
               for c, _ in pairs]
    inner = C.grouped_allreduce_async(
        [c for c, _ in pairs], op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        name=name, outputs=outputs)
    return [_TorchHandle(h, compression, ctx, t if inplace else None)
            for h, (_, ctx), t in zip(inner, pairs, tensors)]


def allreduce_async(tensor, average=None, name=None, compression=None,
                    op=None, prescale_factor=1.0, postscale_factor=1.0,
                    process_set=None):
    return _grouped_async([tensor], average, name, compression, op,
                          prescale_factor, postscale_factor, process_set,
                          inplace=False)[0]


def allreduce_async_(tensor, average=None, name=None, compression=None,
                     op=None, prescale_factor=1.0, postscale_factor=1.0,
                     process_set=None):
    return _grouped_async([tensor], average, name, compression, op,
                          prescale_factor, postscale_factor, process_set,
                          inplace=True)[0]


def allreduce(tensor, average=None, name=None, compression=None, op=None,
              prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    """reference: hvd.allreduce (torch/mpi_ops.py:294-360; the legacy
    ``average=`` flag maps onto op like the reference's handle_average)."""
    C.order_check("allreduce", (tensor,), process_set)
    return allreduce_async(tensor, average=average, name=name,
                           compression=compression, op=op,
                           prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor,
                           process_set=process_set).synchronize()


def allreduce_(tensor, average=None, name=None, compression=None, op=None,
               prescale_factor=1.0, postscale_factor=1.0, process_set=None):
    """In-place variant (reference: allreduce_ torch/mpi_ops.py:363-421)."""
    C.order_check("allreduce", (tensor,), process_set)
    return allreduce_async_(tensor, average=average, name=name,
                            compression=compression, op=op,
                            prescale_factor=prescale_factor,
                            postscale_factor=postscale_factor,
                            process_set=process_set).synchronize()


def grouped_allreduce_async(tensors, average=None, name=None,
                            compression=None, op=None, prescale_factor=1.0,
                            postscale_factor=1.0, process_set=None):
    """One fused dispatch for the group (reference: EnqueueTensorAllreduces
    operations.cc:1480)."""
    return _grouped_async(tensors, average, name, compression, op,
                          prescale_factor, postscale_factor, process_set,
                          inplace=False)


def grouped_allreduce_async_(tensors, average=None, name=None,
                             compression=None, op=None, prescale_factor=1.0,
                             postscale_factor=1.0, process_set=None):
    return _grouped_async(tensors, average, name, compression, op,
                          prescale_factor, postscale_factor, process_set,
                          inplace=True)


def grouped_allreduce(tensors, average=None, name=None, compression=None,
                      op=None, prescale_factor=1.0, postscale_factor=1.0,
                      process_set=None):
    C.order_check("allreduce", tensors, process_set)
    return [h.synchronize() for h in grouped_allreduce_async(
        tensors, average=average, name=name, compression=compression, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)]


def grouped_allreduce_(tensors, average=None, name=None, compression=None,
                       op=None, prescale_factor=1.0, postscale_factor=1.0,
                       process_set=None):
    """In-place grouped allreduce (reference: torch/mpi_ops.py:553-589)."""
    C.order_check("allreduce", tensors, process_set)
    return [h.synchronize() for h in grouped_allreduce_async_(
        tensors, average=average, name=name, compression=compression, op=op,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor,
        process_set=process_set)]


def allgather(tensor, name=None, process_set=None):
    """reference: hvd.allgather (torch/mpi_ops.py:655-712): every rank's
    tensor concatenated along dim 0; the first dims may differ."""
    return C.allgather(tensor, process_set=process_set, name=name)


def allgather_async(tensor, name=None, process_set=None):
    return C.Handle(allgather(tensor, name=name, process_set=process_set),
                    name)


def grouped_allgather(tensors, name=None, process_set=None):
    return [allgather(t, name=name, process_set=process_set)
            for t in tensors]


def grouped_allgather_async(tensors, name=None, process_set=None):
    return [allgather_async(t, name=name, process_set=process_set)
            for t in tensors]


def alltoall(tensor, splits=None, name=None, process_set=None):
    """reference: hvd.alltoall (torch/mpi_ops.py:928-1014): the rows of
    ``tensor`` scattered to the ranks, equally or by ``splits``; returns the
    received rows, and with ``splits`` also the received row counts."""
    return C.alltoall(tensor, splits=splits, process_set=process_set,
                      name=name)


def alltoall_async(tensor, splits=None, name=None, process_set=None):
    return C.Handle(alltoall(tensor, splits=splits, name=name,
                             process_set=process_set), name)


def reducescatter(tensor, op=Sum, name=None, process_set=None,
                  prescale_factor=1.0, postscale_factor=1.0):
    """reference: hvd.reducescatter (torch/mpi_ops.py:1066-1123): this
    rank's rows ``rank*m/n:(rank+1)*m/n`` of the reduction (Sum or
    Average)."""
    return reducescatter_async(tensor, op=op, name=name,
                               process_set=process_set,
                               prescale_factor=prescale_factor,
                               postscale_factor=postscale_factor).synchronize()


def reducescatter_async(tensor, op=Sum, name=None, process_set=None,
                        prescale_factor=1.0, postscale_factor=1.0):
    return grouped_reducescatter_async(
        [tensor], op=op, name=name, process_set=process_set,
        prescale_factor=prescale_factor,
        postscale_factor=postscale_factor)[0]


def grouped_reducescatter(tensors, op=Sum, name=None, process_set=None,
                          prescale_factor=1.0, postscale_factor=1.0):
    return [h.synchronize() for h in grouped_reducescatter_async(
        tensors, op=op, name=name, process_set=process_set,
        prescale_factor=prescale_factor, postscale_factor=postscale_factor)]


def grouped_reducescatter_async(tensors, op=Sum, name=None,
                                process_set=None, prescale_factor=1.0,
                                postscale_factor=1.0):
    """The group's tensors of each fusion dtype reduce-scatter as one
    collective (one pack and one unpack launch on the card)."""
    return C.grouped_reducescatter_async(
        tensors, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        name=name)


class _SparseHandle(C.Handle):
    """The reference's sparse handle is a callable; ``synchronize`` takes it
    too."""

    __slots__ = ()

    def __call__(self):
        return self.synchronize()


def sparse_allreduce_async(tensor, name, op, process_set=None):
    """Allreduce of a ``torch.sparse_coo_tensor`` by gathering its indices
    and values (duplicates sum on coalesce); returns a callable handle
    (reference: torch/mpi_ops.py:591-612)."""
    return _SparseHandle(C.sparse_allreduce(tensor, op=op,
                                            process_set=process_set,
                                            name=name), name)


def join(device=None, process_set=None):
    """reference: hvd.join (torch/mpi_ops_v2.cc DoJoin). ``device`` is
    accepted for API compatibility; a process drives one device. Returns
    the global rank of the last rank to join."""
    return C.join(process_set=process_set)


def broadcast(tensor, root_rank, name=None, process_set=None):
    """reference: hvd.broadcast (torch/mpi_ops.py:843-900)."""
    return C.broadcast(tensor, root_rank, process_set=process_set, name=name)


def broadcast_(tensor, root_rank, name=None, process_set=None):
    return C.broadcast(tensor, root_rank, process_set=process_set, name=name,
                       inplace=True)


def broadcast_async(tensor, root_rank, name=None, process_set=None):
    return C.Handle(broadcast(tensor, root_rank, name=name,
                              process_set=process_set), name)


def broadcast_async_(tensor, root_rank, name=None, process_set=None):
    return C.Handle(broadcast_(tensor, root_rank, name=name,
                               process_set=process_set), name)


def barrier(process_set=None, name=None):
    C.barrier(process_set=process_set, name=name)
