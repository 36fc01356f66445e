"""Eager collectives on per-rank torch tensors.

Port of the JAX package's ``ops/collective_ops.py``: ``ReduceOp``,
``allreduce``/``grouped_allreduce`` and their async handles,
``allgather``, ``broadcast``, ``barrier`` and ``broadcast_object``. Tensors
are per-rank, as in the reference's ``horovod.torch`` — not the JAX eager
API's rank-major stacked layout — and live on the device ``hvd.init()``
chose.

Allreduce semantics follow ``_reduce_shard``: prescale each rank's tensor,
reduce (Sum/Average/Min/Max/Product/Adasum), divide by the set size for
Average, postscale. fp32/fp16/bf16 tensors go through the fusion runtime
(``ops/fusion.py``), where the pack kernel applies the prescale and the
unpack kernel the postscale, with Average's ``1/n`` folded into it; other
dtypes, which no kernel takes, are reduced one collective each. Adasum
gathers every rank's tensor and runs the combine tree of ``ops/adasum.py``
on it (float64 too, one gather each); it refuses integer tensors.

``allgather`` concatenates the ranks' tensors, which must share one shape,
along dim 0 (ragged first dims are not ported yet, ROADMAP A2).
"""

import enum
import hashlib
import pickle

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (ProcessSetError,
                                                  TensorShapeMismatchError)
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.ops.kernels.scale_buffers import DTYPES as _KERNEL_DTYPES


class ReduceOp(enum.IntEnum):
    """reference: horovod/common/message.h:43-50 (enum ReduceOp)."""
    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

# Gather into one tensor that holds the ranks' inputs one after another
# along dim 0 (all_gather_single takes over all_gather_into_tensor's name
# from torch 2.13 on).
all_gather_flat = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor

# Average is a Sum on the wire; the 1/n is applied after it.
DIST_OPS = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def _process_set(process_set):
    ps = global_process_set if process_set is None else process_set
    if ps.process_set_id is None:
        raise ProcessSetError(f"{ps} is not registered")
    if not ps.included():
        raise ProcessSetError(
            f"rank {basics.rank()} is not a member of {ps}")
    return ps


def rank_digests(sig, ps):
    """A 64-bit hash of ``repr(sig)`` and every rank's hash of its own, in
    rank order: one small all-gather, for checks that ranks agree."""
    digest = int.from_bytes(
        hashlib.blake2b(repr(sig).encode(), digest_size=8).digest(),
        "little", signed=True)
    mine = torch.tensor([digest], dtype=torch.int64, device=basics.device())
    every = torch.empty(ps.size(), dtype=torch.int64, device=mine.device)
    all_gather_flat(every, mine, group=ps.group)
    return digest, every.tolist()


def _check_tensor(t, what):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} takes torch tensors, got {type(t).__name__}")
    dev = basics.device()
    if t.device != dev:
        raise ValueError(f"{what}: tensor is on {t.device}, but hvd.init() "
                         f"runs this process on {dev}")


class Handle:
    """A collective already issued: done on the CPU, ordered on the
    device's stream on the GPU (reference: handle_manager.h)."""

    __slots__ = ("_outputs", "name")

    def __init__(self, outputs, name=None):
        self._outputs = outputs
        self.name = name

    def poll(self):
        return True

    def synchronize(self):
        return self._outputs

    wait = synchronize


def _allreduce_unfused(t, out, op, prescale, postscale, ps):
    """Integer and float64 tensors: outside the fusion kernel's dtypes,
    reduced by one collective each."""
    if not t.is_floating_point() and (prescale != 1.0 or postscale != 1.0):
        raise ValueError("prescale/postscale factors need a floating-point "
                         "tensor")
    out.copy_(t)
    if prescale != 1.0:
        out.mul_(prescale)
    dist.all_reduce(out, op=DIST_OPS[op], group=ps.group)
    if op == ReduceOp.AVERAGE:
        out.div_(ps.size())
    if postscale != 1.0:
        out.mul_(postscale)
    return Handle(out)


def _adasum_unfused(t, out, prescale, postscale, ps):
    """float64 under Adasum, outside the scale kernel's dtypes: prescale,
    one gather, the combine tree (whose kernel reads float64 into fp32),
    postscale."""
    from horovod_tpu_torch.ops.adasum import reduce_gathered
    x = t.reshape(-1) * prescale if prescale != 1.0 else t.reshape(-1)
    gathered = torch.empty(ps.size() * x.numel(), dtype=t.dtype,
                           device=t.device)
    all_gather_flat(gathered, x.contiguous(), group=ps.group)
    out.copy_(reduce_gathered(gathered.view(ps.size(), -1),
                              (x.numel(),)).view(out.shape))
    if postscale != 1.0:
        out.mul_(postscale)
    return Handle(out)


def grouped_allreduce_async(tensors, op=Average, prescale_factor=1.0,
                            postscale_factor=1.0, process_set=None,
                            name=None, outputs=None):
    """Queue an allreduce of every tensor in ``tensors``; returns one handle
    per tensor. Same-dtype tensors of a group share one fusion bucket
    whatever the threshold (reference: grouped enqueue, operations.cc:1480).

    ``outputs``: optional per-tensor contiguous destinations (``None``
    entries allocate one); an output may be its input, for the in-place
    variants.
    """
    op = ReduceOp(op)
    ps = _process_set(process_set)
    tensors = list(tensors)
    outputs = list(outputs) if outputs is not None else [None] * len(tensors)
    if len(outputs) != len(tensors):
        raise ValueError("outputs must match tensors one to one")
    for i, t in enumerate(tensors):
        _check_tensor(t, "allreduce")
        if op == ReduceOp.AVERAGE and not t.is_floating_point():
            raise ValueError(
                "Average is not supported for integer tensors; use hvd.Sum "
                "(matches reference torch/mpi_ops.py checks).")
        if op == ReduceOp.ADASUM and not t.is_floating_point():
            raise TypeError(
                f"Adasum combines floating-point tensors; got {t.dtype} "
                "(the reference's Adasum refuses integer tensors too)")
        out = outputs[i]
        if out is None:
            outputs[i] = torch.empty_like(
                t, memory_format=torch.contiguous_format)
        elif out.shape != t.shape or out.dtype != t.dtype \
                or out.device != t.device or not out.is_contiguous():
            raise ValueError("an allreduce output must be a contiguous tensor "
                             "of its input's shape, dtype and device")
    names = [f"{name}.{i}" if name and len(tensors) > 1 else name
             for i in range(len(tensors))]
    handles = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        if t.dtype in _KERNEL_DTYPES:
            by_dtype.setdefault(t.dtype, []).append(i)
        elif op == ReduceOp.ADASUM:
            handles[i] = _adasum_unfused(t, outputs[i],
                                         float(prescale_factor),
                                         float(postscale_factor), ps)
        else:
            handles[i] = _allreduce_unfused(t, outputs[i], op,
                                            float(prescale_factor),
                                            float(postscale_factor), ps)
    if by_dtype:
        from horovod_tpu_torch.ops.fusion import get_runtime
        rt = get_runtime()
        for idxs in by_dtype.values():
            hs = rt.enqueue([tensors[i].contiguous() for i in idxs],
                            [outputs[i] for i in idxs], op,
                            float(prescale_factor), float(postscale_factor),
                            ps, [names[i] for i in idxs])
            for i, h in zip(idxs, hs):
                handles[i] = h
    return handles


def allreduce_async(tensor, op=Average, prescale_factor=1.0,
                    postscale_factor=1.0, process_set=None, name=None,
                    output=None):
    """Async allreduce through the tensor-fusion runtime (reference: every
    async allreduce rides the fusion buffer, operations.cc:747-853)."""
    return grouped_allreduce_async(
        [tensor], op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        name=name, outputs=None if output is None else [output])[0]


def allreduce(tensor, op=Average, prescale_factor=1.0, postscale_factor=1.0,
              process_set=None, name=None):
    """reference: hvd.allreduce (torch/mpi_ops.py:294-360; op semantics
    message.h:43-50, pre/postscale operations.cc:1480)."""
    return allreduce_async(tensor, op=op, prescale_factor=prescale_factor,
                           postscale_factor=postscale_factor,
                           process_set=process_set, name=name).synchronize()


def grouped_allreduce(tensors, op=Average, prescale_factor=1.0,
                      postscale_factor=1.0, process_set=None, name=None):
    """One fused dispatch for a group of tensors, completing together
    (reference: EnqueueTensorAllreduces operations.cc:1480)."""
    return [h.synchronize() for h in grouped_allreduce_async(
        tensors, op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        name=name)]


def allgather(tensor, process_set=None, name=None):
    """Every rank's tensor concatenated along dim 0, in rank order
    (reference: hvd.allgather torch/mpi_ops.py:655-712). The ranks' tensors
    must share one shape and dtype: a mismatch raises
    ``TensorShapeMismatchError``. A 0-d tensor gathers into a vector."""
    ps = _process_set(process_set)
    _check_tensor(tensor, "allgather")
    t = tensor.reshape(1) if tensor.dim() == 0 else tensor.contiguous()
    digest, every = rank_digests((tuple(t.shape), str(t.dtype)), ps)
    if any(h != digest for h in every):
        raise TensorShapeMismatchError(
            f"allgather: the ranks' tensors differ in shape or dtype (this "
            f"rank: {tuple(t.shape)} {t.dtype}); gathering ragged first dims "
            "is not ported yet (ROADMAP A2)")
    out = torch.empty((ps.size() * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    all_gather_flat(out, t, group=ps.group)
    return out


def broadcast(tensor, root_rank, process_set=None, name=None, inplace=False):
    """Broadcast the root rank's tensor (reference: hvd.broadcast
    torch/mpi_ops.py:843-900); ``root_rank`` is a global rank. A tensor off
    the runtime's device (an optimizer's CPU step count) is staged through
    the device."""
    ps = _process_set(process_set)
    if root_rank not in ps.rank_list():
        raise ValueError(f"broadcast root_rank {root_rank} is not a member "
                         f"of {ps} (ranks {ps.rank_list()})")
    if not isinstance(tensor, torch.Tensor):
        raise TypeError(f"broadcast takes torch tensors, got "
                        f"{type(tensor).__name__}")
    out = tensor if inplace else tensor.clone()
    dev = basics.device()
    buf = out if out.device == dev and out.is_contiguous() \
        else out.to(dev, memory_format=torch.contiguous_format)
    dist.broadcast(buf, src=root_rank, group=ps.group)
    if buf is not out:
        out.copy_(buf)
    return out


def barrier(process_set=None, name=None):
    """Block until every rank of the set reaches the barrier (reference:
    hvd.barrier, operations.cc EnqueueBarrier)."""
    ps = _process_set(process_set)
    dev = basics.device()
    if dev.type == "cuda":
        dist.barrier(group=ps.group, device_ids=[dev.index])
    else:
        dist.barrier(group=ps.group)


def poll(handle):
    return handle.poll()


def synchronize(handle):
    return handle.synchronize()


def broadcast_object(obj, root_rank=0, process_set=None, name=None):
    """Pickle on the root, broadcast the length and the bytes, unpickle
    everywhere (reference: torch/functions.py broadcast_object)."""
    ps = _process_set(process_set)
    dev = basics.device()
    payload = pickle.dumps(obj) if basics.rank() == root_rank else b""
    length = broadcast(torch.tensor([len(payload)], dtype=torch.int64,
                                    device=dev),
                       root_rank, process_set=ps, inplace=True)
    buf = torch.empty(int(length.item()), dtype=torch.uint8, device=dev)
    if payload:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    broadcast(buf, root_rank, process_set=ps, name=name, inplace=True)
    return pickle.loads(buf.cpu().numpy().tobytes())
