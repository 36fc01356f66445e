"""Two-level allreduce and allgather over a (cross, local) layout.

Port of the JAX package's ``parallel/strategies.py`` (``allreduce_torus``,
``allreduce_tiered``, ``allgather_hierarchical``,
``allreduce_hierarchical``) on torch tensors and the subgroups of a
``common.topology.Tiers``: its *local* group is this rank's row (a node, or
a slice) and its *cross* group this rank's column. Reference algorithms:
``NCCLHierarchicalAllreduce`` (HOROVOD_HIERARCHICAL_ALLREDUCE), the fork's
``NCCLTorusAllreduce`` (HOROVOD_TORUS_ALLREDUCE, nccl_operations.cc:606-843;
SURVEY.md §1) and ``MPIHierarchicalAllgather``
(HOROVOD_HIERARCHICAL_ALLGATHER).

- torus: pad the flat buffer to a multiple of the local size, reduce-scatter
  it on the local group, allreduce this rank's shard on the cross group
  (exact, or ``wire.block_scaled_allreduce`` with a residual of the shard's
  size when the cross wire is ``int8``/``fp8`` and the shard is eligible),
  all-gather the shards on the local group, cut the padding. Every local
  rank's cross leg runs on its own communicator, in parallel, and moves
  1/local of the bytes over the slow link.
- hierarchical: a full allreduce on the local group, then on the cross
  group: the whole buffer crosses, and no divisibility is needed.
- the hierarchical allgather gathers on the local group, then exchanges one
  block per node on the cross group, in global rank-major order.

The sums round as the JAX functions' do only where their operands meet in
the same order; on a 2 x 2 layout every sum has two operands, so the tiers
are bit-equal to JAX's. ``average`` multiplies by the fp32 reciprocal of
the world size, as XLA compiles JAX's ``/ n``.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.ops import wire as _wire


def cross_label(cross_wire, shard_elems, cross_n, all_float=True):
    """The quantized wire the cross leg rides (``int8``/``fp8``), or None:
    the shared refusal of ``wire.quantized_eligible`` (a shard below one
    BLOCK per cross rank, or a non-float payload, stays exact)."""
    label = _wire.quantized_label(cross_wire)
    if cross_wire not in (None, "", "int8", "fp8", "float16", "bfloat16"):
        raise ValueError(
            f"unknown cross_compression {cross_wire!r}; use None/'' "
            "(exact), 'int8' or 'fp8' (16-bit wire names are accepted and "
            "keep the cross leg exact)")
    if label is not None and not _wire.quantized_eligible(
            shard_elems, cross_n, all_float, True):
        return None
    return label


def torus_(buf, tiers, label=None, residual=None):
    """The torus schedule on ``buf``, a flat buffer whose length divides by
    the local size, in place: local reduce-scatter, the cross leg (exact,
    or quantized on ``label`` with ``residual``, an fp32 tensor of the
    shard's size), local all-gather. Returns ``(buf, new_residual)``
    (``residual`` itself when the cross leg stays exact)."""
    from horovod_tpu_torch.ops.collective_ops import (all_gather_flat,
                                                      launch,
                                                      reduce_scatter_flat)
    shard = torch.empty(buf.numel() // tiers.cols, dtype=buf.dtype,
                        device=buf.device)
    launch(reduce_scatter_flat, shard, buf, op=dist.ReduceOp.SUM,
           group=tiers.local_group)
    new_res = residual
    if label is not None:
        shard, new_res = _wire.block_scaled_allreduce(
            shard, residual=residual, group=tiers.cross_group, wire=label)
    else:
        launch(dist.all_reduce, shard, op=dist.ReduceOp.SUM,
               group=tiers.cross_group)
    launch(all_gather_flat, buf, shard, group=tiers.local_group)
    return buf, new_res


def hierarchical_(buf, tiers):
    """A full allreduce of ``buf`` on the local group, then on the cross
    group, in place."""
    from horovod_tpu_torch.ops.collective_ops import launch
    launch(dist.all_reduce, buf, op=dist.ReduceOp.SUM,
           group=tiers.local_group)
    launch(dist.all_reduce, buf, op=dist.ReduceOp.SUM,
           group=tiers.cross_group)
    return buf


def _average(out, n):
    return out * torch.tensor(_wire.fp32_reciprocal(n), dtype=out.dtype)


def allreduce_torus(x, tiers, average=False, cross_compression=None,
                    cross_residual=None):
    """2-level allreduce of this rank's ``x`` (JAX ``allreduce_torus``).
    ``cross_compression`` ``"int8"``/``"fp8"`` quantizes the cross leg
    alone; with ``cross_residual`` (fp32, the shard's size,
    ``ceil(x.numel() / local)``) returns ``(out, new_residual)``."""
    local_n, cross_n = tiers.cols, tiers.rows
    flat = x.reshape(-1)
    pad = (-flat.numel()) % local_n
    buf = torch.nn.functional.pad(flat, (0, pad)) if pad else flat.clone()
    label = cross_label(cross_compression, buf.numel() // local_n, cross_n,
                        x.is_floating_point())
    buf, new_res = torus_(buf, tiers, label, cross_residual)
    out = buf[:flat.numel()].reshape(x.shape)
    if average:
        out = _average(out, local_n * cross_n)
    if cross_residual is not None:
        return out, new_res
    return out


def allreduce_tiered(x, tiers, average=False, cross_wire="", residual=None,
                     prescale_factor=1.0, postscale_factor=1.0):
    """The hierarchical dispatch tier's entry (JAX ``allreduce_tiered``):
    the prescale, :func:`allreduce_torus` with ``cross_wire`` on the cross
    leg, then the postscale, folded with Average's reciprocal into one
    product as XLA folds them. With ``residual`` returns
    ``(out, new_residual)``."""
    if prescale_factor != 1.0:
        x = x * torch.tensor(prescale_factor, dtype=x.dtype)
    out = allreduce_torus(x, tiers, cross_compression=cross_wire or None,
                          cross_residual=residual)
    out, new_res = out if residual is not None else (out, None)
    scale = fold_scale(tiers.rows * tiers.cols if average else 1,
                       postscale_factor)
    if scale != 1.0:
        out = out * torch.tensor(scale, dtype=out.dtype)
    return out if residual is None else (out, new_res)


def fold_scale(n, postscale_factor):
    """``(1 / n) * postscale`` as XLA folds the two constants: in fp32, the
    reciprocal rounded first."""
    s = torch.tensor(_wire.fp32_reciprocal(n), dtype=torch.float32)
    return float(s * torch.tensor(postscale_factor, dtype=torch.float32))


def allgather_hierarchical(x, tiers):
    """2-level allgather (JAX ``allgather_hierarchical``): this rank's
    ``x`` gathered on the local group, then one block per node on the
    cross group. Returns ``(n, *x.shape)`` in global rank-major order."""
    from horovod_tpu_torch.ops.collective_ops import all_gather_flat, launch
    flat = x.reshape(-1).contiguous()
    local = torch.empty(tiers.cols * flat.numel(), dtype=x.dtype,
                        device=x.device)
    launch(all_gather_flat, local, flat, group=tiers.local_group)
    full = torch.empty(tiers.rows * local.numel(), dtype=x.dtype,
                       device=x.device)
    launch(all_gather_flat, full, local, group=tiers.cross_group)
    return full.view((-1,) + tuple(x.shape))


def allreduce_hierarchical(x, tiers, average=False):
    """A full local allreduce, then a cross allreduce (JAX
    ``allreduce_hierarchical``)."""
    out = hierarchical_(x.reshape(-1).clone(), tiers).reshape(x.shape)
    if average:
        out = _average(out, tiers.rows * tiers.cols)
    return out
