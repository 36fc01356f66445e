"""Collectives inside a training step, over named mesh axes.

Port of the JAX package's ``ops/in_jit.py``. There, a step runs inside
``shard_map`` and a collective names a mesh axis that the trace binds. Here
a step is ordinary eager code: a named axis is a dim of a
``torch.distributed.DeviceMesh`` (:func:`make_mesh`, ``init_device_mesh``
with named dims; gloo on the CPU, NCCL on the card), and entering
:func:`axes` binds the mesh's dims for the code inside. Each name then
resolves to the process group of this rank's row along that dim.

- :func:`axis_bound`, :func:`axis_size_or_1`, :func:`axis_size` and
  :func:`axis_index` are the counterparts of ``parallel/tp.py``'s
  ``axis_bound``/``axis_size_or_1`` and ``lax.axis_size``/``axis_index``.
  Outside :func:`axes`, as outside ``shard_map``, no axis is bound and every
  module of ``parallel/`` takes its local, unsharded form.
- :func:`allreduce`, :func:`allgather`, :func:`broadcast`,
  :func:`reducescatter`, :func:`alltoall` and :func:`ppermute` keep
  ``in_jit.py``'s semantics: op, prescale and postscale (Average divides
  after the sum), and a ``process_set`` whose ``ranks`` are positions on the
  axis, served SPMD-style: every rank of the axis calls, Sum and Average
  ride one all-reduce with non-members contributing zero, the other ops
  gather the axis and select the set's rows, and a non-member receives the
  set's result, which it is expected to ignore.
- Autograd follows JAX's transposes: the all-reduce's backward is the
  identity (Megatron's "g", what ``psum``'s transpose is under JAX's
  varying-axes types), an all-gather's a reduce-scatter and back, an
  all-to-all's the inverse all-to-all, a ``ppermute``'s the inverse
  permutation. :func:`copy_to_axis` is Megatron's "f": the identity forward
  and an all-reduce of the cotangent backward, which JAX's ``pvary``
  transposes to where a replicated activation meets a sharded weight.
- On an axis of size 1 every collective returns its input (an all-gather
  or ``ppermute`` its one row) and calls no process group, as XLA drops a
  collective over one device.

``mark_varying`` and ``mark_varying_like`` have no counterpart: they exist
for JAX's varying-manual-axes type checks, which PyTorch does not have.
"""

import contextlib

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.topology import HVD_AXIS
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average, Max, Min,
                                                  Product, ReduceOp, Sum,
                                                  all_gather_flat,
                                                  reduce_scatter_flat)

_BOUND = []          # the meshes entered with axes(), innermost last


def make_mesh(axes_, device_type=None):
    """A ``DeviceMesh`` over the whole world with one named dim per entry
    of ``axes_`` (an ordered ``{name: size}``; the sizes multiply to the
    world size), rank-major as ``jax.sharding.Mesh`` lays out a reshaped
    device array. ``device_type`` defaults to ``hvd.init``'s device's.
    Collective: every rank calls it, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh
    names = tuple(axes_)
    sizes = tuple(int(axes_[n]) for n in names)
    world = dist.get_world_size()
    total = 1
    for s in sizes:
        total *= s
    if total != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} holds {total} "
                         f"ranks, the world {world}")
    if device_type is None:
        device_type = basics.device().type
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


@contextlib.contextmanager
def axes(mesh):
    """Bind ``mesh``'s dim names inside: the counterpart of running inside
    ``shard_map`` over that mesh."""
    _BOUND.append(mesh)
    try:
        yield mesh
    finally:
        _BOUND.pop()


def _mesh_of(axis_name):
    for mesh in reversed(_BOUND):
        if axis_name in (mesh.mesh_dim_names or ()):
            return mesh
    return None


def axis_bound(axis_name):
    """True when ``axis_name`` names a dim of a bound mesh, even at size
    1."""
    return axis_name is not None and _mesh_of(axis_name) is not None


def axis_size_or_1(axis_name):
    """The size of ``axis_name`` when bound, else 1."""
    mesh = None if axis_name is None else _mesh_of(axis_name)
    return 1 if mesh is None else mesh.size(_dim(mesh, axis_name))


def _dim(mesh, axis_name):
    return mesh.mesh_dim_names.index(axis_name)


def _bound_mesh(axis_name):
    mesh = None if axis_name is None else _mesh_of(axis_name)
    if mesh is None:
        raise NameError(f"unbound axis name: {axis_name}")
    return mesh


def axis_size(axis_name=HVD_AXIS):
    """``lax.axis_size``: NameError when ``axis_name`` is not bound."""
    mesh = _bound_mesh(axis_name)
    return mesh.size(_dim(mesh, axis_name))


def axis_index(axis_name=HVD_AXIS):
    """``lax.axis_index``: this rank's position along ``axis_name`` (the
    mesh's coordinate, which asks no process group)."""
    mesh = _bound_mesh(axis_name)
    return mesh.get_coordinate()[_dim(mesh, axis_name)]


def axis_ranks(axis_name=HVD_AXIS):
    """The global ranks of this rank's row along ``axis_name``, in axis
    order (the mesh's coordinates; no process group is asked)."""
    mesh = _bound_mesh(axis_name)
    idx = list(mesh.get_coordinate())
    idx[_dim(mesh, axis_name)] = slice(None)
    return mesh.mesh[tuple(idx)].tolist()


def axis_group(axis_name=HVD_AXIS):
    """The process group of this rank's row along ``axis_name``."""
    return _bound_mesh(axis_name).get_group(axis_name)


size = axis_size
rank = axis_index


# ---------------------------------------------------------------------------
# Autograd primitives
# ---------------------------------------------------------------------------

def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    """Megatron's "g": the sum forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToAxis(torch.autograd.Function):
    """Megatron's "f": the identity forward, the cotangent summed over the
    axis backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def _gather_first(x, group, n):
    """(n * d0, ...) all-gather of ``x`` along dim 0, rank-major."""
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    all_gather_flat(out, x, group=group)
    return out


def _scatter_first(x, group, n):
    """The sum over the axis of ``x``'s dim-0 block of this rank."""
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    reduce_scatter_flat(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Tiled all-gather along dim 0; backward: its reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_first(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_first(g, ctx.group, ctx.n), None, None


class _ReduceScatter(torch.autograd.Function):
    """Tiled sum-scatter along dim 0; backward: its all-gather."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_first(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_first(g, ctx.group, ctx.n), None, None


def _all_to_all(x, group, n, split_axis, concat_axis):
    parts = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all; backward: the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.meta = (group, n, split_axis, concat_axis)
        return _all_to_all(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.meta
        return _all_to_all(g, group, n, concat_axis, split_axis), None, \
            None, None, None


class Shift:
    """Point-to-point transfers of tensors over an axis group, posted at
    once with ``batch_isend_irecv``: ``wait()`` returns the received
    tensors (zeros where this rank receives nothing). ``send_to`` and
    ``recv_from`` are positions on the axis, or None."""

    def __init__(self, tensors, group, send_to, recv_from):
        self.works = []
        me = dist.get_rank(group)
        if send_to == me and recv_from == me:     # a ring of one
            self.out = list(tensors)
            return
        ranks = dist.get_process_group_ranks(group)
        self.out = [torch.zeros(t.shape, dtype=t.dtype, device=t.device)
                    for t in tensors]
        ops = []
        if send_to is not None:
            ops += [dist.P2POp(dist.isend, t.contiguous(), ranks[send_to],
                               group) for t in tensors]
        if recv_from is not None:
            ops += [dist.P2POp(dist.irecv, o, ranks[recv_from], group)
                    for o in self.out]
        if ops:
            self.works = dist.batch_isend_irecv(ops)

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []
        return self.out


def _perm_peers(perm, me):
    send_to = [d for s, d in perm if s == me]
    recv_from = [s for s, d in perm if d == me]
    if len(send_to) > 1 or len(recv_from) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    return (send_to[0] if send_to else None,
            recv_from[0] if recv_from else None)


class _PPermute(torch.autograd.Function):
    """``lax.ppermute``; backward: the inverse permutation."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        me = dist.get_rank(group)
        return Shift([x], group, *_perm_peers(perm, me)).wait()[0]

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        me = dist.get_rank(ctx.group)
        return Shift([g], ctx.group, *_perm_peers(inv, me)).wait()[0], \
            None, None


# ---------------------------------------------------------------------------
# Collectives over an axis
# ---------------------------------------------------------------------------

def _alone(axis_name):
    """True when ``axis_name`` is unbound or of size 1."""
    return axis_size_or_1(axis_name) == 1


def copy_to_axis(x, axis_name):
    """Megatron's "f" over ``axis_name``; the identity when unbound or of
    size 1."""
    if _alone(axis_name):
        return x
    return _CopyToAxis.apply(x, axis_group(axis_name))


def reduce_from_axis(x, axis_name):
    """Megatron's "g" (``psum``) over ``axis_name``; the identity when
    unbound or of size 1."""
    if _alone(axis_name):
        return x
    return _AllReduceSum.apply(x, axis_group(axis_name))


def _ranks(process_set):
    if process_set is None or getattr(process_set, "ranks", None) is None:
        return None
    return list(process_set.ranks)


def _scaled(x, factor):
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


def _member(ranks, axis_name):
    return axis_index(axis_name) in ranks


def _gather_select(x, ranks, axis_name):
    """All-gather the axis, then the set's rows: (set, ...)."""
    n = axis_size(axis_name)
    g = _AllGather.apply(x[None], axis_group(axis_name), n)
    return g[torch.tensor(ranks, device=x.device)]


def _pos_in_set(ranks, axis_name):
    idx = axis_index(axis_name)
    return ranks.index(idx) if idx in ranks else 0


def _tree(rows):
    from horovod_tpu_torch.ops.adasum import adasum_tree
    return adasum_tree(list(rows.unbind(0)))


def allreduce(x, op=Average, axis_name=HVD_AXIS, process_set=None,
              prescale_factor=1.0, postscale_factor=1.0):
    ranks = _ranks(process_set)
    op = ReduceOp(op)
    if prescale_factor != 1.0:
        x = _scaled(x, prescale_factor)
    if ranks is None:
        n = axis_size(axis_name)
        if n == 1:
            y = x                  # every op of one row is the row
        elif op in (Sum, Average):
            y = _AllReduceSum.apply(x, axis_group(axis_name))
            if op == Average:
                y = y / torch.tensor(n, dtype=y.dtype, device=y.device)
        elif op in (Min, Max):
            y = _all_reduce(x.detach(), axis_group(axis_name),
                            dist.ReduceOp.MIN if op == Min
                            else dist.ReduceOp.MAX)
        elif op == Product:
            y = _gather_select(x, list(range(n)), axis_name).prod(dim=0)
        elif op == Adasum:
            y = _tree(_gather_select(x, list(range(n)), axis_name))
        else:
            raise ValueError(f"unknown op {op}")
    else:
        n = len(ranks)
        if op in (Sum, Average):
            keep = x if _member(ranks, axis_name) else torch.zeros_like(x)
            y = _AllReduceSum.apply(keep, axis_group(axis_name))
            if op == Average:
                y = y / torch.tensor(n, dtype=y.dtype, device=y.device)
        elif op in (Min, Max, Product):
            g = _gather_select(x, ranks, axis_name)
            y = {Min: lambda t: t.amin(dim=0), Max: lambda t: t.amax(dim=0),
                 Product: lambda t: t.prod(dim=0)}[op](g)
        elif op == Adasum:
            y = _tree(_gather_select(x, ranks, axis_name))
        else:
            raise ValueError(f"unknown op {op}")
    if postscale_factor != 1.0:
        y = _scaled(y, postscale_factor)
    return y


def allgather(x, axis_name=HVD_AXIS, process_set=None, axis=0, tiled=True):
    ranks = _ranks(process_set)
    if ranks is None:
        ranks = list(range(axis_size(axis_name)))
        if len(ranks) == 1:
            return x if tiled else x.unsqueeze(axis)
    g = _gather_select(x, ranks, axis_name)             # (set, ...)
    g = g.movedim(0, axis)
    if tiled:
        g = g.flatten(axis, axis + 1)
    return g


def broadcast(x, root_rank, axis_name=HVD_AXIS, process_set=None):
    if axis_size(axis_name) == 1:
        return x
    keep = x if axis_index(axis_name) == root_rank else torch.zeros_like(x)
    if x.dtype == torch.bool:
        return _AllReduceSum.apply(keep.to(torch.int32),
                                   axis_group(axis_name)).to(torch.bool)
    return _AllReduceSum.apply(keep, axis_group(axis_name))


def reducescatter(x, op=Sum, axis_name=HVD_AXIS, process_set=None,
                  scatter_axis=0):
    op = ReduceOp(op)
    if op not in (Sum, Average):
        raise ValueError("reducescatter supports Sum/Average")
    ranks = _ranks(process_set)
    if ranks is None:
        n = axis_size(axis_name)
        if x.shape[scatter_axis] % n:
            raise ValueError(f"reducescatter: axis {scatter_axis} size "
                             f"{x.shape[scatter_axis]} not divisible by the "
                             f"axis size {n}")
        y = x if n == 1 else _ReduceScatter.apply(
            x.movedim(scatter_axis, 0), axis_group(axis_name), n).movedim(
                0, scatter_axis)
    else:
        n = len(ranks)
        if x.shape[scatter_axis] % n:
            raise ValueError(f"reducescatter: axis {scatter_axis} size "
                             f"{x.shape[scatter_axis]} not divisible by set "
                             f"size {n}")
        keep = x if _member(ranks, axis_name) else torch.zeros_like(x)
        full = _AllReduceSum.apply(keep, axis_group(axis_name))
        chunk = x.shape[scatter_axis] // n
        y = full.narrow(scatter_axis, _pos_in_set(ranks, axis_name) * chunk,
                        chunk)
    if op == Average:
        y = y / torch.tensor(n, dtype=y.dtype, device=y.device)
    return y


def alltoall(x, axis_name=HVD_AXIS, process_set=None, split_axis=0,
             concat_axis=0):
    ranks = _ranks(process_set)
    if ranks is None:
        n = axis_size(axis_name)
        if x.shape[split_axis] % n:
            raise ValueError(f"alltoall: axis {split_axis} size "
                             f"{x.shape[split_axis]} not divisible by the "
                             f"axis size {n}")
        if n == 1:
            return x
        return _AllToAll.apply(x, axis_group(axis_name), n, split_axis,
                               concat_axis)
    n = len(ranks)
    if x.shape[split_axis] % n:
        raise ValueError(f"alltoall: axis {split_axis} size "
                         f"{x.shape[split_axis]} not divisible by set size "
                         f"{n}")
    chunk = x.shape[split_axis] // n
    g = _gather_select(x, ranks, axis_name)
    pos = _pos_in_set(ranks, axis_name)
    return torch.cat([g[i].narrow(split_axis, pos * chunk, chunk)
                      for i in range(n)], dim=concat_axis)


def ppermute(x, perm, axis_name=HVD_AXIS):
    """Point-to-point shifts over ``axis_name``: ``perm`` holds (source,
    destination) positions; a rank that receives nothing gets zeros."""
    if axis_size(axis_name) == 1:
        return x if (0, 0) in [(int(s), int(d)) for s, d in perm] \
            else torch.zeros_like(x)
    return _PPermute.apply(x, axis_group(axis_name),
                           [(int(s), int(d)) for s, d in perm])
