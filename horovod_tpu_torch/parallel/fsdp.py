"""FSDP / ZeRO-3: parameters, gradients and optimizer state sharded 1/n.

Port of the JAX package's ``parallel/fsdp.py``. JAX lays each leaf out with
a ``NamedSharding`` and lets GSPMD write the gather and scatter schedule;
the port writes its own, leaf by leaf in :func:`fsdp_spec`'s layout (the
largest n-divisible dim of the leaf's Flax shape, replicated below
``min_size`` elements), so that resharding (``elastic/sharded.py``) and
JAX's state carry over:

- each rank holds its shard of every sharded parameter (the module's
  Parameter itself is the shard) and of its optimizer moments;
- a sharded parameter is all-gathered just before the module that owns it
  runs (a forward pre-hook; a ``Dense``'s at its compute dtype) and its
  storage freed after (a forward hook), so the autograd graph keeps no
  full copy of it; the gradient of the module's output gathers it again
  for the module's backward (:class:`FsdpModel`). The
  gather's backward reduce-scatters the gradient onto the shard (averaged
  over the ranks: each rank's loss is its own batch's mean);
- the replicated parameters' gradients are averaged in one all-reduce
  after the backward;
- the optimizer steps the shards and the replicated parameters on every
  rank.

Not supported with ``remat`` (its recomputation would run the hooks
again).
"""

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common.topology import HVD_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.ops.collective_ops import (Average, all_gather_flat,
                                                  reduce_scatter_flat)
from horovod_tpu_torch.parallel.tp import Dense, FlaxKernel, flax_view


def fsdp_spec(shape, n, min_size=16384, axis_name=HVD_AXIS):
    """JAX's ``PartitionSpec`` as a tuple: ``axis_name`` at the largest
    n-divisible dim of ``shape`` (ties: the first), ``()`` (replicated) for
    a leaf under ``min_size`` elements or with no such dim."""
    if int(np.prod(shape)) < min_size:
        return ()
    dims = [(d, i) for i, d in enumerate(shape) if d % n == 0]
    if not dims:
        return ()
    _, best = max(dims, key=lambda t: (t[0], -t[1]))
    spec = [None] * len(shape)
    spec[best] = axis_name
    return tuple(spec)


def _sharded_dim(spec):
    return next((i for i, a in enumerate(spec) if a is not None), None)


def torch_dim(p, flax_dim):
    """The dim of parameter ``p`` that is dim ``flax_dim`` of its Flax
    leaf."""
    if flax_dim is None or not isinstance(p, FlaxKernel):
        return flax_dim
    return (1 - flax_dim) if p.dim() == 2 else (2, 3, 1, 0)[flax_dim]


def leaf_dims(model, n, min_size=16384):
    """``{name: (Flax dim, torch dim)}`` of each sharded parameter of
    ``model`` (full-shaped), by :func:`fsdp_spec` on its Flax shape."""
    out = {}
    for name, p in model.named_parameters():
        d = _sharded_dim(fsdp_spec(tuple(flax_view(p, p).shape), n,
                                   min_size))
        if d is not None:
            out[name] = (d, torch_dim(p, d))
    return out


def shard_batch(batch, mesh, axis_name=HVD_AXIS):
    """This rank's rows of a global batch (a tensor or a dict of them):
    its block of the leading dim."""
    n, idx = mesh.size(mesh.mesh_dim_names.index(axis_name)), \
        mesh.get_local_rank(axis_name)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis_name) for k, v in batch.items()}
    return batch.chunk(n, dim=0)[idx]


def _gather(shard, dim, dtype, group, out=None):
    """The full value of ``shard`` (cut on ``dim`` over ``group``) in
    ``dtype``, all-gathered into ``out`` (a fresh buffer when None): the
    (n * d0, ...) buffer, ``dim`` first."""
    part = shard.detach().to(dtype).movedim(dim, 0).contiguous()
    if out is None:
        n = dist.get_world_size(group)
        out = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]),
                          dtype=dtype, device=part.device)
    all_gather_flat(out, part, group=group)
    return out


class _Gather(torch.autograd.Function):
    """A shard's full value in ``dtype``; backward: the gradient, in the
    shard's dtype, reduce-scattered onto the shard and averaged over the n
    ranks."""

    @staticmethod
    def forward(ctx, shard, dim, dtype, group):
        ctx.meta = (dim, shard.dtype, group)
        return _gather(shard, dim, dtype, group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        dim, dtype, group = ctx.meta
        n = dist.get_world_size(group)
        g = g.to(dtype).movedim(dim, 0).contiguous()
        out = torch.empty((g.shape[0] // n,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        reduce_scatter_flat(out, g, group=group)
        return (out / n).movedim(0, dim), None, None, None


class FsdpModel:
    """The hooks that gather ``model``'s sharded parameters around each
    module that owns one; ``dims``: ``{name: (Flax dim, torch dim)}``.

    A module's call gathers each of its sharded parameters (a ``Dense``'s
    in the module's ``dtype``, the cast its forward makes, so that the
    graph saves the gathered tensor itself), and after the call frees the
    gathered storage: every tensor the graph saved that views it, a
    transpose or a scoped product's input among them, goes empty. The
    gradient of the call's output, when it arrives, gathers it again into
    the same storage, before the module's own backward reads it."""

    def __init__(self, model, mesh, axis_name, dims):
        self.model, self.mesh, self.axis_name = model, mesh, axis_name
        self.dims = dims
        self.handles = []
        owners = {}
        for name in dims:
            mod, _, leaf = name.rpartition(".")
            owners.setdefault(mod, []).append(leaf)
        for mod, leaves in owners.items():
            m = model.get_submodule(mod)
            self.handles.append(m.register_forward_pre_hook(
                lambda m, args, mod=mod, leaves=leaves:
                self._enter(m, mod, leaves)))
            self.handles.append(m.register_forward_hook(
                lambda m, args, out, leaves=leaves:
                self._leave(m, leaves, out)))

    def _enter(self, m, mod, leaves):
        group = in_step.axis_group(self.axis_name)
        calls = m.__dict__.setdefault("_fsdp_calls", [])
        gathered = []
        for leaf in leaves:
            shard = m._parameters.pop(leaf)
            dim = self.dims[f"{mod}.{leaf}" if mod else leaf][1]
            dtype = m.dtype if isinstance(m, Dense) else shard.dtype
            full = _Gather.apply(shard, dim, dtype, group)
            gathered.append((leaf, shard, full, dim, group))
            setattr(m, leaf, full)
        calls.append(gathered)

    def _leave(self, m, leaves, out):
        gathered = m._fsdp_calls.pop()
        for leaf, shard, _, _, _ in gathered:
            delattr(m, leaf)
            m._parameters[leaf] = shard
        if not isinstance(out, torch.Tensor):
            return          # no output to hang the refill on: keep them
        held = out.untyped_storage().data_ptr()
        gathered = [g for g in gathered
                    if g[2].untyped_storage().data_ptr() != held]
        for _, _, full, _, _ in gathered:
            full.untyped_storage().resize_(0)
        if not gathered or not out.requires_grad:
            return
        pending = [gathered]

        def refill(_grad):
            if not pending:
                return
            with torch.no_grad():
                for _, shard, full, dim, group in pending.pop():
                    storage = full.untyped_storage()
                    storage.resize_(full.numel() * full.element_size())
                    # A tensor of its own on the storage: its writes leave
                    # the version of every saved view of it as it was.
                    shape = list(full.shape)
                    shape.insert(0, shape.pop(dim))
                    _gather(shard, dim, full.dtype, group,
                            out=full.new_empty(0).set_(storage, 0, shape))
        out.register_hook(refill)

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def shard_params(model, mesh, axis_name=HVD_AXIS, min_size=16384):
    """Shard ``model``'s parameters in place (each rank keeps its block of
    each sharded leaf, the same on every rank before) and install the
    gather hooks: returns the :class:`FsdpModel`."""
    if getattr(getattr(model, "config", None), "remat", False):
        raise ValueError("FSDP does not support remat")
    dim_ = mesh.mesh_dim_names.index(axis_name)
    n, idx = mesh.size(dim_), mesh.get_local_rank(axis_name)
    dims = leaf_dims(model, n, min_size)
    with torch.no_grad():
        for name, (_, d) in dims.items():
            p = model.get_parameter(name)
            p.data = p.data.chunk(n, dim=d)[idx].clone()
    return FsdpModel(model, mesh, axis_name, dims)


def _average_replicated(model, fsdp):
    params = [p for name, p in model.named_parameters()
              if name not in fsdp.dims and p.grad is not None]
    if not params or in_step.axis_size(fsdp.axis_name) == 1:
        return
    n = in_step.axis_size(fsdp.axis_name)
    buf = torch.cat([p.grad.reshape(-1) for p in params])
    dist.all_reduce(buf, group=in_step.axis_group(fsdp.axis_name))
    buf /= n
    for p, g in zip(params, buf.split([p.numel() for p in params])):
        p.grad.copy_(g.view_as(p.grad))


def make_fsdp_train_step(loss_fn, tx, mesh, axis_name=HVD_AXIS,
                         min_size=16384):
    """``(init_fn, step_fn)``:

    - ``init_fn(model) -> (fsdp, optimizer)``: shards ``model`` in place
      (:func:`shard_params`) and builds ``tx(model.parameters())``, whose
      moments then have the shards' shapes;
    - ``step_fn(fsdp, optimizer, batch) -> (fsdp, optimizer, loss)``: one
      step on this rank's batch (``loss_fn(model, batch)``, its local
      mean); the loss comes back averaged over the axis."""
    def init_fn(model):
        fsdp = shard_params(model, mesh, axis_name, min_size)
        return fsdp, tx(model.parameters())

    def step_fn(fsdp, optimizer, batch):
        model = fsdp.model
        with in_step.axes(mesh):
            optimizer.zero_grad()
            loss = loss_fn(model, batch)
            loss.backward()
            _average_replicated(model, fsdp)
            optimizer.step()
            loss = in_step.allreduce(loss.detach(), Average, axis_name)
        return fsdp, optimizer, loss

    return init_fn, step_fn
