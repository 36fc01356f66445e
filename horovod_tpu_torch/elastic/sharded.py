"""Elastic membership changes for sharded training state (ZeRO-1, FSDP).

Port of the JAX package's ``elastic/sharded.py``. A replicated state
restores by broadcast; a state partitioned 1/n must be re-partitioned when
n changes:

- :func:`gather_to_host` all-gathers each rank's shards into the full
  logical values, as numpy on the host (collective: every rank calls it);
- :func:`zero_reshard` re-pads a ZeRO-1 state's flat moment vectors from
  ``n * shard_len`` to the new world's ``n' * shard_len'``;
- :func:`fsdp_reshard` cuts a host tree (Flax layout) into this rank's
  shards under the new world's :func:`parallel.fsdp.fsdp_spec` layout;
- :func:`zero_restore` and :func:`fsdp_restore` put host values back into
  a live state. They also load a JAX state: JAX's flat ZeRO moments (the
  port flattens in ``ravel_pytree``'s order and layout) and its FSDP
  leaves (Flax layout, keyed by the port's parameter names).

The gather is collective over the old world, so it runs at a commit; the
re-partition runs in a reset callback, on the new world's mesh::

    saved = {}

    def commit():                        # every rank, between steps
        saved["host"] = sharded.gather_to_host(zero_state)

    def on_reset():                      # registered on the TorchState
        new = dp.ZeroTrainState.create(model, tx, new_mesh)
        sharded.zero_restore(new, sharded.zero_reshard(saved["host"],
                                                       new_mesh))

``kv_reshard`` (the serving KV cache) comes with ROADMAP A15.
"""

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.common.topology import HVD_AXIS
from horovod_tpu_torch.ops.collective_ops import all_gather_flat
from horovod_tpu_torch.parallel.tp import flax_view, from_flax_view


class HostZeroState:
    """A ZeRO-1 state on the host: ``params`` ``{name: array}`` (torch
    layout), ``opt_state`` ``{key: array}`` (flat moments of
    ``n * shard_len``, scalars as they are), ``numel`` the logical length."""

    def __init__(self, step, params, opt_state, numel):
        self.step, self.params, self.opt_state = step, params, opt_state
        self.numel = numel

    def replace(self, **kw):
        d = dict(step=self.step, params=self.params,
                 opt_state=self.opt_state, numel=self.numel)
        d.update(kw)
        return HostZeroState(**d)


def _np(t):
    """A host copy of ``t`` that later steps do not change (``.numpy()``
    of a CPU tensor would share its storage)."""
    return t.detach().cpu().numpy().copy()


def _layout(mesh, axis_name):
    """(n, this rank's position) on ``mesh``'s ``axis_name``; ``mesh`` may
    be the new size n itself, for a world that is not built yet (position
    0)."""
    if isinstance(mesh, int):
        return mesh, 0
    return (mesh.size(mesh.mesh_dim_names.index(axis_name)),
            mesh.get_local_rank(axis_name))


def _gather_flat(t, group, n):
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    all_gather_flat(out, t.detach().reshape(-1).contiguous(),
                                group=group)
    return out


def gather_to_host(state, optimizer=None):
    """The full values of a sharded state, on the host:

    - a ``parallel.dp.ZeroTrainState``: a :class:`HostZeroState`;
    - a ``parallel.fsdp.FsdpModel`` (and its ``optimizer``):
      ``{"params": {name: array}, "opt_state": {name: {key: array}}}`` in
      the Flax layout, each sharded leaf gathered.

    Collective over the state's axis."""
    from horovod_tpu_torch.parallel.dp import ZeroTrainState
    from horovod_tpu_torch.parallel.fsdp import FsdpModel, _gather
    if isinstance(state, ZeroTrainState):
        group = state.mesh.get_group(state.axis_name)
        opt = {}
        for k, v in state.optimizer.state.get(state.shard, {}).items():
            if isinstance(v, torch.Tensor) and v.dim() >= 1:
                opt[k] = _np(_gather_flat(v, group, state.n))
            else:
                opt[k] = _np(v) if isinstance(v, torch.Tensor) else v
        return HostZeroState(
            state.step, {n: _np(p) for n, p in
                         state.model.named_parameters()}, opt, state.numel)
    if isinstance(state, FsdpModel):
        group = state.mesh.get_group(state.axis_name)

        def full(name, p, t):
            if name in state.dims:
                d = state.dims[name][1]
                t = _gather(t, d, t.dtype, group).movedim(0, d)
            return _np(flax_view(p, t))
        named = dict(state.model.named_parameters())
        out = {"params": {k: full(k, p, p) for k, p in named.items()}}
        if optimizer is not None:
            out["opt_state"] = {
                k: {key: full(k, p, v) if isinstance(v, torch.Tensor)
                    and v.shape == p.shape else
                    (_np(v) if isinstance(v, torch.Tensor) else v)
                    for key, v in optimizer.state.get(p, {}).items()}
                for k, p in named.items()}
        return out
    raise TypeError(f"gather_to_host: {type(state).__name__} is not a "
                    "ZeroTrainState or an FsdpModel")


def zero_reshard(state_host, mesh, axis_name=HVD_AXIS):
    """A :class:`HostZeroState` re-padded for ``mesh``'s ``axis_name`` (or
    for n ranks, ``mesh`` an int): each flat moment cut to the logical
    length and padded with zeros to a multiple of the new n."""
    n, _ = _layout(mesh, axis_name)
    logical = state_host.numel
    pad = (-logical) % n

    def leaf(x):
        x = np.asarray(x)
        if x.ndim >= 1 and x.size >= logical:
            return np.pad(x.reshape(-1)[:logical], (0, pad))
        return x
    return state_host.replace(opt_state={k: leaf(v) for k, v in
                                         state_host.opt_state.items()})


def zero_restore(state, host):
    """Load a :class:`HostZeroState` (the world's n already in its
    padding) into a live ``ZeroTrainState``: the parameters, and this
    rank's block of each flat moment."""
    L, idx = state.shard_len, state.index
    with torch.no_grad():
        named = dict(state.model.named_parameters())
        for k, v in host.params.items():
            named[k].copy_(torch.as_tensor(np.asarray(v)))
        st = state.optimizer.state.setdefault(state.shard, {})
        for k, v in host.opt_state.items():
            v = np.asarray(v)
            dev = state.shard.device
            if v.ndim >= 1:
                if v.size != state.n * L:
                    raise ValueError(f"moment {k!r} holds {v.size} elements, "
                                     f"the state's grid {state.n} x {L}")
                st[k] = torch.as_tensor(v[idx * L:(idx + 1) * L].copy(),
                                        device=dev)
            else:
                st[k] = torch.as_tensor(v.copy(), device=dev)
    state.step = host.step
    return state


def fsdp_reshard(tree_host, mesh, axis_name=HVD_AXIS, min_size=16384):
    """This rank's shards of a host tree (nested dicts of arrays in the Flax
    layout: ``gather_to_host``'s, or JAX's) under ``mesh``'s FSDP layout:
    each leaf cut on its :func:`fsdp_spec` dim, or whole when replicated
    (a dim the old n divided but the new one does not, as a fresh
    ``shard_params`` would lay it out). ``mesh`` an int n: shard 0 of
    n."""
    from horovod_tpu_torch.parallel.fsdp import _sharded_dim, fsdp_spec
    n, idx = _layout(mesh, axis_name)

    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        x = np.asarray(x)
        d = _sharded_dim(fsdp_spec(x.shape, n, min_size, axis_name))
        return x if d is None else np.array_split(x, n, axis=d)[idx]
    return leaf(tree_host)


def fsdp_restore(fsdp, optimizer, shards):
    """Load :func:`fsdp_reshard`'s ``shards`` (``{"params": ...,
    "opt_state": ...}``, Flax layout) into a live ``FsdpModel`` and its
    optimizer."""
    named = dict(fsdp.model.named_parameters())
    with torch.no_grad():
        for k, v in shards["params"].items():
            p = named[k]
            p.copy_(from_flax_view(p, torch.as_tensor(np.asarray(v))))
        for k, st in shards.get("opt_state", {}).items():
            p = named[k]
            dst = optimizer.state.setdefault(p, {})
            for key, v in st.items():
                v = torch.as_tensor(np.asarray(v).copy(), device=p.device)
                dst[key] = from_flax_view(p, v).contiguous() \
                    if v.dim() == p.dim() and v.dim() else v
    return fsdp
