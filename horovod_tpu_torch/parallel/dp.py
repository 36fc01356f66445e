"""Data-parallel training steps over an in-step mesh.

Port of the JAX package's ``parallel/dp.py``. JAX builds one compiled SPMD
step with ``shard_map``; here a step is eager code run inside
``in_step.axes(mesh)``, so the model's tensor- and sequence-parallel layers
find their axes bound. Every rank passes its own batch shard.

- :func:`make_train_step`: the loss is local; the gradient reduction over
  the data-parallel axis belongs to the optimizer, a
  ``hvd.DistributedOptimizer`` on that axis's process set
  (:func:`axis_process_set`), whose fusion runtime packs and scales each
  bucket with the scale kernels, as JAX's docstring has it. Gradients are
  summed over ``sum_axes`` (a sequence axis: the parameters are replicated
  over it while each rank's loss sees only its tokens, the sum JAX's
  varying-axes transposes insert). The loss, and the floating leaves of an
  aux (BatchNorm statistics), are averaged over the data-parallel axis.
- :func:`make_zero_train_step`: ZeRO-1. The gradients are flattened (in
  JAX's ``ravel_pytree`` order: parameters by sorted name, each in its
  Flax layout, so JAX's flat moments load as they are), padded to a
  multiple of n and reduce-scattered in one ``reduce_scatter_tensor``
  (divided by n when averaging); each rank steps a ``torch.optim``
  optimizer on its flat 1/n shard only, so its moments are 1/n; one
  ``all_gather_into_tensor`` brings the parameters back. As in JAX the
  optimizer must be elementwise over the flat vector (SGD, Adam, AdamW,
  RMSprop, Adagrad, Adamax, NAdam, RAdam, Rprop, ASGD): a shard-local
  norm is not the global one, so any other class raises ``TypeError``.
"""

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.topology import HVD_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.ops.collective_ops import (Average, all_gather_flat,
                                                  reduce_scatter_flat)
from horovod_tpu_torch.parallel.tp import flax_view, from_flax_view

ELEMENTWISE = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW,
               torch.optim.RMSprop, torch.optim.Adagrad, torch.optim.Adamax,
               torch.optim.NAdam, torch.optim.RAdam, torch.optim.Rprop,
               torch.optim.ASGD)


class TrainState:
    """A model, its optimizer, a step counter and an ``extra`` (e.g. the
    BatchNorm statistics an aux loss returns)."""

    def __init__(self, step, model, optimizer, extra=None):
        self.step, self.model, self.optimizer = step, model, optimizer
        self.extra = extra

    @classmethod
    def create(cls, model, optimizer, extra=None):
        return cls(0, model, optimizer, extra)


def axis_process_set(mesh, axis_name=HVD_AXIS):
    """The process set of this rank's row along ``axis_name``: the global
    set when the row is the world, else a registered one. Collective, as
    ``hvd.add_process_set`` is: every rank registers every row, in the
    same order."""
    import horovod_tpu_torch as hvd
    dim = mesh.mesh_dim_names.index(axis_name)
    if mesh.size(dim) == dist.get_world_size():
        return hvd.global_process_set
    rows = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.size(dim)).tolist()
    me, mine = dist.get_rank(), None
    for ranks in rows:
        ps = hvd.add_process_set(ranks)
        if me in ranks:
            mine = ps
    return mine


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def sum_over(params, axis_name):
    """Each parameter's gradient summed over ``axis_name`` in one
    all-reduce per dtype (a numeric no-op, skipped, at size 1)."""
    if in_step.axis_size_or_1(axis_name) == 1:
        return
    group = in_step.axis_group(axis_name)
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p)
    for ps in by_dtype.values():
        buf = _flat([p.grad for p in ps])
        dist.all_reduce(buf, group=group)
        for p, g in zip(ps, buf.split([p.numel() for p in ps])):
            p.grad.copy_(g.view_as(p.grad))


def _mean_tree(tree, axis_name):
    if isinstance(tree, dict):
        return {k: _mean_tree(v, axis_name) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_mean_tree(v, axis_name) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return in_step.allreduce(tree.detach(), Average, axis_name)
    return tree


def _forward(loss_fn, model, batch, extra, has_aux):
    if has_aux:
        return loss_fn(model, batch, extra)
    return loss_fn(model, batch), None


def _step_with_sums(opt, params, sum_axes):
    """``opt.step()``, the gradients first summed over ``sum_axes``: after
    a ``DistributedOptimizer``'s reductions (a sum and an average over
    other axes commute)."""
    if all(in_step.axis_size_or_1(a) == 1 for a in sum_axes):
        opt.step()
        return
    if hasattr(opt, "synchronize"):
        opt.synchronize()
    for axis in sum_axes:
        sum_over(params, axis)
    should = getattr(opt, "_should_synchronize", None)
    if should is not None:
        opt._should_synchronize = False
    try:
        opt.step()
    finally:
        if should is not None:
            opt._should_synchronize = should


def make_train_step(loss_fn, optimizer, mesh, axis_name=HVD_AXIS,
                    has_aux=False, sum_axes=()):
    """``step(state, batch) -> (state, loss)`` for this rank's ``batch``.

    ``loss_fn(model, batch)`` is the LOCAL loss; with ``has_aux``,
    ``loss_fn(model, batch, extra) -> (loss, new_extra)``, whose floating
    leaves are averaged over ``axis_name`` into ``state.extra``.
    ``optimizer`` steps ``state.model``'s parameters: a
    ``hvd.DistributedOptimizer`` on :func:`axis_process_set`'s set, the
    only reduction over ``axis_name``. ``sum_axes``: mesh axes whose
    gradients are summed (a sequence axis). The loss comes back averaged
    over ``axis_name`` (a sequence-sharded loss stays this rank's)."""
    def step(state, batch):
        model = state.model
        with in_step.axes(mesh):
            optimizer.zero_grad()
            loss, aux = _forward(loss_fn, model, batch, state.extra, has_aux)
            loss.backward()
            _step_with_sums(optimizer, list(model.parameters()), sum_axes)
            loss = in_step.allreduce(loss.detach(), Average, axis_name)
            if has_aux:
                state.extra = _mean_tree(aux, axis_name)
        state.step += 1
        return state, loss
    return step


def make_eval_step(eval_fn, mesh, axis_name=HVD_AXIS):
    """``eval(model, batch) -> metrics``, each averaged over ``axis_name``
    (the MetricAverage semantics), with no gradient recorded."""
    def evaluate(model, batch):
        with torch.no_grad(), in_step.axes(mesh):
            return _mean_tree(eval_fn(model, batch), axis_name)
    return evaluate


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------

def flat_order(model):
    """``model``'s parameters in JAX's ``ravel_pytree`` order: sorted by
    name (a dot sorts before any character of a name, so this is the order
    of the Flax paths' tuples)."""
    return sorted(model.named_parameters(), key=lambda kv: kv[0])


def flatten_flax(named, tensors=None):
    """One fp32 vector of ``tensors`` (default: the parameters of
    ``named``), each in its parameter's Flax layout."""
    ts = [p for _, p in named] if tensors is None else tensors
    return _flat([flax_view(p, t).float() for (_, p), t in zip(named, ts)])


def unflatten_flax(named, flat):
    """The inverse of :func:`flatten_flax`: one tensor per parameter, in
    torch's layout."""
    out, start = [], 0
    for _, p in named:
        shape = flax_view(p, p).shape
        n = p.numel()
        out.append(from_flax_view(p, flat[start:start + n].view(shape)))
        start += n
    return out


class ZeroTrainState:
    """A replicated model and an optimizer over this rank's flat 1/n
    parameter shard (``shard``, a Parameter of ``shard_len`` elements), on
    a mesh axis of ``n`` ranks at position ``index``; ``numel`` is the
    logical (unpadded) length."""

    def __init__(self, step, model, optimizer, shard, n, index, numel,
                 extra=None, mesh=None, axis_name=HVD_AXIS):
        self.step, self.model, self.optimizer = step, model, optimizer
        self.shard, self.n, self.index, self.numel = shard, n, index, numel
        self.extra, self.mesh, self.axis_name = extra, mesh, axis_name

    @property
    def shard_len(self):
        return self.shard.numel()

    @classmethod
    def create(cls, model, tx, mesh, axis_name=HVD_AXIS, extra=None):
        """``tx(params) -> torch.optim.Optimizer`` builds the optimizer (a
        ``functools.partial`` of an elementwise optimizer class)."""
        dim = mesh.mesh_dim_names.index(axis_name)
        n, index = mesh.size(dim), mesh.get_local_rank(axis_name)
        named = flat_order(model)
        with torch.no_grad():
            flat = flatten_flax(named)
        pad = (-flat.numel()) % n
        shard_len = (flat.numel() + pad) // n
        full = torch.nn.functional.pad(flat, (0, pad))
        shard = torch.nn.Parameter(
            full[index * shard_len:(index + 1) * shard_len].clone())
        optimizer = tx([shard])
        if not isinstance(optimizer, ELEMENTWISE):
            raise TypeError(
                f"ZeRO-1 steps each rank's flat shard on its own: the "
                f"optimizer must be elementwise ({', '.join(c.__name__ for c in ELEMENTWISE)}), "
                f"not {type(optimizer).__name__}")
        return cls(0, model, optimizer, shard, n, index, flat.numel(),
                   extra, mesh, axis_name)

    def moments(self):
        """{state key: this rank's flat shard} of the optimizer's vector
        state (its moments)."""
        st = self.optimizer.state.get(self.shard, {})
        return {k: v for k, v in st.items()
                if isinstance(v, torch.Tensor) and v.dim() >= 1}


def make_zero_train_step(loss_fn, tx, mesh, axis_name=HVD_AXIS,
                         has_aux=False, average=True):
    """``step(state, batch) -> (state, loss)`` of a :class:`ZeroTrainState`
    (``tx`` is the one ``ZeroTrainState.create`` was given; the state
    holds the optimizer)."""
    def step(state, batch):
        model = state.model
        named = flat_order(model)
        params = [p for _, p in named]
        with in_step.axes(mesh):
            group = in_step.axis_group(axis_name)
            for p in params:
                p.grad = None
            loss, aux = _forward(loss_fn, model, batch, state.extra, has_aux)
            loss.backward()
            n, L = state.n, state.shard_len
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            with torch.no_grad():
                flat_g = torch.nn.functional.pad(
                    flatten_flax(named, grads), (0, n * L - state.numel))
                g_shard = torch.empty(L, dtype=flat_g.dtype,
                                      device=flat_g.device)
                reduce_scatter_flat(g_shard, flat_g, group=group)
                if average:
                    g_shard /= n
                flat_p = torch.nn.functional.pad(flatten_flax(named),
                                                 (0, n * L - state.numel))
                state.shard.copy_(flat_p[state.index * L:
                                         (state.index + 1) * L])
            state.shard.grad = g_shard
            state.optimizer.step()
            with torch.no_grad():
                flat_new = torch.empty(n * L, dtype=flat_g.dtype,
                                       device=flat_g.device)
                all_gather_flat(flat_new, state.shard.detach(),
                                            group=group)
                for p, t in zip(params, unflatten_flax(
                        named, flat_new[:state.numel])):
                    p.copy_(t)
            loss = in_step.allreduce(loss.detach(), Average, axis_name)
            if has_aux:
                state.extra = _mean_tree(aux, axis_name)
        state.step += 1
        return state, loss
    return step
