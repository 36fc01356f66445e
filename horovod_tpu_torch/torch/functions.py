"""State broadcast helpers for the ``horovod.torch`` surface.

Port of the JAX package's ``torch/functions.py`` (reference:
horovod/torch/functions.py broadcast_parameters, broadcast_optimizer_state,
broadcast_object, allgather_object), used at train start so every rank
begins from the root's state.
"""

import collections

import torch

from horovod_tpu_torch.ops import collective_ops as C
from horovod_tpu_torch.torch.mpi_ops import broadcast_


def broadcast_parameters(params, root_rank=0, process_set=None):
    """Broadcast a ``state_dict()`` or ``named_parameters`` iterable from
    root, in place (reference: functions.py:36-84)."""
    items = list(params.items()) if hasattr(params, "items") else list(params)
    for name, p in items:
        if p is None or not isinstance(p, torch.Tensor):
            continue
        broadcast_(p.data if p.requires_grad else p, root_rank,
                   name=f"broadcast.{name}", process_set=process_set)


def broadcast_object(obj, root_rank=0, name=None, process_set=None):
    """Pickle-and-broadcast an arbitrary object (reference:
    functions.py:187-230)."""
    return C.broadcast_object(obj, root_rank=root_rank, name=name,
                              process_set=process_set)


def allgather_object(obj, name=None, process_set=None):
    """Every rank's object, in rank order (reference:
    functions.py:233-260)."""
    return C.allgather_object(obj, process_set=process_set, name=name)


def broadcast_optimizer_state(optimizer, root_rank=0, process_set=None):
    """Broadcast optimizer hyperparameters and per-parameter state from root
    (reference: functions.py:87-184: scalars ride a pickled blob, tensors
    ride broadcast).

    The root's state decides everything: its scalars and the layout of its
    state tensors (parameter index, key, shape, dtype, CPU or not) ride the
    blob, each rank allocates the tensors it lacks (a fresh optimizer has
    none), and one broadcast runs per root tensor, in the root's order, so
    a rank that joins a running job with a fresh optimizer launches the same
    collectives as the ranks that have stepped. A tensor that the root
    keeps on the CPU (AdamW's ``step`` unless ``capturable`` or ``fused``)
    is allocated on the CPU here too, as the optimizer would, and the
    broadcast stages it through the device. The reference instead steps a
    fresh optimizer once on zero gradients (functions.py:103-121), which
    under AdamW's decoupled weight decay moves the parameters that
    ``broadcast_parameters`` has just synced."""
    state = optimizer.state_dict()
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in state.get("param_groups", [])]
    # (parameter index, key, value), where a tensor's value is its spec.
    entries = [(pid, k, _TensorSpec(tuple(v.shape), v.dtype,
                                    v.device.type == "cpu")
                if isinstance(v, torch.Tensor) else v)
               for pid, pstate in state.get("state", {}).items()
               for k, v in pstate.items()]
    groups, entries = broadcast_object((groups, entries),
                                       root_rank=root_rank,
                                       name="opt_state",
                                       process_set=process_set)
    for group, synced in zip(state["param_groups"], groups):
        group.update(synced)
    dev = C.basics.device()
    mine = state.get("state", {})
    new_state = {}
    for pid, k, v in entries:
        if isinstance(v, _TensorSpec):
            t = mine.get(pid, {}).get(k)
            if not isinstance(t, torch.Tensor) or tuple(t.shape) != v.shape \
                    or t.dtype != v.dtype:
                t = torch.zeros(v.shape, dtype=v.dtype,
                                device="cpu" if v.on_cpu else dev)
            broadcast_(t, root_rank, name=f"opt.state.{pid}.{k}",
                       process_set=process_set)
            v = t
        new_state.setdefault(pid, {})[k] = v
    state["state"] = new_state
    optimizer.load_state_dict(state)


class _TensorSpec(collections.namedtuple("_TensorSpec",
                                         "shape dtype on_cpu")):
    """A root state tensor's shape, dtype and placement (CPU or the
    device), as the blob carries it."""
