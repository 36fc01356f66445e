"""State broadcast helpers for the ``horovod.torch`` surface.

Port of the JAX package's ``torch/functions.py`` (reference:
horovod/torch/functions.py broadcast_parameters, broadcast_optimizer_state,
broadcast_object, allgather_object), used at train start so every rank
begins from the root's state.
"""

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
    """Broadcast optimizer hyperparameters and per-parameter state tensors
    from root (reference: functions.py:87-184: state_dict walk, scalars ride
    a pickled blob, tensors ride broadcast)."""
    state = optimizer.state_dict()
    scalars = {}
    tensors = {}

    for gi, group in enumerate(state.get("param_groups", [])):
        for k, v in group.items():
            if k != "params":
                scalars[f"group.{gi}.{k}"] = v
    for pid, pstate in state.get("state", {}).items():
        for k, v in pstate.items():
            key = f"state.{pid}.{k}"
            if isinstance(v, torch.Tensor):
                tensors[key] = v
            else:
                scalars[key] = v

    synced = broadcast_object(scalars, root_rank=root_rank,
                              name="opt_scalars", process_set=process_set)
    for key, t in tensors.items():
        broadcast_(t, root_rank, name=f"opt.{key}", process_set=process_set)

    for gi, group in enumerate(state.get("param_groups", [])):
        for k in list(group.keys()):
            if k != "params":
                group[k] = synced[f"group.{gi}.{k}"]
    for pid, pstate in state.get("state", {}).items():
        for k in list(pstate.keys()):
            if not isinstance(pstate[k], torch.Tensor):
                pstate[k] = synced[f"state.{pid}.{k}"]
    optimizer.load_state_dict(state)
