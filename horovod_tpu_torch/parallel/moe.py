"""Expert parallelism: a switch-style Mixture-of-Experts layer.

Port of the JAX package's ``parallel/moe.py``. Capacity-based routing
(Switch Transformer): every expert takes ``capacity`` token slots per
source shard and a token past them is dropped (its residual passes through).
Experts are sharded over an in-step mesh axis (``ops/in_step.py``): each
position of ``axis_name`` owns ``num_experts / n`` of them, and two
alltoalls move the token slots to their expert's owner and back, flat
(``in_step.alltoall``: split dim 0, concat dim 1, and its inverse) or
through the 2-level alltoall (``parallel/strategies.py``,
:func:`_hier_dispatch`/:func:`_hier_combine`) when
``strategies.a2a_hierarchy_for`` arms it. With no axis bound every expert
is local, the oracle of the sharded layer.

JAX's semantics, kept: top-k of the fp32 router's softmax, the selected
gates renormalized; the k choices taken in priority order, each expert's
slots handed out first come, first served in token order (the ``used``
offset carried from one choice to the next);
``capacity = max(1, int(cf * k * T / E))``; the Switch load-balancing loss
``E * sum_e f_e * P_e`` on the top-1 assignment, per local shard; bias-free
experts with the tanh ``gelu``, as plain batched products in ``dtype``.

The route is indices, not JAX's dense one-hot (T, E, C) dispatch and
combine tensors: :func:`_router` gives each token's (expert, slot) choice
as a flat slot index and its gate; dispatch scatters the tokens into
their slots, combine gathers each token's slots back and sums them
weighted by its gates. The same numbers as the one-hot products (each a
sum of one product per choice), without the (T, E, C) tensors, which
reach 0.54 GB each in fp32 at GPT-2 small's 8,192 tokens, 8 experts and
2,048 slots. Gradients reach the router through the gates.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from horovod_tpu_torch.common.topology import EP_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.parallel.tp import (Dense, at_precision,
                                           lecun_normal_, shard_generator)


def _hier_dispatch(slots, axis_name, num_slices, cross_label):
    """Expert-major ``(E, C, d)`` slots to source-major ``(e_local, n*C,
    d)`` through the 2-level alltoall: the tiled split-0/concat-1 exchange
    as a split-0/concat-0 one and a local transpose. Bit-equal to the flat
    route unless the cross leg is quantized."""
    from horovod_tpu_torch.parallel.strategies import alltoall_tiered_groups
    n = in_step.axis_size(axis_name)
    E, C, d = slots.shape
    z = alltoall_tiered_groups(slots, axis_name, num_slices,
                               cross_wire=cross_label)
    return z.reshape(n, E // n, C, d).transpose(0, 1).reshape(E // n, n * C,
                                                              d)


def _hier_combine(y, axis_name, num_slices, cross_label):
    """The inverse of :func:`_hier_dispatch`: source-major ``(e_local,
    n*C, d)`` expert outputs back to the expert-major ``(E, C, d)``
    layout, through the same 2-level exchange."""
    from horovod_tpu_torch.parallel.strategies import alltoall_tiered_groups
    n = in_step.axis_size(axis_name)
    e_local, nC, d = y.shape
    z = y.reshape(e_local, n, nC // n, d).transpose(0, 1).reshape(
        n * e_local, nC // n, d)
    return alltoall_tiered_groups(z, axis_name, num_slices,
                                  cross_wire=cross_label)


class Route(NamedTuple):
    """A top-k capacity route of T tokens over E experts of C slots:
    ``slot`` (T, k) the flat slot ``e * C + position`` of each choice,
    ``E * C`` where the choice was dropped; ``gate`` (T, k) the
    renormalized gates; ``aux`` the load-balancing loss."""
    slot: torch.Tensor
    gate: torch.Tensor
    aux: torch.Tensor


def _one_hot(e, E):
    """``(E, T)`` int64 one-hot of expert indices ``e`` (T,), expert-major
    so each expert's queue is one contiguous row (``F.one_hot`` checks its
    indices' range on the host: a device sync on CUDA)."""
    return (torch.arange(E, device=e.device)[:, None] == e).long()


def _router(probs, k, capacity):
    """Top-k capacity routing of router probabilities ``probs`` (T, E), as
    JAX's ``_router`` routes it, as indices (:class:`Route`)."""
    T, E = probs.shape
    gate, expert = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    used = torch.zeros(E, 1, dtype=torch.long, device=probs.device)
    slots = []
    for j in range(k):
        e = expert[:, j]
        onehot = _one_hot(e, E)                              # (E, T)
        # Each token's place in its expert's queue for this choice.
        pos = (onehot.cumsum(1) - onehot + used).gather(0, e[None])[0]
        keep = pos < capacity
        slots.append(torch.where(keep, e * capacity + pos,
                                 torch.full_like(pos, E * capacity)))
        used = used + (onehot * keep).sum(1, keepdim=True)
    # Switch Transformer eq. 4 on the top-1 assignment.
    f = _one_hot(expert[:, 0], E).to(probs.dtype).mean(1)
    aux = E * (f * probs.mean(0)).sum()
    return Route(torch.stack(slots, 1), gate, aux)


def dispatch(x, slot, n_slots):
    """``(n_slots, d)``: token ``t`` of ``x`` (T, d) in each slot that
    ``slot`` (T, k) gives it, zeros in an empty slot. Index ``n_slots``
    (a dropped choice) lands nowhere. Written as a scatter of the tokens
    into the slots, whose backward gathers each token's gradient from its
    slots: a gather from the slots instead would accumulate every empty
    slot's gradient into one padding row, serially."""
    rows = x if slot.shape[1] == 1 else x.repeat_interleave(slot.shape[1], 0)
    out = x.new_zeros(n_slots + 1, x.shape[1])
    return out.index_put((slot.reshape(-1),), rows)[:n_slots]


def combine(y, slot, gate, dtype):
    """``(T, d)``: each token's slots of ``y`` (n_slots, d) summed,
    weighted by its gates cast to ``dtype``; products and sum in fp32,
    rounded once to ``dtype`` (a one-hot product's numbers)."""
    picked = torch.cat([y, y.new_zeros(1, y.shape[1])])[slot]    # (T, k, d)
    g = gate.to(dtype).to(torch.float32)[..., None]
    return (g * picked.to(torch.float32)).sum(1).to(dtype)


class MoEMlp(nn.Module):
    """Expert-parallel MoE feed-forward layer (a drop-in for a dense MLP):
    ``forward(x) -> (y, aux)``. ``num_experts`` is global; built inside
    ``in_step.axes(mesh)`` with ``axis_name`` bound to n positions, the
    layer holds ``num_experts / n`` experts' weights (``w_in`` (e, d, f),
    ``w_out`` (e, f, d), fp32) and a replicated fp32 ``router``.
    ``hierarchical``: None asks ``strategies.a2a_hierarchy_for`` (the
    registry, ``HOROVOD_HIERARCHICAL_ALLTOALL``), True forces the 2-level
    route where a slice layout exists, False keeps it flat.

    ``phase_hook``: a profiling aid, not part of the layer's contract
    (``chip_smoke.py``'s per-phase CUDA events set it and clear it): when
    set, a callable of a phase name, called at the start of the forward
    (``"start"``) and after the router, the dispatch, the expert products
    and the combine. None, the default, costs one attribute test a
    phase.
    ``last_dropped``: the number of dropped choices in the last forward,
    a tensor on the device."""

    def __init__(self, num_experts, hidden_size, intermediate_size, k=1,
                 capacity_factor=2.0, dtype=torch.float32,
                 axis_name=EP_AXIS, hierarchical=None):
        super().__init__()
        n = in_step.axis_size_or_1(axis_name)
        if num_experts % n:
            raise ValueError(f"num_experts {num_experts} not divisible by "
                             f"ep={n}")
        self.num_experts, self.k = num_experts, k
        self.capacity_factor = capacity_factor
        self.hidden_size, self.intermediate_size = hidden_size, \
            intermediate_size
        self.dtype, self.axis_name = dtype, axis_name
        self.hierarchical = hierarchical
        self.shard_of = (in_step.axis_index(axis_name), n) if n > 1 else None
        e_local = num_experts // n
        self.router = Dense(hidden_size, num_experts, use_bias=False,
                            dtype=torch.float32)
        self.w_in = nn.Parameter(torch.empty(e_local, hidden_size,
                                             intermediate_size))
        self.w_out = nn.Parameter(torch.empty(e_local, intermediate_size,
                                              hidden_size))
        self.last_dropped = self.phase_hook = None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """Flax's ``lecun_normal`` on this shard's experts (a fan-in of
        ``e_local * d`` and ``e_local * f``, as Flax counts a 3-D
        kernel's), drawn from :func:`shard_generator`; the router is a
        ``Dense`` and is reset as one."""
        g = shard_generator(generator, self.shard_of)
        e = self.w_in.shape[0]
        lecun_normal_(self.w_in, e * self.hidden_size, g)
        lecun_normal_(self.w_out, e * self.intermediate_size, g)

    def _mark(self, name):
        if self.phase_hook is not None:
            self.phase_hook(name)

    def forward(self, x):
        E, d, dt = self.num_experts, self.hidden_size, self.dtype
        n = in_step.axis_size_or_1(self.axis_name)
        if self.w_in.shape[0] * n != E:
            raise ValueError(f"{E} experts over ep={n}: the layer was built "
                             f"for {self.w_in.shape[0]} local experts")
        self._mark("start")
        xt = x.reshape(-1, d)
        T = xt.shape[0]
        capacity = max(1, int(self.capacity_factor * self.k * T / E))
        probs = torch.softmax(self.router(xt.to(torch.float32)), dim=-1)
        route = _router(probs, self.k, capacity)
        self.last_dropped = (route.slot == E * capacity).sum()
        self._mark("router")
        slots = dispatch(xt.to(dt), route.slot, E * capacity).view(
            E, capacity, d)
        hier = None
        if n > 1:
            from horovod_tpu_torch.parallel import strategies
            hier = strategies.a2a_hierarchy_for(self.axis_name,
                                                self.hierarchical)
            members = in_step.axis_ranks(self.axis_name)
            if hier is None:
                strategies._record_a2a_flat(slots, n, members)
        if hier is not None:
            slots = _hier_dispatch(slots, self.axis_name, *hier)
        elif n > 1:
            slots = in_step.alltoall(slots, self.axis_name, split_axis=0,
                                     concat_axis=1)
        self._mark("dispatch")
        h = at_precision(None, torch.bmm, slots, self.w_in.to(dt))
        h = F.gelu(h, approximate="tanh")
        y = at_precision(None, torch.bmm, h, self.w_out.to(dt))
        self._mark("experts")
        if hier is not None:
            y = _hier_combine(y, self.axis_name, *hier)
        elif n > 1:
            strategies._record_a2a_flat(y, n, members)
            y = in_step.alltoall(y, self.axis_name, split_axis=1,
                                 concat_axis=0)
        out = combine(y.reshape(E * capacity, d), route.slot, route.gate, dt)
        self._mark("combine")
        return out.reshape(x.shape), route.aux


__all__ = ["MoEMlp", "EP_AXIS", "Route", "dispatch", "combine"]
