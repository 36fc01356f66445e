"""Two-level allreduce, allgather and alltoall over a (cross, local) layout.

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

- the tiered alltoall (:func:`alltoall_tiered`): a slice-local alltoall
  on the local group, then one alltoall of the grouped rows on the cross
  group, bit-equal to the flat alltoall over the rank-major world unless
  the cross leg is quantized (:class:`_QuantizedA2A`, a block-scaled
  exchange whose backward is the exact inverse alltoall).
  :func:`alltoall_tiered_groups` runs the same schedule over an in-step
  mesh axis (``ops/in_step.py``), the MoE layer's expert axis, on
  subgroups of each of the axis's rows; :func:`a2a_hierarchy_for`
  resolves whether it applies. Each alltoall is metered by tier
  (:func:`a2a_wire_bytes`) with the JAX package's integer formulas
  (``wire.hierarchical_a2a_bytes``; a flat one split by its foreign-slice
  share).

The sums round as the JAX functions' do only where their operands meet in
the same order; on a 2 x 2 layout every sum has two operands, so the tiers
are bit-equal to JAX's. ``average`` multiplies by the fp32 reciprocal of
the world size, as XLA compiles JAX's ``/ n``.
"""

import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import topology as _topology
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


# ---------------------------------------------------------------------------
# The alltoall tier
# ---------------------------------------------------------------------------

_a2a_lock = threading.Lock()
_a2a_bytes = {}                # (dtype label, "ici" | "dcn") -> bytes


def a2a_wire_bytes():
    """``{(dtype, tier): bytes}`` booked by the alltoalls since the last
    :func:`reset_a2a_wire_bytes`: a quantized cross leg under its wire's
    label, everything else under the payload's dtype."""
    with _a2a_lock:
        return dict(_a2a_bytes)


def reset_a2a_wire_bytes():
    with _a2a_lock:
        _a2a_bytes.clear()


def _book(label, tiers):
    with _a2a_lock:
        for tier, nbytes in tiers.items():
            if nbytes:
                key = (label, tier)
                _a2a_bytes[key] = _a2a_bytes.get(key, 0) + int(nbytes)


def _dtype_label(x):
    return str(x.dtype).replace("torch.", "")


def live_slices(n):
    """``(num_slices, slice_size)`` of ``n`` ranks now (JAX's
    ``_live_slices``): the ``HOROVOD_MESH_SLICES`` knob, read live, else
    the initialized topology's slices when they span ``n`` ranks, through
    ``topology.slice_layout``'s rules."""
    from horovod_tpu_torch.common import basics
    k = _topology.forced_slices()
    st = basics._state
    if not k and st is not None and st.topology is not None \
            and st.topology.num_slices > 1 and st.topology.size == n:
        k = st.topology.num_slices
    return _topology.slice_layout(n, k or 1)


def _record_a2a_flat(x, n, members):
    """Book a flat alltoall of this rank's ``x`` over ``n`` ranks (global
    ``members``): ``n * numel * itemsize``, the self-destined rows
    included, split by the share of destinations in a foreign slice."""
    _, slice_size = live_slices(dist.get_world_size())
    total = n * x.numel() * x.element_size()
    _book(_dtype_label(x), _wire.split_tiers(
        total, _wire.a2a_dcn_fraction(list(members), slice_size)))


def _record_a2a_tiered(x, n, num_slices, cross_label):
    """Book a tiered alltoall: the local leg at the payload's dtype, all
    ICI; the cross leg at its wire's, its ``(S-1)/S`` share DCN
    (``wire.hierarchical_a2a_bytes``)."""
    h = _wire.hierarchical_a2a_bytes(x.numel(), n, num_slices,
                                     x.element_size(),
                                     cross_wire=cross_label or "")
    _book(_dtype_label(x), {"ici": h["local"]})
    _book(h["cross_label"] or _dtype_label(x), h["cross_tiers"])


class _QuantizedA2A(torch.autograd.Function):
    """One block-scaled alltoall leg over ``group`` (JAX's
    ``_quantized_a2a``): ``x``'s dim 0 holds one destination row per
    member; each row is quantized by ``wire.BLOCK``-element blocks, the
    1-byte rows and their fp32 scales move in two ``all_to_all_single``
    calls, and the receiver dequantizes. Stateless: an alltoall reduces
    nothing, so there is no residual to feed back. The backward is the
    exact inverse alltoall (split and concat on dim 0 is its own inverse):
    straight through, as JAX's custom VJP."""

    @staticmethod
    def forward(ctx, x, group, s, wire):
        from horovod_tpu_torch.ops.collective_ops import launch
        ctx.group, ctx.s = group, s
        rows = x.reshape(s, -1).to(torch.float32)
        pad = (-rows.shape[1]) % _wire.BLOCK
        if pad:
            rows = torch.nn.functional.pad(rows, (0, pad))
        blocks = rows.view(s, -1, _wire.BLOCK)
        q, scale = _wire.quantize_blocks(blocks, wire)
        qt, st = torch.empty_like(q), torch.empty_like(scale)
        launch(dist.all_to_all_single, _wire._bytes(qt), _wire._bytes(q),
               group=group)
        launch(dist.all_to_all_single, st, scale, group=group)
        out = _wire.dequantize(qt, st).reshape(s, -1)
        if pad:
            out = out[:, :-pad]
        return out.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        from horovod_tpu_torch.ops.collective_ops import launch
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        launch(dist.all_to_all_single, out, g.contiguous(), group=ctx.group)
        return out, None, None, None


def _cross_label(x, cross_wire, num_slices):
    """The quantized wire the cross leg rides, or None: a float payload of
    at least one BLOCK per destination slice (``wire.quantized_eligible``,
    the refusal ``wire.hierarchical_a2a_bytes`` applies too)."""
    label = _wire.quantized_label(cross_wire) if cross_wire else None
    if label is not None and not _wire.quantized_eligible(
            x.numel(), num_slices, x.is_floating_point(), True):
        return None
    return label


def alltoall_tiered(x, tiers, cross_wire=None, record=True):
    """2-level alltoall of this rank's ``x`` over a ``tiers`` layout (a
    ``common.topology.Tiers``, or the axis tiers of
    :func:`alltoall_tiered_groups`): a tiled alltoall on the local group,
    then one on the cross group (JAX ``alltoall_tiered``). ``x``'s dim 0
    divides by the world of the layout, as the flat tiled alltoall's does;
    the result is the flat alltoall's over the rank-major layout, bit for
    bit unless ``cross_wire`` (``int8``/``fp8``) quantizes the cross leg.
    Differentiable: each leg's backward is its inverse. ``record=False``
    books no bytes."""
    from horovod_tpu_torch.ops.in_step import _AllToAll
    cross_n, local_n = tiers.rows, tiers.cols
    n = cross_n * local_n
    m = x.shape[0]
    if m % n:
        raise ValueError(f"alltoall_tiered: leading dim {m} not divisible "
                         f"by the {cross_n}x{local_n} layout's {n} ranks")
    label = _cross_label(x, cross_wire, cross_n)
    if record:
        _record_a2a_tiered(x, n, cross_n, label)
    tail = tuple(x.shape[1:])
    blocks = x.reshape((cross_n, local_n, m // n) + tail)
    if local_n > 1:
        blocks = _AllToAll.apply(blocks, tiers.local_group, local_n, 1, 1)
    if cross_n > 1 and label is not None:
        blocks = _QuantizedA2A.apply(blocks, tiers.cross_group, cross_n,
                                     label)
    elif cross_n > 1:
        blocks = _AllToAll.apply(blocks, tiers.cross_group, cross_n, 0, 0)
    return blocks.reshape((m,) + tail)


class AxisTiers:
    """The (slice, position-in-slice) layout of one row of an in-step mesh
    axis: ``rows`` slices of ``cols`` positions, rank-major along the
    axis, with this rank's local group (its slice's positions) and cross
    group (the same position in every slice)."""

    def __init__(self, rows, cols, local_group, cross_group):
        self.rows, self.cols = rows, cols
        self.local_group, self.cross_group = local_group, cross_group


def axis_tiers(axis_name, num_slices):
    """The :class:`AxisTiers` of this rank's row of ``axis_name`` cut into
    ``num_slices`` slices. ``dist.new_group`` is collective over the
    world: the first call creates the subgroups of every row of the axis,
    on every rank at once (SPMD code makes that call everywhere); they are
    kept on the mesh, which dies with the world."""
    from horovod_tpu_torch.ops import in_step
    mesh = in_step._bound_mesh(axis_name)
    cache = mesh.__dict__.setdefault("_hvd_axis_tiers", {})
    key = (axis_name, int(num_slices))
    if key not in cache:
        dim = mesh.mesh_dim_names.index(axis_name)
        n = mesh.size(dim)
        cols = n // num_slices
        me, mine = dist.get_rank(), None
        for row in mesh.mesh.movedim(dim, -1).reshape(-1, n).tolist():
            local = [dist.new_group(row[c * cols:(c + 1) * cols])
                     for c in range(num_slices)]
            cross = [dist.new_group([row[c * cols + p]
                                     for c in range(num_slices)])
                     for p in range(cols)]
            if me in row:
                c, p = divmod(row.index(me), cols)
                mine = AxisTiers(num_slices, cols, local[c], cross[p])
        cache[key] = mine
    return cache[key]


def alltoall_tiered_groups(x, axis_name, num_slices, cross_wire=None,
                           record=True):
    """:func:`alltoall_tiered` over an in-step mesh axis (JAX
    ``alltoall_tiered_groups``): the axis's positions rank-major in
    ``num_slices`` slices, the local leg within each slice, the cross leg
    between the same position of every slice. What ``parallel/moe.py``
    routes expert dispatch and combine through."""
    from horovod_tpu_torch.ops import in_step
    n = in_step.axis_size(axis_name)
    s = int(num_slices)
    if s <= 1 or n % s:
        raise ValueError(
            f"alltoall_tiered_groups: {s} slices do not divide the "
            f"{n}-rank axis {axis_name!r} (resolve the hierarchy with "
            "a2a_hierarchy_for first)")
    if x.shape[0] % n:
        raise ValueError(f"alltoall_tiered_groups: leading dim "
                         f"{x.shape[0]} not divisible by axis size {n}")
    return alltoall_tiered(x, axis_tiers(axis_name, s), cross_wire, record)


def a2a_hierarchy_for(axis_name, hierarchical=None):
    """``(num_slices, cross_label or None)`` when an alltoall over the
    in-step axis ``axis_name`` takes the 2-level route, else None (JAX's
    resolution chain): ``hierarchical`` True forces it and False refuses
    it; None asks the alltoall-strategy registry, whose default is
    ``hier_qcross`` under ``HOROVOD_HIERARCHICAL_ALLTOALL``. The slice
    count is :func:`live_slices`'s for the axis's ranks; the cross wire is ``wire.alltoall_cross_wire_for``'s under
    ``hier_qcross`` (a plain ``hier`` keeps the cross leg exact). None
    too when ``hvd.init`` has not run."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import in_step
    n = in_step.axis_size_or_1(axis_name)
    st = basics._state
    if n <= 1 or st is None:
        return None
    cfg = st.config
    if hierarchical is None:
        default = "hier_qcross" if cfg.hierarchical_alltoall else ""
        strategy = _wire.alltoall_strategy_for("global", default)
        if strategy not in ("hier", "hier_qcross"):
            return None
    elif not hierarchical:
        return None
    else:
        strategy = "hier_qcross"
    num_slices, _ = live_slices(n)
    if num_slices <= 1:
        return None
    cross = None
    if strategy == "hier_qcross":
        cross = _wire.quantized_label(
            _wire.alltoall_cross_wire_for("global", cfg))
    return num_slices, cross
