"""Eager collectives on per-rank torch tensors.

Port of the JAX package's ``ops/collective_ops.py``: ``ReduceOp``,
``allreduce``/``grouped_allreduce`` and their async handles, ``allgather``
(ragged first dims too), ``alltoall`` (with splits), ``reducescatter``,
``broadcast``, ``barrier``, ``join``, ``broadcast_object`` and
``allgather_object``. Tensors are per-rank, as in the reference's
``horovod.torch`` — not the JAX eager API's rank-major stacked layout — and
live on the device ``hvd.init()`` chose; no result goes through the host.

Allreduce semantics follow ``_reduce_shard``: prescale each rank's tensor,
reduce (Sum/Average/Min/Max/Product/Adasum), divide by the set size for
Average, postscale. fp32/fp16/bf16 tensors go through the fusion runtime
(``ops/fusion.py``), where the pack kernel applies the prescale and the
unpack kernel the postscale, with Average's ``1/n`` folded into it (on the
quantized and cast wires of ``ops/wire.py`` the buckets round as JAX's
fused program does instead); other dtypes, which no kernel takes, are
reduced one collective each, exactly. Adasum
gathers every rank's tensor and runs the combine tree of ``ops/adasum.py``
on it (float64 too, one gather each); it refuses integer tensors.

``allgather`` concatenates the ranks' tensors along dim 0; their first
dims may differ. The first dims are exchanged (one small int64 all-gather,
which also checks that the rest of the shape and the dtype agree), every
rank's tensor is padded to the largest, gathered, and the padding is cut
out, as JAX's padded program does; under ``HOROVOD_HIERARCHICAL_ALLGATHER``
the global set's gather runs in two levels (``parallel/strategies.py``).
An allreduce of the global set rides the fusion runtime's strategy
(``hierarchical``, ``torus``, ``torus_qcross``; ``ops/fusion.py``), so the
JAX eager tier's verdict is the runtime's for that bucket; a one-shot
``Compression.int8`` request rides the flat quantized exchange, never the
tier, as in JAX. ``alltoall`` exchanges the split matrix
the same way. A group of fp32/fp16/bf16 tensors reduce-scatters as one
collective: each tensor's n row blocks are packed rank-major (block r of
every tensor, then block r + 1) by the pack kernel with the prescale, one
``reduce_scatter`` runs over the buffer, and the unpack kernel writes the
outputs with the postscale, Average's ``1/n`` folded into it.

Join (``HOROVOD_JOIN_MODE=1`` on every process; see "Join" below): a rank
that called ``join()`` contributes nothing to the collectives of the ranks
still active until every rank has joined.

Every eager collective opens with :func:`fence`: the fusion runtime closes
buckets on a timer, decided by rank 0, so the buckets in flight go first on
every rank and each communicator sees the same sequence.

Every ``torch.distributed`` call goes through :func:`launch`: a failure of
the backend (a peer that died, a process group that was aborted) reaches
the caller as ``HorovodInternalError``, the error the elastic loop
(``elastic/state.py::run``) recovers from, with the backend's own error as
its ``__cause__``. A failure also counts in ``collective_errors_total``,
leaves an ``error`` event in the flight ring and dumps it
(``dispatch_error``).

Every eager collective and every fused bucket runs inside
:func:`_dispatch_op` (JAX's ``_timeline_op``), the observability planes'
choke point: the per-op count, bytes and wire bytes, the host latency, the
flight ``dispatch``/``complete`` pair with its per-set sequence number,
the timeline span, the step profiler's dispatch record, the ``dispatch``
span under the active step trace and, while a ``torch.profiler`` session
runs, an ``hvd::<OP>::<name>`` annotation. Each is one gate read when its
plane is off.
"""

import contextlib
import enum
import hashlib
import math
import pickle
import threading
import time

import torch
import torch.distributed as dist

from horovod_tpu_torch import trace as _trace
from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                  ProcessSetError,
                                                  TensorShapeMismatchError)
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics import instruments as _metrics
from horovod_tpu_torch.profile import ledger as _profile
from horovod_tpu_torch.ops import wire as _wire
from horovod_tpu_torch.ops.kernels.scale_buffers import DTYPES as _KERNEL_DTYPES
from horovod_tpu_torch.ops.kernels.scale_buffers import pack_scale, unpack_scale


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
# Reduce a flat tensor and keep this rank's 1/n of it, the same way
# (reduce_scatter_single takes over reduce_scatter_tensor's name).
reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor

# Average is a Sum on the wire; the 1/n is applied after it.
DIST_OPS = {
    ReduceOp.AVERAGE: dist.ReduceOp.SUM,
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
}


def launch(fn, *args, **kwargs):
    """Run one ``torch.distributed`` call ``fn(*args, **kwargs)``, waiting
    on it when ``async_op=True``. A failure of the backend, or any call
    once the process group has been aborted (``basics.abort``), raises
    :class:`HorovodInternalError` from the original error, after the
    failure epilogue (:func:`_dispatch_failed`)."""
    st = basics._get_state()
    name = getattr(fn, "__name__", "collective")
    if st.aborted is not None:
        err = HorovodInternalError(f"{name}: {st.aborted}")
        _dispatch_failed(name, err)
        raise err
    try:
        work = fn(*args, **kwargs)
        if kwargs.get("async_op"):
            work.wait()
    except HorovodInternalError as e:
        _dispatch_failed(name, e)
        raise
    except Exception as e:
        # torch.distributed's errors (DistError and gloo's) are
        # RuntimeErrors; after an abort the group is gone and the call may
        # raise anything.
        _dispatch_failed(name, e)
        if isinstance(e, RuntimeError) or st.aborted is not None:
            raise HorovodInternalError(
                f"{name} failed on rank {st.rank} of {st.size}: {e}") from e
        raise


# The dispatch span open on this thread: (op label, name), for the failure
# epilogue of a launch inside it.
_span = threading.local()


def _dispatch_failed(what, e):
    """The failure epilogue of one dispatch (JAX's
    ``_translate_dispatch_error``): count the error under the open span's
    op label, record an ``error`` event in the flight ring and dump it.
    Once per exception: a launch inside a span records it, the span then
    sees it recorded. Never raises."""
    if getattr(e, "_hvd_recorded", False):
        return
    try:
        e._hvd_recorded = True
    except Exception:  # noqa: BLE001 — an exception without a __dict__
        pass
    try:
        op_label, name = getattr(_span, "cur", None) or (what, what)
        _metrics.record_collective_error(op_label)
        if _flight.armed:
            _flight.record_event(
                "error", op=op_label, name=name,
                what=(str(e).splitlines() or [""])[0][:200])
            _flight.dump("dispatch_error")
    except Exception:  # noqa: BLE001 — forensics must never fail the job
        pass


def _ps_label(process_set):
    """Bounded-cardinality process-set label for metrics series: 'global'
    or the registered set id."""
    if process_set is None or process_set.ranks is None:
        return "global"
    pid = getattr(process_set, "process_set_id", None)
    return f"set{pid}" if pid is not None else "unregistered"


def _nbytes(t):
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _dispatch_op(name, op_kind, tensors=(), process_set=None, wire=None,
                 sig=None):
    """Metrics, flight, timeline, step profiler, step trace and profiler
    annotation around one eager collective or fused bucket (JAX's
    ``_timeline_op``). Count and bytes go in at entry (a failure still
    counts as an attempt), the latency and the flight ``complete`` on
    return. ``wire``: a list of ``(path, dtype label, wire bytes,
    compressed, tiers)`` records (a fused bucket's exact on-wire
    estimate); without it the payload's bytes are booked, an allreduce's
    twice (its reduce-scatter and all-gather legs). ``sig``: the tensors'
    flight signature when the caller keeps it (a fused bucket's, computed
    once per bucket layout). On the GPU the body
    returns at launch — the device runs after the host — so the latency is
    the host's; a bucket's device time comes from its CUDA events
    (``profile/ledger.py``)."""
    op_label = op_kind.lower()
    profile_on = _profile.armed
    metrics_on = _metrics.enabled()
    flight_on = _flight.armed
    tl = basics.timeline()
    if profile_on:
        t_api = time.perf_counter()
    if metrics_on or flight_on or profile_on:
        nbytes = sum(_nbytes(t) for t in tensors)
        ps_label = _ps_label(process_set)
    if metrics_on:
        _metrics.record_collective(op_label, nbytes, ps_label)
        if wire is not None:
            for w in wire:
                _metrics.record_wire(w[0], w[1], w[2], w[3], tiers=w[4])
        elif tensors:
            wb = nbytes * (2 if op_kind == "ALLREDUCE" else 1)
            _metrics.record_wire(
                "eager", _flight.dtype_name(tensors[0].dtype), wb,
                sched="a2a" if op_kind == "ALLTOALL" else "ring")
    if flight_on:
        # SPMD: every process dispatches the same collectives in the same
        # order, so the per-set seq lines up across ranks (the analyzer's
        # desync key).
        fl_seq = _flight.record_dispatch(
            op_label, ps_label, nbytes,
            _flight.signature(tensors) if sig is None else sig, name)
    prev = getattr(_span, "cur", None)
    _span.cur = (op_label, name)
    if metrics_on or flight_on or profile_on:
        t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            if torch.autograd.profiler._is_profiler_enabled:
                stack.enter_context(torch.profiler.record_function(
                    f"hvd::{op_kind}::{name}"))
            if tl is not None:
                stack.enter_context(tl.op_span(name, op_kind))
            yield
    except BaseException as e:
        _dispatch_failed(op_label, e)
        raise
    finally:
        _span.cur = prev
    if metrics_on or flight_on or profile_on:
        dur = time.perf_counter() - t0
    if metrics_on:
        _metrics.record_collective_latency(op_label, dur)
    if flight_on:
        _flight.record_complete(op_label, ps_label, fl_seq, dur)
        _trace.add_span(_trace.get_active(), "dispatch", time.time() - dur,
                        dur, cat="train", args={"op": op_label,
                                                "seq": fl_seq})
    if profile_on:
        _profile.record_dispatch(
            op_label, dur, time.perf_counter() - t_api - dur, nbytes)


def _process_set(process_set):
    ps = global_process_set if process_set is None else process_set
    if ps.process_set_id is None:
        raise ProcessSetError(f"{ps} is not registered")
    if not ps.included():
        raise ProcessSetError(
            f"rank {basics.rank()} is not a member of {ps}")
    return ps


def digest(sig):
    """A 64-bit hash of ``repr(sig)``, as a signed int64."""
    return int.from_bytes(
        hashlib.blake2b(repr(sig).encode(), digest_size=8).digest(),
        "little", signed=True)


def gather_int64(values, ps):
    """Every rank's ``values`` (ints, as many on every rank), in rank order:
    one small all-gather on the set's device."""
    mine = torch.tensor(values, dtype=torch.int64, device=basics.device())
    every = torch.empty(ps.size() * len(values), dtype=torch.int64,
                        device=mine.device)
    launch(all_gather_flat, every, mine, group=ps.group)
    return every.view(ps.size(), len(values)).tolist()


def rank_digests(sig, ps):
    """:func:`digest` of ``sig`` and every rank's digest of its own, in rank
    order: one small all-gather, for checks that ranks agree."""
    mine = digest(sig)
    return mine, [row[0] for row in gather_int64([mine], ps)]


# ---------------------------------------------------------------------------
# Join (reference: torch/mpi_ops.py DoJoin, controller.cc:269-327; the JAX
# package's _join_sync, _mirror_dispatch, _join_multiprocess and join)
# ---------------------------------------------------------------------------
# With HOROVOD_JOIN_MODE=1 on every process of a multi-process world, every
# collective opens with one descriptor round among its set: one small int64
# all-gather in which each active rank publishes what it launches next and
# each joined rank that it has joined. A joined process sits in join(),
# takes part in every round of its set and mirrors each descriptor with a
# launch of the same collective, of the same size and dtype, whose
# contribution is neutral: zeros for Sum, Average, reducescatter and the
# Adasum gather, +inf / -inf (the integer bounds) for Min / Max, 1 for
# Product, no rows for allgather. NCCL hangs rather than raises when ranks
# launch different sequences, so a mirror launches exactly what the active
# ranks do, and an active rank checks its arguments before it publishes.
# The active ranks' results exclude the joined ones: Average divides by the
# active count and Adasum drops their rows before the tree. A broadcast from
# a joined root and an alltoall raise on every active rank after the round;
# the joined process launches nothing for them and serves on. When a round
# shows every rank joined, join() returns the last rank to join on every
# process, and the state resets.
#
# A process inside join() serves its set's rounds only. While it is there,
# the others issue collectives on that set alone; a collective on another set
# that holds a rank joined to the global set raises instead of hanging.

# A round's int64 slots: joined flag, kind, op, dtype, numel, root, digest.
_ROUND = 7
ALLREDUCE, ADASUM, ALLGATHER, BROADCAST, ALLTOALL, REDUCESCATTER, BARRIER = \
    range(1, 8)
_WIRE_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool)


def join_armed():
    """Whether collectives open with a join round: HOROVOD_JOIN_MODE=1 in a
    world of more than one process."""
    st = basics._get_state()
    return st.config.join_mode and st.size > 1


def _set_joined(ps, joined):
    if ps.ranks is None:
        basics._get_state().joined_ranks = joined
    else:
        ps.joined_ranks = joined


def join_round(ps, kind, op=0, dtype=None, numel=0, root=0, sig=None,
               agree=False):
    """The round a collective on ``ps`` opens with: returns the global ranks
    of ``ps`` that have joined (none when join is not armed). While armed,
    this rank publishes its descriptor (``kind``, ``op``, ``dtype``,
    ``numel``, ``root`` and the digest of ``sig``) and every active rank's
    must be the same, else ``TensorShapeMismatchError`` on all of them.
    Unarmed, ``agree`` checks the digests of ``sig`` alone (one small
    all-gather); without it nothing is exchanged."""
    if not join_armed():
        if agree:
            mine, every = rank_digests(sig, ps)
            if any(h != mine for h in every):
                raise TensorShapeMismatchError(
                    f"{_KIND_NAMES[kind]}: the ranks' tensors differ (this "
                    f"rank: {sig}); digests by rank: {every}")
        return frozenset()
    st = basics._get_state()
    ranks = ps.rank_list()
    if ps.ranks is not None:
        away = st.joined_ranks & set(ranks)
        if away:
            raise HorovodInternalError(
                f"{_KIND_NAMES[kind]} on process set {ranks} while rank(s) "
                f"{sorted(away)} have joined the global set: a joined "
                "process serves global-set collectives only")
    else:
        busy = [p.rank_list() for p in st.process_set_table.by_id.values()
                if p.ranks is not None and p.joined_ranks]
        if busy:
            raise HorovodInternalError(
                f"{_KIND_NAMES[kind]} on the global set while ranks have "
                f"joined process set(s) {busy}: a process in "
                "join(process_set=...) serves that set's collectives only")
    if dtype is not None and dtype not in _WIRE_DTYPES:
        raise TypeError(f"{dtype} is not supported while join is armed")
    desc = [0, kind, int(op),
            0 if dtype is None else _WIRE_DTYPES.index(dtype), int(numel),
            int(root), 0 if sig is None else digest(sig)]
    rows = gather_int64(desc, ps)
    joined = frozenset(r for r, row in zip(ranks, rows) if row[0])
    _set_joined(ps, set(joined))
    bad = [row for row in rows if not row[0] and row != desc]
    if bad:
        raise TensorShapeMismatchError(
            f"join-mode collective mismatch on {ranks}: this rank launches "
            f"{_describe(desc)}, others {[_describe(b) for b in bad[:2]]}; "
            "every rank must issue the same collectives in the same order")
    return joined


_KIND_NAMES = {ALLREDUCE: "allreduce", ADASUM: "Adasum allreduce",
               ALLGATHER: "allgather", BROADCAST: "broadcast",
               ALLTOALL: "alltoall", REDUCESCATTER: "reducescatter",
               BARRIER: "barrier"}


def _describe(desc):
    _, kind, op, code, numel, root, _ = desc
    return (f"{_KIND_NAMES.get(kind, kind)}(op={op}, "
            f"dtype={_WIRE_DTYPES[code]}, numel={numel}, root={root})")


def _neutral(op, dtype):
    """The element a joined rank contributes to ``op``."""
    if op == ReduceOp.PRODUCT:
        return 1
    if op not in (ReduceOp.MIN, ReduceOp.MAX):
        return 0
    if dtype == torch.bool:
        return op == ReduceOp.MIN
    if dtype.is_floating_point:
        return math.inf if op == ReduceOp.MIN else -math.inf
    info = torch.iinfo(dtype)
    return info.max if op == ReduceOp.MIN else info.min


def _mirror(desc, joined, ps):
    """On a joined process: launch what the active ranks of ``ps`` launch
    for ``desc``, with a neutral contribution."""
    _, kind, op, code, numel, root, _ = desc
    with _dispatch_op(f"join_mirror_{_KIND_NAMES.get(kind, kind)}", "JOIN",
                      (), ps):
        _mirror_launch(kind, op, code, numel, root, joined, ps)


def _mirror_launch(kind, op, code, numel, root, joined, ps):
    dtype, dev, n = _WIRE_DTYPES[code], basics.device(), ps.size()
    if kind == ALLREDUCE:
        op = ReduceOp(op)
        buf = torch.full((numel,), _neutral(op, dtype), dtype=dtype,
                         device=dev)
        launch(dist.all_reduce, buf, op=DIST_OPS[op], group=ps.group)
    elif kind == ADASUM:
        launch(all_gather_flat,
               torch.empty(n * numel, dtype=dtype, device=dev),
               torch.zeros(numel, dtype=dtype, device=dev), group=ps.group)
    elif kind == ALLGATHER:
        _gather_rows(None, ps, joined, dtype, numel)
    elif kind == REDUCESCATTER:
        launch(reduce_scatter_flat,
               torch.empty(numel // n, dtype=dtype, device=dev),
               torch.zeros(numel, dtype=dtype, device=dev),
               op=dist.ReduceOp.SUM, group=ps.group)
    elif kind == BROADCAST and root not in joined:
        launch(dist.broadcast, torch.empty(numel, dtype=dtype, device=dev),
               src=root, group=ps.group)
    elif kind == BARRIER:
        _barrier(ps)
    # ALLTOALL, or a broadcast from a joined root: the active ranks raise
    # after the round and launch nothing.


def _serve(ps):
    """join()'s loop: take part in every round of ``ps`` as joined and
    mirror each descriptor, until a round shows every rank joined; returns
    the highest rank that joined in that last round."""
    ranks = ps.rank_list()
    me = [1] + [0] * (_ROUND - 1)
    prev = set(basics._get_state().joined_ranks if ps.ranks is None
               else ps.joined_ranks)
    while True:
        rows = gather_int64(me, ps)
        joined = {r for r, row in zip(ranks, rows) if row[0]}
        _set_joined(ps, joined)
        descs = [row for row in rows if not row[0]]
        if not descs:
            _set_joined(ps, set())
            return max(joined - prev, default=ranks[-1])
        if all(d == descs[0] for d in descs):
            _mirror(descs[0], frozenset(joined), ps)
        prev = joined


def fence():
    """The prologue of every eager collective (the JAX package's
    ``FusionRuntime.fence``, ``horovod_tpu/ops/collective_ops.py:2185-2193``):
    the fused buckets in flight go first on every process. Process 0
    flushes what it has pending and publishes the boundary; another process
    waits until process 0's boundaries cover its pending tensors. Buckets
    close on a timer, so without this a rank could issue the eager
    collective before a bucket another rank issued first: mismatched NCCL
    launches, a hang."""
    st = basics._get_state()
    if st.fusion is not None:
        st.fusion.fence()


def join(process_set=None):
    """Signal that this rank's data ran out (reference semantics:
    torch/mpi_ops.py DoJoin, controller.cc:269-327). Until every rank of
    the set has joined, this rank contributes nothing to the active ranks'
    collectives (Sum sees zeros, Average divides by the active count, Min,
    Max, Product and Adasum exclude it, allgather drops its rows,
    reducescatter excludes it). Returns the global rank of the last rank to
    join, on every rank; the join state then resets.

    Across processes it needs ``HOROVOD_JOIN_MODE=1`` on every process,
    which makes every collective open with a descriptor round; without it,
    join() in a world of more than one process raises. ``process_set``:
    join within that set only; its other members go on with set-scoped
    collectives, and the ranks outside it are not involved."""
    ps = _process_set(process_set)
    fence()
    if ps.size() == 1:
        _set_joined(ps, set())
        return ps.rank_list()[0]
    if not basics._get_state().config.join_mode:
        # Not HorovodInternalError: the elastic wrapper retries on that, and
        # this usage error would repeat forever.
        raise NotImplementedError(
            "hvd.join() across processes requires HOROVOD_JOIN_MODE=1 on "
            "every process (it arms a descriptor round on every "
            "collective); without it no process can drop out of the "
            "collectives: pad uneven batches instead")
    return _serve(ps)


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


def _allreduce_unfused(t, out, op, prescale, postscale, ps, name=None):
    """Integer and float64 tensors: outside the fusion kernel's dtypes,
    reduced by one collective each."""
    if not t.is_floating_point() and (prescale != 1.0 or postscale != 1.0):
        raise ValueError("prescale/postscale factors need a floating-point "
                         "tensor")
    fence()
    joined = join_round(ps, ALLREDUCE, op, t.dtype, t.numel())
    out.copy_(t)
    if prescale != 1.0:
        out.mul_(prescale)
    with _dispatch_op(name or "allreduce", "ALLREDUCE", (t,), ps):
        launch(dist.all_reduce, out, op=DIST_OPS[op], group=ps.group)
    if op == ReduceOp.AVERAGE:
        out.div_(ps.size() - len(joined))
    if postscale != 1.0:
        out.mul_(postscale)
    return Handle(out)


def active_rows(gathered, ps, joined):
    """The rows of a gathered (n, ...) tensor that active ranks sent: all
    of it when no rank of ``ps`` has joined."""
    if not joined:
        return gathered
    return gathered[[i for i, r in enumerate(ps.rank_list())
                     if r not in joined]]


def _adasum_unfused(t, out, prescale, postscale, ps, name=None):
    """float64 under Adasum, outside the scale kernel's dtypes: prescale,
    one gather, the combine tree (whose kernel reads float64 into fp32),
    postscale."""
    from horovod_tpu_torch.ops.adasum import reduce_gathered
    fence()
    joined = join_round(ps, ADASUM, ReduceOp.ADASUM, t.dtype, t.numel())
    x = t.reshape(-1) * prescale if prescale != 1.0 else t.reshape(-1)
    gathered = torch.empty(ps.size() * x.numel(), dtype=t.dtype,
                           device=t.device)
    with _dispatch_op(name or "allreduce", "ALLREDUCE", (t,), ps):
        launch(all_gather_flat, gathered, x.contiguous(), group=ps.group)
    rows = active_rows(gathered.view(ps.size(), -1), ps, joined)
    out.copy_(reduce_gathered(rows, (x.numel(),)).view(out.shape))
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

    A one-shot wire request (``Compression.int8``'s ``compress``) is
    consumed here, as JAX's ``allreduce_async`` consumes it: on a runtime
    whose own wire is quantized it changes nothing, and otherwise this
    call's fp32/fp16/bf16 tensors become a bucket of their own on that wire
    (float64 and integer tensors stay exact).
    """
    request = _wire.quantized_label(_wire.consume_wire_request())
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
                                         float(postscale_factor), ps,
                                         names[i])
        else:
            handles[i] = _allreduce_unfused(t, outputs[i], op,
                                            float(prescale_factor),
                                            float(postscale_factor), ps,
                                            names[i])
    if by_dtype:
        from horovod_tpu_torch.ops.fusion import get_runtime
        rt = get_runtime()
        if request is not None and _wire.is_quantized(rt.wire_for(ps)):
            request = None
        for idxs in by_dtype.values():
            hs = rt.enqueue([tensors[i].contiguous() for i in idxs],
                            [outputs[i] for i in idxs], op,
                            float(prescale_factor), float(postscale_factor),
                            ps, [names[i] for i in idxs], wire=request)
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


def _gather_rows(t, ps, joined, dtype, row_numel):
    """The gather's two launches: every rank's first dim (and a digest of
    the rest of its shape and its dtype), then the ranks' rows padded to
    the largest first dim, gathered flat. ``t``: this rank's contiguous
    tensor of rank >= 1, or None for a joined rank's mirror, which sends no
    rows. Returns the active ranks' rows concatenated along dim 0 and their
    first dims, in rank order (None for the mirror)."""
    n = ps.size()
    mine = [0, 0] if t is None else \
        [t.shape[0], digest((tuple(t.shape[1:]), str(t.dtype)))]
    rows = gather_int64(mine, ps)
    active = [i for i, r in enumerate(ps.rank_list()) if r not in joined]
    if len({rows[i][1] for i in active}) > 1:
        # Never on a mirror: the join round already held the active ranks'
        # digests equal.
        raise TensorShapeMismatchError(
            f"allgather: the ranks' tensors differ beyond dim 0 or in dtype "
            f"(this rank: {tuple(t.shape)} {t.dtype}); digests by rank: "
            f"{[rows[i][1] for i in active]}")
    sizes = [rows[i][0] for i in range(n)]
    most = max(sizes)
    per = most * row_numel
    dev = basics.device()
    src = torch.empty(0, dtype=dtype, device=dev) if t is None \
        else t.reshape(-1)
    if src.numel() < per:
        src = torch.cat([src, src.new_zeros(per - src.numel())])
    st = basics._get_state()
    if st.config.hierarchical_allgather and ps.ranks is None and not joined:
        # HOROVOD_HIERARCHICAL_ALLGATHER: gather within each node, then one
        # block per node across nodes (JAX's allgather_hierarchical over
        # mesh2d); the same rank-major rows.
        from horovod_tpu_torch.parallel.strategies import \
            allgather_hierarchical
        out = allgather_hierarchical(
            src, st.topology.tiers(st.topology.node_shape())).view(-1)
    else:
        out = torch.empty(n * per, dtype=dtype, device=dev)
        launch(all_gather_flat, out, src, group=ps.group)
    if t is None:
        return None
    kept = [sizes[i] for i in active]
    if any(s != most for s in sizes):
        out = torch.cat([out[i * per:i * per + sizes[i] * row_numel]
                         for i in active])
    return out.view((sum(kept),) + tuple(t.shape[1:])), kept


def allgather_sizes(tensor, ps, what="allgather", name=None):
    """:func:`allgather` on a registered set ``ps``, with the first dims of
    the ranks that sent rows, in rank order."""
    _check_tensor(tensor, what)
    t = tensor.reshape(1) if tensor.dim() == 0 else tensor.contiguous()
    tail = tuple(t.shape[1:])
    row_numel = math.prod(tail)
    fence()
    joined = join_round(ps, ALLGATHER, dtype=t.dtype, numel=row_numel,
                        sig=(tail, str(t.dtype)))
    with _dispatch_op(name or what, "ALLGATHER", (t,), ps):
        return _gather_rows(t, ps, joined, t.dtype, row_numel)


def allgather(tensor, process_set=None, name=None):
    """Every rank's tensor concatenated along dim 0, in rank order
    (reference: hvd.allgather torch/mpi_ops.py:655-712). The first dims may
    differ; the rest of the shape and the dtype must agree, else
    ``TensorShapeMismatchError``. A 0-d tensor gathers into a vector. The
    rows of a rank that has joined are dropped."""
    return allgather_sizes(tensor, _process_set(process_set),
                           name=name)[0]


def alltoall(tensor, splits=None, process_set=None, name=None):
    """Scatter the rows of ``tensor`` to the ranks of the set and gather
    what they send (reference: hvd.alltoall torch/mpi_ops.py:928-1014).
    Without ``splits`` the first dim is split equally and must divide by the
    set size; ``splits`` gives the rows for each rank, in set order (rows
    past their sum are not sent). Returns the received rows, in rank order,
    and with ``splits`` also the rows received from each rank (int64, on
    the tensor's device). The ranks' tensors must agree beyond dim 0 and in
    dtype. Raises while any rank has joined.

    Equal splits on the global set take the hierarchical route (JAX's
    eager tier: ``parallel/strategies.py::alltoall_tiered``, a slice-local
    leg, then one cross-slice leg on ``hvd.set_alltoall_cross_dtype``'s
    wire) when ``hvd.set_alltoall_strategy("hier"|"hier_qcross")`` or
    ``HOROVOD_HIERARCHICAL_ALLTOALL`` arms it over more than one slice; a
    one-slice layout stays flat. Both routes book their bytes by tier
    (``strategies.a2a_wire_bytes``)."""
    ps = _process_set(process_set)
    _check_tensor(tensor, "alltoall")
    n = ps.size()
    if tensor.dim() < 1:
        raise TensorShapeMismatchError("alltoall takes a tensor of rank >= 1")
    m = tensor.shape[0]
    if splits is None:
        if m % n:
            raise TensorShapeMismatchError(
                f"alltoall without splits: the first dim {m} must divide by "
                f"the set size {n}")
        send = [m // n] * n
    else:
        send = torch.as_tensor(splits)
        if send.dim() != 1 or send.numel() != n or (send < 0).any():
            raise TensorShapeMismatchError(
                f"alltoall splits must be {n} non-negative row counts, one "
                f"per rank of the set, got {send.tolist()}")
        send = [int(v) for v in send.tolist()]
        if sum(send) > m:
            raise TensorShapeMismatchError(
                f"alltoall splits sum to {sum(send)} rows, but the tensor "
                f"has {m}")
    fence()
    if join_round(ps, ALLTOALL):
        raise HorovodInternalError(
            "alltoall is not supported while ranks have joined (as the "
            "reference: join covers allreduce, allgather and broadcast)")
    tail = tuple(tensor.shape[1:])
    rows = gather_int64(send + [digest((tail, str(tensor.dtype)))], ps)
    if len({row[-1] for row in rows}) > 1:
        raise TensorShapeMismatchError(
            f"alltoall: the ranks' tensors differ beyond dim 0 or in dtype "
            f"(this rank: {tuple(tensor.shape)} {tensor.dtype})")
    me = ps.rank()
    received = [row[me] for row in rows]
    with _dispatch_op(name or "alltoall", "ALLTOALL", (tensor,), ps):
        if splits is None:
            from horovod_tpu_torch.parallel import strategies as _strategies
            hier = _a2a_hier_for(ps, tensor)
            if hier is not None:
                st = basics._get_state()
                slices, cross = hier
                tiers = st.topology.tiers((slices, n // slices))
                with torch.no_grad():
                    return _strategies.alltoall_tiered(tensor.contiguous(),
                                                       tiers, cross)
            _strategies._record_a2a_flat(tensor, n, ps.rank_list())
        out = torch.empty((sum(received),) + tail, dtype=tensor.dtype,
                          device=tensor.device)
        launch(dist.all_to_all_single, out, tensor[:sum(send)].contiguous(),
               received, send, group=ps.group)
    if splits is None:
        return out
    return out, torch.tensor(received, dtype=torch.int64,
                             device=tensor.device)


def _a2a_hier_for(ps, tensor):
    """``(num_slices, cross label or None)`` when an equal-splits alltoall
    of ``tensor`` on ``ps`` takes the hierarchical route, else None (JAX's
    ``_eager_a2a_hier_for``): the global set only, the alltoall-strategy
    registry's ``hier``/``hier_qcross`` (``hier_qcross`` by default under
    ``HOROVOD_HIERARCHICAL_ALLTOALL``), more than one live slice; the cross
    wire (``wire.alltoall_cross_wire_for``, never the allreduce knobs) only
    under ``hier_qcross`` and for a float payload of a BLOCK or more per
    destination slice."""
    from horovod_tpu_torch.parallel import strategies as _strategies
    cfg = basics._get_state().config
    if ps.ranks is not None or not (cfg.hierarchical_alltoall
                                    or _wire.alltoall_strategy_pinned()):
        return None
    strategy = _wire.alltoall_strategy_for(
        "global", "hier_qcross" if cfg.hierarchical_alltoall else "")
    if strategy not in ("hier", "hier_qcross"):
        return None
    slices, _ = _strategies.live_slices(ps.size())
    if slices <= 1:
        return None
    cross = None
    if strategy == "hier_qcross":
        cross = _strategies._cross_label(
            tensor, _wire.alltoall_cross_wire_for("global", cfg), slices)
    return slices, cross


def rank_major_blocks(tensors, n):
    """Each tensor's n row blocks, block r of every tensor before block
    r + 1: contiguous views whose concatenation a reduce-scatter over n
    ranks leaves rank r the reduction of its blocks, in the tensors'
    order."""
    views = [t.reshape(n, -1) for t in tensors]
    return [v[r] for r in range(n) for v in views]


def _reducescatter(ts, outs, op, prescale, postscale, ps, name=None):
    """One reduce-scatter of ``ts`` (one dtype; a list of more than one
    only for the kernel's dtypes) into ``outs``."""
    n, dtype = ps.size(), ts[0].dtype
    total = sum(t.numel() for t in ts)
    sig = (int(op), prescale, postscale, str(dtype),
           tuple(tuple(t.shape) for t in ts))
    fence()
    joined = join_round(ps, REDUCESCATTER, op, dtype, total, sig=sig,
                        agree=True)
    if dtype in _KERNEL_DTYPES:
        flat = torch.empty(total, dtype=dtype, device=ts[0].device)
        pack_scale(rank_major_blocks(ts, n), flat, prescale)
    else:
        flat = ts[0].reshape(-1)
        if prescale != 1.0:
            flat = flat * prescale
    out = torch.empty(total // n, dtype=dtype, device=flat.device)
    with _dispatch_op(name or "reducescatter", "REDUCESCATTER", ts, ps):
        launch(reduce_scatter_flat, out, flat.contiguous(),
               op=dist.ReduceOp.SUM, group=ps.group)
    if op == ReduceOp.AVERAGE:
        postscale = postscale / (n - len(joined))
    if dtype in _KERNEL_DTYPES:
        unpack_scale(out, outs, postscale)
    else:
        outs[0].copy_(out.view(outs[0].shape))
        if postscale != 1.0:
            outs[0].mul_(postscale)


def grouped_reducescatter_async(tensors, op=Sum, prescale_factor=1.0,
                                postscale_factor=1.0, process_set=None,
                                name=None):
    """Reduce every tensor across the set and keep this rank's block of
    rows: rank r gets rows r m/n .. (r + 1) m/n of the reduction of an
    (m, ...) tensor (reference: hvd.reducescatter torch/mpi_ops.py:1066-1123;
    EnqueueTensorReducescatters operations.cc:1797). Sum and Average only;
    each first dim must divide by the set size. The tensors of each of the
    kernel's dtypes go out as one collective: packed rank-major with the
    prescale, one ``reduce_scatter``, unpacked with the postscale (and
    Average's 1/n); others take one collective each. Returns a handle per
    tensor."""
    op = ReduceOp(op)
    ps = _process_set(process_set)
    n = ps.size()
    tensors = list(tensors)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"reducescatter supports Sum and Average, not "
                         f"{op.name} (as the reference: message.h:43-50)")
    pre, post = float(prescale_factor), float(postscale_factor)
    for t in tensors:
        _check_tensor(t, "reducescatter")
        if t.dim() < 1 or t.shape[0] % n:
            raise TensorShapeMismatchError(
                f"reducescatter: the first dim must divide by the set size "
                f"{n}, got {tuple(t.shape)}")
        if not t.is_floating_point():
            if op == ReduceOp.AVERAGE:
                raise ValueError("Average is not supported for integer "
                                 "tensors; use hvd.Sum")
            if pre != 1.0 or post != 1.0:
                raise ValueError("prescale/postscale factors need a "
                                 "floating-point tensor")
    outs = [torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device) for t in tensors]
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype if t.dtype in _KERNEL_DTYPES else i,
                          []).append(i)
    for idxs in groups.values():
        _reducescatter([tensors[i] for i in idxs], [outs[i] for i in idxs],
                       op, pre, post, ps, name)
    return [Handle(o, name) for o in outs]


def reducescatter(tensor, op=Sum, prescale_factor=1.0, postscale_factor=1.0,
                  process_set=None, name=None):
    return grouped_reducescatter_async(
        [tensor], op=op, prescale_factor=prescale_factor,
        postscale_factor=postscale_factor, process_set=process_set,
        name=name)[0].synchronize()


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
    fence()
    joined = join_round(ps, BROADCAST, dtype=tensor.dtype,
                        numel=tensor.numel(), root=root_rank)
    if root_rank in joined:
        raise HorovodInternalError(f"broadcast root_rank {root_rank} has "
                                   "joined")
    out = tensor if inplace else tensor.clone()
    dev = basics.device()
    buf = out if out.device == dev and out.is_contiguous() \
        else out.to(dev, memory_format=torch.contiguous_format)
    with _dispatch_op(name or "broadcast", "BROADCAST", (buf,), ps):
        launch(dist.broadcast, buf, src=root_rank, group=ps.group)
    if buf is not out:
        out.copy_(buf)
    return out


def barrier(process_set=None, name=None):
    """Block until every rank of the set reaches the barrier (reference:
    hvd.barrier, operations.cc EnqueueBarrier)."""
    ps = _process_set(process_set)
    fence()
    join_round(ps, BARRIER)
    with _dispatch_op(name or "barrier", "BARRIER", (), ps):
        _barrier(ps)


def _barrier(ps):
    dev = basics.device()
    if dev.type == "cuda":
        launch(dist.barrier, group=ps.group, device_ids=[dev.index])
    else:
        launch(dist.barrier, group=ps.group)


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


def allgather_object(obj, process_set=None, name=None):
    """Every rank's object, in rank order: pickled, the bytes gathered by
    the ragged allgather, unpickled (reference: torch/functions.py
    allgather_object)."""
    ps = _process_set(process_set)
    payload = torch.frombuffer(bytearray(pickle.dumps(obj)),
                               dtype=torch.uint8).to(basics.device())
    gathered, sizes = allgather_sizes(payload, ps, "allgather_object")
    data = gathered.cpu().numpy().tobytes()
    out, off = [], 0
    for size in sizes:
        out.append(pickle.loads(data[off:off + size]))
        off += size
    return out


def sparse_allreduce(tensor, op=Average, process_set=None, name=None):
    """Allreduce of a ``torch.sparse_coo_tensor``: every rank's indices and
    values gathered (ragged), so duplicate coordinates sum when the result
    is coalesced; Average divides the values by the number of ranks that
    sent them (reference: torch/mpi_ops.py:591-612). Returns an uncoalesced
    sparse tensor of the input's size."""
    op = ReduceOp(op)
    if op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(f"sparse allreduce supports Sum and Average, not "
                         f"{op.name}")
    if not isinstance(tensor, torch.Tensor) or not tensor.is_sparse:
        raise TypeError("sparse_allreduce takes a torch.sparse_coo_tensor")
    if op == ReduceOp.AVERAGE and not tensor.is_floating_point():
        raise ValueError("Average is not supported for integer tensors; use "
                         "hvd.Sum")
    ps = _process_set(process_set)
    indices, sizes = allgather_sizes(tensor._indices().t().contiguous(), ps,
                                     "sparse_allreduce")
    values, _ = allgather_sizes(tensor._values().contiguous(), ps,
                                "sparse_allreduce")
    if op == ReduceOp.AVERAGE:
        values = values / len(sizes)
    return torch.sparse_coo_tensor(indices.t(), values, tensor.size(),
                                   check_invariants=False)
