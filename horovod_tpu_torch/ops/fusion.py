"""Tensor fusion (bucketing) runtime for the eager path.

Port of the JAX package's ``ops/fusion.py`` (``FusedHandle``, the bucket
key, ``enqueue_allreduce``/``enqueue_grouped_allreduce``, ``flush_all``,
``shutdown`` and the flush itself), built the way the reference builds it on
a GPU (fusion_buffer_manager.h:30-62, operations.cc:747-853): one persistent
device fusion buffer per dtype, sized to ``HOROVOD_FUSION_THRESHOLD`` and
allocated once. Each bucket is

    pack+prescale kernel -> one allreduce of the buffer -> unpack+postscale kernel

with Average's ``1/n`` folded into the postscale. The unpack writes each
result straight into its output tensor (``p.grad`` for the optimizer).
An Adasum bucket gathers instead of reducing:

    pack+prescale -> one all-gather into (n, total) ->
    ops.adasum.reduce_gathered (the combine kernel, per tensor) ->
    unpack+postscale from row 0

so it keeps one collective per bucket and still takes each tensor's own
norms, the coefficients the JAX fused path gets by reducing each tensor of
an Adasum bucket on its own (``horovod_tpu/ops/fusion.py:226-233``).

Buckets. Tensors of one key (process set, op, prescale, postscale, dtype)
join that key's open bucket in enqueue order. A bucket closes when the next
tensor (or group) would take it past the threshold, when it reaches the
threshold, or on ``synchronize``/``poll``/``flush_all``; a tensor or group
larger than the threshold forms its own bucket, in a buffer of its own.
Nothing closes a bucket on time, so every rank that enqueues the same
tensors forms the same buckets (the JAX runtime's debounced cycle thread and
its coordinator-published boundaries are not ported yet). The rule is
guarded: the first time a bucket signature (names, sizes, dtype, op, scales)
is seen, ranks exchange its hash once and cache it, like the reference's
response cache, and a mismatch raises ``TensorShapeMismatchError``. While
join is armed (``HOROVOD_JOIN_MODE=1``), every bucket opens with the join
round instead (``collective_ops.join_round``), which carries that hash: a
joined rank mirrors the bucket's collective, Average divides by the active
ranks and an Adasum bucket drops the joined ranks' rows before the tree.

Streams. On the GPU every bucket runs on one side stream, after the streams
that produced its tensors; buckets therefore run in order and share one
buffer, while the backward pass goes on beside them. A handle's
``synchronize`` makes the caller's stream wait for its bucket. On the CPU
(gloo) a bucket is done when it closes.
"""

import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common.exceptions import TensorShapeMismatchError
from horovod_tpu_torch.ops.adasum import reduce_gathered
from horovod_tpu_torch.ops.collective_ops import (ADASUM, ALLREDUCE,
                                                  DIST_OPS, ReduceOp,
                                                  active_rows,
                                                  all_gather_flat,
                                                  join_armed, join_round,
                                                  rank_digests)
from horovod_tpu_torch.ops.kernels.scale_buffers import pack_scale, unpack_scale

_MAX_SIGNATURES = 4096   # runaway-signature guard for the verified cache
_runtime_lock = threading.Lock()


class FusedHandle:
    """Handle for a tensor pending in the fusion queue. Resolves after the
    bucket it lands in is dispatched (reference analog: HandleManager int
    handle + per-entry callback, torch/handle_manager.h)."""

    __slots__ = ("_runtime", "_output", "_event", "_dispatched", "_error",
                 "name")

    def __init__(self, runtime, output, name):
        self._runtime = runtime
        self._output = output
        self._event = None        # the bucket's completion event (GPU)
        self._dispatched = False
        self._error = None
        self.name = name

    def _resolve(self):
        # Asking about a pending tensor closes its bucket, as a cycle tick.
        if not self._dispatched and self._error is None:
            self._runtime.flush_all()
        if self._error is not None:
            raise self._error

    def poll(self):
        self._resolve()
        return self._event is None or self._event.query()

    def synchronize(self):
        self._resolve()
        if self._event is not None:
            torch.cuda.current_stream(self._runtime.device).wait_event(
                self._event)
        return self._output

    wait = synchronize


class _Entry:
    __slots__ = ("tensor", "output", "name", "handle", "stream")

    def __init__(self, tensor, output, name, handle, stream):
        self.tensor = tensor
        self.output = output
        self.name = name
        self.handle = handle
        self.stream = stream


class FusionRuntime:
    def __init__(self, threshold, device):
        self.threshold = int(threshold)
        self.device = device
        self._lock = threading.RLock()
        self._open = {}          # bucket key -> [entries], first-enqueue order
        self._open_bytes = {}
        self._buffers = {}       # dtype -> persistent fusion buffer
        self._verified = {}      # bucket signature -> hash all ranks agreed on
        self._stream = torch.cuda.Stream(device) \
            if device.type == "cuda" else None

    def enqueue(self, tensors, outputs, op, prescale, postscale, process_set,
                names):
        """Queue one unit — a tensor, or a group that shares a bucket — of
        one dtype; returns a handle per tensor."""
        key = (process_set, ReduceOp(op), prescale, postscale,
               tensors[0].dtype)
        stream = None if self._stream is None \
            else torch.cuda.current_stream(self.device)
        nbytes = sum(t.numel() * t.element_size() for t in tensors)
        with self._lock:
            entries = [_Entry(t, out, name, FusedHandle(self, out, name),
                              stream)
                       for t, out, name in zip(tensors, outputs, names)]
            if self._open.get(key) and \
                    self._open_bytes[key] + nbytes > self.threshold:
                self._close(key)
            self._open.setdefault(key, []).extend(entries)
            self._open_bytes[key] = self._open_bytes.get(key, 0) + nbytes
            if self._open_bytes[key] >= self.threshold:
                self._close(key)
        return [e.handle for e in entries]

    def flush_all(self):
        with self._lock:
            for key in list(self._open):
                self._close(key)

    def shutdown(self):
        self.flush_all()
        if self._stream is not None:
            self._stream.synchronize()
        self._buffers.clear()

    def verified_signatures(self):
        """The bucket signatures all ranks have agreed on, oldest first:
        (process set id, op, prescale, postscale, dtype, ((name, numel),
        ...))."""
        with self._lock:
            return list(self._verified)

    def _close(self, key):
        entries = self._open.pop(key)
        del self._open_bytes[key]
        ps, op, prescale, postscale, dtype = key
        try:
            joined = self._check_signature(key, entries)
            event = None
            if self._stream is None:
                self._reduce(entries, ps, op, prescale, postscale, dtype,
                             joined)
            else:
                side = self._stream
                for s in {e.stream.cuda_stream: e.stream
                          for e in entries}.values():
                    side.wait_stream(s)
                with torch.cuda.stream(side):
                    self._reduce(entries, ps, op, prescale, postscale, dtype,
                                 joined)
                    event = torch.cuda.Event()
                    event.record(side)
                # The caching allocator must not hand these blocks out again
                # before the side stream is done with them.
                for e in entries:
                    e.tensor.record_stream(side)
                    e.output.record_stream(side)
        except BaseException as exc:
            for e in entries:
                e.handle._error = exc
            raise
        for e in entries:
            e.handle._event = event
            e.handle._dispatched = True

    def _reduce(self, entries, ps, op, prescale, postscale, dtype, joined):
        total = sum(e.tensor.numel() for e in entries)
        buf = self._buffer(dtype, total)
        pack_scale([e.tensor for e in entries], buf, prescale)
        if op == ReduceOp.ADASUM:
            # Gather every rank's bucket and run the combine tree on it, per
            # tensor; the result is row 0. Adasum is no average: no 1/n.
            gathered = torch.empty(ps.size() * total, dtype=dtype,
                                   device=self.device)
            all_gather_flat(gathered, buf, group=ps.group,
                            async_op=True).wait()
            buf = reduce_gathered(
                active_rows(gathered.view(ps.size(), total), ps, joined),
                [e.tensor.numel() for e in entries])
        else:
            dist.all_reduce(buf, op=DIST_OPS[op], group=ps.group,
                            async_op=True).wait()
            if op == ReduceOp.AVERAGE:
                postscale = postscale / (ps.size() - len(joined))
        unpack_scale(buf, [e.output for e in entries], postscale)

    def _buffer(self, dtype, total):
        itemsize = torch.empty((), dtype=dtype).element_size()
        if total * itemsize > self.threshold:
            # A bucket above the threshold: one big tensor, or a group.
            return torch.empty(total, dtype=dtype, device=self.device)
        buf = self._buffers.get(dtype)
        if buf is None or buf.numel() < total:   # first use, or a raised
            buf = self._buffers[dtype] = torch.empty(   # threshold
                self.threshold // itemsize, dtype=dtype, device=self.device)
        return buf[:total]

    def _check_signature(self, key, entries):
        """The bucket's check that every rank formed it; returns the joined
        ranks of its set."""
        ps, op, prescale, postscale, dtype = key
        sig = (ps.process_set_id, int(op), prescale, postscale, str(dtype),
               tuple((e.name, e.tensor.numel()) for e in entries))
        if join_armed():
            return join_round(ps, ADASUM if op == ReduceOp.ADASUM
                              else ALLREDUCE, op, dtype,
                              sum(n for _, n in sig[-1]), sig=sig)
        if sig in self._verified:
            return frozenset()
        mine, every = rank_digests(sig, ps)
        if any(h != mine for h in every):
            raise TensorShapeMismatchError(
                f"ranks formed different fusion buckets for {len(entries)} "
                f"tensor(s) of {dtype} (op {op.name}); this rank's bucket: "
                f"{sig[-1][:4]}{'...' if len(sig[-1]) > 4 else ''}; bucket "
                f"hashes by rank: {every}. Every rank must enqueue the same "
                "tensors in the same order.")
        if len(self._verified) >= _MAX_SIGNATURES:
            self._verified.clear()
        self._verified[sig] = mine
        return frozenset()


def get_runtime():
    st = basics._get_state()
    with _runtime_lock:
        if st.fusion is None:
            st.fusion = FusionRuntime(st.config.fusion_threshold, st.device)
        return st.fusion
