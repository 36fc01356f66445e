"""Helpers for the PyTorch port's CPU tests.

``run_world(fn, size, args)`` starts ``size`` processes with the ``spawn``
method, gives each the launcher's env contract (HOROVOD_RANK/SIZE/...,
HOROVOD_COORDINATOR_ADDR/PORT) and no other HOROVOD_* variable of the
parent's, calls ``hvd.init(device="cpu")`` and returns
``[fn(rank, size, *args) for each rank]``; ``run_world_async`` does the
same on a thread and returns a future. The scenarios below run in those
processes: this module imports torch and the port only, never JAX, so a
child starts in about a second. The elastic scenarios (``elastic_*``) are
the functions ``runner.run_elastic`` ships to its workers.
"""

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback

import numpy as np
import torch


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, size, port, args, env, results):
    # A HOROVOD_* variable an earlier test left in the parent (an elastic
    # or join switch) must not reach the world: only its own contract.
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        del os.environ[k]
    os.environ.update(env)
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": str(size),
        "HOROVOD_CROSS_RANK": "0", "HOROVOD_CROSS_SIZE": "1",
        "HOROVOD_COORDINATOR_ADDR": "127.0.0.1",
        "HOROVOD_COORDINATOR_PORT": str(port)})
    torch.set_num_threads(2)
    try:
        import horovod_tpu_torch as hvd
        hvd.init(device="cpu")
        try:
            out = fn(rank, size, *args)
        finally:
            hvd.shutdown()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, size=2, args=(), env=None, timeout=120.0, ranks=None):
    """``ranks``: the ranks that report (default all); the others may leave
    without a result, as a rank that dies in a failure scenario does."""
    ranks = list(range(size)) if ranks is None else list(ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, size, port, args, env or {},
                               results))
             for rank in range(size)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < len(ranks):
            try:
                rank, ok, payload = results.get(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"gloo world of {size} did not finish in "
                                   f"{timeout:.0f} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            got[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [got[r] for r in ranks]


def run_world_async(fn, size=2, args=(), env=None, timeout=120.0):
    """:func:`run_world` on a thread: returns a ``Future`` of its result, so
    the caller can compute its JAX reference while the world runs."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_world, fn, size, args, env, timeout)
    pool.shutdown(wait=False)
    return future


def to_np(t):
    return t.detach().float().numpy()


def flax_as_torch_named(template, params, batch_stats):
    """A Flax (params, batch_stats) pair of numpy trees, laid out and named
    as ``template``'s ``state_dict()`` (OIHW kernels, running stats), by
    loading it into a copy of the module."""
    import copy

    from horovod_tpu_torch.models import load_flax_variables
    m = load_flax_variables(copy.deepcopy(template),
                            {"params": params, "batch_stats": batch_stats})
    return {k: to_np(v) for k, v in m.state_dict().items()}


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


# ---------------------------------------------------------------------------
# Collectives scenario: every case of test_torch_collectives in one world.
# ---------------------------------------------------------------------------

def collectives(rank, size, rows, cases, sizes):
    """``rows[dtype]``: (size, ...) fp32 inputs, this rank's row is its
    tensor. ``cases``: (op name, dtype, prescale, postscale). ``sizes``:
    element counts of the fused-vs-unfused and threshold-split tensors."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    out = {}
    ps = hvd.add_process_set(hvd.ProcessSet([0, 1]))
    for op, dt, pre, post in cases:
        x = torch.from_numpy(rows[dt][rank]).to(_DTYPES[dt])
        y = hvd.allreduce(x, op=getattr(hvd, op), prescale_factor=pre,
                          postscale_factor=post, process_set=ps)
        out[("allreduce", op, dt, pre, post)] = to_np(y)

    gen = np.random.default_rng(100 + rank)
    ts = [torch.from_numpy(gen.standard_normal(n).astype(np.float32))
          for n in sizes]
    out["grouped"] = [to_np(t) for t in hvd.grouped_allreduce(ts, op=hvd.Sum)]
    out["unfused"] = [to_np(hvd.allreduce(t, op=hvd.Sum)) for t in ts]
    out["inputs"] = [to_np(t) for t in ts]

    # In place, async, poll, compression.
    a = ts[0].clone()
    h = hvd.allreduce_async_(a, op=hvd.Sum, name="inplace")
    out["poll_type"] = type(hvd.poll(h)).__name__
    out["inplace_is_a"] = hvd.synchronize(h) is a
    out["inplace"] = to_np(a)
    g = [t.clone() for t in ts[:2]]
    hvd.grouped_allreduce_(g, op=hvd.Sum)
    out["grouped_inplace"] = [to_np(t) for t in g]
    c = hvd.allreduce(ts[1], op=hvd.Sum, compression=hvd.Compression.fp16)
    out["fp16_dtype"] = str(c.dtype)
    out["fp16"] = to_np(c)
    out["int_sum"] = hvd.allreduce(torch.tensor([rank + 1, 10]),
                                   op=hvd.Sum).tolist()

    # Broadcast family.
    b = torch.from_numpy(rows["float32"][rank])
    out["broadcast"] = to_np(hvd.broadcast(b, root_rank=1, process_set=ps))
    bb = b.clone()
    hvd.broadcast_async_(bb, root_rank=1).synchronize()
    out["broadcast_"] = to_np(bb)
    out["object"] = hvd.broadcast_object({"from": rank, "x": [rank] * 3},
                                         root_rank=1)
    hvd.barrier()

    # Threshold splits at a 100-byte threshold, with the cycle timer
    # paused so that only the threshold and synchronize close buckets.
    rt = get_runtime()
    rt.threshold = 100
    seen = len(rt.verified_signatures())
    with rt.cycle_paused():
        hs = [hvd.allreduce_async(torch.ones(n) * (rank + 1), op=hvd.Sum,
                                  name=f"split{i}")
              for i, n in enumerate((10, 10, 10, 30, 5))]
        hs += hvd.grouped_allreduce_async(
            [torch.ones(30) * (rank + 1), torch.ones(30) * (rank + 1)],
            op=hvd.Sum, name="group")
    out["split_values"] = [to_np(h.synchronize()) for h in hs]
    out["buckets"] = [[n for _, n in sig[-1]]
                      for sig in rt.verified_signatures()[seen:]]

    # Mismatched buckets: rank 1's second tensor is one element longer.
    try:
        hvd.grouped_allreduce([torch.ones(10), torch.ones(20 + rank)],
                              op=hvd.Sum, name="mismatch")
        out["mismatch"] = None
    except Exception as e:  # noqa: BLE001 — the error's type is the result
        out["mismatch"] = type(e).__name__
    hvd.remove_process_set(ps)
    return out


# ---------------------------------------------------------------------------
# Adasum scenario: every case of test_torch_adasum_collectives in one world.
# ---------------------------------------------------------------------------

def adasum_collectives(rank, size, rows, cases, group_sizes):
    """``rows``: (size, ...) fp32 inputs, this rank's row is its tensor.
    ``cases``: (dtype, prescale, postscale) of single allreduces.
    ``group_sizes``: element counts of a grouped allreduce."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    out = {}
    for dt, pre, post in cases:
        x = torch.from_numpy(rows[rank]).to(_DTYPES[dt])
        y = hvd.allreduce(x, op=hvd.Adasum, prescale_factor=pre,
                          postscale_factor=post)
        out[("allreduce", dt, pre, post)] = (str(y.dtype),
                                             y.double().numpy())

    gen = np.random.default_rng(200 + rank)
    ts = [torch.from_numpy(gen.standard_normal(n).astype(np.float32))
          for n in group_sizes]
    out["group_inputs"] = [to_np(t) for t in ts]
    rt = get_runtime()
    seen = len(rt.verified_signatures())
    out["grouped"] = [to_np(t) for t in hvd.grouped_allreduce(
        ts, op=hvd.Adasum, name="adasum_group")]
    out["group_buckets"] = [[n for _, n in sig[-1]]
                            for sig in rt.verified_signatures()[seen:]]
    c = hvd.allreduce(ts[-1], op=hvd.Adasum, compression=hvd.Compression.fp16)
    out["fp16_wire"] = (str(c.dtype), to_np(c))
    try:
        hvd.allreduce(torch.tensor([rank, 2]), op=hvd.Adasum)
        out["int"] = None
    except TypeError as e:
        out["int"] = f"TypeError: {e}"

    x = torch.from_numpy(rows[rank])
    out["allgather"] = to_np(hvd.allgather(x))
    out["allgather_async"] = to_np(hvd.allgather_async(x[0]).synchronize())
    out["allgather_int"] = hvd.allgather(
        torch.tensor([[rank, 10 * rank]])).tolist()
    out["allgather_scalar"] = hvd.allgather(torch.tensor(rank + 0.5)).tolist()
    out["grouped_allgather"] = [to_np(t) for t in hvd.grouped_allgather(
        [x, x[:, :1]])]
    out["ragged"] = hvd.allgather(torch.ones(rank + 1) * rank).tolist()
    out["ragged_tail"] = _error_name(
        lambda: hvd.allgather(torch.ones(2, rank + 1)))
    return out


# ---------------------------------------------------------------------------
# Data-parallel slice: 3 steps of ResNet training through the optimizer.
# ---------------------------------------------------------------------------

def dp_resnet(rank, size, variables, x, y, steps, lr, op="Average"):
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet, load_flax_variables
    from horovod_tpu_torch.models.resnet import BottleneckResNetBlock

    model = ResNet([1, 1, 1, 1], BottleneckResNetBlock, num_classes=10,
                   num_filters=8, dtype=torch.float32)
    if rank == 0:
        load_flax_variables(model, variables)   # other ranks get it below
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   op=getattr(hvd, op))
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    shard = x.shape[0] // size
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
    ys = torch.from_numpy(y[rank * shard:(rank + 1) * shard]).long()
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(model(xs), ys)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return {"losses": losses,
            "state": {k: to_np(v) for k, v in model.state_dict().items()},
            "momentum": {n: to_np(opt.state[p]["momentum_buffer"])
                         for n, p in model.named_parameters()}}


# ---------------------------------------------------------------------------
# Data-parallel slice: GPT tiny trained with AdamW through the optimizer.
# ---------------------------------------------------------------------------

def dp_gpt(rank, size, params, config_kw, ids, steps, lr, weight_decay):
    """Rank 0 loads the Flax weights, the others get them by broadcast; each
    rank trains on its rows of ``ids`` with the next-token loss. Returns the
    losses, the step-1 reduced gradients, the final parameters and both Adam
    moments, by parameter name."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT, GPTConfig, load_flax_gpt

    model = GPT(GPTConfig.tiny(**config_kw))
    if rank == 0:
        load_flax_gpt(model, params)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    shard = ids.shape[0] // size
    x = torch.from_numpy(ids[rank * shard:(rank + 1) * shard]).long()
    losses, first_grads = [], None
    for _ in range(steps):
        opt.zero_grad()
        logits = model(x)
        loss = F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                               x[:, 1:].flatten())
        loss.backward()
        opt.synchronize()
        if first_grads is None:
            first_grads = {n: to_np(p.grad)
                           for n, p in model.named_parameters()}
        opt.step()
        losses.append(loss.item())
    named = dict(model.named_parameters())
    return {"losses": losses, "grads": first_grads,
            "params": {n: to_np(p) for n, p in named.items()},
            "mu": {n: to_np(opt.state[p]["exp_avg"])
                   for n, p in named.items()},
            "nu": {n: to_np(opt.state[p]["exp_avg_sq"])
                   for n, p in named.items()}}


# ---------------------------------------------------------------------------
# Data-parallel slice: the MNIST-scale MLP trained with SGD.
# ---------------------------------------------------------------------------

def dp_mlp(rank, size, params, x, y, steps, lr):
    """Rank 0 loads the Flax weights, the others get them by broadcast; each
    rank trains on its rows of ``x``/``y`` with SGD(lr, momentum=0.9) in
    ``hvd.DistributedOptimizer``. Returns the losses, the parameters and the
    momentum, by parameter name."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MLP, load_flax_mlp

    model = MLP()
    if rank == 0:
        load_flax_mlp(model, params)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    shard = x.shape[0] // size
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
    ys = torch.from_numpy(y[rank * shard:(rank + 1) * shard]).long()
    losses = []
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(model(xs), ys)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    named = dict(model.named_parameters())
    return {"losses": losses,
            "params": {n: to_np(p) for n, p in named.items()},
            "momentum": {n: to_np(opt.state[p]["momentum_buffer"])
                         for n, p in named.items()}}


# ---------------------------------------------------------------------------
# The rest of the collective surface: every case of
# test_torch_collectives_surface in one world.
# ---------------------------------------------------------------------------

def _error_name(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error's type is the result
        return type(e).__name__
    return None


def collectives_surface(rank, size, data, rs_cases):
    """``data[key]``: per-rank numpy inputs (this rank's is ``[rank]``).
    ``rs_cases``: (op name, dtype, prescale, postscale) of reducescatter.
    Returns the port's outputs by case, as numpy, and the refusals' error
    names."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective_ops as C

    def mine(key):
        return torch.from_numpy(data[key][rank])

    out = {}
    for key in ("ragged", "ragged_int", "ragged_empty"):
        out[key] = hvd.allgather(mine(key)).numpy()
    out["ragged_bf16"] = to_np(hvd.allgather(mine("ragged").bfloat16()))
    out["ragged_async"] = [h.synchronize().numpy()
                           for h in hvd.grouped_allgather_async(
                               [mine("ragged"), mine("ragged_int")])]

    out["a2a"] = hvd.alltoall(mine("a2a")).numpy()
    rows, received = hvd.alltoall(mine("a2a_rows"),
                                  splits=data["splits"][rank])
    out["a2a_splits"] = (rows.numpy(), received.tolist(), str(received.dtype))
    rows, received = hvd.alltoall_async(
        mine("a2a_rows").bfloat16(),
        splits=torch.from_numpy(data["splits"][rank])).synchronize()
    out["a2a_splits_bf16"] = (to_np(rows), received.tolist())

    for case in rs_cases:
        op, dt, pre, post = case
        y = hvd.reducescatter(mine("rs").to(_DTYPES[dt]), op=getattr(hvd, op),
                              prescale_factor=pre, postscale_factor=post)
        out[("rs",) + case] = (str(y.dtype), y.double().numpy())
    calls = {"pack": 0, "unpack": 0}
    raw = C.pack_scale, C.unpack_scale

    def counted(kind, fn):
        def call(*a, **kw):
            calls[kind] += 1
            return fn(*a, **kw)
        return call
    C.pack_scale, C.unpack_scale = (counted("pack", raw[0]),
                                    counted("unpack", raw[1]))
    try:
        group = [mine(k) for k in ("rs", "rs_b", "rs_c")]
        hs = hvd.grouped_reducescatter_async(group, op=hvd.Average,
                                             prescale_factor=0.5,
                                             postscale_factor=3.0)
        out["rs_group"] = [h.synchronize().numpy() for h in hs]
        out["rs_group_launches"] = dict(calls)
    finally:
        C.pack_scale, C.unpack_scale = raw
    out["rs_f64"] = hvd.reducescatter(mine("rs").double(), op=hvd.Average,
                                      postscale_factor=3.0).numpy()
    out["rs_int"] = hvd.reducescatter(mine("rs_int")).numpy()

    out["objects"] = hvd.allgather_object({"rank": rank, "x": [rank] * rank})
    sp = mine("dense").to_sparse_coo()
    h = hvd.sparse_allreduce_async(sp, name="sp", op=hvd.Average)
    got = hvd.synchronize(h)
    out["sparse_callable"] = h() is got
    out["sparse"] = (got.is_sparse, got.coalesce().to_dense().numpy())
    out["sparse_sum"] = hvd.sparse_allreduce_async(
        sp, name="sp", op=hvd.Sum)().coalesce().to_dense().numpy()

    out["errors"] = {
        "rs_not_divisible": _error_name(
            lambda: hvd.reducescatter(torch.ones(size + 1))),
        "rs_min": _error_name(
            lambda: hvd.reducescatter(torch.ones(size), op=hvd.Min)),
        "rs_shapes": _error_name(
            lambda: hvd.reducescatter(torch.ones(size, 1 + rank))),
        "allgather_tail": _error_name(
            lambda: hvd.allgather(torch.ones(2, 2 + rank))),
        "allgather_dtype": _error_name(
            lambda: hvd.allgather(torch.ones(2, dtype=torch.float64
                                             if rank else torch.float32))),
        "a2a_splits_length": _error_name(
            lambda: hvd.alltoall(torch.ones(size), splits=[1] * (size - 1))),
        "a2a_splits_sum": _error_name(
            lambda: hvd.alltoall(torch.ones(size), splits=[2] * size)),
        "a2a_not_divisible": _error_name(
            lambda: hvd.alltoall(torch.ones(size + 1))),
        "a2a_tail": _error_name(
            lambda: hvd.alltoall(torch.ones(size, 1 + rank)))}
    out["ici_built"] = hvd.ici_built()
    # The refusals left the ranks in step: a collective still lines up.
    out["after"] = hvd.allreduce(torch.ones(2) * rank, op=hvd.Sum).tolist()
    return out


# ---------------------------------------------------------------------------
# Join: every case of test_torch_join in one armed world.
# ---------------------------------------------------------------------------

def join_world(rank, size, data):
    """HOROVOD_JOIN_MODE=1, 3 ranks: rank 2 joins at once (its data ran
    out), ranks 0 and 1 run the contract's collectives without it, rank 1
    joins, rank 0 runs one more and joins last. Then, with the join reset,
    a collective of all three, and a join within process set [1, 2]."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import collective_ops as C

    def mine(key):
        return torch.from_numpy(data[key][rank])

    pair = hvd.add_process_set([1, 2])
    out = {"armed": C.join_armed()}
    if rank == 2:
        out["join"] = hvd.join()
    else:
        x = mine("x")
        for op in ("Sum", "Average", "Min", "Max", "Product"):
            out[("fused", op)] = hvd.allreduce(x, op=getattr(hvd, op),
                                               postscale_factor=2.0).numpy()
            out[("unfused", op)] = hvd.allreduce(
                x.double(), op=getattr(hvd, op)).numpy()
        out["int_min"] = hvd.allreduce(mine("ints"), op=hvd.Min).tolist()
        out["int_max"] = hvd.allreduce(mine("ints"), op=hvd.Max).tolist()
        out["grouped"] = [t.numpy() for t in hvd.grouped_allreduce(
            [x, x[:3] * 2], op=hvd.Average)]
        out["adasum"] = hvd.allreduce(x, op=hvd.Adasum).numpy()
        out["adasum_f64"] = hvd.allreduce(x.double(), op=hvd.Adasum).numpy()
        out["allgather"] = hvd.allgather(x).numpy()
        out["ragged"] = hvd.allgather(mine("ragged")).numpy()
        out["rs"] = hvd.reducescatter(mine("rs"), op=hvd.Average).numpy()
        out["broadcast"] = hvd.broadcast(x, root_rank=1).numpy()
        out["objects"] = hvd.allgather_object(rank)
        hvd.barrier()
        out["errors"] = {
            "broadcast_joined_root": _error_name(
                lambda: hvd.broadcast(x, root_rank=2)),
            "alltoall": _error_name(lambda: hvd.alltoall(x[:3]))}
        if rank == 1:
            out["errors"]["set_with_joined_rank"] = _error_name(
                lambda: hvd.allreduce(x, process_set=pair))
            out["join"] = hvd.join()
        else:
            out["alone"] = hvd.allreduce(x, op=hvd.Average).numpy()
            out["join"] = hvd.join()
    out["after"] = hvd.allreduce(mine("x"), op=hvd.Sum).numpy()
    if rank == 1:
        out["set_join"] = hvd.join(process_set=pair)
    elif rank == 2:
        out["set_sum"] = hvd.allreduce(mine("x"), op=hvd.Sum,
                                       process_set=pair).numpy()
        out["set_join"] = hvd.join(process_set=pair)
    out["end"] = hvd.allreduce(mine("x"), op=hvd.Sum).numpy()
    return out


def join_unarmed(rank, size):
    """Without HOROVOD_JOIN_MODE, join() in a world of two processes
    raises on each, and the world goes on."""
    import horovod_tpu_torch as hvd
    return {"error": _error_name(hvd.join),
            "after": hvd.allreduce(torch.ones(1) * (rank + 1),
                                   op=hvd.Sum).tolist()}


# ---------------------------------------------------------------------------
# Fusion cycle scenarios: test_torch_fusion_cycle's worlds.
# ---------------------------------------------------------------------------

def _record_closes(rt):
    """Wrap ``rt._close`` to log every bucket as it closes: (trigger, op,
    dtype, element counts)."""
    closed = []
    raw = rt._close

    def close(key, entries, why):
        closed.append((why, key[1].name, str(key[4]).replace("torch.", ""),
                       [e.tensor.numel() for e in entries]))
        return raw(key, entries, why)
    rt._close = close
    return closed


def fusion_stream(rank, size, stream, threshold, seed):
    """Enqueue ``stream`` (items ("one", op, dtype, n), ("group", op, dtype,
    [n, ...]) or ("flush",)) through the async allreduces at ``threshold``
    bytes; returns the buckets as they closed, how many had closed after
    each item, and the inputs and results."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    rt.threshold = threshold
    closed = _record_closes(rt)
    gen = np.random.default_rng(seed + rank)
    handles, inputs, after = [], [], []
    for item in stream:
        if item[0] == "flush":
            rt.flush_all()
        else:
            kind, op, dt, n = item
            ts = [torch.from_numpy(gen.standard_normal(k).astype(np.float32))
                  .to(_DTYPES[dt]) for k in (n if kind == "group" else [n])]
            inputs += [to_np(t) for t in ts]
            if kind == "group":
                handles += hvd.grouped_allreduce_async(ts,
                                                       op=getattr(hvd, op))
            else:
                handles.append(hvd.allreduce_async(ts[0],
                                                   op=getattr(hvd, op)))
        after.append(len(closed))
    return {"closed": closed, "after": after, "inputs": inputs,
            "outputs": [to_np(h.synchronize()) for h in handles],
            "stats": rt.flush_stats()}


def cycle_world(rank, size, rows, stream, delays):
    """The cycle thread and the boundaries in a world of ``size`` ranks:
    a tensor the timer alone must flush; ``stream`` ((op, dtype) per item,
    this rank's tensor ``rows[i][rank]``) enqueued with each rank sleeping
    ``delays[rank][i]`` seconds before each item; async allreduces fenced by an
    eager one; a follower's synchronize on a tensor rank 0 never enqueues;
    then shutdown, and the threads left."""
    import threading

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    out = {"threads": sorted(t.name for t in rt.threads())}

    h = hvd.allreduce_async(torch.ones(2) * (rank + 1), op=hvd.Sum,
                            name="tick")
    deadline = time.monotonic() + 10.0
    while not h._inner._dispatched and time.monotonic() < deadline:
        time.sleep(0.01)
    out["tick_flushed_by_timer"] = h._inner._dispatched
    out["tick"] = to_np(h.synchronize())

    seen, before = len(rt.verified_signatures()), rt.flush_stats()
    handles = []
    for i, (op, dt) in enumerate(stream):
        time.sleep(delays[rank][i])
        x = torch.from_numpy(rows[i][rank]).to(_DTYPES[dt])
        handles.append(hvd.allreduce_async(x, op=getattr(hvd, op),
                                           name=f"jitter{i}"))
    out["jitter"] = [to_np(h.synchronize()) for h in handles]
    out["signatures"] = [(sig[1], sig[4], [n for _, n in sig[-1]])
                         for sig in rt.verified_signatures()[seen:]]
    after = rt.flush_stats()
    out["closed_by"] = {k: after["closed_by"][k] - before["closed_by"][k]
                        for k in after["closed_by"]}

    hs = [hvd.allreduce_async(torch.ones(k) * (rank + 1), op=hvd.Sum,
                              name=f"fence{k}") for k in (3, 5)]
    out["eager"] = hvd.allreduce(
        torch.ones(2, dtype=torch.float64) * (rank + 1), op=hvd.Sum).tolist()
    out["fenced_before_eager"] = [h._inner._dispatched for h in hs]
    out["fenced"] = [to_np(h.synchronize()) for h in hs]

    if rank != 0:
        rt.BOUNDARY_TIMEOUT_S = 2.0
        h = hvd.allreduce_async(torch.ones(1), name="orphan")
        t0 = time.monotonic()
        try:
            h.synchronize()
            out["orphan"] = None
        except Exception as e:  # noqa: BLE001 — the error is the result
            out["orphan"] = (type(e).__name__, str(e))
        out["orphan_seconds"] = time.monotonic() - t0

    threads = rt.threads()
    hvd.shutdown()
    out["alive_after_shutdown"] = [t.name for t in threads if t.is_alive()]
    out["fusion_threads_left"] = [t.name for t in threading.enumerate()
                                  if t.name.startswith("hvd-fusion")]
    return out


# ---------------------------------------------------------------------------
# Elastic: test_torch_elastic's worlds and the functions run_elastic ships.
# ---------------------------------------------------------------------------

def torch_state_sync(rank, size, seed):
    """Every rank builds a different model, optimizer state and attributes;
    after ``TorchState.sync`` each holds rank 0's."""
    import horovod_tpu_torch as hvd
    torch.manual_seed(seed + rank)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.randn(5, 3)).square().sum().backward()
    opt.step()
    state = hvd.TorchState(model, opt, epoch=rank + 3, note=f"rank{rank}")
    before = {k: to_np(v).copy() for k, v in model.state_dict().items()}
    state.sync()
    return {"before": before,
            "after": {k: to_np(v) for k, v in model.state_dict().items()},
            "momentum": [to_np(opt.state[p]["momentum_buffer"])
                         for p in model.parameters()],
            "attrs": (state.epoch, state.note)}


def peer_dies(rank, size, victim):
    """``victim`` exits after one allreduce. The survivor reports its
    pending async allreduce's and an eager allreduce's errors (type, the
    type of ``__cause__``, seconds to raise), with the cycle timer paused
    so that the async one stays pending until its synchronize."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime
    hvd.allreduce(torch.ones(3), op=hvd.Sum)
    rt = get_runtime()
    if rank == victim:
        os._exit(0)
    out = {"boundary_timeout_s": rt.BOUNDARY_TIMEOUT_S}

    def failure(fn):
        t0 = time.monotonic()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 — the error is the result
            return (type(e).__name__, type(e.__cause__).__name__,
                    time.monotonic() - t0)
        return None

    with rt.cycle_paused():
        h = hvd.allreduce_async(torch.ones(5) * (rank + 1), op=hvd.Sum)
        if rank == 0:
            time.sleep(1.0)     # the victim has gone
        out["pending"] = failure(h.synchronize)
    out["eager"] = failure(lambda: hvd.allreduce(torch.ones(3), op=hvd.Sum))
    hvd.shutdown(abort=True)
    return out


def elastic_kill(script_path, total_steps):
    """tests/test_elastic_failure.py's first scenario on the port: the rank
    of the second host drops it from discovery and dies at step 3."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import attach_listener

    state = attach_listener(hvd.TorchState(w=torch.zeros(4), step=0,
                                           worlds=[]))

    @hvd.elastic.run
    def loop(state):
        while state.step < total_steps:
            if state.step == 3 and hvd.size() == 2 and hvd.rank() == 1:
                with open(script_path, "w") as f:
                    f.write("#!/bin/sh\necho localhost:1\n")
                os._exit(1)
            contrib = torch.ones(4) * (hvd.rank() + 1)
            state.w = state.w + hvd.allreduce(contrib, op=hvd.Sum)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        return state.step, state.w.tolist(), list(state.worlds), hvd.size()

    return loop(state)


def elastic_remove(script_path, total_steps):
    """The second scenario: a graceful removal at step 3. The survivor
    keeps its process (the pid committed at step 3) and its uncommitted
    attribute."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.elastic.worker import (configured_version,
                                                  wait_for_version_change)

    state = attach_listener(hvd.TorchState(w=torch.zeros(2), step=0, pid0=0,
                                           uncommitted=0, worlds=[]))

    @hvd.elastic.run
    def loop(state):
        while state.step < total_steps:
            if state.step == 3 and hvd.size() == 2 and state.pid0 == 0:
                state.pid0 = os.getpid()
                state.commit()
                state.uncommitted = 7       # not committed
                known = configured_version()
                if hvd.rank() == 1:
                    with open(script_path, "w") as f:
                        f.write("#!/bin/sh\necho localhost:1\n")
                # Both idle at the fence, with no collective in flight:
                # the survivor sees the removal at its next check.
                wait_for_version_change(known, timeout=120)
                state.check_host_updates()
            state.w = state.w + hvd.allreduce(torch.ones(2), op=hvd.Sum)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        return (state.step, state.w.tolist(), list(state.worlds), state.pid0,
                os.getpid(), state.uncommitted, hvd.size())

    return loop(state)


def elastic_add(script_path, total_steps):
    """The third scenario: discovery grows from 1 to 2 hosts at step 3; the
    new worker starts from rank 0's state."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.elastic.worker import (configured_version,
                                                  wait_for_version_change)

    state = attach_listener(hvd.TorchState(w=torch.zeros(2), step=0,
                                           worlds=[]))

    @hvd.elastic.run
    def loop(state):
        while state.step < total_steps:
            if state.step == 3 and hvd.size() == 1:
                known = configured_version()
                with open(script_path, "w") as f:
                    f.write("#!/bin/sh\necho localhost:1\necho 127.0.0.1:1\n")
                grown = wait_for_version_change(known, timeout=120)
                assert grown != known, "no grown membership was published"
            state.w = state.w + hvd.allreduce(torch.ones(2), op=hvd.Sum)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        return (state.step, state.w.tolist(), list(state.worlds), hvd.rank(),
                hvd.size())

    return loop(state)


def watchdog_aborts(rank, size):
    """The membership watchdog in a world of one, armed at version 1 with
    the launcher's KV store served here: a version that only adds slots
    leaves the group running; one that removes a slot aborts it, and the
    next collective raises."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.elastic import worker
    from horovod_tpu_torch.runner.http_kv import KVStoreServer

    kv = KVStoreServer(secret="")
    os.environ.update({"HOROVOD_ELASTIC": "1", "HOROVOD_KV_ADDR": "127.0.0.1",
                       "HOROVOD_KV_PORT": str(kv.start())})

    def publish(version, removed):
        kv.put("elastic", f"removed/{version}", removed)
        kv.put("elastic", "version", str(version).encode())

    def aborted_within(seconds):
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            if basics._get_state().aborted is not None:
                return True
            time.sleep(0.05)
        return False

    publish(1, b"0")
    worker.arm_collective_abort(1)
    out = {"before": hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist()}
    publish(2, b"0")
    out["aborted_by_addition"] = aborted_within(1.5)
    out["after_addition"] = hvd.allreduce(torch.ones(2), op=hvd.Sum).tolist()
    publish(3, b"1")
    out["aborted_by_removal"] = aborted_within(5.0)
    out["after_removal"] = _error_name(
        lambda: hvd.allreduce(torch.ones(2), op=hvd.Sum))
    worker.disarm_collective_abort()
    hvd.shutdown(abort=True)
    kv.stop()
    return out
