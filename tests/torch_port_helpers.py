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

if os.environ.get("PYTEST_XDIST_WORKER"):
    # Under pytest-xdist each worker is a process of its own: one torch
    # thread each, or the workers' intra-op pools (a thread per core each)
    # oversubscribe the cores many times over and a torch op waits on the
    # others' spinning threads (a speculative-decoding test of a tiny GPT:
    # 28 s at the default, 2.7 s at one thread, with the suite running).
    # Set when the modules are collected, before any test runs.
    torch.set_num_threads(1)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, size, port, args, env, results, local_size=None):
    # A HOROVOD_* variable an earlier test left in the parent (an elastic
    # or join switch) must not reach the world: only its own contract.
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        del os.environ[k]
    os.environ.update(env)
    local = local_size or size
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(size),
        "HOROVOD_LOCAL_RANK": str(rank % local),
        "HOROVOD_LOCAL_SIZE": str(local),
        "HOROVOD_CROSS_RANK": str(rank // local),
        "HOROVOD_CROSS_SIZE": str(size // local),
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


def run_world(fn, size=2, args=(), env=None, timeout=120.0, ranks=None,
              local_size=None):
    """``ranks``: the ranks that report (default all); the others may leave
    without a result, as a rank that dies in a failure scenario does.
    ``local_size``: ranks per node, host-major (default: one node)."""
    ranks = list(range(size)) if ranks is None else list(ranks)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, rank, size, port, args, env or {},
                               results, local_size))
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


def run_world_async(fn, size=2, args=(), env=None, timeout=120.0,
                    local_size=None):
    """:func:`run_world` on a thread: returns a ``Future`` of its result, so
    the caller can compute its JAX reference while the world runs."""
    import concurrent.futures
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run_world, fn, size, args, env, timeout, None,
                         local_size)
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

def dp_resnet(rank, size, variables, x, y, steps, lr, op="Average",
              sync_bn=False):
    """``sync_bn``: every BatchNorm synchronized over the world."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet, load_flax_variables
    from horovod_tpu_torch.models.resnet import BottleneckResNetBlock

    model = ResNet([1, 1, 1, 1], BottleneckResNetBlock, num_classes=10,
                   num_filters=8, dtype=torch.float32,
                   sync_batch_norm=hvd.global_process_set if sync_bn
                   else None)
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


def dp_resnet_sync_bn(rank, size, variables, x, y, steps, lr):
    """:func:`dp_resnet` with every BatchNorm synchronized."""
    return dp_resnet(rank, size, variables, x, y, steps, lr, sync_bn=True)


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

    def close(key, entries, why, *wire, **eager):
        closed.append((why, key[1].name, str(key[4]).replace("torch.", ""),
                       [e.tensor.numel() for e in entries]))
        return raw(key, entries, why, *wire, **eager)
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
# The quantized and cast wire: test_torch_wire's worlds.
# ---------------------------------------------------------------------------

def wire_world(rank, size, data):
    """Whatever of these ``data`` holds, in this order:

    - ``exchange``: (case, rows, residual rows or None, wire, average,
      prescale, postscale); ``wire.block_scaled_allreduce`` of this rank's
      row over the world: the output and the new residual;
    - ``fused``: (case, dtype, op, prescale, postscale, rounds), each round
      a list of (size, ...) arrays: one grouped async allreduce of this
      rank's rows per round (one bucket, on the world's
      HOROVOD_WIRE_DTYPE), then the bucket's flush_stats and signature;
    - ``exact``: (case, op, rows): one allreduce each, with the count of
      quantized buckets it added;
    - ``mismatch``: a set of ranks 0 and 1 whose wire rank 0 pins to int8;
      the error type a 4096-element allreduce on it raises;
    - ``shutdown``: the error-feedback keys and the global set's and a
      pinned set's wire before and after hvd.shutdown;

    and after the flush statistics are read:

    - ``late_fused``: as ``fused``;
    - ``twins``: {name: rounds}, same-shaped (size, ...) arrays: each
      name's ``Compression.int8`` one-shot Average alone (the outputs and
      its error-feedback residual, the store emptied before and after), then
      all names' rounds interleaved, and the keys the store then holds; the
      same rounds interleaved with no name, and each round alone on an
      empty store.
    """
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.fusion import get_runtime

    out = {}
    for case, rows, res, w, average, pre, post in data.get("exchange", ()):
        r = None if res is None else torch.from_numpy(res[rank])
        y, new = wire.block_scaled_allreduce(
            torch.from_numpy(rows[rank]), residual=r, wire=w,
            average=average, prescale_factor=pre, postscale_factor=post)
        out[case] = (to_np(y), None if new is None else to_np(new))
    rt = get_runtime()

    def fused(cases):
        for case, dt, op, pre, post, rounds in cases:
            got = []
            for arrays in rounds:
                ts = [torch.from_numpy(a[rank]).to(_DTYPES[dt])
                      for a in arrays]
                before = rt.flush_stats()
                hs = hvd.grouped_allreduce_async(
                    ts, op=getattr(hvd, op), prescale_factor=pre,
                    postscale_factor=post, name=case)
                ys = [to_np(h.synchronize()) for h in hs]
                after = rt.flush_stats()
                got.append({"outs": ys, "quantized": after["quantized"]
                            - before["quantized"],
                            "signature": rt.recent_buckets(1)[0][1][4:6]})
            out[case] = got
    fused(data.get("fused", ()))
    for case, op, rows in data.get("exact", ()):
        before = rt.flush_stats()["quantized"]
        y = hvd.allreduce(torch.from_numpy(rows[rank]), op=getattr(hvd, op),
                          name=case)
        out[case] = (to_np(y), rt.flush_stats()["quantized"] - before)
    if data.get("mismatch"):
        ps = hvd.add_process_set(hvd.ProcessSet([0, 1]))
        if rank in (0, 1):
            if rank == 0:
                hvd.set_wire_dtype("int8", f"set{ps.process_set_id}")
            try:
                hvd.allreduce(torch.ones(4096), op=hvd.Sum, process_set=ps,
                              name="mismatch")
                out["mismatch"] = None
            except Exception as e:  # noqa: BLE001 — the type is the result
                out["mismatch"] = type(e).__name__
        hvd.barrier()
    out["stats"] = rt.flush_stats()
    fused(data.get("late_fused", ()))
    if data.get("twins"):
        out["twins"] = _twins(rank, data["twins"])
    if data.get("shutdown"):
        hvd.set_wire_dtype("fp16", "set9")          # a user pin
        keys = len(wire.ef_keys())
        before = (wire.wire_dtype_for("global"), wire.wire_dtype_for("set9"))
        hvd.shutdown()
        out["ef_keys"] = (keys, len(wire.ef_keys()))
        out["registry"] = (before, (wire.wire_dtype_for("global"),
                                    wire.wire_dtype_for("set9")))
    return out


def _twins(rank, twins):
    """``wire_world``'s ``twins``: one-shot int8 allreduces of same-shaped
    tensors, each name alone and then interleaved."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import wire

    def call(name, x):
        wire.request_wire_once("int8")
        return to_np(hvd.allreduce(torch.from_numpy(x[rank]),
                                   op=hvd.Average, name=name))

    def residual(name):
        kept = [wire.ef_get(k)[1] for k in wire.ef_keys()
                if k[0] == "eager" and k[-1][0] == name]
        return [to_np(r).copy() for r in kept]

    alone = {}
    for name, rounds in twins.items():
        wire.reset_error_feedback()
        outs = [call(name, x) for x in rounds]
        alone[name] = (outs, residual(name))
    wire.reset_error_feedback()
    outs = {name: [] for name in twins}
    for i in range(len(next(iter(twins.values())))):
        for name, rounds in twins.items():
            outs[name].append(call(name, rounds[i]))
    both = {name: (outs[name], residual(name)) for name in twins}
    keys = len(wire.ef_keys())
    # The same rounds unnamed and interleaved, then each round alone on an
    # empty store.
    wire.reset_error_feedback()
    unnamed = {name: [] for name in twins}
    for i in range(len(next(iter(twins.values())))):
        for name, rounds in twins.items():
            unnamed[name].append(call(None, rounds[i]))
    unnamed_keys = len(wire.ef_keys())
    fresh = {}
    for name, rounds in twins.items():
        fresh[name] = []
        for x in rounds:
            wire.reset_error_feedback()
            fresh[name].append(call(name, x))
    wire.reset_error_feedback()
    return {"alone": alone, "both": both, "keys": keys, "unnamed": unnamed,
            "unnamed_keys": unnamed_keys, "fresh": fresh}


def dp_mlp_int8(rank, size, params, x, y, steps, lr):
    """``dp_mlp`` with ``compression=hvd.Compression.int8`` (error feedback
    on, the default): also each step's local gradients (before the
    reduction) and reduced ones, by parameter name."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MLP, load_flax_mlp

    model = MLP()
    if rank == 0:
        load_flax_mlp(model, params)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   compression=hvd.Compression.int8)
    named = dict(model.named_parameters())
    local = {}
    for n, p in named.items():
        p.register_hook(lambda g, n=n: local.__setitem__(n, to_np(g).copy()))
    shard = x.shape[0] // size
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
    ys = torch.from_numpy(y[rank * shard:(rank + 1) * shard]).long()
    losses, grads = [], []
    for _ in range(steps):
        opt.zero_grad()
        loss = F.cross_entropy(model(xs), ys)
        loss.backward()
        opt.synchronize()
        grads.append({"local": dict(local),
                      "reduced": {n: to_np(p.grad).copy()
                                  for n, p in named.items()}})
        opt.step()                    # nothing left in flight to drain
        losses.append(loss.item())
    from horovod_tpu_torch.ops.fusion import get_runtime
    return {"losses": losses, "grads": grads,
            "params": {n: to_np(p) for n, p in named.items()},
            "quantized": get_runtime().flush_stats()["quantized"]}


# ---------------------------------------------------------------------------
# SyncBatchNorm: test_torch_sync_batch_norm's worlds.
# ---------------------------------------------------------------------------

def _bn_pass(module, x, w):
    """One forward and backward of ``sum(module(x) * w)``: the output, the
    input's and the parameters' gradients and the running statistics."""
    x = torch.from_numpy(x).requires_grad_()
    y = module(x)
    (y * torch.from_numpy(w)).sum().backward()
    out = {"y": to_np(y).copy(), "x_grad": to_np(x.grad).copy()}
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        v = t.grad if isinstance(t, torch.nn.Parameter) else t
        out[name] = to_np(v).copy()
    return out


def sync_bn_world(rank, size, data):
    """``data["frontend"]``: (case, per-rank inputs, per-rank loss weights,
    scale, bias): ``hvd.SyncBatchNorm`` (momentum 0.1) on this rank's
    input, one pass. ``data["model"]``: the same for the model-side
    ``ops.sync_batch_norm.SyncBatchNorm`` (momentum 0.9). ``data["cases"]``
    (a world of one): the JAX package's TestTorchSyncBatchNorm cases. Also
    the collectives the module issued."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import sync_batch_norm as sbn

    out = {}
    for case, xs, ws, scale, bias in data.get("frontend", ()):
        m = hvd.SyncBatchNorm(scale.shape[0], momentum=0.1)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        out[case] = _bn_pass(m, xs[rank], ws[rank])
    for case, xs, ws, scale, bias in data.get("model", ()):
        m = sbn.SyncBatchNorm(scale.shape[0], momentum=0.9)
        with torch.no_grad():
            m.weight.copy_(torch.from_numpy(scale))
            m.bias.copy_(torch.from_numpy(bias))
        out[case] = _bn_pass(m, xs[rank], ws[rank])
    if "cases" in data:
        out["cases"] = torch_sync_bn_cases(hvd.SyncBatchNorm, data["cases"])
    out["launches"] = sbn.launches
    return out


def torch_sync_bn_cases(cls, inputs):
    """The cases of the JAX package's TestTorchSyncBatchNorm run through
    ``cls`` on ``inputs`` (numpy arrays by case), each case's observables
    as numpy."""
    out = {}
    torch.manual_seed(0)
    m = cls(4, momentum=0.1)
    m.train()
    y = m(torch.from_numpy(inputs["forward"]))
    out["forward"] = [to_np(y), to_np(m.running_mean), to_np(m.running_var)]
    x = torch.from_numpy(inputs["backward"]).requires_grad_()
    m = cls(3)
    m.train()
    m(x).square().sum().backward()
    out["backward"] = [to_np(x.grad), to_np(m.weight.grad),
                       to_np(m.bias.grad)]
    m = cls(2)
    m.train()
    m(torch.from_numpy(inputs["eval"]))
    m.eval()
    out["eval"] = [to_np(m(torch.from_numpy(inputs["eval"]))),
                   np.array([int(m.num_batches_tracked)])]
    try:
        cls(2)(torch.ones(3))
        out["rejects_1d"] = None
    except ValueError as e:
        out["rejects_1d"] = str(e)
    m = cls(3, momentum=None)
    m.train()
    for a in inputs["cumulative"]:
        m(torch.from_numpy(a))
    out["cumulative"] = [to_np(m.running_mean), to_np(m.running_var)]
    m = cls(2, track_running_stats=False)
    m.eval()
    out["no_running_stats"] = [to_np(m(torch.from_numpy(
        inputs["no_running_stats"])))]
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


def fresh_optimizer_sync(rank, size, seed):
    """Rank 0 has taken three local steps with its optimizer; rank 1 joins
    with different weights and a fresh optimizer, first SGD with momentum,
    then AdamW. Each rank wraps its optimizer in hvd.DistributedOptimizer,
    runs ``TorchState.sync`` and then one step on the same batch. Then
    ``powersgd``: both ranks take two steps of AdamW under
    ``Compression.powersgd(2)`` on their own batches (each keeps its own
    residual), then rank 1 starts a fresh optimizer and the sync carries
    rank 0's PowerSGD state (Q and residual) with AdamW's. Returns, per
    optimizer, the parameters and optimizer state after the sync and after
    the step."""
    import horovod_tpu_torch as hvd

    def snapshot(model, opt):
        st = opt.state_dict()["state"]
        return {"params": {k: to_np(v).copy()
                           for k, v in model.state_dict().items()},
                "state": {(pid, k): (to_np(v).copy(), str(v.dtype),
                                     v.device.type)
                          for pid, s in st.items() for k, v in s.items()}}

    out = {}
    for kind in ("sgd", "adamw"):
        torch.manual_seed(seed + rank)
        model = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.Tanh(),
                                    torch.nn.Linear(5, 3))
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9) \
            if kind == "sgd" else torch.optim.AdamW(
                model.parameters(), lr=0.01, weight_decay=0.1)
        if rank == 0:
            for _ in range(3):
                opt.zero_grad()
                model(torch.randn(4, 6)).square().sum().backward()
                opt.step()
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        state = hvd.TorchState(model, opt, step=0)
        state.sync()
        synced = snapshot(model, opt)
        gen = torch.Generator().manual_seed(seed)
        opt.zero_grad()
        model(torch.randn(4, 6, generator=gen)).square().sum().backward()
        opt.step()
        out[kind] = {"synced": synced, "stepped": snapshot(model, opt)}
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(6, 24), torch.nn.Tanh(),
                                torch.nn.Linear(24, 20))

    def powersgd_opt():
        return hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=0.01),
            named_parameters=model.named_parameters(),
            compression=hvd.Compression.powersgd(2))

    opt = powersgd_opt()
    torch.manual_seed(seed + rank)
    for _ in range(2):
        opt.zero_grad()
        model(torch.randn(4, 6)).square().sum().backward()
        opt.step()
    if rank == 1:
        opt._remove_hooks()
        opt = powersgd_opt()
    state = hvd.TorchState(model, opt, step=0)
    state.sync()
    synced = snapshot(model, opt)
    gen = torch.Generator().manual_seed(seed)
    opt.zero_grad()
    model(torch.randn(4, 6, generator=gen)).square().sum().backward()
    opt.step()
    out["powersgd"] = {"synced": synced, "stepped": snapshot(model, opt)}
    return out


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


# ---------------------------------------------------------------------------
# Hierarchical tiers: test_torch_hierarchy's worlds.
# ---------------------------------------------------------------------------

def _bucket_run(rt, hvd, rows_list, rank, op, pre, post, name, **kw):
    """One grouped allreduce of this rank's rows: the outputs and what
    flush_stats moved by (strategies, tiers, quantized)."""
    before = rt.flush_stats()
    hs = hvd.grouped_allreduce_async(
        [torch.from_numpy(a[rank]) for a in rows_list], op=op,
        prescale_factor=pre, postscale_factor=post, name=name, **kw)
    outs = [to_np(h.synchronize()) for h in hs]
    after = rt.flush_stats()
    return {"outs": outs,
            "strategies": {k: after["strategies"][k] - v
                           for k, v in before["strategies"].items()
                           if after["strategies"][k] != v},
            "tiers": {t: {d: n - before["tiers"][t].get(d, 0)
                          for d, n in after["tiers"][t].items()
                          if n != before["tiers"][t].get(d, 0)}
                      for t in after["tiers"]},
            "quantized": after["quantized"] - before["quantized"]}


def hier_world(rank, size, data):
    """The tiers on the world's strategy layout, in this order:

    - ``layout``: the topology's slices, node shape and this rank's local
      and cross members;
    - ``direct``: ``strategies.allreduce_torus`` / ``allreduce_hierarchical``
      (Average) of ``data["x"]``'s row, ``allreduce_tiered`` with an int8
      cross leg over two rounds (``data["tiered"]``: rows per round,
      prescale, postscale; the residual carried), and
      ``allgather_hierarchical`` of ``data["g"]``'s row;
    - ``fused``: for each strategy in ``data["fused"]``, a grouped Average
      allreduce of ``data["bucket"]``'s rows per round through the fusion
      runtime set to it (outputs, strategies and tier bytes);
    - ``refusals``: Min under torus, a 2-member set, a one-shot
      ``Compression.int8`` request, and a pinned ``hier`` strategy over a
      flat knob; the runtime's registry entry after a sync under the pin;
    - ``allgather``: ``hvd.allgather`` of ragged rows
      (HOROVOD_HIERARCHICAL_ALLGATHER in the world's env).
    """
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops import wire
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.parallel import strategies as S

    topo = basics._get_state().topology
    tiers = topo.tiers(topo.strategy_shape())
    out = {"layout": (topo.num_slices, topo.slice_size, topo.node_shape(),
                      tiers.local_ranks, tiers.cross_ranks)}
    x = torch.from_numpy(data["x"][rank])
    direct = {"torus": to_np(S.allreduce_torus(x, tiers, average=True)),
              "hier": to_np(S.allreduce_hierarchical(x, tiers,
                                                     average=True))}
    rounds, pre, post = data["tiered"]
    res = torch.zeros(-(-rounds[0].shape[1] // tiers.cols))
    got = []
    for r in rounds:
        y, res = S.allreduce_tiered(torch.from_numpy(r[rank]), tiers,
                                    average=True, cross_wire="int8",
                                    residual=res, prescale_factor=pre,
                                    postscale_factor=post)
        got.append((to_np(y), to_np(res)))
    direct["tiered"] = got
    direct["gather"] = to_np(S.allgather_hierarchical(
        torch.from_numpy(data["g"][rank]), tiers))
    out["direct"] = direct
    rt = get_runtime()
    fused = {}
    pre, post = data["scales"]
    with rt.cycle_paused():
        for strategy in data["fused"]:
            rt.strategy = strategy
            fused[strategy] = [
                _bucket_run(rt, hvd, rnd, rank, hvd.Average, pre, post,
                            f"bucket.{strategy}")
                for rnd in data["bucket"]]
        out["fused"] = fused
        rt.strategy = "torus"
        ref = {"min": _bucket_run(rt, hvd, data["bucket"][0], rank, hvd.Min,
                                  1.0, 1.0, "min")}
        ps = hvd.add_process_set(hvd.ProcessSet([0, 1]))
        if rank in (0, 1):
            ref["set"] = _bucket_run(rt, hvd, data["bucket"][0], rank,
                                     hvd.Sum, 1.0, 1.0, "set",
                                     process_set=ps)
        hvd.barrier()
        rt.strategy = "torus_qcross"
        hvd.Compression.int8.compress(None)
        ref["int8"] = _bucket_run(rt, hvd, data["bucket"][0][:1], rank,
                                  hvd.Sum, 1.0, 1.0, "int8")
        rt.strategy = "flat"
        hvd.set_dispatch_strategy("hier")
        ref["pinned"] = _bucket_run(rt, hvd, data["bucket"][0], rank,
                                    hvd.Average, 1.0, 1.0, "pinned")
        wire.runtime_sync_dispatch_strategy("flat")
        ref["registry"] = wire.dispatch_strategy_for("global")
        hvd.set_dispatch_strategy("")
    out["refusals"] = ref
    gathered = hvd.allgather(torch.from_numpy(data["ragged"][rank]))
    out["allgather"] = to_np(gathered)
    return out


def one_slice_world(rank, size, rows):
    """A node of ``size`` ranks and no forced slices: the strategy each
    bucket ran, under the world's knobs, and its outputs."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    topo = basics._get_state().topology
    got = _bucket_run(rt, hvd, rows, rank, hvd.Sum, 1.0, 1.0, "one_slice")
    got["layout"] = (topo.num_slices, topo.node_shape(), rt.strategy)
    return got


# ---------------------------------------------------------------------------
# PowerSGD: test_torch_powersgd's world.
# ---------------------------------------------------------------------------

def powersgd_world(rank, size, data):
    """``data["core"]``: cases (case, op, prescale, postscale, rank,
    rounds, state0); each round a list of per-leaf (size, ...) fp32 arrays
    and dtype names, ``state0`` JAX's ``{"q", "err"}`` as numpy. Runs
    ``optim.powersgd.PowerSGD.reduce`` round after round on this rank's
    leaves (ef_dtype float32, the state carried) and returns each round's
    outputs and state. ``data["mlp"]``: the MLP trained with
    ``DistributedOptimizer(SGD, compression=Compression.powersgd(r))`` from
    JAX's weights and initial PowerSGD state: the losses, the parameters,
    and the names of each bucket a step closed."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MLP, load_flax_mlp
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.optim.powersgd import PowerSGD

    out = {}
    for case, op, pre, post, r, rounds, state0 in data["core"]:
        core = PowerSGD(rank=r, op=getattr(hvd, op), prescale_factor=pre,
                        postscale_factor=post, ef_dtype=torch.float32)
        state = {k: tuple(torch.from_numpy(np.asarray(v, np.float32))
                          for v in vs) for k, vs in state0.items()}
        got = []
        for leaves in rounds:
            grads = [torch.from_numpy(a[rank]).to(_DTYPES[dt])
                     for a, dt in leaves]
            red, state = core.reduce(grads, state)
            got.append({"out": [to_np(t) for t in red],
                        "q": [to_np(t) for t in state["q"]],
                        "err": [to_np(t) for t in state["err"]]})
        out[case] = got
    params, state0, x, y, steps, lr, r = data["mlp"]
    model = MLP()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9),
        named_parameters=model.named_parameters(),
        compression=hvd.Compression.powersgd(r))
    load_flax_mlp(model, params, optimizer=opt, powersgd_state=state0)
    shard = x.shape[0] // size
    xs = torch.from_numpy(x[rank * shard:(rank + 1) * shard])
    ys = torch.from_numpy(y[rank * shard:(rank + 1) * shard]).long()
    rt = get_runtime()
    losses, buckets = [], []
    with rt.cycle_paused():
        for _ in range(steps):
            opt.zero_grad()
            # Before the backward: a follower applies process 0's boundary
            # as soon as its own enqueues catch up, inside its backward.
            before = rt.flush_stats()["buckets"]
            loss = F.cross_entropy(model(xs), ys)
            loss.backward()
            opt.step()
            n = rt.flush_stats()["buckets"] - before
            buckets.append([[e for e, _ in sig[-1]]
                            for _, sig in rt.recent_buckets(n)])
            losses.append(loss.item())
    out["mlp"] = {"losses": losses, "buckets": buckets,
                  "params": {n: to_np(p) for n, p in
                             model.named_parameters()},
                  "state_keys": sorted({k for s in opt.state.values()
                                        for k in s})}
    return out
