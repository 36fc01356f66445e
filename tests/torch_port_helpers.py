"""Helpers for the PyTorch port's CPU tests.

``run_world(fn, size, args)`` starts ``size`` processes with the ``spawn``
method, gives each the launcher's env contract (HOROVOD_RANK/SIZE/...,
HOROVOD_COORDINATOR_ADDR/PORT), calls ``hvd.init(device="cpu")`` and returns
``[fn(rank, size, *args) for each rank]``; ``run_world_async`` does the
same on a thread and returns a future. The scenarios below run in those
processes: this module imports torch and the port only, never JAX, so a
child starts in about a second.
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


def run_world(fn, size=2, args=(), env=None, timeout=120.0):
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
        while len(got) < size:
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
    return [got[r] for r in range(size)]


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

    # Threshold splits: a fresh runtime at a 100-byte threshold.
    rt = get_runtime()
    rt.threshold = 100
    seen = len(rt.verified_signatures())
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
    try:
        hvd.allgather(torch.ones(rank + 1))
        out["ragged"] = None
    except Exception as e:  # noqa: BLE001 — the error's type is the result
        out["ragged"] = type(e).__name__
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
