"""Scenarios of ``tests/test_torch_observability.py`` that run in the
spawned gloo worlds of ``torch_port_helpers.run_world``. Like that module,
this one imports torch and the port only, never JAX."""

import contextlib
import copy
import json
import os
import sys
import time

import numpy as np
import torch


def _disarm_all(on):
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.goodput import ledger as goodput
    from horovod_tpu_torch.profile import ledger
    recorder.set_enabled(on)
    ledger.set_enabled(on)
    goodput.armed = on
    metrics.set_enabled(on)


# What the planes' hot path must not call (the recorder's contract, "no
# allocation, no I/O, no device read"): host syncs, device-to-host reads
# and tensor allocations.
_GUARDED = (
    (torch.cuda, ("synchronize",)),
    (torch.cuda.Event, ("synchronize", "wait")),
    (torch.Tensor, ("item", "tolist", "cpu", "numpy")),
    (torch, ("empty", "zeros", "ones", "full", "tensor", "empty_like",
             "zeros_like")),
)
_PLANES = tuple(f"horovod_tpu_torch.{m}" for m in (
    "flight", "profile", "goodput", "metrics", "timeline", "trace"))


@contextlib.contextmanager
def plane_calls():
    """Count the guarded calls whose caller is a plane's module, by name:
    yields the dict of counts."""
    counts = {}
    saved = []

    def wrap(owner, name, fn):
        def counted(*a, **k):
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith(_PLANES):
                counts[name] = counts.get(name, 0) + 1
            return fn(*a, **k)
        return counted
    for owner, names in _GUARDED:
        for name in names:
            fn = getattr(owner, name)
            saved.append((owner, name, owner.__dict__.get(name), fn))
            setattr(owner, name, wrap(owner, name, fn))
    try:
        yield counts
    finally:
        for owner, name, own, fn in saved:
            if own is None:
                delattr(owner, name)
            else:
                setattr(owner, name, own)


def observed_dp(rank, size, seed, steps, tmp):
    """A data-parallel MLP (SGD with momentum, ``DistributedOptimizer``)
    trained twice from the same weights: every plane disarmed, then every
    plane armed (timeline, flight, step profiler, goodput, metrics).
    Returns both runs' parameters, what the armed run's planes recorded,
    and the syncs, reads and allocations the planes made in it."""
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.goodput import ledger as goodput
    from horovod_tpu_torch.models import MLP
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.profile import ledger

    g = torch.Generator().manual_seed(seed)
    x = torch.randn(6 * size, 28 * 28, generator=g)
    y = torch.randint(0, 10, (6 * size,), generator=g)
    xs, ys = x[rank * 6:(rank + 1) * 6], y[rank * 6:(rank + 1) * 6]
    base = MLP(features=(32, 16, 10),
               generator=torch.Generator().manual_seed(seed))

    def train():
        model = copy.deepcopy(base)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        for _ in range(steps):
            opt.zero_grad()
            F.cross_entropy(model(xs), ys).backward()
            opt.step()
        return {n: p.detach().numpy().copy()
                for n, p in model.named_parameters()}

    _disarm_all(False)
    plain = train()
    _disarm_all(True)
    path = os.path.join(tmp, f"timeline_r{rank}_of{size}.json")
    hvd.start_timeline(path)
    b0 = get_runtime().flush_stats()["buckets"]
    i0 = recorder.get().appended()
    n0 = len(ledger.get().records())
    hvd.step_marker()              # opens the first step window
    with plane_calls() as calls:
        armed = train()
    buckets = get_runtime().flush_stats()["buckets"] - b0
    hvd.stop_timeline()
    with open(path) as f:
        timeline = json.load(f)["traceEvents"]
    events = [e for e in recorder.events() if e["i"] >= i0]
    return {"plain": plain, "armed": armed, "buckets": buckets,
            "timeline": [(e["name"], e["ph"], e.get("cat"))
                         for e in timeline],
            "events": [{k: e.get(k) for k in ("kind", "op", "ps", "seq")}
                       for e in events],
            "records": ledger.get().records()[n0:],
            "plane_calls": calls,
            "goodput": goodput.snapshot(),
            "metrics": hvd.metrics_text()}


def desync(rank, size, directory):
    """Four eager allreduces, rank 1 the slower to dispatch; then rank 1
    skips the fifth, dumps its ring and dies, and rank 0's fifth fails on
    the closed connection (its failure epilogue dumps the ring)."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.flight import recorder

    for i in range(4):
        if rank == 1:
            time.sleep(0.02)
        hvd.allreduce(torch.arange(4, dtype=torch.int64) + rank, op=hvd.Sum,
                      name=f"step{i}")
    if rank == 1:
        recorder.dump("skipped", directory=directory, force=True)
        os._exit(0)
    try:
        hvd.allreduce(torch.ones(3, dtype=torch.int64), op=hvd.Sum,
                      name="skipped_by_rank1")
    except hvd.HorovodInternalError:
        return sorted(os.listdir(directory))
    raise AssertionError("the collective rank 1 skipped did not fail")


def overlap_world(rank, size, seed):
    """Torus buckets over a 2 x 2 layout, under the ``HOROVOD_CROSS_OVERLAP``
    the world was started with: the outputs, the knob as the config read
    it, and the buckets by strategy."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    rng = np.random.default_rng(seed + rank)
    data = [rng.standard_normal(n).astype(np.float32)
            for n in (3000, 1201, 64)]
    with rt.cycle_paused():
        hs = [hvd.allreduce_async(torch.from_numpy(d), name=f"t{i}")
              for i, d in enumerate(data)]
        got = [h.synchronize().numpy().copy() for h in hs]
    hvd.allreduce(torch.ones(2, dtype=torch.int64), op=hvd.Sum, name="fence")
    return {"got": got, "knob": basics._get_state().config.cross_overlap,
            "strategies": rt.flush_stats()["strategies"]}
