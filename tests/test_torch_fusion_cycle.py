"""The port's fusion runtime flush control against the JAX package's
(``horovod_tpu/ops/fusion.py``): the debounced cycle thread, the bucket rule,
the boundaries process 0 publishes and the other processes mirror, the fence
of eager collectives, the follower's deadline, the threads' device and
their shutdown.

- One process, ``HOROVOD_CYCLE_TIME=0``: one enqueue stream (mixed dtypes
  and ops, a group, a tensor over the threshold, splits inside a flush)
  through the port and through a JAX ``FusionRuntime`` (cycle 0, its
  threshold scaled by the 8 rows of the CPU mesh's stacked tensors) gives
  the same buckets, closed after the same enqueues. JAX's buckets are read
  by wrapping its ``_fused_program`` in the test (its plan cache is
  bypassed so that every bucket reaches it).
- Three gloo processes with the timer on (1 ms) and every rank sleeping at
  random (``SEED``; rank 1 up to 8 ms, the others up to 4 ms) between
  enqueues: rank 0's timer closes buckets mid-stream, every rank verifies
  the same bucket
  signatures as rank 0, and the values equal the JAX eager allreduce on a
  3-member process set: fp32 within rtol 1e-6 (3-term sums may associate
  differently), bf16/fp16 within two roundings at the result's scale.
"""

import contextlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_helpers as helpers

SEED = 11
THRESHOLD = 400                     # bytes per rank
JAX_ROWS = 8                        # the CPU mesh: stacked (8, n) tensors
# (kind, op, dtype, n): flushes at the threshold after items 3, 6 and 7
# (split inside the flush), item 9 (split inside the flush), and flush_all.
STREAM = [("one", "Sum", "float32", 20), ("one", "Sum", "bfloat16", 30),
          ("one", "Average", "float32", 40), ("one", "Sum", "float32", 30),
          ("one", "Max", "float16", 10),
          ("group", "Sum", "float32", [25, 25]),
          ("one", "Sum", "float32", 60), ("one", "Sum", "float32", 150),
          ("one", "Sum", "float32", 50), ("one", "Sum", "float32", 60),
          ("one", "Sum", "bfloat16", 10), ("flush",)]
JITTER = [("Sum", "float32"), ("Average", "float32"), ("Sum", "bfloat16"),
          ("Sum", "float32"), ("Max", "float16"), ("Average", "bfloat16"),
          ("Sum", "float32"), ("Sum", "float32")] * 2
JITTER_N = (5, 17, 9, 64, 3, 33, 1, 120)
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
_EPS = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


def _jitter_rows():
    gen = np.random.default_rng(SEED)
    return [gen.standard_normal((3, JITTER_N[i % len(JITTER_N)]))
            .astype(np.float32) for i in range(len(JITTER))]


@pytest.fixture(scope="module")
def worlds():
    rows = _jitter_rows()
    # Each rank sleeps its own seeded times, up to 4 cycles, before each
    # enqueue, rank 1 the longest: rank 0's timer closes buckets mid-stream
    # and the others must mirror them.
    delays = [np.random.default_rng(SEED + 1 + r).uniform(
        0.0, 0.004 * (2 if r == 1 else 1), len(JITTER)).tolist()
        for r in range(3)]
    return (helpers.run_world_async(helpers.fusion_stream, 1,
                                    args=(STREAM, THRESHOLD, SEED),
                                    env={"HOROVOD_CYCLE_TIME": "0"}),
            helpers.run_world_async(helpers.cycle_world, 3,
                                    args=(rows, JITTER, delays)),
            rows)


@pytest.fixture(scope="module")
def jax_buckets(hvd, worlds):
    """The JAX runtime's buckets for STREAM: (op, dtype, element counts)
    in dispatch order, and how many had been dispatched after each item."""
    import horovod_tpu.ops.fusion as F
    from horovod_tpu.common.config import Config

    class NoPlans(dict):
        def get(self, key, default=None):
            return default

    got = []
    raw = F._fused_program

    def program(mesh, n, op, prescale, postscale, shapes, dtypes, *a):
        got.append((op.name.capitalize() if op.name != "AVERAGE"
                    else "Average", str(jnp.dtype(dtypes[0])),
                    [int(np.prod(s[1:])) for s in shapes]))
        return raw(mesh, n, op, prescale, postscale, shapes, dtypes, *a)

    cfg = Config.from_env()
    cfg.cycle_time_ms = 0.0
    cfg.fusion_threshold = THRESHOLD * JAX_ROWS
    saved = (F._fused_program, F._flush_plans)
    F._fused_program, F._flush_plans = program, NoPlans()
    try:
        rt = F.FusionRuntime(cfg)
        gen = np.random.default_rng(SEED)
        handles, after = [], []
        for item in STREAM:
            if item[0] == "flush":
                rt.flush_all()
            else:
                kind, op, dt, n = item
                ts = [jnp.asarray(gen.standard_normal((JAX_ROWS, k)),
                                  DTYPES[dt])
                      for k in (n if kind == "group" else [n])]
                if kind == "group":
                    handles += rt.enqueue_grouped_allreduce(
                        ts, getattr(hvd, op), 1.0, 1.0)._handles
                else:
                    handles.append(rt.enqueue_allreduce(
                        ts[0], getattr(hvd, op), 1.0, 1.0))
            after.append(len(got))
        for h in handles:
            h.synchronize()
        rt.shutdown()
    finally:
        F._fused_program, F._flush_plans = saved
    return {"buckets": got, "after": after}


@pytest.fixture(scope="module")
def stream_port(worlds):
    return worlds[0].result()[0]


@pytest.fixture(scope="module")
def cycle_port(worlds):
    return worlds[1].result()


def test_buckets_equal_the_jax_runtime_with_the_timer_off(stream_port,
                                                          jax_buckets):
    port = [(op.capitalize() if op != "AVERAGE" else "Average", dt, n)
            for _, op, dt, n in stream_port["closed"]]
    assert port == jax_buckets["buckets"]
    assert stream_port["after"] == jax_buckets["after"]
    # Splits inside a flush, the group whole, the big tensor alone.
    assert [20, 30] in [n for *_, n in port]
    assert [25, 25] in [n for *_, n in port]
    assert [150] in [n for *_, n in port]
    assert [50] in [n for *_, n in port] and port[-2][2] == [60]


def test_timer_off_closes_on_threshold_and_flush_only(stream_port):
    whys = {why for why, *_ in stream_port["closed"]}
    assert whys == {"threshold", "sync"}
    assert stream_port["stats"]["closed_by"]["cycle"] == 0


def test_stream_values_are_the_inputs_on_one_rank(stream_port):
    # One rank: Sum, Average and Max of a single tensor are the tensor.
    for got, x in zip(stream_port["outputs"], stream_port["inputs"]):
        np.testing.assert_array_equal(got, x)


def test_cycle_thread_flushes_without_poll(cycle_port):
    for out in cycle_port:
        assert out["tick_flushed_by_timer"]
        np.testing.assert_array_equal(out["tick"], np.full(2, 6.0))


def test_threads_by_role(cycle_port):
    assert cycle_port[0]["threads"] == ["hvd-fusion-cycle",
                                        "hvd-fusion-publish"]
    for out in cycle_port[1:]:
        assert out["threads"] == ["hvd-fusion-follower"]


def test_jittered_ranks_form_the_same_buckets(cycle_port):
    sigs = cycle_port[0]["signatures"]
    assert sigs and sum(len(n) for *_, n in sigs) <= len(JITTER)
    assert cycle_port[0]["closed_by"]["cycle"] > 0
    for out in cycle_port[1:]:
        assert out["signatures"] == sigs
        # A follower counts process 0's triggers.
        assert out["closed_by"] == cycle_port[0]["closed_by"]


@pytest.mark.parametrize("i", range(len(JITTER)))
def test_jittered_values_match_jax(hvd, cycle_port, worlds, i):
    rows = worlds[2]
    op, dt = JITTER[i]
    trio = hvd.add_process_set(hvd.ProcessSet([0, 1, 2]))
    try:
        ref = np.asarray(hvd.allreduce(jnp.asarray(rows[i], DTYPES[dt]),
                                       op=getattr(hvd, op),
                                       process_set=trio), np.float32)
    finally:
        hvd.remove_process_set(trio)
    for rank in range(3):
        got = cycle_port[rank]["jitter"][i]
        if dt == "float32":
            np.testing.assert_allclose(got, ref[rank], rtol=1e-6, atol=1e-6)
        else:
            eps = _EPS[dt]
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got, ref[rank], rtol=2 * eps,
                                       atol=2 * eps * scale)


def test_eager_collective_fences_pending_buckets(cycle_port):
    for out in cycle_port:
        assert out["fenced_before_eager"] == [True, True]
        assert out["eager"] == [6.0, 6.0]
        for got, k in zip(out["fenced"], (3, 5)):
            np.testing.assert_array_equal(got, np.full(k, 6.0))


def test_follower_synchronize_names_the_spmd_contract(cycle_port):
    for out in cycle_port[1:]:
        name, msg = out["orphan"]
        assert name == "HorovodInternalError"
        assert "process 0" in msg and "SPMD" in msg
        assert 1.5 < out["orphan_seconds"] < 30


def test_shutdown_joins_every_thread(cycle_port):
    for out in cycle_port:
        assert out["alive_after_shutdown"] == []
        assert out["fusion_threads_left"] == []


def test_flush_threads_enter_the_local_rank_device(monkeypatch):
    """A process of local rank 1: every thread the runtime starts (the
    cycle and publisher threads of process 0, a follower's thread) enters
    ``torch.cuda.device(cuda:1)`` before anything else."""
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.ops.fusion import FusionRuntime

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dev = basics._resolve_device(None, 1)
    assert dev == torch.device("cuda", 1)
    entered = []

    def device(d):
        entered.append((threading.current_thread().name, torch.device(d)))
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.cuda, "device", device)

    store = dist.HashStore()
    runtimes = [FusionRuntime(1024, torch.device("cpu"), cycle_time_ms=1.0,
                              rank=r, size=s, store=store if s > 1 else None)
                for r, s in ((0, 1), (0, 2), (1, 2))]
    for rt in runtimes:
        rt.device = dev
        rt.start()
    names = [t.name for rt in runtimes for t in rt.threads()]
    for rt in (runtimes[0], runtimes[2], runtimes[1]):
        rt.shutdown()
    assert sorted(names) == ["hvd-fusion-cycle", "hvd-fusion-cycle",
                             "hvd-fusion-follower", "hvd-fusion-publish"]
    assert sorted(entered) == sorted((n, dev) for n in names)
    assert not [t for rt in runtimes for t in rt.threads() if t.is_alive()]


def test_cycle_time_changes_on_a_running_runtime():
    """``set_cycle_time_ms``: 0 stops the cycle thread, a positive value
    starts one again; a follower never runs one."""
    from horovod_tpu_torch.ops.fusion import FusionRuntime

    rt = FusionRuntime(1024, torch.device("cpu"), cycle_time_ms=1.0)
    rt.start()
    first = rt.threads()[0]
    rt.set_cycle_time_ms(0)
    first.join(timeout=5)
    assert not first.is_alive()
    rt.set_cycle_time_ms(2.0)
    assert [t.name for t in rt.threads() if t.is_alive()] == \
        ["hvd-fusion-cycle"]
    rt.shutdown()
    assert not [t for t in rt.threads() if t.is_alive()]
    follower = FusionRuntime(1024, torch.device("cpu"), rank=1, size=2,
                             store=dist.HashStore())
    follower.start()
    follower.set_cycle_time_ms(1.0)
    assert [t.name for t in follower.threads()] == ["hvd-fusion-follower"]
    follower.stop_threads()


def test_enqueues_race_the_cycle_thread(monkeypatch):
    """16 threads enqueue while a 0.05 ms cycle thread flushes, with the
    interpreter switching threads every 10 us: every tensor closes exactly
    once, the buckets in sequence order, the last ones by the timer."""
    import sys

    from horovod_tpu_torch.ops import fusion

    class OneRankSet:
        def size(self):
            return 1

    monkeypatch.setattr(fusion, "join_armed", lambda: False)
    rt = fusion.FusionRuntime(1 << 20, torch.device("cpu"),
                              cycle_time_ms=0.05)
    closed, whys = [], set()

    def close(key, entries, why, wire="", strategy="flat", cross="",
              eager=False):
        closed.extend(e.seq for e in entries)
        whys.add(why)
    rt._close = close
    ps, threads, per = OneRankSet(), 16, 200

    def enqueue_many():
        for _ in range(per):
            rt.enqueue([torch.ones(3)], [torch.empty(3)], fusion.ReduceOp.SUM,
                       1.0, 1.0, ps, ["t"])

    rt.start()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=enqueue_many)
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not [w for w in workers if w.is_alive()]
        deadline = time.monotonic() + 10.0     # the tail: the timer's
        while rt._pending and time.monotonic() < deadline:
            time.sleep(0.001)
        rt.flush_all()
    finally:
        sys.setswitchinterval(switch)
        rt.shutdown()
    assert closed == list(range(threads * per))
    assert "cycle" in whys
