"""hvdsim core: a deterministic discrete-event simulator.

Port of the JAX package's ``sim/core.py``, unchanged: pure Python, no
device. The scale twin's whole point is a 100k-rank control plane priced
in seconds on one host: virtual ranks are Python generators that *yield*
their KV operations, a single event heap orders them on a virtual clock,
and each get/put is priced by a small latency model instead of being
executed against wall time. A 65536-rank hierarchical negotiation round is
~300k heap events — seconds of wall time, zero threads.

Determinism contract (the twin's whole point): the event order is a pure
function of the spawned programs and the latency model — ties break on a
monotone sequence number, parked getters wake in park order, and nothing
reads wall clock or a shared RNG. Two runs of the same scenario produce
bit-identical event trails, which is what lets tests assert on the twin
like an invariant rather than a benchmark.

The pieces compose with the REAL runtime math, they do not re-model it:
rank programs (:mod:`horovod_tpu_torch.sim.control`) mirror the
``control_plane`` exchange key layout verbatim, chaos triggers come from
:mod:`horovod_tpu_torch.chaos.plan`'s pure seeded functions, and step
pricing comes from ``profile/roofline.py``.
"""

import dataclasses
import heapq
import os

from horovod_tpu_torch.common.config import Config


class SimTimeout(Exception):
    """A virtual KV get expired before the key landed (the twin analogue
    of ``LocalKV.get`` raising ``TimeoutError``)."""


@dataclasses.dataclass
class LatencyModel:
    """Per-operation pricing for the virtual control plane. Deliberately
    simple — the twin's guards are about RPC *counts* and relative
    shapes, not microsecond fidelity: one base cost per KV RPC, a DCN
    surcharge for cross-slice hops, and a bandwidth term for the payload
    bytes. Knobs: ``HOROVOD_SIM_KV_US`` / ``HOROVOD_SIM_DCN_US``."""

    kv_us: float = Config.sim_kv_us    # base cost of one KV RPC (same-shard)
    dcn_us: float = Config.sim_dcn_us  # surcharge when the RPC crosses slices
    gbps: float = 1.0        # payload term: value bytes / (gbps GB/s)

    @classmethod
    def from_env(cls, env=None):
        env = env if env is not None else os.environ
        m = cls()
        try:
            m.kv_us = float(env.get("HOROVOD_SIM_KV_US", m.kv_us))
            m.dcn_us = float(env.get("HOROVOD_SIM_DCN_US", m.dcn_us))
        except ValueError:
            pass
        return m

    def seconds(self, cross, nbytes=0):
        """Virtual seconds for one KV RPC: base + optional cross-slice
        surcharge + payload/bandwidth."""
        t = (self.kv_us + (self.dcn_us if cross else 0.0)) * 1e-6
        if nbytes:
            t += nbytes / (max(self.gbps, 1e-9) * 1e9)
        return t


def _nbytes(value):
    if isinstance(value, (str, bytes)):
        return len(value)
    return 0


class Simulator:
    """One negotiation-round-scale event simulation.

    Rank programs are generators yielding operation tuples:

    - ``("put", key, value, cross)`` — publish ``key``; resumes after the
      priced latency (``cross`` prices the DCN surcharge).
    - ``("get", key, cross, timeout_s)`` — resumes with the value once
      the key has landed (immediately after the get latency when it
      already has); raises :class:`SimTimeout` in the generator when
      ``timeout_s`` virtual seconds pass first.
    - ``("advance", dt)`` — sleep ``dt`` virtual seconds.

    ``kv_hook(rank, op, key)`` (optional) is consulted before pricing
    each KV operation and returns ``(extra_delay_s, kill)`` — the chaos
    seam: delays model stragglers/KV faults, ``kill`` terminates the
    rank's program on the spot. The hook must itself be deterministic
    (the chaos plan's trigger functions are).

    The ``trail`` (when recording) is a list of
    ``(t_us, rank, op, key)`` tuples in event order — the bit-identical
    artifact the determinism guard asserts on.
    """

    def __init__(self, latency=None, record_trail=False):
        self.latency = latency or LatencyModel()
        self.now = 0.0
        self.trail = [] if record_trail else None
        self.kv_hook = None
        self.results = {}        # rank -> program return value
        self.finish_t = {}       # rank -> virtual completion time
        self.killed = set()      # ranks terminated by the kv_hook
        self.stats = {"events": 0, "kv_ops": 0, "timeouts": 0}
        self._heap = []          # (t, seq, fn, args)
        self._seq = 0
        self._store = {}
        self._intern = {}        # value dedup (see _land)
        self._waiters = {}       # key -> [waiter dict]
        self._live = 0

    # --- scheduling ----------------------------------------------------

    def _push(self, t, fn, *args):
        self._seq += 1
        heapq.heappush(self._heap, (t, self._seq, fn, args))

    def _record(self, t, rank, op, key):
        if self.trail is not None:
            self.trail.append((int(round(t * 1e6)), rank, op, key))

    def spawn(self, rank, gen):
        """Register a rank program; it takes its first step at the
        current virtual time."""
        self._live += 1
        self._push(self.now, self._resume, rank, gen, None, None)

    def run(self):
        """Drain the event heap until every spawned program finished.
        Stale timeout events past that point are dropped unprocessed so
        the final virtual times reflect real completions."""
        while self._heap and self._live > 0:
            t, _, fn, args = heapq.heappop(self._heap)
            self.now = t
            self.stats["events"] += 1
            fn(*args)
        self._heap.clear()
        return self.results

    # --- program stepping ----------------------------------------------

    def _resume(self, rank, gen, sendval, exc):
        try:
            if exc is not None:
                op = gen.throw(exc)
            else:
                op = gen.send(sendval)
        except StopIteration as e:
            self._live -= 1
            self.results[rank] = e.value
            self.finish_t[rank] = self.now
            return
        self._dispatch(rank, gen, op)

    def _kill(self, rank, gen):
        gen.close()
        self._live -= 1
        self.killed.add(rank)
        self.finish_t[rank] = self.now
        self._record(self.now, rank, "kill", "")

    def _chaos(self, rank, op, key):
        if self.kv_hook is None:
            return 0.0, False
        delay, kill = self.kv_hook(rank, op, key)
        return float(delay or 0.0), bool(kill)

    def _dispatch(self, rank, gen, op):
        kind = op[0]
        if kind == "put":
            _, key, value, cross = op
            self.stats["kv_ops"] += 1
            delay, kill = self._chaos(rank, "set", key)
            if kill:
                self._kill(rank, gen)
                return
            t1 = self.now + self.latency.seconds(cross, _nbytes(value)) \
                + delay
            self._push(t1, self._land, rank, gen, key, value)
        elif kind == "get":
            _, key, cross, timeout_s = op
            self.stats["kv_ops"] += 1
            delay, kill = self._chaos(rank, "get", key)
            if kill:
                self._kill(rank, gen)
                return
            t_ready = self.now + self.latency.seconds(cross) + delay
            if key in self._store:
                self._record(t_ready, rank, "get", key)
                self._push(t_ready, self._resume, rank, gen,
                           self._store[key], None)
            else:
                waiter = {"rank": rank, "gen": gen, "key": key,
                          "t_ready": t_ready, "done": False}
                self._waiters.setdefault(key, []).append(waiter)
                self._push(t_ready + float(timeout_s), self._expire,
                           waiter)
        elif kind == "advance":
            self._push(self.now + float(op[1]), self._resume, rank, gen,
                       None, None)
        else:
            raise ValueError(f"unknown sim op {kind!r}")

    def _land(self, rank, gen, key, value):
        """A put arrives: store the value, wake parked getters in park
        order, resume the putter. Equal string values are interned to
        one object — at n=65536 every slice leader publishes an EQUAL
        ~1 MB fan-back blob, and deduping them keeps memory O(1) in the
        slice count and makes downstream decode caches O(1)-hot (str
        hashes are cached per object)."""
        if isinstance(value, str):
            value = self._intern.setdefault(value, value)
        self._store[key] = value
        self._record(self.now, rank, "set", key)
        for waiter in self._waiters.pop(key, ()):
            if waiter["done"]:
                continue
            waiter["done"] = True
            t = max(self.now, waiter["t_ready"])
            self._record(t, waiter["rank"], "get", key)
            self._push(t, self._resume, waiter["rank"], waiter["gen"],
                       value, None)
        self._push(self.now, self._resume, rank, gen, None, None)

    def _expire(self, waiter):
        if waiter["done"]:
            return                      # satisfied before the deadline
        waiter["done"] = True
        self.stats["timeouts"] += 1
        self._record(self.now, waiter["rank"], "timeout", waiter["key"])
        self._push(self.now, self._resume, waiter["rank"], waiter["gen"],
                   None, SimTimeout(waiter["key"]))
