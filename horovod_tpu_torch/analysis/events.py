"""Collective-event model for the static analyzer.

Port of the JAX package's ``analysis/events.py``, the same classes and
hashes. A :class:`CollectiveEvent` is the static twin of one
flight-recorder ``dispatch`` event: same ``op`` label (``collective_ops``
op kind, lowercased), same process-set label, same per-process-set
monotonic ``seq`` (1-based), and, for eager ops, the same signature hash
(``flight.recorder.signature``, which hashes a shape and dtype as the JAX
package does). That alignment makes a cross-check against the flight
recorder a tuple comparison instead of a joining heuristic.

Collectives inside a step over a mesh's named axes (``ops/in_step.py``)
never reach the flight recorder, so their events are static-only,
labelled ``ps="axis:<name>"`` with ``origin="jit"`` (the JAX package's
label, kept so both packages' events compare equal).
"""

import dataclasses
import zlib


class _Aval:
    """shape/dtype stand-in accepted by ``flight.recorder.signature`` (it
    reads only ``.shape`` and ``.dtype``)."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


def signature_of(shapes, dtypes):
    """The flight recorder's signature hash for a (shapes, dtypes) pair —
    one source of truth (delegates to :func:`flight.recorder.signature`)."""
    from horovod_tpu_torch.flight.recorder import signature
    return signature([_Aval(s, d) for s, d in zip(shapes, dtypes)])


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One predicted collective dispatch on one simulated rank."""

    op: str            # flight op label: "allreduce", "allgather", ... or
    #                    the jit primitive: "psum", "ppermute", ...
    ps: str            # "global" / "set<N>" / "unregistered" / "axis:<ax>"
    seq: int           # per-ps monotonic sequence number (1-based)
    shapes: tuple      # wire tensor shapes (global stacked, eager ops)
    dtypes: tuple      # matching dtype strings
    origin: str        # "eager" | "fused" | "jit"
    name: str = None   # user-supplied op name, if any
    nbytes: int = 0
    # Static trip count when inside a lax.scan; 0 = UNKNOWN (the event
    # sits in a while-loop body whose trip count is data-dependent —
    # diffed for presence across ranks, excluded from sequence hashes).
    repeat: int = 1
    # Cost-model context (analysis/cost.py). Eager ops: the reduce-op
    # name ("Sum"/"Average"/...; None for non-reductions) and, for a
    # non-global process set, its member ranks — tier classification
    # needs to know WHICH ranks exchange, not just how many. Jit ops:
    # the named-axis sizes the collective communicates over (None =
    # unknown axis). None of these enter key()/identity(), so cross-rank
    # diffing and the flight cross-check are unchanged.
    red_op: str = None
    ps_ranks: tuple = None
    axis_sizes: tuple = ()

    @property
    def sig(self):
        return signature_of(self.shapes, self.dtypes)

    def identity(self):
        """The flight-recorder identity tuple ``(op, ps, seq, sig)``."""
        return (self.op, self.ps, self.seq, self.sig)

    def key(self):
        """Identity *without* seq — what cross-rank diffing compares at
        each position."""
        return (self.op, self.ps, self.sig, self.repeat)

    def per_rank_elems(self):
        """Elements ONE participant contributes: eager shapes are global
        rank-major stacks (leading axis = set size), jit shapes are the
        per-device view already."""
        total = 0
        for s in self.shapes:
            dims = s[1:] if self.origin != "jit" else s
            cnt = 1
            for d in dims:
                cnt *= int(d)
            total += cnt
        return total

    def group_size(self, world_size=None):
        """Number of exchange participants: the leading stacked dim for
        eager ops, the product of known axis sizes for jit ops (falling
        back to ``world_size`` when the walker couldn't size the axis)."""
        if self.origin != "jit":
            if self.shapes and self.shapes[0]:
                return int(self.shapes[0][0])
            return len(self.ps_ranks) if self.ps_ranks else world_size
        sizes = [s for s in self.axis_sizes if s]
        if not sizes:
            return world_size
        p = 1
        for s in sizes:
            p *= int(s)
        return p

    def describe(self):
        shp = ",".join(f"{tuple(s)}:{d}"
                       for s, d in zip(self.shapes, self.dtypes))
        rep = "" if self.repeat == 1 \
            else (" x?" if self.repeat == 0 else f" x{self.repeat}")
        return (f"{self.op}[{self.ps}] seq={self.seq} sig={self.sig}"
                f" {shp}{rep} ({self.origin})")


def assign_seqs(events):
    """Stamp per-process-set monotonic 1-based seqs (the flight recorder's
    numbering) onto an ordered event list; ``repeat`` advances the counter
    by its trip count, matching what the recorder would log across loop
    iterations. Returns a new list."""
    counters = {}
    out = []
    for e in events:
        seq = counters.get(e.ps, 0) + 1
        # repeat 0 (unknown while-loop count) still advances by one: the
        # later numbering is approximate either way, and the hash skips
        # these events.
        counters[e.ps] = seq + (max(e.repeat, 1) - 1)
        out.append(dataclasses.replace(e, seq=seq))
    return out


def sequence_hash(events, ps=None):
    """Stable (cross-process) hash of an ordered collective sequence:
    crc32 over each event's ``op|ps|sig|repeat``. Accepts
    :class:`CollectiveEvent` lists or flight-recorder event dicts
    (``kind=="dispatch"`` rows; others are skipped). ``ps`` filters to one
    process set. Events with ``repeat=0`` (unknown while-loop trip count)
    are excluded — their contribution is inherently non-static."""
    parts = []
    for e in events:
        if isinstance(e, dict):
            if e.get("kind") != "dispatch":
                continue
            if ps is not None and e.get("ps") != ps:
                continue
            parts.append(f"{e.get('op')}|{e.get('ps')}|{e.get('sig')}|1")
        else:
            if ps is not None and e.ps != ps:
                continue
            if e.repeat == 0:
                continue
            parts.append(f"{e.op}|{e.ps}|{e.sig}|{e.repeat}")
    return format(zlib.crc32(";".join(parts).encode()), "08x")
