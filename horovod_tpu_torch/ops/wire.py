"""Quantized wire tier: block-scaled int8/fp8 allreduce with error feedback.

Port of the JAX package's ``ops/wire.py`` on torch tensors and
``torch.distributed`` groups:

- the wire labels (``int8``, ``fp8``; ``float16``/``bfloat16`` are cast
  wires) and :func:`wire_torch_type`;
- the symmetric block quantizers, one fp32 scale per :data:`BLOCK`
  elements, on ``torch.int8`` and ``torch.float8_e4m3fn``;
- :func:`block_scaled_allreduce`, the two-phase exchange (EQuARX,
  arXiv:2506.17615) over a group: each rank quantizes its buffer's n
  destination shards, one ``all_to_all_single`` moves the 1-byte payload and
  one the scales, each rank sums its shard's dequantized rows in fp32,
  requantizes it, and an all-gather of payload and scales gives every rank
  the whole buffer;
- the error-feedback store (one fp32 residual per key, the oldest evicted
  past 64), the wire-dtype registry (a user pin beats the runtime's sync),
  the dispatch-strategy registry of the hierarchical tiers (the same rule)
  and the one-shot request that ``Compression.int8`` arms;
- the wire-byte accounting, the JAX package's integer formulas.

Residuals live in the prescaled SUM domain: a residual is added after the
prescale and before quantization, and the new one is this round's
first-leg error on the whole buffer plus the second-leg error on the shard
this rank owns, so each global error term re-enters the next reduction
exactly once. :func:`reset_error_feedback` runs on ``hvd.shutdown`` and so
on every elastic reset: a resized world must never replay residuals padded
for the old one.

Rounding follows the JAX functions as XLA compiles them, step for step: a
division by a constant (``max|t|/127``, ``/448``, Average's ``/ n``) is a
product with the constant's fp32 reciprocal, ``t / scale`` a true division,
a product feeding a sum or a difference one fused multiply-add
(:func:`_fma`), and ``torch.round`` rounds half to even as ``jnp.round``
does. The 1-byte payloads cross the backends as ``torch.uint8`` views,
which NCCL and gloo both take.

- the alltoall-strategy and cross-wire registry of the hierarchical
  alltoall (``parallel/strategies.py::alltoall_tiered``, the MoE layer's
  expert dispatch and the eager ``hvd.alltoall``): a registry of its own,
  and a cross wire that never falls back to the allreduce knobs.
"""

import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.topology import slice_of_rank

# One fp32 scale per this many elements (EQuARX's block quantization).
BLOCK = 1024

# Largest finite magnitude of float8_e4m3fn.
FP8_MAX = 448.0

# Quantized wire labels (the rest of the accepted wire dtypes are casts).
QUANTIZED = ("int8", "fp8")

_TORCH_TYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
                "float16": torch.float16, "bfloat16": torch.bfloat16}


def resolve_wire_dtype(name):
    """Normalize a configured wire dtype string ('' for full precision).
    PyTorch always has ``float8_e4m3fn``, so ``fp8`` never falls back to the
    bf16 cast wire as it may on a jax build without it."""
    return name or ""


def quantized_label(dtype_like):
    """``"int8"``/``"fp8"`` when ``dtype_like`` (a wire string or a torch
    dtype) names a quantized wire format, else None."""
    if dtype_like is None or dtype_like == "":
        return None
    if isinstance(dtype_like, str):
        return dtype_like if dtype_like in QUANTIZED else None
    if dtype_like == torch.int8:
        return "int8"
    if dtype_like == torch.float8_e4m3fn:
        return "fp8"
    return None


def is_quantized(name):
    return quantized_label(name) is not None


def wire_torch_type(name):
    """The torch dtype of a configured wire dtype string, or None for the
    full-precision wire (the counterpart of ``wire_numpy_type``)."""
    name = resolve_wire_dtype(name)
    return _TORCH_TYPES[name] if name else None


# ----------------------------------------------------------------------------
# Block quantizers
# ----------------------------------------------------------------------------

def fp32_reciprocal(value):
    """``1 / value`` rounded to fp32: XLA compiles a division by a constant
    (``max/127``, ``out / n``) as a product with this, so the JAX programs
    round there as a product does."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 / torch.tensor(float(value), dtype=torch.float32))


def symmetric_int8_quantize(t):
    """Per-LAST-axis scale ``max|t|/127`` clamped at 1e-30, round + clip
    to ±127. Returns ``(q8, scale)`` with ``scale.shape == t.shape[:-1]``
    (fp32 ``t``)."""
    scale = torch.clamp_min(t.abs().amax(dim=-1) * fp32_reciprocal(127.0),
                            1e-30)
    q = torch.clamp(torch.round(t / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def symmetric_fp8_quantize(t):
    """fp8 (e4m3) sibling of :func:`symmetric_int8_quantize`: per-LAST-axis
    scale ``max|t|/448``, cast to ``float8_e4m3fn`` (the cast rounds; a
    quotient a hair above 448 rounds to 448, not to NaN)."""
    scale = torch.clamp_min(t.abs().amax(dim=-1) * fp32_reciprocal(FP8_MAX),
                            1e-30)
    return (t / scale[..., None]).to(torch.float8_e4m3fn), scale


def quantize_blocks(t, wire):
    """Dispatch to the block quantizer for wire format ``wire``."""
    if wire == "fp8":
        return symmetric_fp8_quantize(t)
    return symmetric_int8_quantize(t)


def dequantize(q, scale):
    return q.to(torch.float32) * scale[..., None]


def _fma(acc, q, scale, sign=1.0):
    """``acc + sign * dequantize(q, scale)`` rounded once to fp32: the fused
    multiply-add XLA makes of a dequantize feeding a sum or a difference.
    A level times an fp32 scale is exact in float64, so the float64 sum
    rounded to fp32 is that FMA (but where the float64 sum lands exactly on
    an fp32 midpoint, a chance of ~2^-29 an element)."""
    prod = q.to(torch.float64) * scale.to(torch.float64)[..., None]
    return (acc.to(torch.float64) + sign * prod).to(torch.float32)


# ----------------------------------------------------------------------------
# The two-phase block-scaled exchange, with optional error feedback.
# ----------------------------------------------------------------------------

def _bytes(q):
    return q.view(torch.uint8)


def block_scaled_allreduce(x, residual=None, group=None, wire="int8",
                           average=False, prescale_factor=1.0,
                           postscale_factor=1.0):
    """Quantized allreduce of this rank's ``x`` over ``group``: ``wire``
    bytes on the wire, fp32 accumulation (JAX ``block_scaled_allreduce``).

    1. the fp32 buffer (prescaled, plus ``residual``, padded to n×BLOCK)
       splits into n destination shards, quantized block-wise;
    2. one ``all_to_all_single`` moves the 1-byte shards, one the scales;
    3. each rank sums the dequantized rows of its shard in fp32, in row
       order, one rounding a row (the reduce-scatter leg);
    4. the reduced shard is requantized, and payload and scales are
       all-gathered and dequantized (the all-gather leg).

    Then ``/ n`` for ``average`` and ``* postscale_factor``, both in fp32,
    and the cast to ``x``'s dtype. ``residual``: an fp32 tensor of ``x``'s
    size, the previous round's error; returns ``(out, new_residual)``, or
    ``(out, None)`` without one.

    Each step rounds where the JAX function, compiled by XLA, rounds: XLA
    fuses a product into the sum or difference it feeds (the prescale into
    the residual's addition, each row's dequantize into the running sum,
    the dequantize into each leg's error), one rounding each (:func:`_fma`).
    """
    from horovod_tpu_torch.ops.collective_ops import all_gather_flat, launch
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    flat = x.reshape(-1).to(torch.float32)
    ef = residual is not None
    if ef and prescale_factor != 1.0:
        flat = (flat.to(torch.float64) * float(torch.tensor(
            prescale_factor, dtype=torch.float32))
            + residual.reshape(-1).to(torch.float64)).to(torch.float32)
    elif prescale_factor != 1.0:
        flat = flat * prescale_factor
    if ef and prescale_factor == 1.0:
        flat = flat + residual.reshape(-1).to(torch.float32)
    size = flat.numel()
    pad = (-size) % (n * BLOCK)
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    nb = flat.numel() // (n * BLOCK)                 # blocks per shard
    blocks = flat.view(n, nb, BLOCK)                 # [dest, block, elem]
    q, scale = quantize_blocks(blocks, wire)         # scale (n, nb)
    err1 = _fma(blocks, q, scale, -1.0) if ef else None
    # Row d goes to rank d; row r of the result came from rank r.
    qt, st = torch.empty_like(q), torch.empty_like(scale)
    launch(dist.all_to_all_single, _bytes(qt), _bytes(q), group=group)
    launch(dist.all_to_all_single, st, scale, group=group)
    part = dequantize(qt[0], st[0])
    for r in range(1, n):                            # row order
        part = _fma(part, qt[r], st[r])
    q2, s2 = quantize_blocks(part, wire)             # s2 (nb,)
    full_q = torch.empty((n,) + tuple(q2.shape), dtype=q2.dtype,
                         device=q2.device)
    full_s = torch.empty((n, nb), dtype=s2.dtype, device=s2.device)
    launch(all_gather_flat, _bytes(full_q).view(-1), _bytes(q2).view(-1),
           group=group)
    launch(all_gather_flat, full_s.view(-1), s2, group=group)
    out = dequantize(full_q, full_s).reshape(-1)
    new_res = None
    if ef:
        # This rank compensates the error of everything it sent (first
        # leg, whole buffer) and the requantization error of the one shard
        # it owns (second leg).
        new_res = err1.reshape(-1)
        shard = nb * BLOCK
        new_res[me * shard:(me + 1) * shard] += \
            _fma(part, q2, s2, -1.0).reshape(-1)
        new_res = new_res[:size]
    out = out[:size]
    # XLA folds the constants of (out * 1/n) * postscale into one product.
    scale = torch.tensor(fp32_reciprocal(n) if average else 1.0,
                         dtype=torch.float32)
    if postscale_factor != 1.0:
        scale = scale * torch.tensor(postscale_factor, dtype=torch.float32)
    if average or postscale_factor != 1.0:
        out = out * float(scale)
    return out.reshape(x.shape).to(x.dtype), new_res


# ----------------------------------------------------------------------------
# Error-feedback store (process-local, fp32 residuals on the device).
# ----------------------------------------------------------------------------

_EF_CAP = 64
_ef_lock = threading.RLock()
_ef_store = {}


def ef_get(key):
    with _ef_lock:
        return _ef_store.get(key)


def ef_put(key, residual):
    with _ef_lock:
        if key not in _ef_store and len(_ef_store) >= _EF_CAP:
            # Evict the oldest entry, never the whole store: a dropped
            # residual costs its bucket one uncompensated round.
            _ef_store.pop(next(iter(_ef_store)))
        _ef_store[key] = residual


def ef_pop(key):
    with _ef_lock:
        return _ef_store.pop(key, None)


def ef_keys():
    with _ef_lock:
        return list(_ef_store)


def reset_error_feedback():
    """Drop every error-feedback residual (``hvd.shutdown`` and so the
    elastic reset: a resized world must not replay errors sized for the old
    one). Returns how many there were."""
    with _ef_lock:
        n = len(_ef_store)
        _ef_store.clear()
    return n


# ----------------------------------------------------------------------------
# Per-process-set wire-dtype registry: the config knob is every set's
# default; an entry overrides it, set by the user (a pin) or by the fusion
# runtime's boundary sync, which defers to a pin.
# ----------------------------------------------------------------------------

_wire_lock = threading.RLock()
_wire_registry = {}            # key -> (value, "user" | "runtime")

_ACCEPTED = ("", "float16", "bfloat16", "int8", "fp8")

_ALIASES = {"fp16": "float16", "bf16": "bfloat16", "float8_e4m3fn": "fp8"}


def _registry_key(ps_label, tier=None):
    return str(ps_label) if not tier else f"{ps_label}@{tier}"


def _normalize(dtype):
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    name = _ALIASES.get(dtype or "", dtype or "")
    if name not in _ACCEPTED:
        raise ValueError(
            f"wire dtype {dtype!r}: expected one of {_ACCEPTED}")
    return resolve_wire_dtype(name)


def set_wire_dtype(dtype, ps_label="global", tier=None):
    """Pin the wire dtype of one process set ('' restores full precision);
    returns the normalized value. The fusion runtime's boundary sync no
    longer overwrites a pinned set. ``tier="dcn"`` sets the cross-slice
    leg's policy (the torus_qcross strategy's cross wire)."""
    name = _normalize(dtype)
    with _wire_lock:
        _wire_registry[_registry_key(ps_label, tier)] = (name, "user")
    return name


def runtime_sync_wire_dtype(dtype, ps_label="global", tier=None):
    """The fusion runtime's adoption of its wire snapshot: like
    :func:`set_wire_dtype` but it defers to a user pin. Returns the value
    in effect."""
    name = _normalize(dtype)
    with _wire_lock:
        key = _registry_key(ps_label, tier)
        cur = _wire_registry.get(key)
        if cur is not None and cur[1] == "user":
            return cur[0]
        _wire_registry[key] = (name, "runtime")
    return name


def wire_dtype_for(ps_label, default="", tier=None):
    """Effective wire dtype of a process set: the registry's entry, else
    ``default`` (normally the config knob)."""
    with _wire_lock:
        v = _wire_registry.get(_registry_key(ps_label, tier))
    return resolve_wire_dtype(default) if v is None else v[0]


def cross_wire_for(ps_label, config):
    """Effective wire dtype of the cross-slice leg of one process set: the
    ``ps@dcn`` entry, else ``HOROVOD_WIRE_DTYPE_DCN``, else the flat wire
    knob."""
    default = getattr(config, "wire_dtype_dcn", "") \
        or getattr(config, "wire_dtype", "")
    return wire_dtype_for(ps_label, default, tier="dcn")


def clear_wire_registry():
    with _wire_lock:
        _wire_registry.clear()


def clear_runtime_wire():
    """Drop the entries a fusion runtime synced in (its knob, or process
    0's boundaries), wires and strategies, keeping the user's pins:
    ``hvd.shutdown`` calls it, so a runtime's policy does not outlive it
    into the next ``hvd.init``."""
    with _wire_lock:
        for reg in (_wire_registry, _strategy_registry,
                    _a2a_strategy_registry):
            for key in [k for k, v in reg.items() if v[1] == "runtime"]:
                del reg[key]


# ----------------------------------------------------------------------------
# Per-process-set dispatch-strategy registry (flat / hier / hier_qcross):
# the same rule as the wire dtype's. The fusion runtime syncs its strategy
# into it at each flush, as the JAX runtime syncs its eager policy, and an
# hvd.set_dispatch_strategy call pins the set against that sync; a pinned
# "hier" or "hier_qcross" (or "flat") steers the runtime's next buckets
# (ops/fusion.py: torus, torus_qcross, flat).
# ----------------------------------------------------------------------------

STRATEGIES = ("", "flat", "hier", "hier_qcross")

_strategy_registry = {}        # ps_label -> (value, "user" | "runtime")


def _normalize_strategy(strategy):
    s = strategy or ""
    if s not in STRATEGIES:
        raise ValueError(
            f"dispatch strategy {strategy!r}: expected one of {STRATEGIES}"
            " ('' = config default; hier = 2-level RS/cross/AG; "
            "hier_qcross = hierarchical with the cross leg on the "
            "quantized wire)")
    return s


def set_dispatch_strategy(strategy, ps_label="global"):
    """Pin the allreduce dispatch strategy of one process set ('' restores
    the config default); returns the normalized value."""
    s = _normalize_strategy(strategy)
    with _wire_lock:
        _strategy_registry[str(ps_label)] = (s, "user")
    return s


def runtime_sync_dispatch_strategy(strategy, ps_label="global"):
    """The fusion runtime's adoption of its strategy: defers to a user pin
    like :func:`runtime_sync_wire_dtype`."""
    s = _normalize_strategy(strategy)
    with _wire_lock:
        cur = _strategy_registry.get(str(ps_label))
        if cur is not None and cur[1] == "user":
            return cur[0]
        _strategy_registry[str(ps_label)] = (s, "runtime")
    return s


def dispatch_strategy_for(ps_label, default=""):
    """Effective dispatch strategy of a process set: the registry's entry,
    else ``default``."""
    with _wire_lock:
        v = _strategy_registry.get(str(ps_label))
    return (default or "") if v is None or not v[0] else v[0]


def pinned_dispatch_strategy(ps_label="global"):
    """The user's pin for a process set, or None (the runtime's own syncs
    are not pins)."""
    with _wire_lock:
        v = _strategy_registry.get(str(ps_label))
    return v[0] if v is not None and v[1] == "user" and v[0] else None


def clear_strategy_registry():
    with _wire_lock:
        _strategy_registry.clear()
        _a2a_strategy_registry.clear()


# ----------------------------------------------------------------------------
# Per-process-set ALLTOALL strategy and cross-wire registry: the
# hierarchical alltoall's own pair of levers (flat / hier / hier_qcross, and
# the cross-slice leg's wire), kept apart from the allreduce pair because an
# alltoall moves activations without error feedback. The cross dtype lives
# in the wire registry under the key ``a2a:<ps>@dcn``, so pins, the
# runtime's syncs and the clears behave as the wire's do.
# ----------------------------------------------------------------------------

_a2a_strategy_registry = {}    # ps_label -> (value, "user" | "runtime")


def set_alltoall_strategy(strategy, ps_label="global"):
    """Pin the alltoall dispatch strategy of one process set ('' restores
    the config default); returns the normalized value."""
    s = _normalize_strategy(strategy)
    with _wire_lock:
        _a2a_strategy_registry[str(ps_label)] = (s, "user")
    return s


def runtime_sync_alltoall_strategy(strategy, ps_label="global"):
    """A runtime's adoption of an alltoall strategy: defers to a user pin
    like :func:`runtime_sync_dispatch_strategy`."""
    s = _normalize_strategy(strategy)
    with _wire_lock:
        cur = _a2a_strategy_registry.get(str(ps_label))
        if cur is not None and cur[1] == "user":
            return cur[0]
        _a2a_strategy_registry[str(ps_label)] = (s, "runtime")
    return s


def alltoall_strategy_for(ps_label, default=""):
    """Effective alltoall strategy of a process set: the registry's entry,
    else ``default`` (``hier_qcross`` under
    ``HOROVOD_HIERARCHICAL_ALLTOALL``)."""
    with _wire_lock:
        v = _a2a_strategy_registry.get(str(ps_label))
    return (default or "") if v is None or not v[0] else v[0]


def alltoall_strategy_pinned():
    """True when any process set has an alltoall strategy entry (the eager
    route's fast exit when the tier is disarmed everywhere)."""
    with _wire_lock:
        return bool(_a2a_strategy_registry)


def set_alltoall_cross_dtype(dtype, ps_label="global"):
    """Pin the wire of the hierarchical alltoall's cross-slice leg for one
    process set ('' restores the config default)."""
    return set_wire_dtype(dtype, f"a2a:{ps_label}", tier="dcn")


def runtime_sync_alltoall_cross_dtype(dtype, ps_label="global"):
    """A runtime's adoption of the alltoall cross wire; defers to a user
    pin."""
    return runtime_sync_wire_dtype(dtype, f"a2a:{ps_label}", tier="dcn")


def alltoall_cross_wire_for(ps_label, config):
    """Effective wire of the hierarchical alltoall's cross-slice leg: the
    ``a2a:<ps>@dcn`` entry, else ``HOROVOD_ALLTOALL_CROSS_DTYPE``. Never
    the allreduce's DCN wire: an alltoall moves activations without error
    feedback, so quantizing them is an explicit choice."""
    default = getattr(config, "alltoall_cross_dtype", "")
    return wire_dtype_for(f"a2a:{ps_label}", default, tier="dcn")


# ----------------------------------------------------------------------------
# One-shot per-call wire request (the Compression.int8 route: compress()
# arms it, the allreduce enqueue right after consumes it; read and clear,
# so it never leaks past one call).
# ----------------------------------------------------------------------------

_tls = threading.local()


def request_wire_once(dtype):
    _tls.once = dtype


def consume_wire_request():
    v = getattr(_tls, "once", None)
    _tls.once = None
    return v


# ----------------------------------------------------------------------------
# Wire-byte accounting (the JAX package's integer formulas).
# ----------------------------------------------------------------------------

def exchange_leg_bytes(per_rank_elems, n):
    """Bytes on the wire for ONE leg of the block-scaled exchange over
    ``n`` ranks of a ``per_rank_elems``-element buffer: the 1-byte payload
    plus the fp32 block scales, padding to n×BLOCK included."""
    per_rank_elems = int(per_rank_elems)
    n = max(int(n), 1)
    padded = -(-per_rank_elems // (n * BLOCK)) * n * BLOCK
    blocks = padded // BLOCK
    return n * (padded + blocks * 4)


def exchange_wire_bytes(per_rank_elems, n):
    """Bytes on the wire for one block-scaled exchange: both legs."""
    return 2 * exchange_leg_bytes(per_rank_elems, n)


def quantized_eligible(total_per_rank_elems, n, all_float, sum_or_avg):
    """Only float Sum/Average payloads of at least one BLOCK per destination
    rank ride the exchange: below that the n×BLOCK padding inflates the
    wire and the exact collective moves fewer bytes."""
    return bool(all_float and sum_or_avg
                and int(total_per_rank_elems) >= max(int(n), 1) * BLOCK)


def ring_dcn_fraction(members, slice_size):
    """Fraction of a rank-ordered ring's hops that cross a slice boundary
    (wraparound included)."""
    m = len(members)
    if m <= 1:
        return 0.0
    crossings = sum(
        slice_of_rank(members[i], slice_size)
        != slice_of_rank(members[(i + 1) % m], slice_size)
        for i in range(m))
    return crossings / m


def a2a_dcn_fraction(members, slice_size):
    """Fraction of all-to-all destination rows that land in a foreign
    slice."""
    m = len(members)
    if m <= 1:
        return 0.0
    counts = {}
    for r in members:
        s = slice_of_rank(r, slice_size)
        counts[s] = counts.get(s, 0) + 1
    same = sum(c * c for c in counts.values())
    return (m * m - same) / (m * m)


def split_tiers(nbytes, frac_dcn):
    """``{"ici": b, "dcn": b}`` for one leg's bytes at a DCN fraction
    (round half to even on the DCN share)."""
    nbytes = int(nbytes)
    dcn = int(round(nbytes * frac_dcn))
    return {"ici": nbytes - dcn, "dcn": dcn}


def hierarchical_wire_bytes(per_rank_elems, n, num_slices, itemsize,
                            cross_wire=""):
    """Per-tier bytes of ONE 2-level hierarchical allreduce (local RS ->
    cross-slice allreduce -> local AG) of a ``per_rank_elems``-element
    buffer over ``n`` ranks in ``num_slices`` slices. Returns ``{"ici",
    "dcn", "cross_label", "shard_elems", "local_size", "num_slices"}``;
    ``cross_label`` is None when the cross leg stays exact."""
    n = max(int(n), 1)
    num_slices = max(int(num_slices), 1)
    itemsize = max(int(itemsize), 1)
    local = max(n // num_slices, 1)
    shard = -(-int(per_rank_elems) // local)         # ceil
    padded = shard * local
    ici = 2 * n * padded * itemsize                  # local RS + local AG
    label = quantized_label(cross_wire)
    if label is not None and not quantized_eligible(
            shard, num_slices, True, True):
        label = None
    if label is not None:
        dcn = local * exchange_wire_bytes(shard, num_slices)
    else:
        dcn = 2 * n * shard * itemsize               # exact cross RS+AG
    return {"ici": ici, "dcn": dcn, "cross_label": label,
            "shard_elems": shard, "local_size": local,
            "num_slices": num_slices}


def hierarchical_a2a_bytes(per_rank_elems, n, num_slices, itemsize,
                           cross_wire=""):
    """Per-tier bytes of ONE 2-level hierarchical alltoall (slice-local a2a
    -> cross-slice a2a on the per-tier wire). Returns ``{"local", "cross",
    "cross_tiers", "ici", "dcn", "cross_label", "local_size",
    "num_slices"}``."""
    n = max(int(n), 1)
    num_slices = max(int(num_slices), 1)
    itemsize = max(int(itemsize), 1)
    local_size = max(n // num_slices, 1)
    per = int(per_rank_elems)
    local_leg = n * per * itemsize
    label = quantized_label(cross_wire)
    if label is not None and not quantized_eligible(
            per, num_slices, True, True):
        label = None
    if label is not None:
        cross_leg = local_size * exchange_leg_bytes(per, num_slices)
    else:
        cross_leg = n * per * itemsize
    frac = (num_slices - 1) / num_slices if num_slices > 1 else 0.0
    cross_tiers = split_tiers(cross_leg, frac)
    return {"local": local_leg, "cross": cross_leg,
            "cross_tiers": cross_tiers,
            "ici": local_leg + cross_tiers["ici"],
            "dcn": cross_tiers["dcn"],
            "cross_label": label, "local_size": local_size,
            "num_slices": num_slices}


def allreduce_wire_bytes(payload_bytes, itemsize, n, wire):
    """Bytes on the wire of one allreduce of a ``payload_bytes`` payload
    (the JAX package's global rank-major payload: n ranks' buffers).
    Full-precision and cast wires count the ring's reduce-scatter and
    all-gather (every element twice, at the wire's width); quantized wires
    the exchange's exact bytes."""
    itemsize = max(int(itemsize), 1)
    elems = int(payload_bytes) // itemsize
    if quantized_label(wire):
        return exchange_wire_bytes(max(elems // max(int(n), 1), 0), n)
    width = {"float16": 2, "bfloat16": 2}.get(wire or "", itemsize)
    return 2 * elems * width
