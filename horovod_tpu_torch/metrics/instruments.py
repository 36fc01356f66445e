"""The framework's series catalogue + recording helpers.

Port of the JAX package's ``metrics/instruments.py``, whole: every series
keeps JAX's name, labels, help text, units and buckets, so both packages
render the same ``/metrics`` text for the same observations. Every
instrumentation point of the port goes through one of the ``record_*``
functions here: the eager collectives and fused buckets
(``ops/collective_ops.py::_dispatch_op``), the fusion runtime
(``ops/fusion.py``), the elastic loop, the goodput ledger, the step
profiler and its watchdog, the serving engine and the SLO engine. All
helpers are no-ops when metrics are disabled (``HOROVOD_METRICS=0``) and
never raise into the hot path.

``record_fusion_kv`` counts the fusion boundaries' store RPCs (the
``TCPStore`` the process group serves, through ``negotiation.record_fusion_kv``),
``record_negotiation`` the negotiation rounds, ``record_http_kv`` and
``record_kv_retry`` the launcher KV client's RPCs and retries,
``record_chaos`` the chaos injections and ``record_telemetry_rpc`` the
telemetry agent's rounds. The autopilot's two series keep their JAX name
and help text and read zero until the autopilot is ported (ROADMAP A17's
second half).
Two have no counterpart, by design: ``record_plan_cache`` (the port's eager
dispatch compiles no plan to cache) and ``record_compile_cache`` (it counts
XLA's persistent compilation cache; the port compiles no XLA program, its
kernels are built by nvcc once per checkout).

Catalogue (names shown without the ``HOROVOD_METRICS_PREFIX``, default
``horovod``):

- ``collective_ops_total{op,process_set}``          dispatches (counter)
- ``collective_bytes_total{op,process_set}``        payload bytes (counter)
- ``collective_latency_seconds{op}``                dispatch latency (histogram)
- ``collective_errors_total{op}``                   failed dispatches (counter)
- ``fusion_flushes_total``                          bucket flushes (counter)
- ``fusion_flush_tensors``                          tensors per flush (histogram)
- ``fusion_flush_bytes``                            bytes per flush (histogram)
- ``fusion_fill_ratio``                             flushed/threshold (histogram)
- ``fusion_boundary_outcomes_total{outcome}``       applied|deferred (counter)
- ``fusion_kv_rpcs_total{kind}``                    boundary KV set/get (counter)
- ``dispatch_plan_events_total{event}``             plan cache hit|miss (counter)
- ``compile_cache_events_total{event}``             XLA persistent-cache
  request|hit (counter; armed by ``HOROVOD_COMPILE_CACHE_DIR``)
- ``negotiation_rounds_total``                      exchange() rounds (counter)
- ``control_plane_rpcs_total{transport,kind}``      every KV RPC (counter)
- ``control_plane_payload_bytes_total{transport}``  KV payload bytes (counter)
- ``elastic_events_total{event}``                   rendezvous/reset/... (counter)
- ``elastic_recovery_seconds{cause}``               failure detection →
  training re-entry (histogram; cause=failure|host_update)
- ``stall_events_total{kind}``                      warning|shutdown (counter)
- ``kv_client_retries_total``                       HTTP-KV client retries (counter)
- ``chaos_injections_total{site,kind}``             chaos faults fired (counter)
- ``step_time_seconds``                             step wall time from the
  step profiler's marker-to-marker windows (histogram)
- ``step_profiler_events_total{kind}``              watchdog findings:
  straggler|regression (counter; horovod_tpu/profile)
- ``wire_bytes_total{dtype,tier}``                  estimated bytes on the
  wire per collective at the effective wire dtype, split per link tier
  (tier=ici|dcn — ops/wire.py accounting; allreduces count both RS+AG
  legs; the flat default split books the ring/a2a slice-boundary
  fraction to dcn, hierarchical dispatches book each leg's tier exactly)
- ``wire_compression_events_total{path,dtype}``     dispatches that
  actually compressed the wire (path=eager|fused|jit; counter)
- ``serving_requests_total{event}``                 request lifecycle
  (event=submitted|admitted|completed|requeued|rejected; counter)
- ``serving_ttft_seconds``                          submit → first
  generated token (histogram; the SLO p50/p99 source)
- ``serving_token_latency_seconds``                 decode-step wall time
  = inter-token latency for every active request (histogram)
- ``serving_tokens_total``                          generated tokens
  (counter; rate() = tokens/sec)
- ``serving_queue_depth``                           admission queue depth
  (gauge)
- ``serving_batch_fill_ratio``                      active slots / total
  slots per decode step (histogram; low values mean the fleet is
  over-provisioned or admission is starved)
- ``slo_burn_rate{objective}``                      rolling-window SLO
  error-budget burn (objective=ttft_p99|tps; gauge — 0 inside the SLO,
  1.0 = consuming the budget exactly, > 1 = burning; computed by
  horovod_tpu/telemetry/slo.py from the declared
  HOROVOD_SLO_TTFT_P99_MS / HOROVOD_SLO_TPS objectives)
- ``autopilot_decisions_total{lever,outcome}``      autopilot control
  decisions (lever=tuner|overlap|cross_wire|remediate; counter)
- ``autopilot_remediations_total{cause,outcome}``   autopilot-initiated
  removals (cause=dead|stalled|straggler; outcome=requested|applied|
  rejected_*; counter)
"""

import os
import threading
import time

from horovod_tpu_torch.flight import recorder as _flight
from horovod_tpu_torch.metrics.registry import MetricsRegistry, exponential_buckets

_enabled = os.environ.get("HOROVOD_METRICS", "1").lower() \
    not in ("0", "false", "no", "off")

REGISTRY = MetricsRegistry(
    prefix=os.environ.get("HOROVOD_METRICS_PREFIX", "horovod"))


def get_registry():
    return REGISTRY


def enabled():
    return _enabled


def set_enabled(value):
    global _enabled
    _enabled = bool(value)


def set_prefix(prefix):
    REGISTRY.prefix = prefix


# --- the catalogue (created eagerly so HELP/TYPE lines are always part of
# the exposition, observed or not) --------------------------------------

_LAT_BUCKETS = exponential_buckets(1e-5, 2.0, 22)          # 10us .. ~21s
_BYTE_BUCKETS = exponential_buckets(1024, 4.0, 14)         # 1KiB .. 64GiB
_COUNT_BUCKETS = exponential_buckets(1, 2.0, 13)           # 1 .. 4096
_RATIO_BUCKETS = exponential_buckets(1.0 / 64, 2.0, 9)     # ~0.016 .. 4

COLLECTIVE_OPS = REGISTRY.counter(
    "collective_ops_total",
    "Eager collective dispatches (sync ops and fused async flush buckets).",
    ("op", "process_set"))
COLLECTIVE_BYTES = REGISTRY.counter(
    "collective_bytes_total",
    "Bytes moved by eager collectives (global rank-major stacked layout).",
    ("op", "process_set"))
COLLECTIVE_LATENCY = REGISTRY.histogram(
    "collective_latency_seconds",
    "Host-side dispatch latency of eager collectives (enqueue to program "
    "return; device execution is async beyond it).",
    ("op",), buckets=_LAT_BUCKETS)
COLLECTIVE_ERRORS = REGISTRY.counter(
    "collective_errors_total",
    "Eager collective dispatches that raised.",
    ("op",))
FUSION_FLUSHES = REGISTRY.counter(
    "fusion_flushes_total",
    "Fusion-runtime bucket flushes dispatched by this process.")
FUSION_FLUSH_TENSORS = REGISTRY.histogram(
    "fusion_flush_tensors",
    "Tensors per fusion flush (bucket size).",
    buckets=_COUNT_BUCKETS)
FUSION_FLUSH_BYTES = REGISTRY.histogram(
    "fusion_flush_bytes",
    "Bytes per fusion flush.",
    buckets=_BYTE_BUCKETS)
FUSION_FILL_RATIO = REGISTRY.histogram(
    "fusion_fill_ratio",
    "Flushed bytes / fusion threshold (1.0 = a full bucket; small values "
    "mean cycle/explicit flushes dominate threshold flushes).",
    buckets=_RATIO_BUCKETS)
FUSION_BOUNDARY_OUTCOMES = REGISTRY.counter(
    "fusion_boundary_outcomes_total",
    "Follower handling of coordinator flush boundaries: applied "
    "immediately vs deferred (boundary ahead of the local enqueue stream).",
    ("outcome",))
FUSION_KV_RPCS = REGISTRY.counter(
    "fusion_kv_rpcs_total",
    "Coordination-service KV RPCs issued by the fusion boundary "
    "publish/consume path (the ADVICE.md hot-poll class shows up here).",
    ("kind",))
DISPATCH_PLAN_EVENTS = REGISTRY.counter(
    "dispatch_plan_events_total",
    "Eager dispatch-plan cache outcomes (event=hit|miss|invalidate). A "
    "steady-state training loop is all hits; misses mean new signatures "
    "(or churn past the plan-cache cap).",
    ("event",))
COMPILE_CACHE_EVENTS = REGISTRY.counter(
    "compile_cache_events_total",
    "JAX persistent-compilation-cache outcomes (event=request|hit). "
    "Armed when HOROVOD_COMPILE_CACHE_DIR wires the cache up; "
    "request-minus-hit is the fresh-XLA-compile count.",
    ("event",))
NEGOTIATION_ROUNDS = REGISTRY.counter(
    "negotiation_rounds_total",
    "Host-side negotiation.exchange() rounds (dynamic-shape collectives, "
    "join mode, order checks).")
CONTROL_PLANE_RPCS = REGISTRY.counter(
    "control_plane_rpcs_total",
    "Control-plane KV RPCs by transport (coord = jax.distributed "
    "coordination service, http = runner HTTP KV store) and verb.",
    ("transport", "kind"))
CONTROL_PLANE_PAYLOAD = REGISTRY.counter(
    "control_plane_payload_bytes_total",
    "Serialized payload bytes written to the control plane.",
    ("transport",))
ELASTIC_EVENTS = REGISTRY.counter(
    "elastic_events_total",
    "Elastic lifecycle events: rank_ready, rendezvous, reset, restore, "
    "host_update, sync, abort (watchdog severed in-flight collectives).",
    ("event",))
ELASTIC_RECOVERY = REGISTRY.histogram(
    "elastic_recovery_seconds",
    "Elastic recovery latency: failure detection (HorovodInternalError / "
    "HostsUpdatedInterrupt caught by the @elastic.run wrapper) to re-entry "
    "into the training function at the new membership "
    "(cause=failure|host_update).",
    ("cause",), buckets=exponential_buckets(0.01, 2.0, 16))  # 10ms..~5min
STALL_EVENTS = REGISTRY.counter(
    "stall_events_total",
    "Stall-inspector findings (kind=warning|shutdown).",
    ("kind",))
GOODPUT_SECONDS = REGISTRY.counter(
    "goodput_seconds_total",
    "Wall-clock seconds decomposed by the goodput ledger "
    "(horovod_tpu/goodput): category=productive_compute plus the named "
    "badput categories (init_compile, rendezvous_recovery, "
    "checkpoint_commit, straggler_wait, cross_wait_comm, autopilot_trial, "
    "wedge_idle). Conservation contract: the categories sum to the "
    "rank's measured wall time within 1%, so "
    "rate(goodput_seconds_total{category='productive_compute'}) over the "
    "sum of all categories IS the job's goodput ratio.",
    ("category",))
KV_CLIENT_RETRIES = REGISTRY.counter(
    "kv_client_retries_total",
    "Runner HTTP-KV client attempts that failed transiently and were "
    "retried (bounded, jittered exponential backoff — HOROVOD_KV_RETRIES).")
CHAOS_INJECTIONS = REGISTRY.counter(
    "chaos_injections_total",
    "Faults fired by the chaos injection runtime (horovod_tpu/chaos; "
    "always zero unless a HOROVOD_CHAOS_PLAN is armed).",
    ("site", "kind"))
STEP_TIME = REGISTRY.histogram(
    "step_time_seconds",
    "Training-step wall time measured by the step profiler's "
    "marker-to-marker windows (hvd.step_marker / optimizer wrapper / "
    "elastic State.commit).",
    buckets=exponential_buckets(1e-4, 2.0, 22))        # 100us .. ~3.5min
STEP_PROFILER_EVENTS = REGISTRY.counter(
    "step_profiler_events_total",
    "Online watchdog findings from the step profiler "
    "(kind=straggler|regression; horovod_tpu/profile/watchdog.py).",
    ("kind",))
WIRE_BYTES = REGISTRY.counter(
    "wire_bytes_total",
    "Estimated bytes-on-wire per collective at the effective wire dtype, "
    "split per link tier (tier=ici|dcn). ops/wire.py accounting: "
    "allreduce counts both internal legs — reduce-scatter + all-gather — "
    "at the wire width; quantized wires count both 1-byte legs plus fp32 "
    "block scales and padding. Flat dispatches book the slice-boundary "
    "ring/a2a fraction of their bytes to dcn (the static cost model's "
    "tier-split rule, shared via wire.ring_dcn_fraction); hierarchical "
    "dispatches book each decomposed leg's tier exactly. The "
    "int8-vs-float32 ratio here is the provable off-chip savings; the "
    "dcn-vs-flat ratio is the hierarchical tier's.",
    ("dtype", "tier"))
WIRE_COMPRESSION_EVENTS = REGISTRY.counter(
    "wire_compression_events_total",
    "Collective dispatches whose wire was actually compressed "
    "(path=eager|fused|jit, dtype=int8|fp8|float16|bfloat16). jit-path "
    "events are recorded at trace time: once per compiled program, not "
    "per execution.",
    ("path", "dtype"))
SERVING_REQUESTS = REGISTRY.counter(
    "serving_requests_total",
    "Serving-engine request lifecycle events (horovod_tpu/serving): "
    "submitted|admitted|completed|requeued (re-queued from the last "
    "committed token after an elastic disruption)|rejected (queue full).",
    ("event",))
SERVING_TTFT = REGISTRY.histogram(
    "serving_ttft_seconds",
    "Time-to-first-token per request: submit() to the first generated "
    "token's commit (includes queue wait + prefill — the user-facing "
    "p50/p99 SLO).",
    buckets=exponential_buckets(1e-4, 2.0, 22))        # 100us .. ~3.5min
SERVING_TOKEN_LATENCY = REGISTRY.histogram(
    "serving_token_latency_seconds",
    "Decode-step wall time — the inter-token latency every active "
    "request observed on that step (admission/prefill excluded; they "
    "land in serving_ttft_seconds).",
    buckets=exponential_buckets(1e-5, 2.0, 22))        # 10us .. ~21s
SERVING_TOKENS = REGISTRY.counter(
    "serving_tokens_total",
    "Generated tokens committed by the serving engine (rate() is the "
    "fleet tokens/sec).")
SERVING_QUEUE_DEPTH = REGISTRY.gauge(
    "serving_queue_depth",
    "Requests waiting for a slot in the serving admission queue "
    "(sampled at every submit/admit; the first thing to read when "
    "requests time out — docs/troubleshooting.md).")
SLO_BURN = REGISTRY.gauge(
    "slo_burn_rate",
    "Rolling-window SLO error-budget burn per declared objective "
    "(objective=ttft_p99|tps; horovod_tpu/telemetry/slo.py). 0 = inside "
    "the SLO, 1.0 = consuming the error budget exactly, > 1 = burning "
    "it — the admission/scale-up signal the autopilot SignalFrame and "
    "`telemetry top --serving` read.",
    ("objective",))
SERVING_FILL = REGISTRY.histogram(
    "serving_batch_fill_ratio",
    "Active slots / total slots at each decode step (1.0 = the "
    "continuous batch is full; persistently low fill under a deep queue "
    "means admission is starved — a scheduler bug).",
    buckets=_RATIO_BUCKETS)
AUTOPILOT_DECISIONS = REGISTRY.counter(
    "autopilot_decisions_total",
    "Autopilot controller decisions per lever and outcome "
    "(horovod_tpu/autopilot: lever=tuner|overlap|cross_wire|remediate; "
    "outcome=adopt|hold|frozen|reverted|no_signal|baseline|"
    "drift_detected|trial|adopted|requested|unreachable). Every decision "
    "also lands in the flight ring as an autopilot_decision event.",
    ("lever", "outcome"))
AUTOPILOT_REMEDIATIONS = REGISTRY.counter(
    "autopilot_remediations_total",
    "Autopilot remediation requests and their driver-side outcomes "
    "(cause=dead|stalled|straggler; outcome=requested|no_driver|"
    "publish_failed on the coordinator, applied|rejected_floor|"
    "rejected_rate|rejected_unknown_host on the driver arm).",
    ("cause", "outcome"))
TELEMETRY_RPCS = REGISTRY.counter(
    "telemetry_rpcs_total",
    "Telemetry-plane KV RPCs by phase (horovod_tpu/telemetry): the "
    "aggregation round's beacon_put|probe_get|slice_get|slice_put|"
    "job_get|job_put — whose scaling contract is job_get per round == "
    "slice count, not world size (TestTelemetryScaling) — plus read_get, "
    "the demand-driven /cluster/* endpoint reads that scale with scrape "
    "rate instead.",
    ("phase",))


# --- recording helpers (the stack's API) --------------------------------

def record_collective(op, nbytes, process_set="global"):
    """One eager collective dispatch attempt: count + bytes (recorded at
    entry; failures still count as attempts)."""
    if not _enabled:
        return
    COLLECTIVE_OPS.labels(op, process_set).inc()
    if nbytes:
        COLLECTIVE_BYTES.labels(op, process_set).inc(float(nbytes))


def record_collective_latency(op, seconds):
    """Dispatch latency of one SUCCESSFUL eager collective."""
    if not _enabled:
        return
    COLLECTIVE_LATENCY.labels(op).observe(seconds)


def record_collective_error(op):
    if not _enabled:
        return
    COLLECTIVE_ERRORS.labels(op).inc()


def record_fusion_flush(n_tensors, nbytes, threshold):
    if not _enabled:
        return
    FUSION_FLUSHES.inc()
    FUSION_FLUSH_TENSORS.observe(n_tensors)
    FUSION_FLUSH_BYTES.observe(nbytes)
    if threshold:
        FUSION_FILL_RATIO.observe(nbytes / float(threshold))


def record_boundary(outcome):
    if not _enabled:
        return
    FUSION_BOUNDARY_OUTCOMES.labels(outcome).inc()


def record_fusion_kv(sets=0, gets=0, payload_bytes=0):
    if not _enabled:
        return
    if sets:
        FUSION_KV_RPCS.labels("set").inc(sets)
        CONTROL_PLANE_RPCS.labels("coord", "set").inc(sets)
    if gets:
        FUSION_KV_RPCS.labels("get").inc(gets)
        CONTROL_PLANE_RPCS.labels("coord", "get").inc(gets)
    if payload_bytes:
        CONTROL_PLANE_PAYLOAD.labels("coord").inc(payload_bytes)


# Default flat-schedule DCN fractions (per schedule: ring / a2a),
# resolved lazily from the live slice layout and cached (reset by
# basics.shutdown — an elastic resize must never replay a stale slice
# split). None = not yet resolved.
_tier_frac = None


def _default_dcn_fraction(sched="ring"):
    """Slice-boundary DCN fraction of the live topology for one flat
    schedule — the static cost model's rules for flat dispatches, shared
    via wire.ring_dcn_fraction / a2a_dcn_fraction: ``S/n`` for ring legs,
    ``1 - L/n`` for all-to-all legs when a slice hierarchy exists, else 0
    (single-slice worlds book everything to ici)."""
    global _tier_frac
    if _tier_frac is None:
        fracs = {"ring": 0.0, "a2a": 0.0}
        try:
            from horovod_tpu_torch.common import basics, topology
            from horovod_tpu_torch.ops import wire as _wire
            if basics.is_initialized():
                topo = basics._get_state().topology
                size = topo.size
                slices, slice_size = topology.slice_layout(
                    size, topo.num_slices if topo.num_slices > 1 else None)
                if slices > 1:
                    members = list(range(size))
                    fracs = {
                        "ring": _wire.ring_dcn_fraction(members,
                                                        slice_size),
                        "a2a": _wire.a2a_dcn_fraction(members,
                                                      slice_size)}
        except Exception:  # noqa: BLE001 — accounting must never break
            fracs = {"ring": 0.0, "a2a": 0.0}   # a dispatch
        _tier_frac = fracs
    return _tier_frac.get(sched, _tier_frac["ring"])


def reset_tier_split():
    """Forget the cached flat-schedule tier split (topology changed)."""
    global _tier_frac
    _tier_frac = None


def record_wire(path, dtype, nbytes, compressed=False, tiers=None,
                sched="ring"):
    """Wire accounting for one collective dispatch: bytes at the effective
    wire dtype, plus a compression event when the wire was actually
    narrowed (quantized exchange or 16-bit cast). ``tiers`` (a
    ``{"ici": b, "dcn": b}`` dict) books an explicit per-tier split (the
    hierarchical dispatch paths and the quantized exchange's per-leg
    schedules pass it); without it the flat split of the live slice
    layout at this leg's ``sched`` (``"ring"``/``"a2a"``) applies —
    all-ici on single-slice worlds."""
    if not _enabled or not dtype:
        return
    if nbytes and tiers is None:
        from horovod_tpu_torch.ops import wire as _wire
        tiers = _wire.split_tiers(nbytes, _default_dcn_fraction(sched))
    if tiers:
        for tier, b in tiers.items():
            if b:
                WIRE_BYTES.labels(str(dtype), tier).inc(float(b))
    if compressed:
        WIRE_COMPRESSION_EVENTS.labels(path, str(dtype)).inc()


def record_plan_cache(event):
    """One dispatch-plan cache outcome (event=hit|miss|invalidate)."""
    if not _enabled:
        return
    DISPATCH_PLAN_EVENTS.labels(event).inc()


def record_compile_cache(event):
    """One persistent-compilation-cache outcome (event=request|hit)."""
    if not _enabled:
        return
    COMPILE_CACHE_EVENTS.labels(event).inc()


def record_negotiation(gets, payload_bytes, sets=1, tier_gets=None):
    """One negotiation.exchange() round: ``sets`` publishes + ``gets``
    peer-read RPC attempts. Hierarchical rounds additionally pass
    ``tier_gets`` ({"local","cross","fanback"}) so the scrape shows the
    per-tier fan-out the slice-leader decomposition is supposed to bound
    (kind=neg_get_<tier>)."""
    if not _enabled:
        return
    NEGOTIATION_ROUNDS.inc()
    CONTROL_PLANE_RPCS.labels("coord", "set").inc(max(int(sets), 1))
    if gets:
        CONTROL_PLANE_RPCS.labels("coord", "get").inc(gets)
    for tier, n in (tier_gets or {}).items():
        if n:
            CONTROL_PLANE_RPCS.labels("coord", f"neg_get_{tier}").inc(n)
    if payload_bytes:
        CONTROL_PLANE_PAYLOAD.labels("coord").inc(payload_bytes)


def record_http_kv(kind, payload_bytes=0):
    """One runner HTTP-KV client RPC (kind=get|put|delete|wait)."""
    if not _enabled:
        return
    CONTROL_PLANE_RPCS.labels("http", kind).inc()
    if payload_bytes:
        CONTROL_PLANE_PAYLOAD.labels("http").inc(payload_bytes)


def record_elastic_event(event):
    # Flight ring BEFORE the metrics gate: elastic transitions are exactly
    # the events a post-mortem needs, and the recorder has its own switch.
    if _flight.armed:
        _flight.record_event("elastic", what=event)
    if not _enabled:
        return
    ELASTIC_EVENTS.labels(event).inc()


def record_elastic_recovery(cause, seconds):
    """One completed elastic recovery: detection → training re-entry."""
    if _flight.armed:
        _flight.record_event("elastic", what=f"recovered_{cause}",
                             dur=seconds)
    if not _enabled:
        return
    ELASTIC_RECOVERY.labels(cause).observe(seconds)


def record_goodput_seconds(category, seconds):
    """Delta export from the goodput ledger (horovod_tpu/goodput/ledger
    throttles and computes the per-category deltas; counters only grow)."""
    if not _enabled:
        return
    GOODPUT_SECONDS.labels(category).inc(float(seconds))


def record_kv_retry():
    if not _enabled:
        return
    KV_CLIENT_RETRIES.inc()


def record_chaos(site, kind):
    """One chaos fault fired. Recorded even though injections are test
    machinery: the counter is how a soak (or an operator reading a scrape)
    correlates observed symptoms with injected causes."""
    if not _enabled:
        return
    CHAOS_INJECTIONS.labels(site, kind).inc()


def record_step(seconds):
    """One completed step-profiler window (wall seconds)."""
    if not _enabled:
        return
    STEP_TIME.observe(seconds)


def record_profiler_event(kind):
    """One watchdog finding (kind=straggler|regression)."""
    if not _enabled:
        return
    STEP_PROFILER_EVENTS.labels(kind).inc()


def record_profiler_kv(sets=0, gets=0):
    """Watchdog cross-rank publish traffic on the coordination service —
    reported under control_plane_rpcs_total like every other KV user."""
    if not _enabled:
        return
    if sets:
        CONTROL_PLANE_RPCS.labels("coord", "prof_set").inc(sets)
    if gets:
        CONTROL_PLANE_RPCS.labels("coord", "prof_get").inc(gets)


def record_serving_request(event):
    """One serving request lifecycle event (event=submitted|admitted|
    completed|requeued|rejected). Requeues also land in the flight ring:
    they are exactly the events a zero-drop post-mortem needs."""
    if _flight.armed and event in ("requeued", "rejected"):
        _flight.record_event("serving", what=event)
    if not _enabled:
        return
    SERVING_REQUESTS.labels(event).inc()


def record_serving_ttft(seconds):
    if not _enabled:
        return
    SERVING_TTFT.observe(seconds)


def record_serving_step(seconds, active, slots, tokens=0):
    """One serving decode step: inter-token latency, fill ratio, and the
    tokens it committed."""
    if not _enabled:
        return
    SERVING_TOKEN_LATENCY.observe(seconds)
    if slots:
        SERVING_FILL.observe(active / float(slots))
    if tokens:
        SERVING_TOKENS.inc(tokens)


def record_serving_queue(depth):
    if not _enabled:
        return
    SERVING_QUEUE_DEPTH.set(depth)


def record_slo_burn(objective, burn):
    """Current burn rate of one declared SLO objective (set by
    telemetry/slo.py whenever a window is recomputed)."""
    if not _enabled:
        return
    SLO_BURN.labels(objective).set(float(burn))


def record_autopilot_decision(lever, outcome):
    """One autopilot controller decision (horovod_tpu/autopilot)."""
    if not _enabled:
        return
    AUTOPILOT_DECISIONS.labels(lever, outcome).inc()


def record_autopilot_remediation(cause, outcome):
    """One autopilot remediation lifecycle event (request or driver-arm
    outcome). The flight-ring mirror is recorded at the call sites —
    they carry the rank/host detail this counter aggregates away."""
    if not _enabled:
        return
    AUTOPILOT_REMEDIATIONS.labels(cause, outcome).inc()


def record_telemetry_rpc(phase, n=1):
    """One (or ``n``) telemetry-plane KV RPCs in the given aggregation
    phase (horovod_tpu/telemetry/aggregator.py)."""
    if not _enabled:
        return
    TELEMETRY_RPCS.labels(phase).inc(n)


def record_stall(kind):
    if _flight.armed:
        _flight.record_event("stall", what=kind)
    if not _enabled:
        return
    STALL_EVENTS.labels(kind).inc()


# --- timeline integration ----------------------------------------------
#
# Registry values double as Chrome-trace COUNTER events ("ph": "C") so the
# aggregate series land in the same chrome://tracing file as the op spans
# (the reference's timeline has no counter tracks at all). Emission is
# throttled: the fusion runtime calls maybe_emit_timeline_counters() after
# every flush, which at kHz flush rates would otherwise snapshot the whole
# registry per flush.

_TL_MIN_INTERVAL_S = 0.1
_tl_last = 0.0
_tl_lock = threading.Lock()


def emit_timeline_counters(timeline):
    """Dump every series' current value into ``timeline`` as counter
    events. Histograms emit their _count and _sum. No-op when metrics are
    disabled — an all-zero dump would pollute the trace of a user who
    explicitly turned the registry off."""
    if timeline is None or not _enabled:
        return 0
    n = 0
    for name, fam in REGISTRY.snapshot().items():
        for s in fam["series"]:
            lab = ",".join(f"{k}={v}" for k, v in s["labels"].items())
            label = f"{name}{{{lab}}}" if lab else name
            if fam["type"] == "histogram":
                timeline.record_counter(label + "_count", s["count"])
                timeline.record_counter(label + "_sum", s["sum"])
                n += 2
            else:
                timeline.record_counter(label, s["value"])
                n += 1
    return n


def maybe_emit_timeline_counters(timeline):
    """Throttled emit_timeline_counters (at most once per 100 ms)."""
    global _tl_last
    if timeline is None or not _enabled:
        return 0
    now = time.monotonic()
    with _tl_lock:
        if now - _tl_last < _TL_MIN_INTERVAL_S:
            return 0
        _tl_last = now
    return emit_timeline_counters(timeline)
