"""Runtime configuration knobs read from ``HOROVOD_*`` environment variables.

Port of the JAX package's ``common/config.py``, cut to the fields the
data-parallel training path reads: the fusion threshold, the cycle time,
the join protocol's switch (``HOROVOD_JOIN_MODE``), the launcher's
rank/size/coordinator contract (``runner/launch.py``
``build_worker_env``: HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/
CROSS_SIZE and HOROVOD_COORDINATOR_ADDR/PORT, HOROVOD_START_TIMEOUT;
with none of them, the MPI/PMI/Slurm env of a process mpirun started) and
the elastic knobs (``HOROVOD_ELASTIC``, ``HOROVOD_ELASTIC_TIMEOUT``,
``HOROVOD_BLACKLIST_COOLDOWN_RANGE``, ``HOROVOD_HOST_KEY``,
``HOROVOD_ELASTIC_INIT_VERSION``), the wire knobs
(``HOROVOD_WIRE_DTYPE``, ``HOROVOD_WIRE_DTYPE_DCN``,
``HOROVOD_WIRE_ERROR_FEEDBACK``) and the hierarchical tiers' knobs
(``HOROVOD_HIERARCHICAL_ALLREDUCE``, ``HOROVOD_HIERARCHICAL_ALLGATHER``,
``HOROVOD_TORUS_ALLREDUCE``, ``HOROVOD_HIERARCHICAL_DISPATCH``,
``HOROVOD_CROSS_OVERLAP``, ``HOROVOD_MESH_SLICES``) with the alltoall
tier's (``HOROVOD_HIERARCHICAL_ALLTOALL``,
``HOROVOD_ALLTOALL_CROSS_DTYPE``), and the serving, tracing, SLO and
metrics knobs (``HOROVOD_SERVING*``, ``HOROVOD_TRACE*``,
``HOROVOD_SLO_*``, ``HOROVOD_METRICS*``) and the per-rank observability
planes' knobs (``HOROVOD_TIMELINE*``, ``HOROVOD_FLIGHT_*``,
``HOROVOD_STEP_PROFILER``, ``HVD_STEP_REPORT_FILE``, ``HOROVOD_PROFILE_*``,
``HOROVOD_PEAK_*``, ``HOROVOD_GOODPUT*``, ``HOROVOD_RUN_HISTORY_DIR``,
``HOROVOD_RUN_ID``), the
control plane's (``HOROVOD_STALL_CHECK_*``, ``HOROVOD_STALL_SHUTDOWN_TIME_SECONDS``,
``HOROVOD_ORDER_CHECK``, ``HOROVOD_CONTROL_PLANE``, ``HOROVOD_KV_SHARD_*``,
``HOROVOD_CONTROL_LEASE_MS``, ``HOROVOD_KV_RETRY*``, ``HOROVOD_CHAOS_*``),
the cluster telemetry plane's (``HOROVOD_TELEMETRY*``), the tuners'
(``HOROVOD_AUTOTUNE*``, ``HOROVOD_AUTOPILOT*``,
``HOROVOD_PROFILE_Z_THRESHOLD``), the scale twin's (``HOROVOD_SIM_*``) and
the logging's (``HOROVOD_LOG_LEVEL``, ``HOROVOD_LOG_HIDE_TIME``) with JAX's
defaults. Every knob declared here rides from the launcher to each worker
(``runner/launch.py::build_worker_env``), which ``python -m
horovod_tpu_torch.analysis.lint`` holds (HVL007).
"""

import dataclasses
import os


def _env_int(name, default, env=None):
    v = (os.environ if env is None else env).get(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        return default


def _env_bool(name, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.lower() in ("1", "true", "yes", "on")


def _env_float(name, default):
    v = os.environ.get(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        return default


@dataclasses.dataclass
class Config:
    # Fusion buffer threshold in bytes: a bucket of same-signature tensors is
    # reduced with one collective once it would grow past this size.
    fusion_threshold: int = 64 * 1024 * 1024
    # The fusion runtime's cycle in ms (ops/fusion.py): its debounced cycle
    # thread flushes the pending tensors after a whole cycle with no
    # enqueue; with more than one process only process 0's thread runs and
    # the others mirror its flushes. 0 turns the timer off (buckets then
    # close on the threshold and on poll/synchronize).
    cycle_time_ms: float = 1.0
    # Arms hvd.join() across processes: every collective then opens with a
    # descriptor round among its set (ops/collective_ops.py, "Join"). Set it
    # on every process or on none.
    join_mode: bool = False
    # The fusion runtime's wire (ops/wire.py): "" (full precision), the
    # cast wires "float16"/"bfloat16", or the quantized "int8"/"fp8"
    # block-scaled exchange.
    wire_dtype: str = ""
    # The wire of the torus_qcross strategy's cross-slice leg
    # (ops/fusion.py; "" inherits wire_dtype): wire.cross_wire_for's
    # default, after a per-tier registry entry.
    wire_dtype_dcn: str = ""
    # Error feedback for the quantized wire: each bucket's fp32
    # quantization error is added back before its next quantize.
    wire_error_feedback: bool = True

    # --- the hierarchical tiers (parallel/strategies.py, ops/fusion.py) ---
    # The fused buckets' allreduce strategy (reference common.h:130-132):
    # "hierarchical" (a full local allreduce, then a cross allreduce),
    # "torus" (local reduce-scatter, cross allreduce of the shard, local
    # all-gather) or, with hierarchical_dispatch, "torus_qcross" (torus with
    # the cross leg on wire_dtype_dcn). hierarchical_dispatch wins over
    # torus_allreduce, which wins over hierarchical_allreduce.
    hierarchical_allreduce: bool = False
    torus_allreduce: bool = False
    hierarchical_dispatch: bool = False
    # hvd.allgather gathers within each node first, then one block per
    # node across nodes.
    hierarchical_allgather: bool = False
    # JAX's cross-leg overlap, parsed and without effect: the port's
    # buckets run on the fusion stream and only a handle's consumer waits
    # on its bucket's event, so the overlap is there either way
    # (ops/fusion.py).
    cross_overlap: bool = True
    # The hierarchical alltoall (parallel/strategies.py::alltoall_tiered):
    # over more than one slice, an equal-splits hvd.alltoall and the MoE
    # layer's expert dispatch and combine run a slice-local leg, then one
    # cross-slice leg. Apart from the allreduce knobs on purpose: an
    # alltoall moves activations.
    hierarchical_alltoall: bool = False
    # The wire of that cross-slice leg ("" exact, "int8"/"fp8"
    # block-scaled); never inherited from wire_dtype or wire_dtype_dcn.
    alltoall_cross_dtype: str = ""
    # HOROVOD_MESH_SLICES=k: the world as k slices of size/k ranks (JAX's
    # forced slice layout); "" or 0: one slice per node.
    mesh_slices: str = ""

    # Bootstrap (reference gloo_run.py:203-214 env plumbing). -1 = unset.
    rank: int = 0
    local_rank: int = 0
    cross_rank: int = 0
    size: int = -1
    local_size: int = -1
    cross_size: int = -1
    coordinator_addr: str = ""
    coordinator_port: int = 0
    # Seconds a process waits to reach the coordinator's store and the
    # others (the launcher's --start-timeout, HOROVOD_START_TIMEOUT).
    start_timeout: float = 300.0

    # --- elastic (elastic/, runner/elastic/) ---
    # Set by the elastic driver on every worker it starts.
    elastic: bool = False
    # Seconds the elastic driver waits for --min-np slots
    # (--elastic-timeout; 0 = the launcher's --start-timeout).
    elastic_timeout: float = 0.0
    # "base,cap" seconds of a failed host's exponential cooldown
    # (--blacklist-cooldown-range; "" = 10 s doubling up to 600 s).
    blacklist_cooldown_range: str = ""
    # This worker's host in the driver's assignment rows.
    host_key: str = ""
    # The membership version this worker last initialized under.
    elastic_init_version: int = 0

    # --- autotune (autotune/; reference common.h:133-138): the fusion
    # runtime's flush-window ParameterManager on process 0, over the
    # threshold, the cycle time and the strategy/wire categoricals ---
    autotune: bool = False
    autotune_log_file: str = ""
    autotune_warmup_samples: int = 3
    autotune_steps_per_sample: int = 10
    autotune_bayes_opt_max_samples: int = 20
    autotune_gaussian_process_noise: float = 0.8

    # --- autopilot (autopilot/): the online controller on process 0,
    # closed-loop tuning over the signal plane plus straggler/dead-rank
    # remediation through the elastic driver. Opt-in: its decisions change
    # the buckets and can remove hosts.
    autopilot: bool = False
    # Decision-epoch cadence in seconds (the controller thread's tick).
    autopilot_interval: float = 10.0
    # Remediation rate limit: at most this many controller-initiated host
    # removals per rolling window (autopilot/remediate.WINDOW_S).
    autopilot_max_removals: int = 1
    # Hysteresis: a rank must be named (watchdog straggler, telemetry
    # dead/stalled) this many consecutive epochs before the controller acts.
    autopilot_hysteresis: int = 3
    # Do-not-shrink floor (0 = the elastic launch's --min-np, else 1).
    autopilot_min_world: int = 0
    # A twin-pretrained prior (python -m horovod_tpu_torch.sim --pretrain
    # writes one): the controller skips the categorical sweep and starts
    # the numeric search at the twin's best point. "" = cold start; a
    # mismatched or malformed prior is logged, never fatal.
    autopilot_prior: str = ""
    # The robust-z threshold of the controller's revert-on-regression and
    # drift checks (the step watchdog reads the same variable).
    profile_z_threshold: float = 4.0

    # --- the scale twin (sim/): its virtual control plane's latency model,
    # the base cost of one KV RPC and the cross-slice surcharge in
    # microseconds (sim/core.py::LatencyModel.from_env reads them). The
    # twin's guards assert on RPC counts; these only shape virtual times.
    sim_kv_us: float = 5.0
    sim_dcn_us: float = 50.0

    # --- serving (serving/; `hvdrun-torch --serving` sets HOROVOD_SERVING,
    # `python -m horovod_tpu_torch.serving` is the worker it launches) ---
    serving: bool = False
    # Request-frontend base port (each process binds port + local_rank,
    # like the metrics endpoint; 0 = bind a free port).
    serving_port: int = 0
    # Decode-batch slot count: the continuous batch's fixed width.
    serving_slots: int = 4
    # KV-cache capacity per slot in tokens (prompt + generation; 0 = the
    # model config's max_position_embeddings).
    serving_max_len: int = 0
    # Chunked-prefill feed width in tokens (TTFT costs ~P/chunk forwards).
    serving_prefill_chunk: int = 64
    # Admission-queue capacity (0 = unbounded). At the limit submits are
    # rejected (HTTP 503 + Retry-After) and /serving/health is saturated.
    serving_queue_limit: int = 0
    # Migrate in-flight KV caches through elastic membership changes as
    # host copies; off: in-flight requests re-queue from their last
    # committed token and re-prefill (the same token streams either way).
    serving_migrate_kv: bool = False
    # Reference-worker model selector (gpt_tiny | gpt2 | llama_tiny).
    serving_model: str = "gpt_tiny"
    # Elastic commit cadence in engine steps.
    serving_commit_steps: int = 1

    # --- request tracing and SLO burn rates (trace/, telemetry/slo.py) ---
    trace: bool = True
    # Live request traces kept per process (step traces have their own cap).
    trace_capacity: int = 256
    # Directory for per-rank trace shard dumps ("" = none): the serving
    # frontend writes trace_r<rank>.json when it stops.
    trace_dir: str = ""
    # Declared SLO objectives (0 = not declared): p99 TTFT in ms and a
    # generated-tokens/s floor, over a window of slo_window_s seconds.
    slo_ttft_p99_ms: float = 0.0
    slo_tps: float = 0.0
    slo_window_s: float = 60.0

    # --- timeline (reference common.h:117-118; timeline.py) ---
    timeline_filename: str = ""
    timeline_mark_cycles: bool = False

    # --- flight recorder (flight/): the always-on bounded event ring,
    # dumped on failure paths ---
    flight: bool = True
    # Ring capacity in events (two per collective: dispatch + complete).
    flight_capacity: int = 4096
    # Dump directory ("" = ./flight_dumps); hvdrun-torch --flight-dir
    # exports it to every worker.
    flight_dir: str = ""

    # --- step profiler (profile/) ---
    step_profiler: bool = True
    # JSONL stream of per-step records ("" = in-memory ring only);
    # rendered by `python -m horovod_tpu_torch.profile.report`.
    step_report_file: str = ""
    # "a:b" = capture a torch.profiler trace from the step-a marker to the
    # step-b marker ("" = off).
    profile_steps: str = ""
    # Capture output directory ("" = ./profile_traces).
    profile_dir: str = ""
    # Watchdog cross-rank publish cadence in steps (0 = local-only).
    profile_publish_steps: int = 16
    # Completed per-step records kept in the ledger's ring.
    profile_history: int = 512
    # Per-peer KV read budget of the watchdog's cross-rank round (ms).
    profile_publish_timeout_ms: int = 250
    # The least excess (ms) over the median that marks a straggler, so
    # microsecond jitter never trips the robust-z test.
    profile_straggler_min_ms: float = 5.0
    # Roofline peak overrides (0 = the detected card's row): bf16 TFLOP/s,
    # HBM / ICI / DCN GB/s (profile/roofline.py::chip_peaks reads them).
    peak_tflops: float = 0.0
    peak_hbm_gbs: float = 0.0
    peak_ici_gbs: float = 0.0
    peak_dcn_gbs: float = 0.0

    # --- goodput/badput accounting + durable run history (goodput/) ---
    goodput: bool = True
    # Directory for per-rank goodput summary dumps at shutdown
    # (goodput_r<rank>.json; "" = no dumps).
    goodput_dir: str = ""
    # Durable cross-run history: rank 0 appends run_<id>.jsonl journals
    # under this directory, one flushed line per record. "" = off.
    run_history_dir: str = ""
    # Journal goodput-heartbeat cadence in seconds.
    goodput_journal_s: float = 10.0
    # Run id override: names the journal file run_<id>.jsonl.
    run_id: str = ""

    # --- metrics (metrics/) ---
    metrics: bool = True
    # Scrape endpoint port; 0 = no HTTP server. Each process binds
    # port + local_rank.
    metrics_port: int = 0
    metrics_addr: str = "0.0.0.0"
    # Series-name prefix in the text exposition.
    metrics_prefix: str = "horovod"

    # --- stall inspector (ops/stall_inspector.py; reference
    # common.h:124-125): a warning when an enqueued tensor waits longer
    # than stall_check_time_seconds for its flush, and, past
    # stall_shutdown_time_seconds (0 = never), HorovodInternalError at the
    # next enqueue.
    stall_check_disable: bool = False
    stall_check_time_seconds: float = 60.0
    stall_shutdown_time_seconds: float = 0.0
    # Debug: every eager collective exchanges its signature with the set's
    # other processes through negotiation.exchange before it runs, and a
    # mismatch (a different collective, shape or dtype at the same point)
    # raises TensorShapeMismatchError naming the processes that differ.
    order_check: bool = False

    # --- control plane (common/control_plane.py) ---
    # flat | hier | "" = auto (hier whenever the slice layout has more
    # than one slice): negotiation rounds decompose into slice-local
    # gathers with one leaders-only cross-slice round, and the fusion
    # boundaries reach a slice's members through its leader.
    control_plane: str = ""
    # The launcher's per-slice KV shard listeners (0 = one per slice when
    # the hierarchical control plane is armed) and the first one's port
    # (0 = ephemeral; the ports reach the workers as
    # HOROVOD_KV_SHARD_PORTS).
    kv_shard_count: int = 0
    kv_shard_port_base: int = 0
    # A slice member whose leader has not re-published a boundary the root
    # holds within this lease takes the re-publish over.
    control_lease_ms: float = 2000.0
    # The KV client's retries of a transient transport fault (URLError,
    # connection reset, HTTP 5xx) with jittered exponential backoff
    # (runner/http_kv.py); a 404 or another 4xx is an answer, never retried.
    kv_retries: int = 3
    kv_retry_backoff_ms: float = 50.0
    kv_retry_backoff_max_ms: float = 2000.0

    # --- chaos (chaos/): a seeded fault plan, a JSON (or, with PyYAML,
    # YAML) file or inline text; "" = disarmed. The seed overrides the
    # plan's; the ledger directory takes the per-rank JSONL ledgers.
    chaos_plan: str = ""
    chaos_seed: int = 0
    chaos_ledger: str = ""

    # --- cluster telemetry plane (telemetry/): rank -> slice leader -> job
    # view over the launcher's KV, armed by hvd.init when the KV is
    # reachable and the world has more than one process.
    telemetry: bool = True
    # Beacon and aggregation cadence in seconds.
    telemetry_interval: float = 2.0
    # The mergeable metrics snapshot in each digest.
    telemetry_metrics: bool = True
    # Health thresholds (0 = derived from the interval, see
    # telemetry/health.thresholds): beacon age marking a rank dead, step
    # clock stop marking it stalled.
    telemetry_dead_after: float = 0.0
    telemetry_stall_after: float = 0.0
    # Step lag behind the job median marking a rank straggling, and global
    # collective-seq lag marking it desynced.
    telemetry_step_lag: int = 5
    telemetry_seq_lag: int = 64

    # --- logging (common/logging.py; reference: HOROVOD_LOG_LEVEL /
    # HOROVOD_LOG_HIDE_TIME, horovod/common/logging.cc) ---
    log_level: str = "warning"
    log_hide_time: bool = False

    def __post_init__(self):
        if self.trace_capacity < 1:
            raise ValueError(
                f"trace_capacity={self.trace_capacity}: need >= 1 (the "
                "trace store must hold at least the request being read)")
        if self.slo_ttft_p99_ms < 0.0 or self.slo_tps < 0.0:
            raise ValueError(
                f"SLO targets must be >= 0 (0 = not declared), got "
                f"slo_ttft_p99_ms={self.slo_ttft_p99_ms}, "
                f"slo_tps={self.slo_tps}")
        if self.slo_window_s <= 0.0:
            raise ValueError(
                f"slo_window_s={self.slo_window_s}: the burn-rate "
                "window must be positive")
        # The goodput paths: surrounding whitespace in an env var must not
        # make another directory, and the journal's heartbeat IS the
        # goodput summary.
        self.goodput_dir = (self.goodput_dir or "").strip()
        self.run_history_dir = (self.run_history_dir or "").strip()
        if self.run_history_dir and not self.goodput:
            raise ValueError(
                "run_history_dir requires goodput=True "
                "(HOROVOD_GOODPUT=1): the run journal's heartbeat IS the "
                "goodput summary")
        if self.goodput_journal_s <= 0.0:
            raise ValueError(
                f"goodput_journal_s={self.goodput_journal_s}: the journal "
                "heartbeat cadence must be positive")
        self.control_plane = (self.control_plane or "").strip().lower()
        if self.control_plane not in ("", "flat", "hier"):
            raise ValueError(
                f"control_plane={self.control_plane!r}: flat, hier, or "
                "empty (auto: hier when the slice layout has >1 slice)")

    @classmethod
    def from_env(cls):
        c = cls()
        c.fusion_threshold = _env_int("HOROVOD_FUSION_THRESHOLD", c.fusion_threshold)
        c.cycle_time_ms = _env_float("HOROVOD_CYCLE_TIME", c.cycle_time_ms)
        c.join_mode = _env_bool("HOROVOD_JOIN_MODE", c.join_mode)
        c.wire_dtype = os.environ.get("HOROVOD_WIRE_DTYPE", c.wire_dtype)
        c.wire_dtype_dcn = os.environ.get("HOROVOD_WIRE_DTYPE_DCN",
                                          c.wire_dtype_dcn)
        c.wire_error_feedback = _env_bool("HOROVOD_WIRE_ERROR_FEEDBACK",
                                          c.wire_error_feedback)
        c.hierarchical_allreduce = _env_bool(
            "HOROVOD_HIERARCHICAL_ALLREDUCE", c.hierarchical_allreduce)
        c.torus_allreduce = _env_bool("HOROVOD_TORUS_ALLREDUCE",
                                      c.torus_allreduce)
        c.hierarchical_dispatch = _env_bool("HOROVOD_HIERARCHICAL_DISPATCH",
                                            c.hierarchical_dispatch)
        c.hierarchical_allgather = _env_bool(
            "HOROVOD_HIERARCHICAL_ALLGATHER", c.hierarchical_allgather)
        c.cross_overlap = _env_bool("HOROVOD_CROSS_OVERLAP", c.cross_overlap)
        c.hierarchical_alltoall = _env_bool("HOROVOD_HIERARCHICAL_ALLTOALL",
                                            c.hierarchical_alltoall)
        v = os.environ.get("HOROVOD_ALLTOALL_CROSS_DTYPE",
                           c.alltoall_cross_dtype)
        c.alltoall_cross_dtype = {"fp16": "float16",
                                  "bf16": "bfloat16"}.get(v, v)
        c.mesh_slices = os.environ.get("HOROVOD_MESH_SLICES", c.mesh_slices)
        c.rank = _env_int("HOROVOD_RANK", c.rank)
        c.local_rank = _env_int("HOROVOD_LOCAL_RANK", c.local_rank)
        c.cross_rank = _env_int("HOROVOD_CROSS_RANK", c.cross_rank)
        c.size = _env_int("HOROVOD_SIZE", c.size)
        c.local_size = _env_int("HOROVOD_LOCAL_SIZE", c.local_size)
        c.cross_size = _env_int("HOROVOD_CROSS_SIZE", c.cross_size)
        if "HOROVOD_RANK" not in os.environ:
            c._mpi_fallback()
        c.coordinator_addr = os.environ.get("HOROVOD_COORDINATOR_ADDR",
                                            c.coordinator_addr)
        c.coordinator_port = _env_int("HOROVOD_COORDINATOR_PORT",
                                      c.coordinator_port)
        c.start_timeout = _env_float("HOROVOD_START_TIMEOUT", c.start_timeout)
        c.elastic = _env_bool("HOROVOD_ELASTIC", c.elastic)
        c.elastic_timeout = _env_float("HOROVOD_ELASTIC_TIMEOUT",
                                       c.elastic_timeout)
        c.blacklist_cooldown_range = os.environ.get(
            "HOROVOD_BLACKLIST_COOLDOWN_RANGE", c.blacklist_cooldown_range)
        c.host_key = os.environ.get("HOROVOD_HOST_KEY", c.host_key)
        c.elastic_init_version = _env_int("HOROVOD_ELASTIC_INIT_VERSION",
                                          c.elastic_init_version)
        c.autotune = _env_bool("HOROVOD_AUTOTUNE", c.autotune)
        c.autotune_log_file = os.environ.get("HOROVOD_AUTOTUNE_LOG",
                                             c.autotune_log_file)
        c.autotune_warmup_samples = _env_int(
            "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", c.autotune_warmup_samples)
        c.autotune_steps_per_sample = _env_int(
            "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", c.autotune_steps_per_sample)
        c.autotune_bayes_opt_max_samples = _env_int(
            "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
            c.autotune_bayes_opt_max_samples)
        c.autotune_gaussian_process_noise = _env_float(
            "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
            c.autotune_gaussian_process_noise)
        c.autopilot = _env_bool("HOROVOD_AUTOPILOT", c.autopilot)
        c.autopilot_interval = _env_float("HOROVOD_AUTOPILOT_INTERVAL",
                                          c.autopilot_interval)
        c.autopilot_max_removals = _env_int(
            "HOROVOD_AUTOPILOT_MAX_REMOVALS", c.autopilot_max_removals)
        c.autopilot_hysteresis = _env_int("HOROVOD_AUTOPILOT_HYSTERESIS",
                                          c.autopilot_hysteresis)
        c.autopilot_min_world = _env_int("HOROVOD_AUTOPILOT_MIN_WORLD",
                                         c.autopilot_min_world)
        c.autopilot_prior = os.environ.get("HOROVOD_AUTOPILOT_PRIOR",
                                           c.autopilot_prior)
        c.profile_z_threshold = _env_float("HOROVOD_PROFILE_Z_THRESHOLD",
                                           c.profile_z_threshold)
        c.sim_kv_us = _env_float("HOROVOD_SIM_KV_US", c.sim_kv_us)
        c.sim_dcn_us = _env_float("HOROVOD_SIM_DCN_US", c.sim_dcn_us)
        c.serving = _env_bool("HOROVOD_SERVING", c.serving)
        c.serving_port = _env_int("HOROVOD_SERVING_PORT", c.serving_port)
        c.serving_slots = _env_int("HOROVOD_SERVING_SLOTS",
                                   c.serving_slots)
        c.serving_max_len = _env_int("HOROVOD_SERVING_MAX_LEN",
                                     c.serving_max_len)
        c.serving_prefill_chunk = _env_int("HOROVOD_SERVING_PREFILL_CHUNK",
                                           c.serving_prefill_chunk)
        c.serving_queue_limit = _env_int("HOROVOD_SERVING_QUEUE_LIMIT",
                                         c.serving_queue_limit)
        c.serving_migrate_kv = _env_bool("HOROVOD_SERVING_MIGRATE_KV",
                                         c.serving_migrate_kv)
        c.serving_model = os.environ.get("HOROVOD_SERVING_MODEL",
                                         c.serving_model)
        c.serving_commit_steps = _env_int("HOROVOD_SERVING_COMMIT_STEPS",
                                          c.serving_commit_steps)
        c.trace = _env_bool("HOROVOD_TRACE", c.trace)
        c.trace_capacity = _env_int("HOROVOD_TRACE_CAPACITY",
                                    c.trace_capacity)
        c.trace_dir = os.environ.get("HOROVOD_TRACE_DIR", c.trace_dir)
        c.slo_ttft_p99_ms = _env_float("HOROVOD_SLO_TTFT_P99_MS",
                                       c.slo_ttft_p99_ms)
        c.slo_tps = _env_float("HOROVOD_SLO_TPS", c.slo_tps)
        c.slo_window_s = _env_float("HOROVOD_SLO_WINDOW_S",
                                    c.slo_window_s)
        c.timeline_filename = os.environ.get("HOROVOD_TIMELINE",
                                             c.timeline_filename)
        c.timeline_mark_cycles = _env_bool("HOROVOD_TIMELINE_MARK_CYCLES",
                                           c.timeline_mark_cycles)
        c.flight = _env_bool("HOROVOD_FLIGHT_RECORDER", c.flight)
        c.flight_capacity = _env_int("HOROVOD_FLIGHT_CAPACITY",
                                     c.flight_capacity)
        c.flight_dir = os.environ.get("HOROVOD_FLIGHT_DIR", c.flight_dir)
        c.step_profiler = _env_bool("HOROVOD_STEP_PROFILER",
                                    c.step_profiler)
        c.step_report_file = os.environ.get("HVD_STEP_REPORT_FILE",
                                            c.step_report_file)
        c.profile_steps = os.environ.get("HOROVOD_PROFILE_STEPS",
                                         c.profile_steps)
        c.profile_dir = os.environ.get("HOROVOD_PROFILE_DIR", c.profile_dir)
        c.profile_publish_steps = _env_int("HOROVOD_PROFILE_PUBLISH_STEPS",
                                           c.profile_publish_steps)
        c.profile_history = _env_int("HOROVOD_PROFILE_HISTORY",
                                     c.profile_history)
        c.profile_publish_timeout_ms = _env_int(
            "HOROVOD_PROFILE_PUBLISH_TIMEOUT_MS",
            c.profile_publish_timeout_ms)
        c.profile_straggler_min_ms = _env_float(
            "HOROVOD_PROFILE_STRAGGLER_MIN_MS", c.profile_straggler_min_ms)
        c.peak_tflops = _env_float("HOROVOD_PEAK_TFLOPS", c.peak_tflops)
        c.peak_hbm_gbs = _env_float("HOROVOD_PEAK_HBM_GBS", c.peak_hbm_gbs)
        c.peak_ici_gbs = _env_float("HOROVOD_PEAK_ICI_GBS", c.peak_ici_gbs)
        c.peak_dcn_gbs = _env_float("HOROVOD_PEAK_DCN_GBS", c.peak_dcn_gbs)
        c.goodput = _env_bool("HOROVOD_GOODPUT", c.goodput)
        c.goodput_dir = os.environ.get("HOROVOD_GOODPUT_DIR", c.goodput_dir)
        c.run_history_dir = os.environ.get("HOROVOD_RUN_HISTORY_DIR",
                                           c.run_history_dir)
        c.goodput_journal_s = _env_float("HOROVOD_GOODPUT_JOURNAL_S",
                                         c.goodput_journal_s)
        c.run_id = os.environ.get("HOROVOD_RUN_ID", c.run_id)
        c.metrics = _env_bool("HOROVOD_METRICS", c.metrics)
        c.metrics_port = _env_int("HOROVOD_METRICS_PORT", c.metrics_port)
        c.metrics_addr = os.environ.get("HOROVOD_METRICS_ADDR",
                                        c.metrics_addr)
        c.metrics_prefix = os.environ.get("HOROVOD_METRICS_PREFIX",
                                          c.metrics_prefix)
        c.stall_check_disable = _env_bool("HOROVOD_STALL_CHECK_DISABLE",
                                          c.stall_check_disable)
        c.stall_check_time_seconds = _env_float(
            "HOROVOD_STALL_CHECK_TIME_SECONDS", c.stall_check_time_seconds)
        c.stall_shutdown_time_seconds = _env_float(
            "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
            c.stall_shutdown_time_seconds)
        c.order_check = _env_bool("HOROVOD_ORDER_CHECK", c.order_check)
        c.control_plane = os.environ.get("HOROVOD_CONTROL_PLANE",
                                         c.control_plane)
        c.kv_shard_count = _env_int("HOROVOD_KV_SHARD_COUNT",
                                    c.kv_shard_count)
        c.kv_shard_port_base = _env_int("HOROVOD_KV_SHARD_PORT_BASE",
                                        c.kv_shard_port_base)
        c.control_lease_ms = _env_float("HOROVOD_CONTROL_LEASE_MS",
                                        c.control_lease_ms)
        c.kv_retries = _env_int("HOROVOD_KV_RETRIES", c.kv_retries)
        c.kv_retry_backoff_ms = _env_float("HOROVOD_KV_RETRY_BACKOFF_MS",
                                           c.kv_retry_backoff_ms)
        c.kv_retry_backoff_max_ms = _env_float(
            "HOROVOD_KV_RETRY_BACKOFF_MAX_MS", c.kv_retry_backoff_max_ms)
        c.chaos_plan = os.environ.get("HOROVOD_CHAOS_PLAN", c.chaos_plan)
        c.chaos_seed = _env_int("HOROVOD_CHAOS_SEED", c.chaos_seed)
        c.chaos_ledger = os.environ.get("HOROVOD_CHAOS_LEDGER",
                                        c.chaos_ledger)
        c.telemetry = _env_bool("HOROVOD_TELEMETRY", c.telemetry)
        c.telemetry_interval = _env_float("HOROVOD_TELEMETRY_INTERVAL",
                                          c.telemetry_interval)
        c.telemetry_metrics = _env_bool("HOROVOD_TELEMETRY_METRICS",
                                        c.telemetry_metrics)
        c.telemetry_dead_after = _env_float("HOROVOD_TELEMETRY_DEAD_AFTER",
                                            c.telemetry_dead_after)
        c.telemetry_stall_after = _env_float(
            "HOROVOD_TELEMETRY_STALL_AFTER", c.telemetry_stall_after)
        c.telemetry_step_lag = _env_int("HOROVOD_TELEMETRY_STEP_LAG",
                                        c.telemetry_step_lag)
        c.telemetry_seq_lag = _env_int("HOROVOD_TELEMETRY_SEQ_LAG",
                                       c.telemetry_seq_lag)
        c.log_level = os.environ.get("HOROVOD_LOG_LEVEL", c.log_level)
        c.log_hide_time = _env_bool("HOROVOD_LOG_HIDE_TIME",
                                    c.log_hide_time)
        c.__post_init__()     # re-validate what the env set
        return c

    def _mpi_fallback(self):
        """mpirun/jsrun/srun start one process per slot with no HOROVOD_*
        rank env: read the rank contract from the MPI/PMI/Slurm-provided env
        (reference: test/utils/common.py:32-64 mpi_env_rank_and_size reads
        the same variables). Ranks are placed host-major, so the cross rank
        is the rank over the local size."""
        for rank_var, size_var, lrank_var, lsize_var in (
                ("OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_SIZE",
                 "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE"),
                ("PMI_RANK", "PMI_SIZE", "MPI_LOCALRANKID",
                 "MPI_LOCALNRANKS"),
                ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
                 "SLURM_NTASKS_PER_NODE")):
            if rank_var not in os.environ:
                continue
            self.rank = _env_int(rank_var, self.rank)
            self.size = _env_int(size_var, self.size)
            if self.local_size <= 0:
                self.local_size = _env_int(lsize_var, self.local_size)
            if "HOROVOD_LOCAL_RANK" not in os.environ:
                self.local_rank = _env_int(lrank_var, self.local_rank)
            if self.local_size > 0 and \
                    "HOROVOD_CROSS_RANK" not in os.environ:
                self.cross_rank = self.rank // self.local_size
                if self.cross_size <= 0 and self.size > 0:
                    self.cross_size = -(-self.size // self.local_size)
            return
