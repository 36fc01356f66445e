"""CLI/config-file -> HOROVOD_* environment plumbing.

Reference: horovod/runner/common/util/config_parser.py (set_env_from_args:19-205
and the YAML ``--config-file`` loader) — every tunable flag maps to the env
var the core reads, so flags, YAML and raw env are interchangeable.

Port of the JAX package's ``runner/config_parser.py``, the same map: the
launcher keeps JAX's flags, and each sets its env var on every worker; the
port reads those of its own knobs (``common/config.py``).
"""

# flag attribute -> env var (reference: config_parser.py constants)
_ARG_ENV_MAP = [
    ("fusion_threshold_mb", "HOROVOD_FUSION_THRESHOLD",
     lambda v: str(int(v * 1024 * 1024))),
    ("cycle_time_ms", "HOROVOD_CYCLE_TIME", str),
    ("cache_capacity", "HOROVOD_CACHE_CAPACITY", str),
    ("hierarchical_allreduce", "HOROVOD_HIERARCHICAL_ALLREDUCE",
     lambda v: "1" if v else None),
    ("hierarchical_allgather", "HOROVOD_HIERARCHICAL_ALLGATHER",
     lambda v: "1" if v else None),
    ("torus_allreduce", "HOROVOD_TORUS_ALLREDUCE",
     lambda v: "1" if v else None),
    ("autotune", "HOROVOD_AUTOTUNE", lambda v: "1" if v else None),
    ("autotune_log_file", "HOROVOD_AUTOTUNE_LOG", str),
    ("autotune_warmup_samples", "HOROVOD_AUTOTUNE_WARMUP_SAMPLES", str),
    ("autotune_steps_per_sample", "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", str),
    ("autotune_bayes_opt_max_samples",
     "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES", str),
    ("autotune_gaussian_process_noise",
     "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE", str),
    ("timeline_filename", "HOROVOD_TIMELINE", str),
    ("timeline_mark_cycles", "HOROVOD_TIMELINE_MARK_CYCLES",
     lambda v: "1" if v else None),
    ("no_stall_check", "HOROVOD_STALL_CHECK_DISABLE",
     lambda v: "1" if v else None),
    ("stall_check_warning_time_seconds", "HOROVOD_STALL_CHECK_TIME_SECONDS",
     str),
    ("stall_check_shutdown_time_seconds",
     "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS", str),
    ("order_check", "HOROVOD_ORDER_CHECK",
     lambda v: "1" if v else None),
    ("log_level", "HOROVOD_LOG_LEVEL", str),
    ("log_hide_timestamp", "HOROVOD_LOG_HIDE_TIME",
     lambda v: "1" if v else None),
    ("wire_dtype", "HOROVOD_WIRE_DTYPE", str),
    ("hierarchical_alltoall", "HOROVOD_HIERARCHICAL_ALLTOALL",
     lambda v: "1" if v else None),
    ("alltoall_cross_dtype", "HOROVOD_ALLTOALL_CROSS_DTYPE", str),
    ("no_wire_error_feedback", "HOROVOD_WIRE_ERROR_FEEDBACK",
     lambda v: "0" if v else None),
    ("compile_cache_dir", "HOROVOD_COMPILE_CACHE_DIR", str),
    ("control_plane", "HOROVOD_CONTROL_PLANE", str),
    ("kv_shard_count", "HOROVOD_KV_SHARD_COUNT", str),
    ("kv_shard_port_base", "HOROVOD_KV_SHARD_PORT_BASE", str),
    ("control_lease_ms", "HOROVOD_CONTROL_LEASE_MS", str),
    ("elastic_timeout", "HOROVOD_ELASTIC_TIMEOUT", str),
    ("gloo_timeout_seconds", "HOROVOD_GLOO_TIMEOUT_SECONDS", str),
    ("nics", "HOROVOD_NICS", str),
    ("nics", "HOROVOD_GLOO_IFACE", str),
    ("num_nccl_streams", "HOROVOD_NUM_NCCL_STREAMS", str),
    ("thread_affinity", "HOROVOD_THREAD_AFFINITY", str),
    ("mpi_threads_disable", "HOROVOD_MPI_THREADS_DISABLE",
     lambda v: "1" if v else None),
    ("blacklist_cooldown_range", "HOROVOD_BLACKLIST_COOLDOWN_RANGE",
     lambda v: f"{v[0]},{v[1]}"),
    ("flight_dir", "HOROVOD_FLIGHT_DIR", str),
    ("no_flight_recorder", "HOROVOD_FLIGHT_RECORDER",
     lambda v: "0" if v else None),
    ("chaos_plan", "HOROVOD_CHAOS_PLAN", str),
    ("chaos_seed", "HOROVOD_CHAOS_SEED", str),
    ("chaos_ledger", "HOROVOD_CHAOS_LEDGER", str),
    ("no_step_profiler", "HOROVOD_STEP_PROFILER",
     lambda v: "0" if v else None),
    ("no_telemetry", "HOROVOD_TELEMETRY",
     lambda v: "0" if v else None),
    ("telemetry_interval", "HOROVOD_TELEMETRY_INTERVAL", str),
    ("step_report_file", "HVD_STEP_REPORT_FILE", str),
    ("profile_steps", "HOROVOD_PROFILE_STEPS", str),
    ("profile_dir", "HOROVOD_PROFILE_DIR", str),
    ("profile_publish_steps", "HOROVOD_PROFILE_PUBLISH_STEPS", str),
    ("autopilot", "HOROVOD_AUTOPILOT", lambda v: "1" if v else None),
    ("no_autopilot", "HOROVOD_AUTOPILOT", lambda v: "0" if v else None),
    ("autopilot_interval", "HOROVOD_AUTOPILOT_INTERVAL", str),
    ("autopilot_prior", "HOROVOD_AUTOPILOT_PRIOR", str),
    ("serving", "HOROVOD_SERVING", lambda v: "1" if v else None),
    ("serving_port", "HOROVOD_SERVING_PORT", str),
    ("serving_slots", "HOROVOD_SERVING_SLOTS", str),
    ("serving_queue_limit", "HOROVOD_SERVING_QUEUE_LIMIT", str),
    ("trace", "HOROVOD_TRACE", lambda v: "1" if v else None),
    ("no_trace", "HOROVOD_TRACE", lambda v: "0" if v else None),
    ("trace_dir", "HOROVOD_TRACE_DIR", str),
    ("goodput", "HOROVOD_GOODPUT", lambda v: "1" if v else None),
    ("no_goodput", "HOROVOD_GOODPUT", lambda v: "0" if v else None),
    ("goodput_dir", "HOROVOD_GOODPUT_DIR", str),
    ("run_history_dir", "HOROVOD_RUN_HISTORY_DIR", str),
]


def set_env_from_args(env, args):
    """reference: config_parser.py set_env_from_args."""
    for attr, var, conv in _ARG_ENV_MAP:
        v = getattr(args, attr, None)
        if v is None or v is False or v == "":
            continue
        cv = conv(v)
        if cv is not None:
            env[var] = cv
    return env


def parse_config_file(args, path):
    """YAML config overriding CLI defaults (reference: config_parser.py:205
    --config-file). Only keys matching known arg names are applied."""
    import yaml
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    known = {a for a, _, _ in _ARG_ENV_MAP} | {
        "np", "hosts", "hostfile", "verbose", "min_np", "max_np",
        "slots_per_host", "ssh_port", "ssh_identity_file", "start_timeout"}
    for section, values in cfg.items():
        if isinstance(values, dict):
            items = values.items()
        else:
            items = [(section, values)]
        for k, v in items:
            k = k.replace("-", "_")
            # Explicit CLI flags win over the config file; YAML only fills
            # defaults (reference precedence: config_parser.py applies config
            # where the arg wasn't set).
            if k in known and getattr(args, k, None) in (None, False, ""):
                setattr(args, k, v)
    return args
