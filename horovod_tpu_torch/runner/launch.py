"""``hvdrun-torch`` — the launcher CLI of the PyTorch/CUDA port.

Reference: horovod/runner/launch.py (``horovodrun``; arg surface :286-596,
``_run``:806, ``run_commandline``:830), through the JAX package's
``runner/launch.py``, whose flags it keeps. Where the JAX launcher starts one
worker per host (one JAX process drives every chip of its host), this one
starts one worker per slot, as ``horovodrun`` does on GPUs: each gets its
own HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE, the
address and port of the ``TCPStore`` rank 0 serves in ``hvd.init()``
(``common/basics.py``), and the launcher's KV store; ``hvd.init()`` puts it
on ``cuda:<local_rank>``, and ``CUDA_VISIBLE_DEVICES`` is left as it is.

Example::

    python -m horovod_tpu_torch.runner -np 8 -H host1:4,host2:4 python train.py
    hvdrun-torch -np 4 python train.py        # 4 GPUs of this host

Elastic launches (``--min-np``/``--max-np``/``--host-discovery-script``,
``--reset-limit``, ``--elastic-timeout``, ``--blacklist-cooldown-range``)
run ``runner/elastic/driver.py``: one worker per slot of each membership
version, survivors re-initializing in place. The flags of the JAX
package's other features are kept and set their env vars on every worker,
as the JAX launcher does, and ambient serving, tracing, SLO and metrics
knobs ride along. The workers read (``common/config.py``):

- the wire (``--wire-dtype``, ``--no-wire-error-feedback``:
  ``HOROVOD_WIRE_DTYPE``, ``_DCN``, ``HOROVOD_WIRE_ERROR_FEEDBACK``);
- the tiers (``--hierarchical-allreduce``, ``--hierarchical-allgather``,
  ``--torus-allreduce``, ``--hierarchical-alltoall``,
  ``--alltoall-cross-dtype``, with ``HOROVOD_HIERARCHICAL_DISPATCH``,
  ``HOROVOD_CROSS_OVERLAP`` and ``HOROVOD_MESH_SLICES``);
- serving (``--serving``, ``--serving-port``, ``--serving-slots``,
  ``--serving-queue-limit``: ``HOROVOD_SERVING*``; ``python -m
  horovod_tpu_torch.serving`` is the worker);
- tracing (``--trace``, ``--no-trace``, ``--trace-dir``:
  ``HOROVOD_TRACE*``), the SLOs (``HOROVOD_SLO_*``) and metrics
  (``HOROVOD_METRICS*``);
- the timeline (``--timeline-filename``, ``--timeline-mark-cycles``:
  ``HOROVOD_TIMELINE*``), the flight recorder (``--flight-dir``,
  ``--no-flight-recorder``: ``HOROVOD_FLIGHT_*``), the step profiler
  (``--no-step-profiler``, ``--step-report-file``, ``--profile-steps``,
  ``--profile-dir``: ``HOROVOD_STEP_PROFILER``, ``HVD_STEP_REPORT_FILE``,
  ``HOROVOD_PROFILE_*``) and goodput (``--goodput``, ``--no-goodput``,
  ``--goodput-dir``, ``--run-history-dir``: ``HOROVOD_GOODPUT*``,
  ``HOROVOD_RUN_HISTORY_DIR``);
- the control plane (``--control-plane``, ``--control-lease-ms``,
  ``--no-stall-check``, ``--stall-check-warning-time-seconds``,
  ``--stall-check-shutdown-time-seconds``, ``--order-check``:
  ``HOROVOD_CONTROL_PLANE``, ``HOROVOD_CONTROL_LEASE_MS``,
  ``HOROVOD_STALL_*``, ``HOROVOD_ORDER_CHECK``) and its KV shards
  (``--kv-shard-count``, ``--kv-shard-port-base``: the launcher starts
  ``control_plane.kv_shard_count`` shard listeners and gives every worker
  their ports in ``HOROVOD_KV_SHARD_PORTS``);
- the cluster telemetry plane (``--no-telemetry``,
  ``--telemetry-interval``: ``HOROVOD_TELEMETRY*``);
- chaos (``--chaos-plan``, ``--chaos-seed``, ``--chaos-ledger``:
  ``HOROVOD_CHAOS_*``; ``hvd.init`` arms the plan, the elastic driver arms
  its own copy under the ``driver`` role);
- autotune (``--autotune``, ``--autotune-log-file``,
  ``--autotune-warmup-samples``, ``--autotune-steps-per-sample``,
  ``--autotune-bayes-opt-max-samples``,
  ``--autotune-gaussian-process-noise``: ``HOROVOD_AUTOTUNE*``, the fusion
  runtime's flush-window tuner on rank 0) and the autopilot
  (``--autopilot``, ``--no-autopilot``, ``--autopilot-interval``,
  ``--autopilot-prior``: ``HOROVOD_AUTOPILOT*``, the controller thread
  ``hvd.init`` arms on rank 0; an elastic launch's driver polls its
  removal requests).
"""

import argparse
import os
import socket
import sys

from horovod_tpu_torch.common import logging as hvd_logging
from horovod_tpu_torch.runner import config_parser
from horovod_tpu_torch.runner.exec import (WorkerProcess,
                                           wait_for_any_failure_or_all_success)
from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                            host_assignment_by_host,
                                            parse_host_files, parse_hosts)
from horovod_tpu_torch.runner.http_kv import KVStoreServer
from horovod_tpu_torch.runner.secret import SECRET_ENV, make_secret_key


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="hvdrun-torch",
        description="Launch horovod_tpu_torch training: one process per "
                    "slot (GPU) across hosts.")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("-np", "--num-proc", dest="np", type=int,
                   help="Total number of processes (ranks), one per GPU.")
    p.add_argument("-H", "--hosts", dest="hosts",
                   help="host1:slots,host2:slots list.")
    p.add_argument("-hostfile", "--hostfile", dest="hostfile",
                   help="Hostfile with 'host slots=N' lines.")
    p.add_argument("--ssh-port", type=int, dest="ssh_port")
    p.add_argument("--ssh-identity-file", dest="ssh_identity_file")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--config-file", dest="config_file")
    p.add_argument("--check-build", action="store_true")
    p.add_argument("--start-timeout", type=int, default=600,
                   dest="start_timeout")
    p.add_argument("--disable-cache", action="store_true")
    p.add_argument("--launcher", dest="launcher", default="auto",
                   choices=["auto", "ssh", "mpi", "jsrun"],
                   help="Process launcher: ssh fan-out (default), mpirun, or "
                        "jsrun on LSF. 'auto' picks jsrun inside an LSF "
                        "allocation with jsrun available, else ssh. "
                        "(reference: horovodrun --gloo/--mpi/... selection, "
                        "launch.py:286-596 + js_run path)")
    # Launcher-selection aliases (reference: --gloo/--mpi/--jsrun,
    # launch.py:286-596). "gloo" maps to the native ssh/KV rendezvous path —
    # the role gloo plays in the reference.
    p.add_argument("--gloo", action="store_true", dest="use_gloo")
    p.add_argument("--mpi", action="store_true", dest="use_mpi")
    p.add_argument("--jsrun", action="store_true", dest="use_jsrun")
    p.add_argument("--network-interface", "--network-interfaces",
                   dest="nics",
                   help="Comma-separated NICs workers may bind/probe on")
    p.add_argument("--output-filename", dest="output_filename",
                   help="Mirror each worker's output to "
                        "<dir>/rank.<NN>/stdout")
    p.add_argument("--prefix-output-with-timestamp", action="store_true",
                   dest="prefix_output_with_timestamp")
    p.add_argument("--tcp", action="store_true", dest="tcp_flag",
                   help="Accepted for compatibility (the data plane is "
                        "NCCL, or gloo on the CPU)")
    p.add_argument("--num-nccl-streams", type=int, dest="num_nccl_streams",
                   help="Accepted for compatibility")
    p.add_argument("--thread-affinity", type=int, dest="thread_affinity")
    p.add_argument("--binding-args", dest="binding_args")
    p.add_argument("--mpi-threads-disable", action="store_true",
                   dest="mpi_threads_disable", default=None)
    p.add_argument("--no-mpi-threads-disable", action="store_false",
                   dest="mpi_threads_disable")
    p.add_argument("--gloo-timeout-seconds", type=int,
                   dest="gloo_timeout_seconds")
    p.add_argument("--mpi-args", dest="mpi_args", default="",
                   help="Extra args appended to mpirun/jsrun.")

    tuning = p.add_argument_group("tuning")
    tuning.add_argument("--fusion-threshold-mb", type=float,
                        dest="fusion_threshold_mb")
    tuning.add_argument("--cycle-time-ms", type=float, dest="cycle_time_ms")
    tuning.add_argument("--cache-capacity", type=int, dest="cache_capacity")
    tuning.add_argument("--no-hierarchical-allreduce", action="store_false",
                        dest="hierarchical_allreduce", default=False)
    tuning.add_argument("--no-hierarchical-allgather", action="store_false",
                        dest="hierarchical_allgather", default=False)
    tuning.add_argument("--no-torus-allreduce", action="store_false",
                        dest="torus_allreduce", default=False)
    tuning.add_argument("--hierarchical-allreduce", action="store_true",
                        dest="hierarchical_allreduce")
    tuning.add_argument("--hierarchical-allgather", action="store_true",
                        dest="hierarchical_allgather")
    tuning.add_argument("--torus-allreduce", action="store_true",
                        dest="torus_allreduce",
                        help="2-level ICI/DCN torus allreduce "
                             "(fork knob HOROVOD_TORUS_ALLREDUCE)")
    tuning.add_argument("--wire-dtype", dest="wire_dtype",
                        choices=["", "bfloat16", "float16", "bf16", "fp16",
                                 "int8", "fp8"],
                        help="Collective wire dtype: 16-bit casts the fused "
                             "buckets; int8/fp8 ride the block-scaled "
                             "quantized exchange with error feedback "
                             "(HOROVOD_WIRE_DTYPE; docs/performance.md)")
    tuning.add_argument("--hierarchical-alltoall", action="store_true",
                        dest="hierarchical_alltoall",
                        help="2-level ICI/DCN alltoall for eligible "
                             "equal-splits exchanges and MoE expert "
                             "dispatch/combine when a slice hierarchy "
                             "exists (HOROVOD_HIERARCHICAL_ALLTOALL; "
                             "docs/performance.md)")
    tuning.add_argument("--alltoall-cross-dtype",
                        dest="alltoall_cross_dtype",
                        choices=["", "bfloat16", "float16", "bf16", "fp16",
                                 "int8", "fp8"],
                        help="Wire dtype of the hierarchical alltoall's "
                             "cross-slice (DCN) leg; int8/fp8 ride the "
                             "block-scaled exchange, 16-bit names keep it "
                             "exact (HOROVOD_ALLTOALL_CROSS_DTYPE). "
                             "Deliberately independent of --wire-dtype: "
                             "alltoall payloads are activations.")
    tuning.add_argument("--no-wire-error-feedback", action="store_true",
                        dest="no_wire_error_feedback",
                        help="Disable the quantized wire's error-feedback "
                             "residuals (HOROVOD_WIRE_ERROR_FEEDBACK=0)")
    tuning.add_argument("--control-plane", dest="control_plane",
                        choices=["flat", "hier"],
                        help="Control-plane strategy "
                             "(HOROVOD_CONTROL_PLANE): hier decomposes "
                             "negotiation + fusion-boundary sync into "
                             "slice-local rounds with leaders-only "
                             "cross-slice (DCN) rendezvous and shards "
                             "the HTTP-KV per slice; default is hier "
                             "whenever the slice layout has >1 slice. "
                             "See docs/scale_validation.md.")
    tuning.add_argument("--kv-shard-count", type=int,
                        dest="kv_shard_count",
                        help="Per-slice HTTP-KV shard listeners "
                             "(HOROVOD_KV_SHARD_COUNT; 0 = one per "
                             "slice when the hierarchical control "
                             "plane is armed).")
    tuning.add_argument("--kv-shard-port-base", type=int,
                        dest="kv_shard_port_base",
                        help="First shard listener port; shard k binds "
                             "base + k (HOROVOD_KV_SHARD_PORT_BASE; "
                             "0 = ephemeral).")
    tuning.add_argument("--control-lease-ms", type=float,
                        dest="control_lease_ms",
                        help="Boundary-stream leader lease in ms "
                             "(HOROVOD_CONTROL_LEASE_MS): a member "
                             "whose slice leader goes stale past this "
                             "window takes the re-publish over.")
    tuning.add_argument("--compile-cache-dir", dest="compile_cache_dir",
                        help="Persistent XLA compile-cache directory "
                             "exported to every worker "
                             "(HOROVOD_COMPILE_CACHE_DIR). Elastic launches "
                             "default it to <output-dir or cwd>/"
                             ".horovod_compile_cache so re-rendezvoused "
                             "workers skip XLA recompiles.")

    autotune = p.add_argument_group("autotune")
    autotune.add_argument("--autotune", action="store_true", dest="autotune")
    autotune.add_argument("--no-autotune", action="store_false",
                          dest="autotune")
    autotune.add_argument("--autotune-log-file", dest="autotune_log_file")
    autotune.add_argument("--autotune-warmup-samples", type=int,
                          dest="autotune_warmup_samples")
    autotune.add_argument("--autotune-steps-per-sample", type=int,
                          dest="autotune_steps_per_sample")
    autotune.add_argument("--autotune-bayes-opt-max-samples", type=int,
                          dest="autotune_bayes_opt_max_samples")
    autotune.add_argument("--autotune-gaussian-process-noise", type=float,
                          dest="autotune_gaussian_process_noise")

    autopilot = p.add_argument_group("autopilot")
    autopilot.add_argument("--autopilot", action="store_true",
                           dest="autopilot", default=False,
                           help="Arm the online self-driving controller "
                                "(HOROVOD_AUTOPILOT=1): closed-loop "
                                "tuning of fusion threshold/cycle, "
                                "dispatch strategy and wire dtype from "
                                "the signal plane, plus automated "
                                "straggler/dead-rank blacklist + "
                                "re-rendezvous under elastic launches.")
    autopilot.add_argument("--no-autopilot", action="store_true",
                           dest="no_autopilot",
                           help="Explicitly disarm the autopilot "
                                "(HOROVOD_AUTOPILOT=0), overriding an "
                                "ambient env opt-in.")
    autopilot.add_argument("--autopilot-interval", type=float,
                           dest="autopilot_interval",
                           help="Decision-epoch cadence in seconds "
                                "(HOROVOD_AUTOPILOT_INTERVAL, "
                                "default 10).")
    autopilot.add_argument("--autopilot-prior", type=str,
                           dest="autopilot_prior",
                           help="Twin-pretrained warm start: path to an "
                                "export_observations JSON artifact "
                                "written by python -m "
                                "horovod_tpu_torch.sim --pretrain "
                                "(HOROVOD_AUTOPILOT_PRIOR). The "
                                "controller skips the categorical sweep "
                                "and starts the numeric search at the "
                                "twin's best point; a mismatched prior "
                                "is rejected with a warning, never "
                                "fatal.")

    tracing = p.add_argument_group("tracing")
    tracing.add_argument("--trace", action="store_true", dest="trace",
                         default=False,
                         help="Arm request/step span tracing "
                              "(HOROVOD_TRACE=1; the default — this flag "
                              "overrides an ambient env opt-out). Serving "
                              "requests expose their span tree at "
                              "GET /debug/trace/<rid>; merge per-rank "
                              "shards with `python -m "
                              "horovod_tpu_torch.trace.analyze`.")
    tracing.add_argument("--no-trace", action="store_true",
                         dest="no_trace",
                         help="Disarm tracing (HOROVOD_TRACE=0).")
    tracing.add_argument("--trace-dir", dest="trace_dir",
                         help="Directory for per-rank trace shard dumps "
                              "(HOROVOD_TRACE_DIR).")

    goodput = p.add_argument_group("goodput accounting")
    goodput.add_argument("--goodput", action="store_true", dest="goodput",
                         default=False,
                         help="Arm job goodput/badput accounting "
                              "(HOROVOD_GOODPUT=1; the default — this "
                              "flag overrides an ambient env opt-out). "
                              "See docs/observability.md.")
    goodput.add_argument("--no-goodput", action="store_true",
                         dest="no_goodput",
                         help="Disarm goodput accounting "
                              "(HOROVOD_GOODPUT=0).")
    goodput.add_argument("--goodput-dir", dest="goodput_dir",
                         help="Directory for per-rank goodput summary "
                              "dumps at exit (HOROVOD_GOODPUT_DIR).")
    goodput.add_argument("--run-history-dir", dest="run_history_dir",
                         help="Durable cross-run history root "
                              "(HOROVOD_RUN_HISTORY_DIR): rank 0 appends "
                              "a per-run JSONL journal here; render and "
                              "regress with `python -m "
                              "horovod_tpu_torch.goodput`.")

    timeline = p.add_argument_group("timeline")
    timeline.add_argument("--timeline-filename", dest="timeline_filename")
    timeline.add_argument("--no-timeline-mark-cycles", action="store_false",
                          dest="timeline_mark_cycles", default=False)
    timeline.add_argument("--timeline-mark-cycles", action="store_true",
                          dest="timeline_mark_cycles")

    stall = p.add_argument_group("stall")
    stall.add_argument("--stall-check", action="store_false",
                       dest="no_stall_check", default=False)
    stall.add_argument("--no-stall-check", action="store_true",
                       dest="no_stall_check")
    stall.add_argument("--stall-check-warning-time-seconds", type=float,
                       dest="stall_check_warning_time_seconds")
    stall.add_argument("--stall-check-shutdown-time-seconds", type=float,
                       dest="stall_check_shutdown_time_seconds")
    stall.add_argument("--order-check", action="store_true",
                       dest="order_check", default=False,
                       help="debug: cross-check every eager collective's "
                            "op/shape/dtype signature across ranks before "
                            "dispatch (catches SPMD order divergence as an "
                            "error instead of a hang)")

    flight = p.add_argument_group("flight recorder")
    flight.add_argument("--flight-dir", dest="flight_dir",
                        help="Directory for per-rank flight-recorder crash "
                             "dumps (HOROVOD_FLIGHT_DIR), exported to every "
                             "worker so an elastic disruption collects all "
                             "ranks' dumps in one place for "
                             "`python -m horovod_tpu_torch.flight.analyze`. "
                             "See docs/observability.md.")
    flight.add_argument("--no-flight-recorder", action="store_true",
                        dest="no_flight_recorder",
                        help="Disable the always-armed flight recorder "
                             "(HOROVOD_FLIGHT_RECORDER=0).")

    profiler = p.add_argument_group("step profiler")
    profiler.add_argument("--no-step-profiler", action="store_true",
                          dest="no_step_profiler",
                          help="Disable the always-on step profiler "
                               "(HOROVOD_STEP_PROFILER=0).")
    profiler.add_argument("--step-report-file", dest="step_report_file",
                          help="Per-step attribution JSONL stream "
                               "(HVD_STEP_REPORT_FILE), exported to every "
                               "worker; render with `python -m "
                               "horovod_tpu_torch.profile.report`.")
    profiler.add_argument("--profile-steps", dest="profile_steps",
                          help="a:b — capture a torch.profiler trace from "
                               "the step-a marker to the step-b marker "
                               "(HOROVOD_PROFILE_STEPS).")
    profiler.add_argument("--profile-dir", dest="profile_dir",
                          help="Trace-capture output directory "
                               "(HOROVOD_PROFILE_DIR).")
    profiler.add_argument("--profile-publish-steps", type=int,
                          dest="profile_publish_steps",
                          help="Watchdog cross-rank publish cadence in "
                               "steps (HOROVOD_PROFILE_PUBLISH_STEPS; "
                               "0 = local-only).")

    telemetry = p.add_argument_group("cluster telemetry")
    telemetry.add_argument("--no-telemetry", action="store_true",
                           dest="no_telemetry",
                           help="Disable the hierarchical cluster "
                                "telemetry plane (HOROVOD_TELEMETRY=0). "
                                "See docs/observability.md.")
    telemetry.add_argument("--telemetry-interval", type=float,
                           dest="telemetry_interval",
                           help="Telemetry beacon/aggregation cadence in "
                                "seconds (HOROVOD_TELEMETRY_INTERVAL, "
                                "default 2.0). Health thresholds derive "
                                "from it unless overridden.")

    chaos = p.add_argument_group("chaos")
    chaos.add_argument("--chaos-plan", dest="chaos_plan",
                       help="Fault-injection plan exported to every worker "
                            "(HOROVOD_CHAOS_PLAN): a YAML/JSON file path "
                            "(must be readable on the worker hosts) or "
                            "inline YAML/JSON. See docs/robustness.md.")
    chaos.add_argument("--chaos-seed", type=int, dest="chaos_seed",
                       help="Seed overriding the plan's own "
                            "(HOROVOD_CHAOS_SEED) — probabilistic triggers "
                            "are a counter-hash of it, so a seed pins the "
                            "whole injection schedule.")
    chaos.add_argument("--chaos-ledger", dest="chaos_ledger",
                       help="Directory for the per-rank JSONL injection "
                            "ledgers (HOROVOD_CHAOS_LEDGER).")

    serving = p.add_argument_group("serving")
    serving.add_argument("--serving", action="store_true", dest="serving",
                         default=False,
                         help="Serving mode (HOROVOD_SERVING=1): workers "
                              "run the continuous-batching inference "
                              "engine instead of a training loop — e.g. "
                              "`hvdrun --serving -np 8 python -m "
                              "horovod_tpu.serving`. Composes with the "
                              "elastic flags for zero-drop rolling "
                              "restarts (docs/inference.md).")
    serving.add_argument("--serving-port", type=int, dest="serving_port",
                         help="Request-frontend base port "
                              "(HOROVOD_SERVING_PORT); each process binds "
                              "port + local_rank, like --metrics-port.")
    serving.add_argument("--serving-slots", type=int, dest="serving_slots",
                         help="Decode-batch slot count "
                              "(HOROVOD_SERVING_SLOTS; the continuous "
                              "batch's fixed width).")
    serving.add_argument("--serving-queue-limit", type=int,
                         dest="serving_queue_limit",
                         help="Admission-queue capacity "
                              "(HOROVOD_SERVING_QUEUE_LIMIT; 0 = "
                              "unbounded). At the limit the frontend "
                              "answers 503 and /serving/health reports "
                              "saturated.")

    elastic = p.add_argument_group("elastic")
    elastic.add_argument("--min-np", "--min-num-proc", type=int,
                         dest="min_np")
    elastic.add_argument("--max-np", "--max-num-proc", type=int,
                         dest="max_np")
    elastic.add_argument("--elastic-timeout", type=int,
                         dest="elastic_timeout")
    elastic.add_argument("--blacklist-cooldown-range", nargs=2, type=float,
                         dest="blacklist_cooldown_range",
                         help="Base and cap (seconds) of the per-host "
                              "blacklist exponential cooldown")
    elastic.add_argument("--slots-per-host", type=int, dest="slots_per_host")
    elastic.add_argument("--host-discovery-script",
                         dest="host_discovery_script")
    elastic.add_argument("--reset-limit", type=int, dest="reset_limit")

    logg = p.add_argument_group("logging")
    logg.add_argument("--log-level", dest="log_level",
                      choices=["trace", "debug", "info", "warning", "error",
                               "fatal"])
    logg.add_argument("--log-without-timestamp", action="store_true",
                      dest="log_hide_timestamp")
    logg.add_argument("--log-with-timestamp", "--no-log-hide-timestamp",
                      action="store_false", dest="log_hide_timestamp")
    logg.add_argument("--log-hide-timestamp", action="store_true",
                      dest="log_hide_timestamp")

    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="Training command, e.g. python train.py")
    args = p.parse_args(argv)
    if args.config_file:
        config_parser.parse_config_file(args, args.config_file)
    # Launcher-selection aliases override --launcher auto-detection.
    if getattr(args, "use_mpi", False):
        args.launcher = "mpi"
    elif getattr(args, "use_jsrun", False):
        args.launcher = "jsrun"
    elif getattr(args, "use_gloo", False) and args.launcher == "auto":
        args.launcher = "ssh"
    return args


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _resolve_hosts(args):
    if args.hostfile:
        return parse_host_files(args.hostfile)
    if args.hosts:
        return parse_hosts(args.hosts)
    # Inside an LSF allocation with no explicit hosts, use the allocation
    # (reference: launch.py LSF default via util/lsf.py).
    from horovod_tpu_torch.runner import lsf
    if lsf.using_lsf():
        return parse_hosts(lsf.lsf_hosts_string())
    # Default: np slots on this host (reference defaults to localhost:np).
    return parse_hosts(f"localhost:{args.np or 1}")


def _resolve_launcher(args):
    if getattr(args, "launcher", "auto") != "auto":
        return args.launcher
    # jsrun places tasks according to the LSF allocation, so auto-selecting
    # it is only valid when the user did not name hosts explicitly.
    if not args.hosts and not args.hostfile:
        from horovod_tpu_torch.runner import lsf
        if lsf.using_jsrun():
            return "jsrun"
    return "ssh"


def build_worker_env(base_env, slot, coordinator_addr, coordinator_port,
                     kv_port, args, kv_shard_ports=(), flight_dir=None):
    """One slot's env (reference: gloo_run.py:66-78, 203-227 — the rank/size
    env contract between launcher and core): that slot's rank contract, the
    coordinator store's address and port (bound by rank 0 in
    ``hvd.init()``), the launcher's KV store and its shard ports, the job
    secret, the start timeout, and the tuning flags as env vars.
    ``flight_dir``: the elastic driver's own flight directory
    (``runner/elastic/driver.py::driver_flight_dir``), which its workers
    share."""
    env = dict(base_env)
    env.update({
        "HOROVOD_RANK": str(slot.rank),
        "HOROVOD_SIZE": str(slot.size),
        "HOROVOD_LOCAL_RANK": str(slot.local_rank),
        "HOROVOD_LOCAL_SIZE": str(slot.local_size),
        "HOROVOD_CROSS_RANK": str(slot.cross_rank),
        "HOROVOD_CROSS_SIZE": str(slot.cross_size),
        "HOROVOD_COORDINATOR_ADDR": coordinator_addr,
        "HOROVOD_COORDINATOR_PORT": str(coordinator_port),
        "HOROVOD_KV_ADDR": coordinator_addr,
        "HOROVOD_KV_PORT": str(kv_port),
        "HOROVOD_START_TIMEOUT": str(args.start_timeout),
    })
    if kv_shard_ports:
        env["HOROVOD_KV_SHARD_PORTS"] = ",".join(
            str(p) for p in kv_shard_ports)
    if os.environ.get(SECRET_ENV):
        env[SECRET_ENV] = os.environ[SECRET_ENV]
    # The flight recorder's collection point: every worker dumps into one
    # directory, so a disruption leaves one analyzable set of per-rank
    # rings (flight.analyze merges them). An elastic launch defaults it,
    # the launch mode whose failures need the forensics; --flight-dir wins
    # (set_env_from_args below).
    flight_dir = flight_dir or os.environ.get("HOROVOD_FLIGHT_DIR") \
        or getattr(args, "flight_dir", None)
    if not flight_dir and env.get("HOROVOD_ELASTIC"):
        from horovod_tpu_torch.flight.recorder import default_collection_dir
        flight_dir = default_collection_dir(
            getattr(args, "output_filename", None))
    if flight_dir:
        env.setdefault("HOROVOD_FLIGHT_DIR", flight_dir)
    if os.environ.get("HOROVOD_FLIGHT_RECORDER"):
        env.setdefault("HOROVOD_FLIGHT_RECORDER",
                       os.environ["HOROVOD_FLIGHT_RECORDER"])
    # The step profiler's knobs (the ledger, watchdog and capture run in
    # each process; the JSONL stream and the capture directory are shared
    # collection points like the flight directory).
    for var in ("HOROVOD_STEP_PROFILER", "HVD_STEP_REPORT_FILE",
                "HOROVOD_PROFILE_STEPS", "HOROVOD_PROFILE_DIR",
                "HOROVOD_PROFILE_PUBLISH_STEPS"):
        if os.environ.get(var):
            env.setdefault(var, os.environ[var])
    # Every other knob common/config.py::Config declares rides through, so
    # a knob set on the launcher is never silently single-process: a worker
    # on another host gets only this dict (runner/exec.py sends it as
    # `env K=V ...` over ssh). Slice membership and the telemetry
    # thresholds must agree across ranks. The names stay literals:
    # `python -m horovod_tpu_torch.analysis.lint` (HVL007) reads them from
    # this file's AST and flags a declared knob missing here.
    for var in ("HOROVOD_TELEMETRY", "HOROVOD_TELEMETRY_INTERVAL",
                "HOROVOD_TELEMETRY_METRICS", "HOROVOD_TELEMETRY_DEAD_AFTER",
                "HOROVOD_TELEMETRY_STALL_AFTER",
                "HOROVOD_TELEMETRY_STEP_LAG", "HOROVOD_TELEMETRY_SEQ_LAG",
                "HOROVOD_MESH_SLICES",
                "HOROVOD_LOG_LEVEL", "HOROVOD_LOG_HIDE_TIME",
                "HOROVOD_BLACKLIST_COOLDOWN_RANGE",
                "HOROVOD_PROFILE_HISTORY",
                "HOROVOD_PROFILE_PUBLISH_TIMEOUT_MS",
                "HOROVOD_PROFILE_Z_THRESHOLD",
                "HOROVOD_PROFILE_STRAGGLER_MIN_MS",
                "HOROVOD_PEAK_TFLOPS", "HOROVOD_PEAK_HBM_GBS",
                "HOROVOD_PEAK_ICI_GBS", "HOROVOD_PEAK_DCN_GBS",
                "HOROVOD_WIRE_DTYPE", "HOROVOD_WIRE_ERROR_FEEDBACK",
                "HOROVOD_WIRE_DTYPE_DCN", "HOROVOD_HIERARCHICAL_DISPATCH",
                "HOROVOD_CROSS_OVERLAP", "HOROVOD_HIERARCHICAL_ALLTOALL",
                "HOROVOD_ALLTOALL_CROSS_DTYPE",
                "HOROVOD_CONTROL_PLANE", "HOROVOD_KV_SHARD_COUNT",
                "HOROVOD_KV_SHARD_PORT_BASE", "HOROVOD_CONTROL_LEASE_MS",
                "HOROVOD_AUTOPILOT", "HOROVOD_AUTOPILOT_INTERVAL",
                "HOROVOD_AUTOPILOT_MAX_REMOVALS",
                "HOROVOD_AUTOPILOT_HYSTERESIS",
                "HOROVOD_AUTOPILOT_MIN_WORLD",
                "HOROVOD_AUTOPILOT_PRIOR",
                "HOROVOD_SIM_KV_US", "HOROVOD_SIM_DCN_US",
                "HOROVOD_SERVING", "HOROVOD_SERVING_PORT",
                "HOROVOD_SERVING_SLOTS", "HOROVOD_SERVING_MAX_LEN",
                "HOROVOD_SERVING_PREFILL_CHUNK",
                "HOROVOD_SERVING_QUEUE_LIMIT",
                "HOROVOD_SERVING_MIGRATE_KV", "HOROVOD_SERVING_MODEL",
                "HOROVOD_SERVING_COMMIT_STEPS",
                "HOROVOD_TRACE", "HOROVOD_TRACE_CAPACITY",
                "HOROVOD_TRACE_DIR",
                "HOROVOD_JOIN_MODE", "HOROVOD_FLIGHT_CAPACITY",
                "HOROVOD_KV_RETRIES", "HOROVOD_KV_RETRY_BACKOFF_MS",
                "HOROVOD_KV_RETRY_BACKOFF_MAX_MS",
                "HOROVOD_SLO_TTFT_P99_MS", "HOROVOD_SLO_TPS",
                "HOROVOD_SLO_WINDOW_S",
                "HOROVOD_GOODPUT", "HOROVOD_GOODPUT_DIR",
                "HOROVOD_GOODPUT_JOURNAL_S", "HOROVOD_RUN_HISTORY_DIR",
                "HOROVOD_RUN_ID",
                "HOROVOD_METRICS", "HOROVOD_METRICS_PORT",
                "HOROVOD_METRICS_ADDR", "HOROVOD_METRICS_PREFIX",
                # Knobs the JAX launcher carries only from its flags
                # (config_parser): set in the launcher's env, they ride
                # too.
                "HOROVOD_FUSION_THRESHOLD", "HOROVOD_CYCLE_TIME",
                "HOROVOD_ELASTIC",
                "HOROVOD_HIERARCHICAL_ALLREDUCE",
                "HOROVOD_HIERARCHICAL_ALLGATHER", "HOROVOD_TORUS_ALLREDUCE",
                "HOROVOD_ELASTIC_TIMEOUT",
                "HOROVOD_AUTOTUNE", "HOROVOD_AUTOTUNE_LOG",
                "HOROVOD_AUTOTUNE_WARMUP_SAMPLES",
                "HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE",
                "HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES",
                "HOROVOD_AUTOTUNE_GAUSSIAN_PROCESS_NOISE",
                "HOROVOD_TIMELINE", "HOROVOD_TIMELINE_MARK_CYCLES",
                "HOROVOD_STALL_CHECK_DISABLE",
                "HOROVOD_STALL_CHECK_TIME_SECONDS",
                "HOROVOD_STALL_SHUTDOWN_TIME_SECONDS",
                "HOROVOD_ORDER_CHECK",
                "HOROVOD_CHAOS_PLAN", "HOROVOD_CHAOS_SEED",
                "HOROVOD_CHAOS_LEDGER"):
        if os.environ.get(var):
            env.setdefault(var, os.environ[var])
    config_parser.set_env_from_args(env, args)
    return env


def _start_rendezvous(args):
    """Shared bootstrap of the static launchers: host assignment, the
    coordinator address and ports, the KV server (reference:
    RendezvousServer start in launch_gloo, gloo_run.py:242-260)."""
    hosts = _resolve_hosts(args)
    slot_infos = get_host_assignments(hosts, args.np or None)
    by_host = host_assignment_by_host(slot_infos)
    coordinator_addr = socket.gethostname() \
        if len(by_host) > 1 else "localhost"
    # Picked here, bound by rank 0's TCPStore: a port taken in between fails
    # hvd.init() with a named error, and the launcher reaps the run.
    coordinator_port = _free_port()
    # A per-job secret: all KV control-plane traffic is HMAC-signed
    # (reference: secret.py per-job key + network.py:306 signed messages).
    os.environ.setdefault(SECRET_ENV, make_secret_key())
    # Per-slice shard listeners when the hierarchical control plane is
    # armed (or --kv-shard-count asks): the slice-local scopes never touch
    # the root listener.
    from horovod_tpu_torch.common import control_plane as _cp
    from horovod_tpu_torch.common.config import _env_int
    flag_env = config_parser.set_env_from_args(dict(os.environ), args)
    kv = KVStoreServer(
        shards=_cp.kv_shard_count(slot_infos[0].size, env=flag_env),
        shard_port_base=_env_int("HOROVOD_KV_SHARD_PORT_BASE", 0, flag_env))
    kv_port = kv.start()
    kv.put("global", "size", str(slot_infos[0].size).encode())
    return slot_infos, by_host, coordinator_addr, coordinator_port, kv, kv_port


def _run_static_mpi(args, launcher, extra_env=None):
    """mpirun/jsrun fan-out: one launcher invocation starts one worker per
    slot; each reads its rank contract from the MPI-provided env
    (OMPI_COMM_WORLD_* / PMI_*, ``Config.from_env``)."""
    from horovod_tpu_torch.runner import js_run as js_mod
    from horovod_tpu_torch.runner import mpi_run as mpi_mod

    slot_infos, by_host, coordinator_addr, coordinator_port, kv, kv_port = \
        _start_rendezvous(args)
    first = slot_infos[0]
    env = dict(extra_env or {})
    env.update({
        "HOROVOD_SIZE": str(first.size),
        "HOROVOD_LOCAL_SIZE": str(first.local_size),
        "HOROVOD_CROSS_SIZE": str(len(by_host)),
        "HOROVOD_COORDINATOR_ADDR": coordinator_addr,
        "HOROVOD_COORDINATOR_PORT": str(coordinator_port),
        "HOROVOD_KV_ADDR": coordinator_addr,
        "HOROVOD_KV_PORT": str(kv_port),
        "HOROVOD_START_TIMEOUT": str(args.start_timeout),
    })
    if kv.shard_ports:
        env["HOROVOD_KV_SHARD_PORTS"] = ",".join(
            str(p) for p in kv.shard_ports)
    if os.environ.get(SECRET_ENV):
        env[SECRET_ENV] = os.environ[SECRET_ENV]
    config_parser.set_env_from_args(env, args)
    import shlex
    extra = shlex.split(args.mpi_args) if getattr(args, "mpi_args", "") \
        else None
    host_slots = [(h, len(slots)) for h, slots in by_host.items()]
    try:
        if launcher == "jsrun":
            return js_mod.js_run(host_slots, env, args.command,
                                 extra_js_args=extra)
        return mpi_mod.mpi_run(host_slots, env, args.command,
                               extra_mpi_args=extra)
    finally:
        kv.stop()


def _bootstrap_watchdog(kv, expected_ranks, warn_after=45.0):
    """Diagnose dead launches early: every worker registers a reachability
    probe in the KV as ``hvd.init()`` starts (runner/task.py
    ``register_bootstrap``, the analog of the reference's NIC probing
    task_fn.py:23-54). If some never do, warn naming the missing ranks."""
    import threading as _threading
    import time as _time

    done = _threading.Event()

    def watch():
        deadline = _time.time() + warn_after
        missing = set(expected_ranks)
        while missing and _time.time() < deadline:
            for r in list(missing):
                if kv.get("bootstrap", str(r)) is not None:
                    missing.discard(r)
            if done.wait(1.0):
                return  # run finished: a missing probe is moot, not a fault
        if missing and not done.is_set():
            hvd_logging.warning(
                "no bootstrap probe from rank(s) %s after %.0fs — check "
                "ssh/network reachability from those hosts to the launcher "
                "(KV port)", sorted(missing), warn_after)

    t = _threading.Thread(target=watch, daemon=True)
    t.start()
    t.cancel = done.set
    return t


def _run_static(args, extra_env=None, harvest=None, kv_preload=None):
    """Start one worker per slot and wait: the first failing worker's exit
    code (the rest are terminated), else 0 after ``harvest(kv)``."""
    slot_infos, by_host, coordinator_addr, coordinator_port, kv, kv_port = \
        _start_rendezvous(args)
    for (scope, key), value in (kv_preload or {}).items():
        kv.put(scope, key, value)

    workers = []
    try:
        for slot in slot_infos:
            env = build_worker_env(dict(extra_env or {}), slot,
                                   coordinator_addr, coordinator_port,
                                   kv_port, args,
                                   kv_shard_ports=kv.shard_ports)
            workers.append(WorkerProcess(
                slot.hostname, args.command, env, tag=str(slot.rank),
                ssh_port=args.ssh_port,
                ssh_identity_file=args.ssh_identity_file,
                output_dir=getattr(args, "output_filename", None),
                rank=slot.rank,
                prefix_timestamp=getattr(args, "prefix_output_with_timestamp",
                                         False)))
        expected = [s.rank for s in slot_infos]
        watchdog = _bootstrap_watchdog(kv, expected)
        failures = wait_for_any_failure_or_all_success(workers)
        watchdog.cancel()
        if failures:
            hvd_logging.error("workers failed (rank: exit code): %s",
                              failures)
            # Ranks that never probed in likely could not reach the launcher.
            missing = [r for r in expected
                       if kv.get("bootstrap", str(r)) is None]
            if missing:
                hvd_logging.error(
                    "rank(s) %s never reached the launcher control plane — "
                    "check ssh/network from those hosts to the launcher (KV "
                    "port)", sorted(missing))
            rc = next(iter(failures.values()))
            return rc if rc > 0 else 1
        if harvest is not None:
            harvest(kv)
        return 0
    finally:
        # Reap surviving workers on any exit path: an exception out of the
        # wait (a launcher-side timeout or interrupt) must not leave workers
        # running, perhaps blocked in a collective (reference: gloo_run
        # terminates the job when the launcher exits). No-op for exited workers.
        try:
            for w in workers:
                try:
                    w.terminate()
                except Exception:  # noqa: BLE001 — best-effort reaping
                    pass
        finally:
            kv.stop()


def _run_elastic(args):
    from horovod_tpu_torch.runner.elastic.driver import run_elastic_driver
    return run_elastic_driver(args)


def check_build_text():
    import torch
    import torch.distributed as dist

    def mark(ok):
        return "X" if ok else " "
    cuda = torch.backends.cuda.is_built()
    return ("Horovod-TPU PyTorch port (horovod_tpu_torch):\n\n"
            f"Available Frameworks:\n    [X] PyTorch {torch.__version__}\n\n"
            "Available Controllers:\n    [X] torch.distributed (TCPStore)\n"
            "\nAvailable Tensor Operations:\n"
            f"    [{mark(cuda and dist.is_nccl_available())}] NCCL"
            f"{' ' + str(torch.cuda.nccl.version()) if cuda and dist.is_nccl_available() else ''}\n"
            f"    [{mark(dist.is_gloo_available())}] gloo\n"
            f"    [{mark(dist.is_mpi_available())}] MPI\n\n"
            f"CUDA: {'[X] ' + str(torch.version.cuda) if cuda else '[ ]'}\n\n"
            "Available Features:\n    [X] process sets\n    [X] Adasum\n"
            "    [X] join\n    [X] elastic\n    [X] timeline\n")


def run_commandline(argv=None):
    args = parse_args(argv)
    if args.version:
        from importlib import metadata
        try:
            print(metadata.version("horovod-tpu"))
        except metadata.PackageNotFoundError:
            print("unknown")
        return 0
    if args.check_build:
        print(check_build_text())
        return 0
    if not args.command:
        print("error: no training command given", file=sys.stderr)
        return 2
    if args.log_level:
        os.environ["HOROVOD_LOG_LEVEL"] = args.log_level
    try:
        if args.host_discovery_script or args.min_np or args.max_np:
            return _run_elastic(args)
        launcher = _resolve_launcher(args)
        if launcher in ("mpi", "jsrun"):
            return _run_static_mpi(args, launcher)
        return _run_static(args)
    except (ValueError, TimeoutError) as e:
        print(f"hvdrun-torch: error: {e}", file=sys.stderr)
        return 1


def main():
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
