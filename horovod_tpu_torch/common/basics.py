"""Init, shutdown and the rank/size family for the PyTorch/CUDA port.

Port of the JAX package's ``common/basics.py`` (``init``, ``shutdown``,
``is_initialized``, the rank/size queries and the ``*_built`` capability
queries, ``ici_built`` among them; reference: horovod/common/basics.py:51-148, operations.cc:1119-1449).

Where the JAX package bootstraps ``jax.distributed`` over the TPU mesh, the
port creates one ``torch.distributed`` process group: NCCL on the GPU, gloo
on the CPU. Rank and size come from the launcher's env contract
(HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/CROSS_RANK/CROSS_SIZE and
HOROVOD_COORDINATOR_ADDR/PORT); with no env it is a 1-process world, as the
reference at np=1. One process drives one device.

Elastic runs (``elastic/state.py``) shut down and init again in one process
at each membership change: ``shutdown(abort=True)`` aborts the process group
instead of draining it, since peers may be dead, and the next ``init`` reads
the refreshed HOROVOD_* contract, serves or reaches a new store at the
version's coordinator port and builds a new group on the same device.
``abort`` is the membership watchdog's: it aborts the group from another
thread, so a collective blocked on a dead peer raises, and every later one
raises ``HorovodInternalError`` until the shutdown.

``init`` also arms the chaos plan (``HOROVOD_CHAOS_PLAN``) and the per-rank
observability planes from the config (the flight recorder, the step
profiler and goodput before the bootstrap; the trace store, the SLOs,
metrics and its endpoint, the timeline and the run journal after it) and,
once the world is known, the cluster telemetry agent (with the launcher's
KV and more than one process); ``shutdown`` closes them (the run journal
gets the cluster view and the goodput summary, the agent stops, the
timeline is written with the registry's totals, the step profiler's open
window dropped, a capture still open written out). The negotiation keys
start at epoch 0 with each new store, and their sequences at 0 after each
shutdown. ``start_timeline``/``stop_timeline`` are the
reference's (operations.cc:1079-1111).
"""

import atexit
import datetime
import os
import threading

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.config import Config
from horovod_tpu_torch.ops import wire
from horovod_tpu_torch.common.exceptions import (HorovodInternalError,
                                                 NotInitializedError)

_lock = threading.Lock()
_state = None
_asked_device = None    # init()'s device argument, for an elastic re-init

_STORE_TIMEOUT = datetime.timedelta(seconds=300)


class _State:
    def __init__(self, config, device, rank, size, local_rank, local_size,
                 cross_rank, cross_size):
        self.config = config
        self.device = device
        self.backend = "nccl" if device.type == "cuda" else "gloo"
        self.rank = rank
        self.size = size
        self.local_rank = local_rank
        self.local_size = local_size
        self.cross_rank = cross_rank
        self.cross_size = cross_size
        self.process_set_table = None   # set by process_sets._init_table
        self.topology = None            # common.topology.Topology
        self.fusion = None              # set lazily by ops.fusion
        # Runtimes built in this world so far (ops.fusion.reset_runtime):
        # each one's store keys are its own.
        self.fusion_generation = 0
        # The process group's store (the TCPStore rank 0 serves): the
        # fusion runtime publishes and reads its flush boundaries there,
        # and negotiation exchanges through its own clone of it.
        self.store = None
        self.negotiation_store = None
        # Ranks that called hvd.join(), as the last join round showed them
        # (ops/collective_ops.py); the global set's share of the protocol.
        self.joined_ranks = set()
        # Why the process group was aborted (abort()); None while it runs.
        self.aborted = None
        self.timeline = None            # set by start_timeline


def _no_gpu_error():
    return HorovodInternalError(
        "hvd.init(): no CUDA device is visible to PyTorch. The port runs on "
        "the GPU (NCCL); call hvd.init(device=\"cpu\") to run on the CPU "
        "over gloo.")


def _resolve_device(device, local_rank):
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise _no_gpu_error()
        if device.index is None:
            device = torch.device("cuda", local_rank)
    elif device.type != "cpu":
        raise ValueError(f"hvd.init(device={device!s}): the port runs on "
                         "'cuda' or 'cpu'")
    return device


def init(comm=None, process_sets=None, device=None):
    """Initialize Horovod on this process's device.

    ``device`` defaults to the GPU of this process's local rank, with NCCL;
    with no CUDA device the call raises :class:`HorovodInternalError` rather
    than carry on elsewhere. ``device="cpu"`` selects gloo and the kernels'
    plain PyTorch versions (the CPU test tier). ``comm`` is accepted for API
    compatibility; rank subsets use ``process_sets``.
    """
    global _state, _asked_device
    with _lock:
        if _state is not None:
            return
        config = Config.from_env()
        if config.chaos_plan:
            # Before any control-plane traffic, so the whole bootstrap is
            # injectable; idempotent across an elastic re-init (the site
            # counters and the ledger survive it).
            from horovod_tpu_torch.chaos import injector as _chaos
            _chaos.install_from_env()
        # The per-rank observability planes arm before the bootstrap, so
        # the flight ring covers it and goodput books it to init_compile;
        # each survives an elastic re-init (the ring, the completed step
        # records and the goodput decomposition are the evidence).
        _arm_planes(config)
        size = config.size if config.size > 0 else 1
        rank = config.rank
        if not 0 <= rank < size:
            raise HorovodInternalError(
                f"HOROVOD_RANK={rank} is outside [0, HOROVOD_SIZE={size})")
        local_size = config.local_size if config.local_size > 0 else size
        cross_size = config.cross_size if config.cross_size > 0 else 1
        dev = _resolve_device(device, config.local_rank)
        if os.environ.get("HOROVOD_KV_ADDR"):
            # A launched worker: tell the launcher's watchdog it got here.
            from horovod_tpu_torch.runner.task import register_bootstrap
            register_bootstrap()
        if dist.is_initialized():
            raise HorovodInternalError(
                "torch.distributed is already initialized; hvd.init() owns "
                "the process group")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            if config.elastic:
                # On a collective error NCCL's watchdog aborts the
                # communicators and the caller's wait raises, which the
                # elastic loop recovers from, instead of ending the process.
                os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "2")
        if size == 1:
            store = dist.HashStore()
        else:
            if not config.coordinator_port:
                raise HorovodInternalError(
                    f"HOROVOD_SIZE={size} needs HOROVOD_COORDINATOR_ADDR/PORT "
                    "(set by the launcher)")
            addr = config.coordinator_addr or "127.0.0.1"
            try:
                store = dist.TCPStore(
                    addr, config.coordinator_port, size,
                    is_master=(rank == 0), timeout=datetime.timedelta(
                        seconds=config.start_timeout))
            except Exception as e:   # a port taken since the launcher's pick
                raise HorovodInternalError(
                    f"rank {rank}: the coordinator store at {addr}:"
                    f"{config.coordinator_port} could not be "
                    f"{'served' if rank == 0 else 'reached'} within "
                    f"{config.start_timeout:.0f} s "
                    f"(HOROVOD_START_TIMEOUT): {e}") from e
        st = _State(config, dev, rank, size, config.local_rank, local_size,
                    config.cross_rank, cross_size)
        st.store = store
        # A new store every init (rank 0 serves it): its keys start empty.
        from horovod_tpu_torch.common import negotiation as _negotiation
        _negotiation.reset_epoch()
        dist.init_process_group(st.backend, store=store, rank=rank,
                                world_size=size, timeout=_STORE_TIMEOUT)
        _state, _asked_device = st, device
        from horovod_tpu_torch.common import topology as _topology
        st.topology = _topology.Topology(
            size, rank, local_size, cross_size,
            forced=_topology.parse_slices(config.mesh_slices))
        # The subgroups of an armed tier, on every rank at once (a later
        # first use would create them inside a flush).
        if config.hierarchical_allreduce or config.torus_allreduce \
                or config.hierarchical_dispatch:
            st.topology.tiers(st.topology.strategy_shape())
        if config.hierarchical_allgather:
            st.topology.tiers(st.topology.node_shape())
        from horovod_tpu_torch.common import process_sets as _ps
        _ps._init_table(st, process_sets)
        atexit.register(_stop_threads_at_exit, st)
        _configure_observability(config, st.local_rank)
        # The cluster telemetry plane, once the world and its slices are
        # known; it starts only with the launcher's KV and more than one
        # process, else cluster_snapshot() serves the local view.
        try:
            from horovod_tpu_torch.telemetry import aggregator as _telemetry
            _telemetry.start_from_config(config, st.topology, rank, size)
        except Exception as e:  # noqa: BLE001 — must not block init
            from horovod_tpu_torch.common import logging as hvd_logging
            hvd_logging.warning("telemetry plane failed to start: %s", e)
        # The autopilot (HOROVOD_AUTOPILOT), process 0 only, after the
        # telemetry plane so its first frame reads the health view; an
        # elastic re-init re-arms it under the new membership.
        try:
            from horovod_tpu_torch.autopilot import controller as _autopilot
            _autopilot.start_from_config(config)
        except Exception as e:  # noqa: BLE001 — must not block init
            from horovod_tpu_torch.common import logging as hvd_logging
            hvd_logging.warning("autopilot failed to start: %s", e)
        if config.timeline_filename:
            _start_timeline_locked(st, config.timeline_filename,
                                   config.timeline_mark_cycles)
        # The durable run journal (HOROVOD_RUN_HISTORY_DIR), on rank 0 once
        # the world is known; armed once: an elastic re-init keeps
        # appending to the same run's journal.
        try:
            from horovod_tpu_torch.goodput import history as _run_history
            if _run_history.get_journal() is None:
                _run_history.journal_configure(
                    config, rank=rank, world=size,
                    run_id=config.run_id or None)
        except Exception as e:  # noqa: BLE001 — must not block init
            from horovod_tpu_torch.common import logging as hvd_logging
            hvd_logging.warning("run-history journal failed to arm: %s", e)


def _arm_planes(config):
    """The flight recorder, the step profiler and the goodput ledger, from
    the config (JAX's ``init`` arms them in this order)."""
    from horovod_tpu_torch.flight import recorder as _flight
    from horovod_tpu_torch.goodput import ledger as _goodput
    from horovod_tpu_torch.profile import ledger as _profile
    _flight.configure(config)
    _profile.configure(config)
    _goodput.configure(config)


def _close_planes(st):
    """At shutdown (an elastic reset's too): the run journal gets the
    cluster view, the telemetry agent stops, the negotiation sequences
    reset, the timeline ends with the registry's totals as counter events,
    the run journal gets the goodput summary, the step profiler discards
    its OPEN window (recovery traffic must not land in the first step after
    it) and a capture still open is written out. Never raises."""
    from horovod_tpu_torch import metrics as hvd_metrics
    from horovod_tpu_torch.common import negotiation as _negotiation
    from horovod_tpu_torch.telemetry import aggregator as _telemetry
    try:
        # The job view, while the agent still runs: the journal reader
        # takes the last record of each kind.
        from horovod_tpu_torch.goodput import history as _run_history
        if _run_history.get_journal() is not None \
                and _telemetry.get_agent() is not None:
            _run_history.journal_append("cluster",
                                        view=_telemetry.cluster_snapshot())
    except Exception:  # noqa: BLE001
        pass
    try:
        # The agent's keys are this membership's: the next init starts one
        # under the next generation.
        _telemetry.stop()
        _negotiation.reset()
    except Exception:  # noqa: BLE001 — must not block the shutdown
        pass
    if st.timeline is not None:
        try:
            hvd_metrics.emit_timeline_counters(st.timeline)
            st.timeline.close()
        except Exception:  # noqa: BLE001 — observability must not block
            pass
        st.timeline = None
    try:
        from horovod_tpu_torch.goodput import history as _run_history
        if _run_history.get_journal() is not None:
            from horovod_tpu_torch.goodput import ledger as _goodput
            _run_history.journal_append("goodput",
                                        summary=_goodput.snapshot())
    except Exception:  # noqa: BLE001
        pass
    try:
        from horovod_tpu_torch.profile import capture as _capture
        from horovod_tpu_torch.profile import ledger as _profile
        _profile.reset_window()
        _capture.shutdown()
    except Exception:  # noqa: BLE001
        pass
    hvd_metrics.instruments.reset_tier_split()


def _configure_observability(config, local_rank):
    """Request tracing and the declared SLOs, then the metrics registry's
    switches and, with ``HOROVOD_METRICS_PORT``, its scrape endpoint at
    ``port + local_rank``, as JAX's ``init`` arms them. The trace store and
    the registry survive a re-init: a requeued request's spans are its
    history. A port that will not bind is logged, never fatal."""
    from horovod_tpu_torch import metrics as hvd_metrics
    from horovod_tpu_torch import trace as _trace
    from horovod_tpu_torch.common import logging as hvd_logging
    from horovod_tpu_torch.telemetry import slo as _slo
    _trace.configure(config)
    _slo.configure(config)
    hvd_metrics.set_enabled(config.metrics)
    hvd_metrics.set_prefix(config.metrics_prefix)
    if config.metrics and config.metrics_port:
        try:
            port = hvd_metrics.start_http_server(
                config.metrics_port + local_rank, addr=config.metrics_addr)
            hvd_logging.info("metrics scrape endpoint on :%d", port)
        except OSError as e:
            hvd_logging.warning("metrics endpoint failed to bind: %s", e)


def _stop_threads_at_exit(st):
    """A process that exits without ``shutdown()`` (a failed worker) stops
    the fusion runtime's threads first: a thread inside a store call while
    the interpreter finalizes would abort the process and lose its exit
    code."""
    if st.fusion is not None:
        st.fusion.stop_threads()


def asked_device():
    """The ``device`` argument of the last ``init()`` that succeeded: an
    elastic re-init asks for the same."""
    return _asked_device


def _abort_locked(st, reason):
    """Fail the fusion runtime's pending handles and abort the process
    group (every group of the world), with no store traffic and no wait on
    peers."""
    if st.aborted is None:
        st.aborted = reason
    if st.fusion is not None:
        st.fusion.abort(HorovodInternalError(reason))
    if dist.is_initialized():
        dist.distributed_c10d._abort_process_group()


def abort(reason):
    """Abort the process group from any thread (the elastic membership
    watchdog): a collective blocked on a dead peer raises, and every later
    collective raises ``HorovodInternalError(reason)`` until
    ``shutdown()``."""
    with _lock:
        if _state is not None and _state.aborted is None:
            _abort_locked(_state, reason)


def shutdown(abort=False):
    """Flush pending fused collectives, stop and join the fusion runtime's
    threads, and tear down the process group (reference: horovod_shutdown,
    operations.cc:1006-1013). ``abort=True``, or a group already aborted:
    fail the pending handles and abort the group instead, without waiting
    on peers that may be dead (the elastic reset)."""
    global _state
    with _lock:
        if _state is None:
            return
        # The autopilot first, while the runtime it steers is reachable:
        # its pin goes with it, and get_controller() is None after.
        try:
            from horovod_tpu_torch.autopilot import controller as _autopilot
            _autopilot.stop()
        except Exception:  # noqa: BLE001 — must not block exit
            pass
        st, _state = _state, None
        try:
            _shutdown_locked(st, abort)
        finally:
            _close_planes(st)


def _shutdown_locked(st, abort):
    """The process group's teardown: aborted, or drained and destroyed."""
    from horovod_tpu_torch.metrics.server import stop_http_server
    stop_http_server()
    # Residuals are sized and padded for this world: a resized one
    # (the elastic reset) must not replay them. The runtime's synced
    # wire goes with it; the user's pins stay.
    wire.reset_error_feedback()
    wire.clear_runtime_wire()
    if abort or st.aborted is not None:
        _abort_locked(st, st.aborted or "the process group was shut "
                      "down by an elastic reset")
        if st.process_set_table is not None:
            st.process_set_table.destroy_groups(aborted=True)
        if st.topology is not None:
            st.topology.destroy(aborted=True)
        # The store (rank 0's server) goes with its last reference: a
        # re-init at an unchanged version binds the same port again.
        st.store = None
        return
    try:
        if st.fusion is not None:
            st.fusion.shutdown()
    finally:
        if st.process_set_table is not None:
            st.process_set_table.destroy_groups()
        if st.topology is not None:
            st.topology.destroy()
        dist.destroy_process_group()


def is_initialized():
    """reference: horovod_is_initialized (operations.cc:1027)."""
    return _state is not None


def _get_state():
    if _state is None:
        raise NotInitializedError()
    return _state


def device():
    """The ``torch.device`` this process's collectives run on."""
    return _get_state().device


# --- rank / size queries (reference: operations.cc:1119-1229) ---

def size():
    return _get_state().size


def local_size():
    return _get_state().local_size


def cross_size():
    return _get_state().cross_size


def rank():
    return _get_state().rank


def local_rank():
    return _get_state().local_rank


def cross_rank():
    return _get_state().cross_rank


def is_homogeneous():
    """reference: horovod_is_homogeneous (operations.cc:1233): every host
    runs local_size processes."""
    st = _get_state()
    return st.local_size * st.cross_size == st.size


# --- build-capability queries (reference: operations.cc:1307-1449), each
# answered by what this PyTorch build offers.

def mpi_threads_supported():
    return False


def mpi_enabled():
    return False


def mpi_built():
    return dist.is_mpi_available()


def gloo_enabled():
    return is_initialized() and _state.backend == "gloo"


def gloo_built():
    return dist.is_gloo_available()


def nccl_built():
    return dist.is_nccl_available()


def ddl_built():
    return False


def ccl_built():
    return False


def cuda_built():
    return torch.backends.cuda.is_built()


def rocm_built():
    return torch.version.hip is not None


def xla_built():
    """The port's data plane is NCCL/gloo, not XLA."""
    return False


def ici_built():
    """No TPU interconnect (ICI) on a GPU."""
    return False


# --- timeline control (reference: horovod_start_timeline,
# operations.cc:1079-1111) ---

def _start_timeline_locked(st, file_path, mark_cycles=False):
    from horovod_tpu_torch.timeline import Timeline
    if st.timeline is not None:
        st.timeline.close()
    st.timeline = Timeline(file_path, mark_cycles=mark_cycles,
                           device=st.device)
    return st.timeline


def start_timeline(file_path, mark_cycles=False):
    """Start (or restart) the Chrome-trace timeline of this process's
    collectives into ``file_path`` (written when it stops, or at
    ``shutdown()``). ``hvd.init()`` starts it when ``HOROVOD_TIMELINE``
    is set."""
    return _start_timeline_locked(_get_state(), file_path, mark_cycles)


def stop_timeline():
    """Stop the timeline and write its file."""
    st = _get_state()
    if st.timeline is not None:
        st.timeline.close()
        st.timeline = None


def timeline():
    """The running :class:`~horovod_tpu_torch.timeline.Timeline`, or
    None (also before ``init``)."""
    st = _state
    return st.timeline if st is not None else None


def metrics_snapshot():
    """JSON-able dict of every metrics series' current value. Works before
    init too — the registry is process-global."""
    from horovod_tpu_torch import metrics as hvd_metrics
    return hvd_metrics.snapshot()


def metrics_text():
    """The metrics registry in Prometheus text exposition format 0.0.4 —
    the payload the ``HOROVOD_METRICS_PORT`` scrape endpoint serves."""
    from horovod_tpu_torch import metrics as hvd_metrics
    return hvd_metrics.render_text()
