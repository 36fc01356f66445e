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
        # The process group's store (the TCPStore rank 0 serves): the
        # fusion runtime publishes and reads its flush boundaries there.
        self.store = None
        # Ranks that called hvd.join(), as the last join round showed them
        # (ops/collective_ops.py); the global set's share of the protocol.
        self.joined_ranks = set()
        # Why the process group was aborted (abort()); None while it runs.
        self.aborted = None


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
        st, _state = _state, None
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
