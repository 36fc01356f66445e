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
``HOROVOD_ALLTOALL_CROSS_DTYPE``).
"""

import dataclasses
import os


def _env_int(name, default):
    v = os.environ.get(name)
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
    # JAX's cross-leg overlap: a hierarchical bucket's cross leg left in
    # flight past its flush. Read and kept: its scheduler is steered by the
    # step profiler, which comes with ROADMAP A16; until then every bucket
    # completes inside its flush.
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
