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
``HOROVOD_ELASTIC_INIT_VERSION``).
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
