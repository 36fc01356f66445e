"""Launch workers with ``mpirun`` instead of ssh fan-out.

Reference: horovod/runner/mpi_run.py (implementation detection via
``mpirun --version`` :60-131, per-implementation flags, ``-x`` env forwarding,
``-H`` host list). Port of the JAX package's ``runner/mpi_run.py``, with one
rank per slot as ``horovodrun --mpi`` starts them: ``-np`` is the number of
slots and ``-H`` lists each host with its slots. mpirun is only the process
launcher: each worker reads its rank contract from the MPI-provided env
(``OMPI_COMM_WORLD_*``/``PMI_*``, ``common/config.py``) and bootstraps the
process group through the coordinator store; NCCL (or gloo) is the data
plane.
"""

import os
import shutil
import subprocess

# Implementation names (reference: mpi_run.py:26-31).
OPENMPI = "OpenMPI"
SPECTRUM_MPI = "SpectrumMPI"
MPICH = "MPICH"
INTEL_MPI = "IntelMPI"
UNKNOWN = "Unknown"
MISSING = "Missing"

# Env prefixes always forwarded to workers, mirroring the reference's
# env filtering (reference: horovod/runner/common/util/env.py).
_FORWARD_PREFIXES = ("HOROVOD_", "NCCL_", "CUDA_", "TORCH_", "PATH",
                     "PYTHONPATH", "LD_LIBRARY_PATH")


def _impl_from_version_output(output):
    """Classify an ``mpirun --version`` banner (reference: mpi_run.py:80-131)."""
    if "Open MPI" in output or "OpenRTE" in output or "OpenMPI" in output:
        return OPENMPI
    if "IBM Spectrum MPI" in output:
        return SPECTRUM_MPI
    if "Intel(R) MPI" in output:
        return INTEL_MPI
    if "MPICH" in output or "HYDRA" in output:
        return MPICH
    return UNKNOWN


def get_mpi_implementation(env=None):
    env = dict(env) if env is not None else dict(os.environ)
    mpirun = shutil.which("mpirun", path=env.get("PATH"))
    if mpirun is None:
        return MISSING
    try:
        out = subprocess.run([mpirun, "--version"], capture_output=True,
                             text=True, timeout=30, env=env)
    except (OSError, subprocess.TimeoutExpired):
        return MISSING
    return _impl_from_version_output(out.stdout + out.stderr)


def mpi_available(env=None):
    return get_mpi_implementation(env) not in (UNKNOWN, MISSING)


def _forwarded_env_flags(impl, env):
    names = sorted(k for k in env
                   if k.startswith(_FORWARD_PREFIXES) or k in
                   ("HOME", "USER", "SHELL"))
    flags = []
    if impl in (OPENMPI, SPECTRUM_MPI):
        for n in names:
            flags += ["-x", n]
    elif impl == INTEL_MPI or impl == MPICH:
        if names:
            flags += ["-genvlist", ",".join(names)]
    return flags


def build_mpi_command(impl, hosts, env, command, extra_mpi_args=None):
    """Compose the mpirun command line. ``hosts``: ``[(host, slots)]``; one
    rank per slot, placed host-major (``--map-by slot``), as
    ``get_host_assignments`` numbers them."""
    np_total = sum(n for _, n in hosts)
    cmd = ["mpirun", "--allow-run-as-root" if impl == OPENMPI else None,
           "-np", str(np_total)]
    cmd = [c for c in cmd if c]
    if len(hosts) > 1 or hosts[0][0] not in ("localhost", "127.0.0.1"):
        cmd += ["-H", ",".join(f"{h}:{n}" for h, n in hosts)]
    if impl == OPENMPI:
        # reference mpi_run.py:46: -bind-to none -map-by slot
        cmd += ["--bind-to", "none", "--map-by", "slot"]
        cmd += ["--mca", "pml", "ob1", "--mca", "btl", "^openib"]
    elif impl == SPECTRUM_MPI:
        cmd += ["-tcp"]
    elif impl in (MPICH, INTEL_MPI):
        # Hydra: consecutive ranks fill a host's slots first.
        cmd += ["-ppn", str(hosts[0][1])]
    cmd += _forwarded_env_flags(impl, env)
    if extra_mpi_args:
        cmd += list(extra_mpi_args)
    cmd += list(command)
    return cmd


def mpi_run(hosts, env, command, extra_mpi_args=None, dry_run=False):
    """Run the training command across hosts via mpirun; returns exit code."""
    full_env = {**os.environ, **env}
    impl = get_mpi_implementation(full_env)
    if impl == MISSING:
        raise RuntimeError(
            "hvdrun-torch --launcher mpi requires an MPI installation with "
            "mpirun on PATH. Install Open MPI / MPICH, or use the default "
            "ssh launcher.")
    if impl == UNKNOWN:
        # Proceeding would emit no env-forwarding flags and the remote
        # workers would silently train unsynchronized.
        raise RuntimeError(
            "hvdrun-torch --launcher mpi: could not classify the installed "
            "MPI from `mpirun --version` (need Open MPI, Spectrum MPI, "
            "MPICH, or Intel MPI); use the default ssh launcher instead.")
    cmd = build_mpi_command(impl, hosts, full_env, command,
                            extra_mpi_args=extra_mpi_args)
    if dry_run:
        return cmd
    proc = subprocess.run(cmd, env=full_env)
    return proc.returncode
