"""Launch workers with ``jsrun`` on LSF/CSM clusters.

Reference: horovod/runner/js_run.py (jsrun resource-set construction from the
LSF allocation, :40-130). Port of the JAX package's ``runner/js_run.py``,
with one rank per slot: one resource set per host, one task and one GPU per
slot of it. Workers learn their rank from ``OMPI_COMM_WORLD_*`` (jsrun is
Spectrum-MPI based) through ``Config.from_env``.
"""

import os
import shutil
import subprocess

from horovod_tpu_torch.runner import lsf
from horovod_tpu_torch.runner.mpi_run import _FORWARD_PREFIXES


def js_available(env=None):
    return shutil.which("jsrun") is not None


def build_js_command(hosts, env, command, extra_js_args=None):
    """``jsrun`` line for ``hosts`` (``[(host, slots)]``): a resource set per
    host with one task and one GPU per slot."""
    slots = hosts[0][1]
    cmd = ["jsrun",
           "--nrs", str(len(hosts)),      # resource sets == hosts
           "--tasks_per_rs", str(slots),  # one rank per slot
           "--gpu_per_rs", str(slots),
           "--rs_per_host", "1",
           "--cpu_per_rs", "ALL_CPUS",
           "--launch_distribution", "packed"]
    names = sorted(k for k in env if k.startswith(_FORWARD_PREFIXES))
    for n in names:
        cmd += ["-E", n]
    if extra_js_args:
        cmd += list(extra_js_args)
    cmd += list(command)
    return cmd


def js_run(hosts, env, command, extra_js_args=None, dry_run=False):
    """Run across the LSF allocation via jsrun; returns exit code."""
    if not js_available():
        raise RuntimeError("hvdrun-torch --launcher jsrun requires jsrun on "
                           "PATH (Spectrum LSF with CSM)")
    hosts = hosts or lsf.get_compute_hosts()
    full_env = {**os.environ, **env}
    cmd = build_js_command(hosts, full_env, command,
                           extra_js_args=extra_js_args)
    if dry_run:
        return cmd
    proc = subprocess.run(cmd, env=full_env)
    return proc.returncode
