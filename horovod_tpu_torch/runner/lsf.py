"""LSF cluster detection and host discovery.

Reference: horovod/runner/util/lsf.py (LSFUtils: ``using_lsf``, compute-host
discovery via CSM queries) and horovod/runner/launch.py's implicit LSF default
(when ``-H``/``-hostfile`` are absent and an LSF job is active, hosts come from
the allocation).

Port of the JAX package's ``runner/lsf.py``: the standard ``LSB_*``
environment is read directly (``LSB_DJOB_HOSTFILE`` — one line per slot —
preferred, ``LSB_MCPU_HOSTS`` fallback) instead of shelling out to IBM CSM
utilities; the launcher needs the hosts and their slots, one rank per slot.
"""

import collections
import os
import shutil


def using_lsf(env=None):
    """True when the current process runs inside an LSF job."""
    env = env if env is not None else os.environ
    return "LSB_JOBID" in env


def using_jsrun(env=None):
    """True when LSF is active and ``jsrun`` is on PATH (Spectrum LSF CSM)."""
    return using_lsf(env) and shutil.which("jsrun") is not None


def get_compute_hosts(env=None):
    """Ordered ``[(host, slots)]`` for the current LSF allocation.

    ``LSB_DJOB_HOSTFILE`` lists one hostname per allocated slot; counting
    occurrences yields slots per host. ``LSB_MCPU_HOSTS`` is the inline
    equivalent: ``"host1 n1 host2 n2 ..."``. The first host is the launch
    node in batch jobs; it is kept (matching the reference, which trains on
    the launch node too unless CSM says otherwise).
    """
    env = env if env is not None else os.environ
    hostfile = env.get("LSB_DJOB_HOSTFILE", "")
    counts = collections.OrderedDict()
    if hostfile and os.path.exists(hostfile):
        with open(hostfile) as f:
            for line in f:
                host = line.strip()
                if host:
                    counts[host] = counts.get(host, 0) + 1
        return list(counts.items())
    mcpu = env.get("LSB_MCPU_HOSTS", "")
    if mcpu:
        toks = mcpu.split()
        for host, n in zip(toks[::2], toks[1::2]):
            counts[host] = counts.get(host, 0) + int(n)
        return list(counts.items())
    raise ValueError(
        "LSF job detected (LSB_JOBID set) but neither LSB_DJOB_HOSTFILE nor "
        "LSB_MCPU_HOSTS is available to derive hosts")


def get_num_hosts(env=None):
    return len(get_compute_hosts(env))


def get_num_slots(env=None):
    return sum(n for _, n in get_compute_hosts(env))


def lsf_hosts_string(env=None):
    """``host1:n1,host2:n2`` string consumable by ``hvdrun -H``."""
    return ",".join(f"{h}:{n}" for h, n in get_compute_hosts(env))
