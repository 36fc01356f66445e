"""In-process ``run()`` / ``run_elastic()`` APIs.

Reference: horovod/runner/__init__.py:95-247 — ``horovod.run(func, np=…)``
cloudpickles ``func`` and launches it on every rank, returning the per-rank
results. Port of the JAX package's ``runner/api.py``: the pickled function
ships through the launcher's KV store and each rank's result comes back
through it, so the list is by rank (one process per slot; the JAX run() has
one result per host). ``cloudpickle`` is imported here only: the CLI needs
no pickling library beyond ``pickle``.
"""

import os
import sys

from horovod_tpu_torch.runner import launch as launch_mod

_TASK_CMD = [sys.executable, "-m", "horovod_tpu_torch.runner.task",
             "kv:func/pickle"]


def _harvester(out):
    def harvest(kv):
        import cloudpickle
        rank = 0
        while True:
            v = kv.get("results", str(rank))
            if v is None:
                break
            out[rank] = cloudpickle.loads(v)
            rank += 1
    return harvest


def run(func, args=(), kwargs=None, np=None, hosts=None, hostfile=None,
        use_ssh=None, ssh_port=None, ssh_identity_file=None, verbose=False,
        extra_env=None, device=None):
    """Run ``func(*args, **kwargs)`` on every rank, after ``hvd.init(device=
    device)``, and return the results by rank (reference:
    runner/__init__.py run). With no hosts and at most one process, this
    process inits and calls ``func`` itself, as the JAX run() does."""
    kwargs = kwargs or {}
    if hosts is None and hostfile is None and (np or 1) == 1:
        import horovod_tpu_torch as hvd
        if extra_env:
            os.environ.update(extra_env)
        hvd.init(device=device)
        return [func(*args, **kwargs)]

    import cloudpickle
    payload = cloudpickle.dumps((func, args, kwargs, device))
    argv = []
    if np:
        argv += ["-np", str(np)]
    if hosts:
        argv += ["-H", hosts]
    if hostfile:
        argv += ["--hostfile", hostfile]
    if ssh_port:
        argv += ["--ssh-port", str(ssh_port)]
    if ssh_identity_file:
        argv += ["--ssh-identity-file", ssh_identity_file]
    if verbose:
        argv += ["--verbose"]
    argv += _TASK_CMD

    parsed = launch_mod.parse_args(argv)
    harvested = {}
    rc = launch_mod._run_static(parsed, extra_env=extra_env,
                                harvest=_harvester(harvested),
                                kv_preload={("func", "pickle"): payload})
    if rc != 0:
        raise RuntimeError(f"hvdrun-torch failed with exit code {rc}")
    size = len(launch_mod.get_host_assignments(
        launch_mod._resolve_hosts(parsed), parsed.np or None))
    missing = [r for r in range(size) if r not in harvested]
    if missing:
        raise RuntimeError(f"run() completed but ranks {missing} reported "
                           "no result")
    return [harvested[r] for r in range(size)]


def run_elastic(func, args=(), kwargs=None, min_np=1, max_np=None,
                host_discovery_script=None, slots_per_host=None,
                reset_limit=None, start_timeout=600, verbose=False):
    """Elastic variant (reference: horovod.run with elastic args routing to
    launch.py:689 ``_run_elastic``): not ported to horovod_tpu_torch yet."""
    raise NotImplementedError(
        "run_elastic: elastic training is not ported to horovod_tpu_torch "
        "yet (ROADMAP A9); use run() with a fixed np")
