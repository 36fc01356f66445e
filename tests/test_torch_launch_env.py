"""The launcher carries every knob to a worker on another host, as the JAX
package's launcher does.

A worker on another host gets only the dict ``build_worker_env`` returns
(``runner/exec.py::build_launch_command`` sends it as ``env K=V ...`` over
ssh); a local one also inherits the launcher's environment. These tests set
every knob that the port's ``common/config.py::Config`` declares in the
launcher's environment and read a remote slot's env and its ssh command;
hold the port's env against JAX's ``build_worker_env`` on the same
arguments and environment; check the elastic default of
``HOROVOD_FLIGHT_DIR`` for a worker and for the driver; and parse each knob
the port newly declares as JAX's ``Config.from_env`` does. Tolerance:
equal strings and values.
"""

import os
import shlex

import pytest

from horovod_tpu_torch.analysis.lint import (_BOOTSTRAP_VARS, declared_knobs,
                                             propagated_knobs)

DECLARED = sorted(declared_knobs())
# Written by the launcher from its own flag, whatever the environment says.
FLAG_OWNED = {"HOROVOD_START_TIMEOUT"}
CARRIED = [k for k in DECLARED if k not in _BOOTSTRAP_VARS
           and k not in FLAG_OWNED]
ARGV = ["-np", "2", "-H", "h1:1,h2:1", "python", "train.py"]


def _value(knob):
    """A value no flag default could produce: the knob's own name."""
    return f"v-{knob.lower()}"


@pytest.fixture(scope="module")
def remote():
    """A remote slot's env and ssh command, with every declared knob (and
    every knob JAX's Config declares) set in the launcher's environment;
    JAX's env for the same host, arguments and environment."""
    from horovod_tpu.analysis.lint import declared_knobs as jax_declared
    from horovod_tpu.runner import hosts as JH
    from horovod_tpu.runner import launch as J
    from horovod_tpu_torch.runner import hosts as PH
    from horovod_tpu_torch.runner import launch as P
    from horovod_tpu_torch.runner.exec import build_launch_command

    knobs = (set(DECLARED) | set(jax_declared())) - _BOOTSTRAP_VARS
    saved = dict(os.environ)
    os.environ.update({k: _value(k) for k in knobs})
    try:
        args = P.parse_args(ARGV)
        slot = PH.get_host_assignments(PH.parse_hosts("h1:1,h2:1"), 2)[1]
        env = P.build_worker_env({}, slot, "coord", 1234, 5678, args)
        argv, _, secret = build_launch_command(
            slot.hostname, args.command, env, local=False)
        jslots = JH.get_host_assignments(JH.parse_hosts("h1:1,h2:1"), 2)
        jenv = J.build_worker_env({}, [jslots[1]], "coord", 1234, 5678,
                                  J.parse_args(ARGV))
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return {"env": env, "command": argv[-1], "secret": secret,
            "args": args, "jenv": jenv, "knobs": knobs}


@pytest.mark.parametrize("knob", CARRIED)
def test_remote_slot_carries_the_knob(remote, knob):
    """(a) The knob set in the launcher's environment reaches a worker on
    another host: in ``build_worker_env``'s dict and in the ``env K=V``
    assignments of its ssh command."""
    assert remote["env"].get(knob) == _value(knob)
    assert f" {knob}={shlex.quote(_value(knob))} " in remote["command"]


def test_the_flag_owned_knob_is_the_flags(remote):
    """HOROVOD_START_TIMEOUT is the launcher's --start-timeout on every
    worker, local or remote."""
    value = str(remote["args"].start_timeout)
    assert remote["env"]["HOROVOD_START_TIMEOUT"] == value
    assert f" HOROVOD_START_TIMEOUT={value} " in remote["command"]


def test_every_declared_knob_is_propagated_in_the_source():
    """HVL007's view of the same contract: each declared knob's spelling
    appears in the launcher's worker-env plumbing."""
    missing = set(DECLARED) - propagated_knobs() - _BOOTSTRAP_VARS
    assert not missing, sorted(missing)


def test_carries_what_jax_carries(remote):
    """(b) Every knob that JAX's ``build_worker_env`` carries from the same
    environment, and the port declares, the port carries with the same
    value."""
    jax_carried = {k for k in remote["knobs"]
                   if remote["jenv"].get(k) == _value(k)}
    both = jax_carried & set(DECLARED)
    assert len(both) > 60, sorted(both)
    differ = {k: (remote["env"].get(k), remote["jenv"][k]) for k in both
              if remote["env"].get(k) != remote["jenv"][k]}
    assert not differ, differ


def _worker_flight_dir(package, argv, monkeypatch):
    import importlib
    L = importlib.import_module(f"{package}.runner.launch")
    H = importlib.import_module(f"{package}.runner.hosts")
    monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    slots = H.get_host_assignments(H.parse_hosts("h1:1"), 1)
    slot = slots[0] if package == "horovod_tpu_torch" else slots
    env = L.build_worker_env({"HOROVOD_ELASTIC": "1"}, slot, "coord", 1, 2,
                             L.parse_args(argv))
    return env.get("HOROVOD_FLIGHT_DIR")


ELASTIC = ["--min-np", "1", "--max-np", "2", "-H", "h1:1",
           "--output-filename", "run_logs"]


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["defaulted", "flight_dir_flag"])
def test_elastic_worker_flight_dir(monkeypatch, explicit):
    """(c) An elastic launch's worker dumps into
    ``default_collection_dir(--output-filename)``, as under JAX's launcher;
    an explicit --flight-dir wins."""
    from horovod_tpu_torch.flight.recorder import default_collection_dir
    argv = ELASTIC + (["--flight-dir", "/tmp/ours"] if explicit else []) \
        + ["python", "train.py"]
    got = _worker_flight_dir("horovod_tpu_torch", argv, monkeypatch)
    want = "/tmp/ours" if explicit else default_collection_dir("run_logs")
    assert got == want
    assert got == _worker_flight_dir("horovod_tpu", argv, monkeypatch)


def test_static_launch_sets_no_flight_dir(monkeypatch):
    argv = ["-np", "1", "-H", "h1:1", "python", "train.py"]
    monkeypatch.delenv("HOROVOD_FLIGHT_DIR", raising=False)
    from horovod_tpu_torch.runner import hosts as H
    from horovod_tpu_torch.runner import launch as L
    slot = H.get_host_assignments(H.parse_hosts("h1:1"), 1)[0]
    env = L.build_worker_env({}, slot, "coord", 1, 2, L.parse_args(argv))
    assert "HOROVOD_FLIGHT_DIR" not in env


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["defaulted", "flight_dir_flag"])
def test_elastic_driver_flight_dir(monkeypatch, explicit):
    """(c) The elastic driver's disruption marker and the env of the worker
    it spawns name one flight directory, ``default_collection_dir``
    unless --flight-dir; the process's own env is left as it was, since
    several in-process drivers may run at once."""
    from horovod_tpu_torch.flight import recorder as R
    from horovod_tpu_torch.flight.recorder import default_collection_dir
    from horovod_tpu_torch.runner import hosts as H
    from horovod_tpu_torch.runner import launch as L
    from horovod_tpu_torch.runner.elastic import driver as D

    seen = {}

    class Stop(Exception):
        pass

    class FakeDriver:
        """Spawns version 2, a disruptive one, from its wait."""

        def __init__(self, *a, spawn_fn=None, **kw):
            self._host_manager = None
            self._spawn = spawn_fn

        def start(self):
            pass

        def version_disrupted(self, version):
            return True

        def wait_for_available_slots(self, *a, **kw):
            seen["env"] = os.environ.get("HOROVOD_FLIGHT_DIR")
            self._spawn(H.get_host_assignments(H.parse_hosts("h1:1"), 1), 2)

        def stop(self):
            pass

    real_env = L.build_worker_env

    def worker_env(*a, **kw):
        seen["worker"] = real_env(*a, **kw).get("HOROVOD_FLIGHT_DIR")
        raise Stop()

    monkeypatch.setattr(D, "ElasticDriver", FakeDriver)
    monkeypatch.setattr(L, "build_worker_env", worker_env)
    monkeypatch.setattr(R, "driver_mark", lambda *a, directory=None:
                        seen.setdefault("mark", directory))
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", "/tmp/before")
    argv = ELASTIC + (["--flight-dir", "/tmp/ours"] if explicit else []) \
        + ["python", "train.py"]
    args = L.parse_args(argv)
    if not explicit:
        monkeypatch.delenv("HOROVOD_FLIGHT_DIR")
    with pytest.raises(Stop):
        D.run_elastic_driver(args)
    want = "/tmp/ours" if explicit else default_collection_dir("run_logs")
    assert seen["mark"] == seen["worker"] == want
    assert D.driver_flight_dir(args, {} if not explicit else
                               {"HOROVOD_FLIGHT_DIR": "/tmp/ours"}) == want
    before = "/tmp/before" if explicit else None
    assert seen["env"] == os.environ.get("HOROVOD_FLIGHT_DIR") == before


# (knob, Config field, values): each newly declared knob, with a value that
# parses, one that falls back to the default, and the default's spelling.
NEW_KNOBS = [
    ("HOROVOD_LOG_LEVEL", "log_level", ("info", "debug", "warning")),
    ("HOROVOD_LOG_HIDE_TIME", "log_hide_time", ("1", "no", "true")),
    ("HOROVOD_KV_RETRIES", "kv_retries", ("5", "x", "0")),
    ("HOROVOD_KV_RETRY_BACKOFF_MS", "kv_retry_backoff_ms",
     ("12.5", "x", "50")),
    ("HOROVOD_KV_RETRY_BACKOFF_MAX_MS", "kv_retry_backoff_max_ms",
     ("900", "x", "2000.0")),
    ("HOROVOD_PROFILE_HISTORY", "profile_history", ("64", "x", "512")),
    ("HOROVOD_PROFILE_PUBLISH_TIMEOUT_MS", "profile_publish_timeout_ms",
     ("100", "1.5", "250")),
    ("HOROVOD_PROFILE_STRAGGLER_MIN_MS", "profile_straggler_min_ms",
     ("2.5", "x", "5")),
    ("HOROVOD_SIM_KV_US", "sim_kv_us", ("7.5", "x", "5")),
    ("HOROVOD_SIM_DCN_US", "sim_dcn_us", ("80", "x", "50.0")),
    ("HOROVOD_PEAK_TFLOPS", "peak_tflops", ("756", "x", "0")),
    ("HOROVOD_PEAK_HBM_GBS", "peak_hbm_gbs", ("3350", "x", "0")),
    ("HOROVOD_PEAK_ICI_GBS", "peak_ici_gbs", ("900", "x", "0")),
    ("HOROVOD_PEAK_DCN_GBS", "peak_dcn_gbs", ("50", "x", "0")),
]


@pytest.mark.parametrize("knob,field,values", NEW_KNOBS,
                         ids=[k for k, _, _ in NEW_KNOBS])
def test_new_knob_parses_as_jax(monkeypatch, knob, field, values):
    """(d) Unset and at each value, the port's Config reads the knob as
    JAX's does."""
    from horovod_tpu.common.config import Config as JaxConfig
    from horovod_tpu_torch.common.config import Config
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    got = [getattr(Config.from_env(), field)]
    want = [getattr(JaxConfig.from_env(), field)]
    for v in values:
        monkeypatch.setenv(knob, v)
        got.append(getattr(Config.from_env(), field))
        want.append(getattr(JaxConfig.from_env(), field))
    assert got == want
    assert getattr(Config(), field) == getattr(JaxConfig(), field)
