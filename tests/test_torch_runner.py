"""The port's launcher (``horovod_tpu_torch.runner``) against the JAX
package's (``horovod_tpu.runner``): host strings, hostfiles and the YAML
config parse the same; ``parse_args`` gives the same namespace for the same
argv; the env of each slot holds that slot's rank contract where the JAX
launcher gives one env per host; the KV store signs its answers, 404s too.
End to end, ``python -m horovod_tpu_torch.runner`` starts one gloo process
per slot on 127.0.0.1 (``tests/torch_launch_worker.py``, 2 and 3 ranks,
concurrently), whose allreduces and broadcast equal the JAX eager ones on
the same numpy rows (a process set of as many ranks on the 8-device CPU
mesh; Sum and Average within rtol 1e-6, broadcast exact); ``run(fn, np=2)``
returns the results by rank; a worker that exits 1 makes the launcher
return 1 and leaves no worker behind; ``--min-np`` reaches the elastic
driver (its runs are in ``test_torch_elastic.py``).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_launch_worker.py"
SEED = 5
CONTRACT = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE")


def _launch(n, out, *extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.runner", "-np", str(n),
         "-H", f"127.0.0.1:{n}", "--start-timeout", "60", sys.executable,
         str(WORKER), str(out), str(SEED), *extra],
        cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The three launches and a run(), all at once."""
    from horovod_tpu_torch.runner import run

    def rank_and_sum():     # nested: cloudpickle ships it by value
        import torch

        import horovod_tpu_torch as hvd
        return hvd.rank(), hvd.size(), hvd.allreduce(
            torch.ones(2) * (hvd.rank() + 1), op=hvd.Sum).tolist()

    dirs = {k: tmp_path_factory.mktemp(k) for k in ("np2", "np3", "fail")}
    procs = {"np2": _launch(2, dirs["np2"]), "np3": _launch(3, dirs["np3"]),
             "fail": _launch(2, dirs["fail"], "1")}
    got = {}
    t = threading.Thread(target=lambda: got.setdefault(
        "run", run(rank_and_sum, np=2, device="cpu",
                   extra_env={"PYTHONPATH": str(ROOT)})))
    t.start()
    out = {}
    for k, p in procs.items():
        text, _ = p.communicate(timeout=180)
        ranks = {}
        for f in dirs[k].glob("rank*.json"):
            r = json.loads(f.read_text())
            ranks[r["rank"]] = r
        out[k] = {"rc": p.returncode, "log": text, "ranks": ranks}
    t.join(timeout=180)
    out["run"] = got.get("run")
    return out


# --- parsing, against the JAX runner -------------------------------------

HOST_STRINGS = ["a:4,b:2,c", "h1:4,h2:4", "localhost:3",
                "127.0.0.1:2,127.0.0.2:2"]
ASSIGNMENTS = [("a:4,b:4", 8), ("a:4,b:4", 6), ("a:2,b:1,c:3", None),
               ("a:1", 1), ("h1:2,h2:2", 4)]
ARGVS = [
    ["-np", "8", "-H", "h1:4,h2:4", "--fusion-threshold-mb", "32",
     "--cycle-time-ms", "2.5", "--torus-allreduce", "--autotune",
     "--timeline-filename", "/tmp/t.json", "--log-level", "debug",
     "python", "train.py"],
    ["-np", "2", "--start-timeout", "30", "--output-filename", "/tmp/o",
     "--mpi", "python", "x.py"],
    ["-hostfile", "hf", "--cycle-time-ms", "0", "--gloo", "--verbose",
     "python", "-m", "mod", "--flag"],
]


@pytest.mark.parametrize("hosts", HOST_STRINGS)
def test_parse_hosts_matches_jax(hosts):
    from horovod_tpu.runner import hosts as J
    from horovod_tpu_torch.runner import hosts as P
    assert [dataclasses.asdict(h) for h in P.parse_hosts(hosts)] == \
        [dataclasses.asdict(h) for h in J.parse_hosts(hosts)]


def test_parse_host_files_matches_jax(tmp_path):
    from horovod_tpu.runner import hosts as J
    from horovod_tpu_torch.runner import hosts as P
    f = tmp_path / "hf"
    f.write_text("h1 slots=4\n# comment\nh2:2\nh3\n\n")
    got = [dataclasses.asdict(h) for h in P.parse_host_files(str(f))]
    assert got == [dataclasses.asdict(h) for h in J.parse_host_files(str(f))]
    assert got == [{"hostname": "h1", "slots": 4},
                   {"hostname": "h2", "slots": 2},
                   {"hostname": "h3", "slots": 1}]


@pytest.mark.parametrize("hosts,np_", ASSIGNMENTS)
def test_host_assignments_match_jax(hosts, np_):
    from horovod_tpu.runner import hosts as J
    from horovod_tpu_torch.runner import hosts as P
    got = P.get_host_assignments(P.parse_hosts(hosts), np_)
    want = J.get_host_assignments(J.parse_hosts(hosts), np_)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert [s.rank for s in got] == list(range(len(got)))


def test_oversubscription_raises_as_jax():
    from horovod_tpu_torch.runner import hosts as P
    with pytest.raises(ValueError, match="only 2 slots"):
        P.get_host_assignments(P.parse_hosts("a:2"), 4)


@pytest.mark.parametrize("argv", ARGVS, ids=["tunables", "mpi", "hostfile"])
def test_parse_args_matches_jax(argv):
    from horovod_tpu.runner import launch as J
    from horovod_tpu_torch.runner import launch as P
    assert vars(P.parse_args(argv)) == vars(J.parse_args(argv))


@pytest.mark.parametrize("argv", ARGVS, ids=["tunables", "mpi", "hostfile"])
def test_env_from_args_matches_jax(argv):
    from horovod_tpu.runner import config_parser as JC
    from horovod_tpu.runner import launch as J
    from horovod_tpu_torch.runner import config_parser as PC
    from horovod_tpu_torch.runner import launch as P
    assert PC.set_env_from_args({}, P.parse_args(argv)) == \
        JC.set_env_from_args({}, J.parse_args(argv))


def test_config_file_matches_jax(tmp_path):
    from horovod_tpu.runner import config_parser as JC
    from horovod_tpu.runner import launch as J
    from horovod_tpu_torch.runner import config_parser as PC
    from horovod_tpu_torch.runner import launch as P
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("tuning:\n  fusion-threshold-mb: 16\n  cycle-time-ms: 5\n"
                   "np: 4\nlog-level: info\nno_such_key: 1\n")
    argv = ["--config-file", str(cfg), "--cycle-time-ms", "2", "python",
            "x.py"]
    got, want = P.parse_args(argv), J.parse_args(argv)
    assert vars(got) == vars(want)
    assert (got.fusion_threshold_mb, got.cycle_time_ms, got.np) == (16, 2, 4)
    assert PC.set_env_from_args({}, got) == JC.set_env_from_args({}, want)


def test_per_slot_env_two_hosts_two_slots():
    from horovod_tpu.runner import hosts as JH
    from horovod_tpu.runner import launch as J
    from horovod_tpu_torch.runner import hosts as PH
    from horovod_tpu_torch.runner import launch as P
    argv = ["-np", "4", "--fusion-threshold-mb", "32", "--cycle-time-ms",
            "2", "python", "x.py"]
    slots = PH.get_host_assignments(PH.parse_hosts("h1:2,h2:2"), 4)
    jslots = JH.get_host_assignments(JH.parse_hosts("h1:2,h2:2"), 4)
    envs = [P.build_worker_env({}, s, "coord", 1234, 5678,
                               P.parse_args(argv)) for s in slots]
    for env, j in zip(envs, jslots):
        assert [env[k] for k in CONTRACT] == [str(v) for v in (
            j.rank, j.size, j.local_rank, j.local_size, j.cross_rank,
            j.cross_size)]
        assert (env["HOROVOD_COORDINATOR_ADDR"], env["HOROVOD_KV_ADDR"],
                env["HOROVOD_COORDINATOR_PORT"], env["HOROVOD_KV_PORT"]) \
            == ("coord", "coord", "1234", "5678")
        assert env["HOROVOD_FUSION_THRESHOLD"] == str(32 * 1024 * 1024)
        assert env["HOROVOD_CYCLE_TIME"] == "2.0"
        assert "CUDA_VISIBLE_DEVICES" not in env
    # The JAX launcher's one env per host is its first slot's contract.
    for host in ("h1", "h2"):
        jenv = J.build_worker_env(
            {}, [s for s in jslots if s.hostname == host], "coord", 1234,
            5678, J.parse_args(argv))
        first = next(e for e, s in zip(envs, slots) if s.hostname == host)
        assert [first[k] for k in CONTRACT] == [jenv[k] for k in CONTRACT]


# --- the KV store ---------------------------------------------------------

def test_kv_roundtrip_with_the_secret_and_a_signed_404():
    from horovod_tpu_torch.runner.http_kv import KVStoreClient, KVStoreServer
    from horovod_tpu_torch.runner.secret import make_secret_key
    secret = make_secret_key()
    srv = KVStoreServer(secret=secret)
    port = srv.start()
    try:
        c = KVStoreClient("127.0.0.1", port, secret=secret)
        c.put("scope", "key", b"value")
        assert c.get("scope", "key") == b"value"
        assert srv.get("scope", "key") == b"value"
        assert c.get("scope", "missing") is None     # a signed 404
        c.delete("scope", "key")
        assert c.get("scope", "key") is None
        with pytest.raises(Exception, match="403"):
            KVStoreClient("127.0.0.1", port, secret=make_secret_key(),
                          retries=0).put("scope", "key", b"x")
    finally:
        srv.stop()


def test_kv_unsigned_404_fails_closed():
    from horovod_tpu_torch.runner.http_kv import KVStoreClient, KVStoreServer
    from horovod_tpu_torch.runner.secret import make_secret_key
    srv = KVStoreServer(secret="")
    port = srv.start()
    try:
        with pytest.raises(PermissionError):
            KVStoreClient("127.0.0.1", port,
                          secret=make_secret_key()).get("nosuch", "key")
    finally:
        srv.stop()


def test_kv_speaks_the_jax_protocol():
    from horovod_tpu.runner import http_kv as J
    from horovod_tpu_torch.runner import http_kv as P
    from horovod_tpu_torch.runner.secret import make_secret_key
    secret = make_secret_key()
    srv = J.KVStoreServer(secret=secret)
    port = srv.start()
    try:
        c = P.KVStoreClient("127.0.0.1", port, secret=secret)
        c.put("s", "k", b"v")
        assert srv.get("s", "k") == b"v" and c.get("s", "k") == b"v"
        assert c.get("s", "gone") is None
    finally:
        srv.stop()


def test_sharded_kv_names_its_roadmap_item(monkeypatch):
    """The sharded KV (ROADMAP A17, now ported): ``HOROVOD_KV_SHARD_PORTS``
    routes a client's slice-local scopes to the shard listeners and the
    rest to the root, and the server reads through its shards."""
    from horovod_tpu_torch.runner import http_kv
    srv = http_kv.KVStoreServer(shards=2, secret="")
    port = srv.start()
    try:
        monkeypatch.setenv("HOROVOD_KV_SHARD_PORTS",
                           ",".join(str(p) for p in srv.shard_ports))
        c = http_kv.KVStoreClient("127.0.0.1", port, secret="")
        c.put("telemetry@s3", "k", b"v")
        c.put("elastic", "k", b"w")
        assert srv._shards[1]._httpd.store == {"telemetry@s3": {"k": b"v"}}
        assert srv._httpd.store == {"elastic": {"k": b"w"}}
        assert srv.get("telemetry@s3", "k") == b"v"
        assert c.get("telemetry@s3", "k") == b"v"
    finally:
        srv.stop()


def test_min_np_reaches_the_elastic_driver(monkeypatch):
    """``--min-np`` (and a discovery script) route the CLI to
    ``run_elastic_driver`` with the parsed flags; ``--check-build`` marks
    elastic as built."""
    from horovod_tpu_torch.runner import launch
    from horovod_tpu_torch.runner.elastic import driver
    seen = []
    monkeypatch.setattr(driver, "run_elastic_driver",
                        lambda args: seen.append(args) or 0)
    assert launch.run_commandline(["--min-np", "1", "--max-np", "2",
                                   "--reset-limit", "3", "python",
                                   "x.py"]) == 0
    assert launch.run_commandline(["--host-discovery-script", "d.sh",
                                   "python", "x.py"]) == 0
    assert [(a.min_np, a.max_np, a.reset_limit) for a in seen] == \
        [(1, 2, 3), (None, None, None)]
    assert "[X] elastic" in launch.check_build_text()


def test_taken_coordinator_port_fails_with_a_named_error(monkeypatch):
    """The launcher picks the coordinator port and rank 0's TCPStore binds
    it in hvd.init(): a port taken in between fails at once, named."""
    import socket

    import horovod_tpu_torch as hvd
    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen(1)
        for k, v in {"HOROVOD_RANK": "0", "HOROVOD_SIZE": "2",
                     "HOROVOD_COORDINATOR_ADDR": "127.0.0.1",
                     "HOROVOD_COORDINATOR_PORT": str(taken.getsockname()[1]),
                     "HOROVOD_START_TIMEOUT": "5"}.items():
            monkeypatch.setenv(k, v)
        t0 = time.monotonic()
        with pytest.raises(hvd.HorovodInternalError,
                           match="coordinator store .* could not be served"):
            hvd.init(device="cpu")
        assert time.monotonic() - t0 < 5
    assert not hvd.is_initialized()


# --- MPI, jsrun and the MPI env fallback ----------------------------------

def test_mpi_env_fallback_reads_the_rank_contract(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    for k in CONTRACT:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "3")
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "4")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_RANK", "1")
    monkeypatch.setenv("OMPI_COMM_WORLD_LOCAL_SIZE", "2")
    c = Config.from_env()
    assert (c.rank, c.size, c.local_rank, c.local_size, c.cross_rank,
            c.cross_size) == (3, 4, 1, 2, 1, 2)
    monkeypatch.setenv("HOROVOD_RANK", "2")
    monkeypatch.setenv("HOROVOD_SIZE", "8")
    c = Config.from_env()
    assert (c.rank, c.size) == (2, 8)        # the HOROVOD_* env wins


def test_mpi_and_jsrun_lines_start_one_rank_per_slot():
    from horovod_tpu_torch.runner import js_run, mpi_run
    env = {"HOROVOD_CYCLE_TIME": "1", "NCCL_DEBUG": "INFO", "OTHER": "x"}
    cmd = mpi_run.build_mpi_command(mpi_run.OPENMPI, [("h1", 4), ("h2", 4)],
                                    env, ["python", "train.py"])
    assert cmd[:4] == ["mpirun", "--allow-run-as-root", "-np", "8"]
    assert cmd[cmd.index("-H") + 1] == "h1:4,h2:4"
    assert cmd[cmd.index("--map-by") + 1] == "slot"
    assert "HOROVOD_CYCLE_TIME" in cmd and "NCCL_DEBUG" in cmd
    assert "OTHER" not in cmd and cmd[-2:] == ["python", "train.py"]
    local = mpi_run.build_mpi_command(mpi_run.MPICH, [("localhost", 2)], env,
                                      ["python", "x.py"])
    assert local[:3] == ["mpirun", "-np", "2"] and "-H" not in local
    js = js_run.build_js_command([("h1", 4), ("h2", 4)], env, ["python"])
    assert js[js.index("--nrs") + 1] == "2"
    assert js[js.index("--tasks_per_rs") + 1] == "4"
    assert js[js.index("--gpu_per_rs") + 1] == "4"


def test_check_build_names_torch_nccl_and_gloo(capsys):
    from horovod_tpu_torch.runner.launch import run_commandline
    assert run_commandline(["--check-build"]) == 0
    out = capsys.readouterr().out
    assert "PyTorch" in out and "NCCL" in out and "gloo" in out


# --- end to end -----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3])
def test_launch_gives_each_slot_its_contract(launched, n):
    from horovod_tpu.runner import hosts as J
    got = launched[f"np{n}"]
    assert got["rc"] == 0, got["log"][-3000:]
    assert sorted(got["ranks"]) == list(range(n))
    for s in J.get_host_assignments(J.parse_hosts(f"127.0.0.1:{n}"), n):
        r = got["ranks"][s.rank]
        assert [r["env"][k] for k in CONTRACT] == [str(v) for v in (
            s.rank, s.size, s.local_rank, s.local_size, s.cross_rank,
            s.cross_size)]
        assert r["size"] == n and r["local_rank"] == s.local_rank
        assert r["env"]["HOROVOD_COORDINATOR_PORT"] == \
            got["ranks"][0]["env"]["HOROVOD_COORDINATOR_PORT"]


@pytest.mark.parametrize("n", [2, 3])
def test_launched_collectives_match_jax(hvd, launched, n):
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_launch_worker import inputs
    x = inputs(SEED, n)
    ps = hvd.add_process_set(hvd.ProcessSet(list(range(n))))
    try:
        refs = {"sum": hvd.allreduce(jnp.asarray(x[0]), op=hvd.Sum,
                                     process_set=ps),
                "average": hvd.allreduce(jnp.asarray(x[1]), op=hvd.Average,
                                         process_set=ps),
                "broadcast": hvd.broadcast(jnp.asarray(x[0]), 1,
                                           process_set=ps)}
    finally:
        hvd.remove_process_set(ps)
    got = launched[f"np{n}"]["ranks"]
    for rank in range(n):
        for key, ref in refs.items():
            want = np.asarray(ref)[rank]
            if key == "broadcast":
                np.testing.assert_array_equal(got[rank][key], want)
            else:
                np.testing.assert_allclose(got[rank][key], want, rtol=1e-6,
                                           atol=1e-6)


def test_run_returns_results_by_rank(launched):
    assert launched["run"] == [(0, 2, [3.0, 3.0]), (1, 2, [3.0, 3.0])]


def test_failing_worker_fails_the_launch_and_is_reaped(launched):
    got = launched["fail"]
    assert got["rc"] == 1, got["log"][-3000:]
    assert "workers failed" in got["log"]
    pids = [r["pid"] for r in got["ranks"].values()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = []
        for pid in pids:
            try:
                os.kill(pid, 0)
                alive.append(pid)
            except ProcessLookupError:
                pass
        time.sleep(0.1)
    assert not alive
