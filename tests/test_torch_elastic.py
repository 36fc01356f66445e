"""Elastic training in the port (``horovod_tpu_torch.elastic``,
``torch/elastic.py``, ``runner/elastic/``) against the JAX package.

- ``ElasticSampler``: the same indices, length and ``state_dict`` as
  ``horovod_tpu.torch.ElasticSampler`` for every rank of worlds of 1-3,
  shuffled or not, after ``record_batch`` + ``reset``, ``set_epoch`` and
  ``load_state_dict`` (exact: both draw one ``torch.randperm``).
- ``TorchState``: the JAX ``TestTorchState`` cases, bit-equal restores, a
  restore that does not alias the commit, and in a 2-rank gloo world a
  ``sync`` that gives every rank rank 0's model, optimizer state and
  attributes.
- The driver: one sequence of discovered hosts (an addition, a removal, a
  slot-count decrease, a failure with blacklisting, re-admission after the
  cooldown, a slot-count increase) through the JAX ``ElasticDriver`` and the
  port's: equal versions and slot lists, equal disruption flags except at
  the increase (the JAX driver respawns a resized host's one process; the
  port's surviving slots keep theirs), and the port's per-slot KV rows.
- The three scenarios of ``tests/test_elastic_failure.py`` through the
  port's ``run_elastic`` on CPU workers (gloo), held to that file's
  expected values: a worker killed at step 3 of 6 gives ``w == [12] * 4``
  and worlds ``[2, 2, 2, 1, 1, 1]``; a graceful removal keeps the
  survivor's pid and its uncommitted attribute; a host added at step 3
  scales up in place.
- The membership watchdog: a version that only adds slots leaves the
  group running, one that removes a slot aborts it, and the next
  collective raises ``HorovodInternalError``.
- A peer that dies: the survivor's pending async allreduce and its eager
  allreduce raise ``HorovodInternalError`` with the backend's error as
  ``__cause__`` within seconds, on process 0 (its peer's gloo connection
  closes) and on a follower (process 0's store is gone), not after
  ``BOUNDARY_TIMEOUT_S``.
"""

import dataclasses
import os
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import torch_port_helpers as helpers

ROOT = pathlib.Path(__file__).resolve().parents[1]


# --- ElasticSampler -------------------------------------------------------

def _sampler_walk(cls, basics, monkeypatch, rank, size, shuffle):
    """A fixed walk through a sampler's API; every observable on the way."""
    monkeypatch.setattr(basics, "rank", lambda: rank)
    monkeypatch.setattr(basics, "size", lambda: size)
    s = cls(list(range(23)), shuffle=shuffle, seed=7)
    seen = [(list(s), len(s))]
    s.record_batch(0, 2)
    s.record_batch(2, 1)
    s.reset()
    seen.append((list(s), len(s), s.state_dict()))
    s.set_epoch(3)
    seen.append((list(s), len(s), s.state_dict()))
    s.record_batch(1, 3)
    state = s.state_dict()
    t = cls(list(range(23)), shuffle=shuffle, seed=7)
    t.load_state_dict(state)
    seen.append((list(t), len(t), t.state_dict()))
    return seen


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3])
def test_elastic_sampler_matches_jax(monkeypatch, size, shuffle):
    from horovod_tpu.common import basics as jax_basics
    from horovod_tpu.torch.elastic import ElasticSampler as JaxSampler
    from horovod_tpu_torch.common import basics as port_basics
    from horovod_tpu_torch.torch.elastic import ElasticSampler
    for rank in range(size):
        want = _sampler_walk(JaxSampler, jax_basics, monkeypatch, rank, size,
                             shuffle)
        got = _sampler_walk(ElasticSampler, port_basics, monkeypatch, rank,
                            size, shuffle)
        assert got == want, (rank, size, shuffle)


# --- TorchState -----------------------------------------------------------

def _model_and_opt(seed):
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4),
                                torch.nn.Linear(4, 2))
    return model, torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)


def _train_step(model, opt, seed):
    g = torch.Generator().manual_seed(seed)
    opt.zero_grad()
    model(torch.randn(6, 3, generator=g)).square().sum().backward()
    opt.step()


def _snapshot(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            [opt.state[p]["momentum_buffer"].clone()
             for p in model.parameters()])


def test_torch_state_commit_restore_matches_jax():
    """JAX's TestTorchState.test_commit_restore, on both packages, with the
    restored tensors held bit-equal to the commit and to each other."""
    from horovod_tpu.torch.elastic import TorchState as JaxState
    from horovod_tpu_torch.torch.elastic import TorchState
    got = {}
    for name, cls in (("jax", JaxState), ("port", TorchState)):
        model, opt = _model_and_opt(0)
        _train_step(model, opt, 1)
        state = cls(model=model, optimizer=opt, epoch=0)
        state.save()
        committed = _snapshot(model, opt)
        _train_step(model, opt, 2)
        state.epoch = 5
        assert not torch.equal(model[0].weight, committed[0]["0.weight"])
        state.restore()
        assert state.epoch == 0
        got[name] = _snapshot(model, opt)
        for k, v in committed[0].items():
            assert torch.equal(got[name][0][k], v), (name, k)
        for a, b in zip(got[name][1], committed[1]):
            assert torch.equal(a, b), name
        state2 = cls(model=model, optimizer=opt, epoch=0)
        assert state2.epoch == 0
    for k in got["jax"][0]:
        assert torch.equal(got["jax"][0][k], got["port"][0][k]), k


def test_torch_state_restore_does_not_alias_the_commit():
    """A step after a restore leaves the commit as it was, so a second
    failure restores the same state (the optimizer's load_state_dict keeps
    the tensors it is given when their device and dtype match)."""
    from horovod_tpu_torch.torch.elastic import TorchState
    model, opt = _model_and_opt(0)
    _train_step(model, opt, 1)
    state = TorchState(model=model, optimizer=opt, step=1)
    state.commit()
    committed = _snapshot(model, opt)
    for seed in (2, 3):
        _train_step(model, opt, seed)
        state.restore()
        now = _snapshot(model, opt)
        assert all(torch.equal(a, b) for a, b in zip(now[1], committed[1]))
        assert all(torch.equal(now[0][k], v) for k, v in committed[0].items())


@pytest.fixture(scope="module")
def state_sync_worlds():
    """The TorchState sync worlds (1 and 2 ranks) and the fresh-optimizer
    world, started at once."""
    return {1: helpers.run_world_async(helpers.torch_state_sync, size=1,
                                       args=(11,)),
            2: helpers.run_world_async(helpers.torch_state_sync, size=2,
                                       args=(11,)),
            "fresh": helpers.run_world_async(helpers.fresh_optimizer_sync,
                                             size=2, args=(5,), timeout=60)}


def test_torch_state_sync_matches_jax_single_process(hvd,
                                                     state_sync_worlds):
    """JAX's TestTorchState.test_sync_broadcasts: in a world of one a sync
    leaves the model and attributes as they are, in both packages."""
    from horovod_tpu.torch.elastic import TorchState as JaxState
    model, opt = _model_and_opt(0)
    state = JaxState(model=model, optimizer=opt, epoch=3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state.sync()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    port = state_sync_worlds[1].result()[0]
    assert port["attrs"] == (3, "rank0")
    for k, v in port["after"].items():
        np.testing.assert_array_equal(v, port["before"][k])


def test_torch_state_sync_gives_rank_0s_state(state_sync_worlds):
    got = state_sync_worlds[2].result()
    zero = got[0]
    for r in (0, 1):
        assert got[r]["attrs"] == (3, "rank0")
        for k, v in got[r]["after"].items():
            np.testing.assert_array_equal(v, zero["before"][k], err_msg=k)
        for a, b in zip(got[r]["momentum"], zero["momentum"]):
            np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(got[1]["before"][k], zero["before"][k])
               for k in zero["before"])


@pytest.fixture(scope="module")
def fresh_optimizer_world(state_sync_worlds):
    return state_sync_worlds["fresh"].result()


@pytest.mark.parametrize("kind", ["sgd", "adamw", "powersgd"])
def test_fresh_optimizer_sync_gives_rank_0s_state(fresh_optimizer_world,
                                                  kind):
    """A rank that joins with a fresh optimizer ends ``TorchState.sync``
    with rank 0's parameters and optimizer state bit for bit (AdamW's
    ``step`` on the CPU, as the optimizer keeps it; under PowerSGD its Q
    and residual too, as JAX's elastic state carries its optax state), and
    the next step through DistributedOptimizer leaves both ranks equal.
    Without the root-driven layout the fresh rank launches no broadcasts
    and the world fails or hangs."""
    zero, one = (r[kind] for r in fresh_optimizer_world)
    for when in ("synced", "stepped"):
        a, b = zero[when], one[when]
        assert set(a["params"]) == set(b["params"])
        for k in a["params"]:
            np.testing.assert_array_equal(b["params"][k], a["params"][k],
                                          err_msg=f"{when} {k}")
        assert set(a["state"]) == set(b["state"]) and a["state"]
        for k, (v, dtype, where) in a["state"].items():
            assert b["state"][k][1:] == (dtype, where), (when, k)
            np.testing.assert_array_equal(b["state"][k][0], v,
                                          err_msg=f"{when} {k}")
    if kind == "adamw":
        assert {k[1] for k in zero["synced"]["state"]} == {
            "step", "exp_avg", "exp_avg_sq"}
    if kind == "powersgd":         # both weights compressed, no bias
        keys = [k for k in zero["synced"]["state"] if "powersgd" in k[1]]
        assert sorted(keys) == [(0, "powersgd_err"), (0, "powersgd_q"),
                                (2, "powersgd_err"), (2, "powersgd_q")]
        assert all(w == "cpu" for k, (_, _, w) in
                   zero["synced"]["state"].items() if k[1] == "step")


# --- the driver -----------------------------------------------------------

# Discovered hosts, then an exit (host, code) where the host dict is None.
SEQUENCE = [
    {"a": 2, "b": 2},                   # first membership
    {"a": 2, "b": 2, "c": 2},           # addition
    {"a": 2, "c": 2},                   # removal
    {"a": 1, "c": 2},                   # slot-count decrease
    ("c", 1),                           # c fails: cooled down, reassigned
    "cooldown",                         # c is usable again
    {"a": 1, "c": 2},                   # re-admitted
    {"a": 2, "c": 2},                   # slot-count increase
]
# The one step where the port's disruption flag differs, and why: the JAX
# driver respawns a resized host's one process; the port keeps the
# surviving slots' processes and only adds one.
PORT_ONLY = {7: False}


class _Discovery:
    def __init__(self):
        self.hosts = {}

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


def _drive(driver_cls, monkeypatch):
    monkeypatch.setenv("HOROVOD_BLACKLIST_COOLDOWN_RANGE", "0.3,0.3")
    disc, spawned = _Discovery(), []
    d = driver_cls(disc, 1, spawn_fn=lambda a, v: spawned.append((v, a)))
    steps = []
    for item in SEQUENCE:
        if item == "cooldown":
            time.sleep(0.35)
            steps.append(None)
            continue
        n = len(spawned)
        if isinstance(item, tuple):
            d.record_worker_exit(*item)
        else:
            disc.hosts = dict(item)
            d._maybe_update(disc.find_available_hosts_and_slots())
        assert len(spawned) == n + 1, item
        version, assignment = spawned[-1]
        steps.append((version, d.version_disrupted(version),
                      [dataclasses.asdict(s) for s in assignment]))
    return steps


def test_driver_assignments_match_jax(monkeypatch):
    from horovod_tpu.runner.elastic.driver import ElasticDriver as JaxDriver
    from horovod_tpu_torch.runner.elastic.driver import ElasticDriver
    want = _drive(JaxDriver, monkeypatch)
    got = _drive(ElasticDriver, monkeypatch)
    assert [s[0] for s in got if s] == list(range(1, 8))
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None:
            continue
        assert g[0] == w[0] and g[2] == w[2], i
        assert g[1] == PORT_ONLY.get(i, w[1]), (i, g[1], w[1])
    # c's failure removed it; the cooldown let it back in.
    assert {s["hostname"] for s in got[4][2]} == {"a"}
    assert {s["hostname"] for s in got[6][2]} == {"a", "c"}


def test_driver_publishes_one_row_per_slot():
    import json

    from horovod_tpu_torch.runner.elastic.driver import (publish_assignment,
                                                         slot_key)
    from horovod_tpu_torch.runner.hosts import (get_host_assignments,
                                                parse_hosts)
    from horovod_tpu_torch.runner.http_kv import KVStoreServer
    kv = KVStoreServer(secret="")
    v1 = get_host_assignments(parse_hosts("a:2,b:2"), 4)
    v2 = get_host_assignments(parse_hosts("a:1,b:2"), 3)
    assert publish_assignment(kv, v1, 1, set(), False, "a", 1111)
    assert publish_assignment(kv, v2, 2, {slot_key(s) for s in v1}, True,
                              "a", 2222)
    for version, slots, port in ((1, v1, 1111), (2, v2, 2222)):
        for s in slots:
            row = json.loads(kv.get(
                "assignment", f"{version}/{s.hostname}/{s.local_rank}"))
            assert row == {"rank": s.rank, "size": s.size,
                           "local_size": s.local_size,
                           "cross_rank": s.cross_rank,
                           "cross_size": s.cross_size,
                           "coordinator_addr": "a",
                           "coordinator_port": port}
        assert kv.get("elastic", f"nslots/{version}") == \
            str(len(slots)).encode()
    assert kv.get("assignment", "2/a/1") is None    # a's second slot left
    assert (kv.get("elastic", "update_kind/1"),
            kv.get("elastic", "update_kind/2")) == (b"add", b"removal")
    assert (kv.get("elastic", "removed/1"),
            kv.get("elastic", "removed/2")) == (b"0", b"1")
    assert kv.get("elastic", "version") == b"2"
    kv.put("elastic", "finished", b"1")
    assert not publish_assignment(kv, v1, 3, set(), False, "a", 3333)
    assert kv.get("elastic", "version") == b"2"


# --- the failure scenarios through run_elastic ----------------------------

SCENARIOS = {
    "kill": (helpers.elastic_kill, 6, "localhost:1\necho 127.0.0.1:1"),
    "remove": (helpers.elastic_remove, 6, "localhost:1\necho 127.0.0.1:1"),
    "add": (helpers.elastic_add, 8, "localhost:1"),
}


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The three scenarios at once, each through run_elastic with CPU
    workers."""
    from horovod_tpu_torch.runner import run_elastic
    env = {"PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    out = {}

    def one(name):
        fn, steps, _ = SCENARIOS[name]
        script = scripts[name]
        t0 = time.monotonic()
        try:
            out[name] = run_elastic(fn, args=(str(script), steps), min_np=1,
                                    host_discovery_script=str(script),
                                    start_timeout=120, extra_env=env,
                                    device="cpu")
        except Exception as e:  # noqa: BLE001 — reported by the test
            out[name] = e
        out[name + "_s"] = time.monotonic() - t0

    # The scripts before any thread starts: a script written on one thread
    # while another forks a worker can be held open for writing by the
    # child, and exec then fails with ETXTBSY (exit 126).
    scripts = {}
    for name, (_, _, hosts) in SCENARIOS.items():
        script = scripts[name] = tmp_path_factory.mktemp(name) / "discover.sh"
        script.write_text(f"#!/bin/sh\necho {hosts}\n")
        script.chmod(0o755)
    threads = [threading.Thread(target=one, args=(n,)) for n in SCENARIOS]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=240)
    return out


def _results(runs, name):
    got = runs.get(name)
    if isinstance(got, Exception) or got is None:
        pytest.fail(f"{name}: {got!r}")
    return got


def test_worker_killed_midrun_recovers_at_new_world_size(elastic_runs):
    results = _results(elastic_runs, "kill")
    assert len(results) == 1      # only the survivor reports
    steps, w, worlds, final_world = results[0]
    assert steps == 6 and final_world == 1
    # Steps 0-2 at world 2 (1 + 2 a step), the in-flight step 3 rolled
    # back and run again at world 1 with steps 4-5 (1 a step).
    np.testing.assert_allclose(w, [12.0] * 4)
    assert worlds == [2, 2, 2, 1, 1, 1]


def test_graceful_scale_down_preserves_pid_and_uncommitted(elastic_runs):
    results = _results(elastic_runs, "remove")
    assert len(results) == 1
    steps, w, worlds, pid0, pid_now, uncommitted, final_world = results[0]
    assert steps == 6 and final_world == 1
    assert pid0 == pid_now and pid0 != 0
    assert uncommitted == 7
    np.testing.assert_allclose(w, [3 * 2 + 3 * 1] * 2)
    assert worlds == [2, 2, 2, 1, 1, 1]


def test_host_added_midrun_scales_up_in_place(elastic_runs):
    results = _results(elastic_runs, "add")
    assert len(results) == 2
    for steps, w, worlds, rank, final_world in results:
        assert steps == 8 and final_world == 2
    assert [r[3] for r in results] == [0, 1]
    w0, worlds0 = results[0][1], results[0][2]
    assert worlds0.count(1) * 1 + worlds0.count(2) * 2 == w0[0]
    assert worlds0[0] == 1 and worlds0[-1] == 2
    np.testing.assert_allclose(results[1][1], w0)


# --- a peer that dies -----------------------------------------------------

@pytest.mark.parametrize("victim", [1, 0], ids=["follower_dies",
                                                "process_0_dies"])
def test_dead_peer_raises_horovod_internal_error_fast(victim):
    survivor = 1 - victim
    got = helpers.run_world(helpers.peer_dies, size=2, args=(victim,),
                            ranks=[survivor], timeout=90)[0]
    assert got["boundary_timeout_s"] >= 60
    for what in ("pending", "eager"):
        name, cause, seconds = got[what]
        assert name == "HorovodInternalError", (what, got)
        assert cause in ("RuntimeError", "DistNetworkError",
                         "DistBackendError"), (what, got)
        assert seconds < 10, (what, got)


def test_membership_watchdog_aborts_on_a_removal_only():
    got = helpers.run_world(helpers.watchdog_aborts, size=1)[0]
    assert got == {"before": [1.0, 1.0], "aborted_by_addition": False,
                   "after_addition": [1.0, 1.0], "aborted_by_removal": True,
                   "after_removal": "HorovodInternalError"}
