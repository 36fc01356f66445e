"""The port's control plane held against the JAX package's: the exchange
simulations and layout rules of ``common/control_plane.py``, the chaos
plans' parsing and trigger decisions, the KV shard router, the stall
inspector, the hierarchical boundary stream's lease, and one 4-rank gloo
world (2 slices of 2) that runs negotiation flat and hierarchical, fused
buckets on both boundary streams, a deliberate order mismatch and a chaos
plan against the launcher's KV."""

import importlib
import json
import os
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_a17_helpers as A  # noqa: E402
import torch_port_helpers as helpers  # noqa: E402
from torch_shared import shared  # noqa: E402

from horovod_tpu.common import control_plane as jcp  # noqa: E402
from horovod_tpu_torch.chaos import injector as tinjector  # noqa: E402
from horovod_tpu_torch.common import control_plane as tcp  # noqa: E402

# ``chaos.plan`` is also a function the packages export: the modules by name.
jplan = importlib.import_module("horovod_tpu.chaos.plan")
tplan = importlib.import_module("horovod_tpu_torch.chaos.plan")

WORLD, ROUNDS, SEED = 4, 3, 19


@pytest.fixture(autouse=True)
def _no_layout_env(monkeypatch):
    for k in ("HOROVOD_MESH_SLICES", "HOROVOD_CONTROL_PLANE",
              "HOROVOD_KV_SHARD_COUNT", "HOROVOD_KV_SHARD_PORTS"):
        monkeypatch.delenv(k, raising=False)


# ---------------------------------------------------------------------------
# exchange simulations and layout rules
# ---------------------------------------------------------------------------

def _sim_view(r):
    """A simulate_exchange result without the sweep's attempts, which
    depend on thread timing (as the JAX package's own guard compares)."""
    out = {k: v for k, v in r.items() if k != "per_proc"}
    out["per_proc"] = [{k: v for k, v in c.items() if k != "attempts"}
                       for c in r["per_proc"]]
    return out


@pytest.mark.parametrize("strategy", ["flat", "hier"])
@pytest.mark.parametrize("slices", [1, 2, 4])
@pytest.mark.parametrize("world", [16, 64])
def test_simulate_exchange_matches_jax(world, slices, strategy):
    def payload(p, r):
        return [p + 1, r, (p * 7919 + r) % 13]

    got = tcp.simulate_exchange(world, slices, rounds=2, payload_fn=payload,
                                strategy=strategy)
    want = jcp.simulate_exchange(world, slices, rounds=2, payload_fn=payload,
                                 strategy=strategy)
    assert _sim_view(got) == _sim_view(want)
    assert got["identical"] and got["result"] == [payload(p, 1)
                                                  for p in range(world)]
    if got["strategy"] == "hier":
        assert got["member_gets_per_round"] == 1.0


GRID = [(w, k) for w in (1, 2, 3, 4, 6, 8, 12, 16, 64, 96)
        for k in (None, 0, 1, 2, 3, 4, 8)]


def test_exchange_plan_matches_jax():
    for world, k in GRID:
        assert tcp.exchange_plan(world, k) == jcp.exchange_plan(world, k), \
            (world, k)


@pytest.mark.parametrize("env", [{}, {"HOROVOD_CONTROL_PLANE": "flat"},
                                 {"HOROVOD_CONTROL_PLANE": "hier"},
                                 {"HOROVOD_KV_SHARD_COUNT": "3"},
                                 {"HOROVOD_MESH_SLICES": "4"}])
def test_kv_shard_count_matches_jax(monkeypatch, env):
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for world, k in GRID:
        assert tcp.kv_shard_count(world, k) == jcp.kv_shard_count(world, k)
        assert tcp.kv_shard_count(world, k, env=dict(os.environ)) \
            == jcp.kv_shard_count(world, k)
    assert tcp.configured() == jcp.configured()


def test_scope_routing_matches_jax():
    scopes = ["telemetry", "elastic", "x@s", "x@sa", "a@s0@s3"] + [
        jcp.slice_scope(s, sid) for s in ("telemetry", "bootstrap")
        for sid in range(9)]
    for scope in scopes:
        for n in range(6):
            assert tcp.shard_of_scope(scope, n) == jcp.shard_of_scope(
                scope, n), (scope, n)
    for sid in range(9):
        assert tcp.slice_scope("telemetry", sid) == jcp.slice_scope(
            "telemetry", sid)


def test_proc_slice_layout_and_boundary_role_match_jax():
    for n_procs in (1, 2, 3, 4, 6, 8, 16):
        for local in (1, 2, 4):
            for k in (None, 2, 3, 4, 8):
                lay = tcp.proc_slice_layout(n_procs, local, k)
                assert lay == jcp.proc_slice_layout(n_procs, local, k)
                nk, per = lay
                groups = None if nk <= 1 else [
                    list(range(s * per, (s + 1) * per)) for s in range(nk)]
                for coord in (0, 1):
                    for p in range(n_procs):
                        assert tcp.boundary_role(p, groups, coord) == \
                            jcp.boundary_role(p, groups, coord)


def test_exchange_groups_follow_the_layout(monkeypatch):
    monkeypatch.setenv("HOROVOD_MESH_SLICES", "2")
    assert tcp.exchange_groups(list(range(8))) == [[0, 1, 2, 3],
                                                   [4, 5, 6, 7]]
    assert tcp.exchange_groups([0, 5]) == [[0], [5]]
    assert tcp.exchange_groups([4, 5, 6, 7]) is None   # one slice of them
    monkeypatch.setenv("HOROVOD_CONTROL_PLANE", "flat")
    assert tcp.exchange_groups(list(range(8))) is None


def test_coord_kv_wraps_the_store():
    import datetime

    import torch.distributed as dist
    store = dist.HashStore()
    store.set_timeout(datetime.timedelta(seconds=5))
    kv = tcp.CoordKV(store)
    kv.set("a", "1")
    kv.set("a", "2", overwrite=True)
    assert kv.get("a", 1000) == "2"
    kv.delete("a")
    with pytest.raises(Exception):
        kv.get("a", 50)
    got, c = tcp.flat_exchange(kv, 0, [0], "b", json.dumps([7]), 1000)
    assert got == {0: "[7]"} and c["gets"] == 0


# ---------------------------------------------------------------------------
# chaos plans
# ---------------------------------------------------------------------------

PLAN = {"seed": 5, "note": "grid", "faults": [
    {"site": "http_kv.request", "kind": "drop", "at": [0, 1, 7]},
    {"site": "http_kv.request", "kind": "http_5xx", "every": 5, "after": 3},
    {"site": "collective.dispatch", "kind": "delay", "p": 0.3,
     "delay_ms": 2.0},
    {"site": "fusion.flush", "kind": "hang", "at_step": [3, 9],
     "hang_s": 7.0},
    {"site": "elastic.commit", "kind": "crash", "rank": 0, "at_step": [4],
     "max_fires": 1},
    {"site": "negotiation.exchange", "kind": "delay", "every": 3, "p": 0.6,
     "rank": 2},
    {"site": "driver.discovery", "kind": "host_remove", "at": [2],
     "duration": 3, "host_index": 0},
    {"site": "telemetry.tick", "kind": "delay", "p": 0.5, "max_fires": 4,
     "after": 10},
]}


def test_plan_parsing_matches_jax():
    got = tplan.ChaosPlan.from_dict(PLAN)
    want = jplan.ChaosPlan.from_dict(PLAN)
    assert got.to_dict() == want.to_dict()
    assert tplan.ChaosPlan.from_yaml(json.dumps(PLAN)).to_dict() \
        == want.to_dict()
    assert sorted(got.by_site) == sorted(want.by_site)
    assert tplan.KINDS == jplan.KINDS and tplan.SITES == jplan.SITES
    bad = [{"site": "nowhere", "kind": "drop", "at": [0]},
           {"site": "fusion.flush", "kind": "drop", "at": [0]},
           {"site": "fusion.flush", "kind": "delay"},
           {"site": "fusion.flush", "kind": "delay", "p": 1.5},
           {"site": "driver.discovery", "kind": "host_remove", "at": [0]},
           {"site": "fusion.flush", "kind": "delay", "at": [0],
            "typo": 1}]
    for spec in bad:
        with pytest.raises(ValueError) as t:
            tplan.ChaosPlan.from_dict({"faults": [spec]})
        with pytest.raises(ValueError) as j:
            jplan.ChaosPlan.from_dict({"faults": [spec]})
        assert str(t.value) == str(j.value)


def test_yaml_plan_without_pyyaml_says_json(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ValueError, match="write the plan as JSON"):
        tplan.ChaosPlan.from_yaml("seed: 1\nfaults: []\n")
    assert len(tplan.ChaosPlan.from_yaml(json.dumps(PLAN))) == 8


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1])
def test_trigger_decisions_match_jax(seed):
    got = tplan.ChaosPlan.from_dict({**PLAN, "seed": seed})
    want = jplan.ChaosPlan.from_dict({**PLAN, "seed": seed})
    fired = {(3, 3)}
    for idx, (ts, js) in enumerate(zip(got.faults, want.faults)):
        decisions = [
            (ts.matches(n, step, rank, seed, idx, fires, fired),
             js.matches(n, step, rank, seed, idx, fires, fired))
            for n in range(256) for step in range(32)
            for rank, fires in ((0, 0), (2, 1))]
        assert [t for t, _ in decisions] == [j for _, j in decisions]
    for n in range(256):
        for idx in range(len(PLAN["faults"])):
            assert tplan._unit(seed, idx, n) == jplan._unit(seed, idx, n)
    # A cursor driven through the same calls fires the same faults.
    tc, jc = tplan.TriggerCursor(got), jplan.TriggerCursor(want)
    rng = np.random.default_rng(seed)
    for _ in range(600):
        site = PLAN["faults"][int(rng.integers(len(PLAN["faults"])))]["site"]
        rank, step = int(rng.integers(4)), int(rng.integers(12))
        assert [s.kind for s in tc.decide(site, rank, step)] == \
            [s.kind for s in jc.decide(site, rank, step)]
    assert tc.log == jc.log


def test_injector_ledger_and_host_filter(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_CHAOS_PLAN", json.dumps(PLAN))
    monkeypatch.setenv("HOROVOD_CHAOS_LEDGER", str(tmp_path))
    monkeypatch.setenv("HOROVOD_RANK", "0")
    tinjector.install_from_env()
    try:
        tinjector.install_from_env()          # unchanged env: no reset
        hosts = {"a": 1, "b": 2, "c": 1}
        seen = [tinjector.filter_hosts("driver.discovery", hosts)
                for _ in range(6)]
        assert [sorted(h) for h in seen] == [
            ["a", "b", "c"], ["a", "b", "c"], ["b", "c"], ["b", "c"],
            ["b", "c"], ["a", "b", "c"]]
        tinjector.set_step(4)
        with pytest.raises(Exception):
            tinjector.fire("http_kv.request")    # call 0: drop
        entries = tinjector.read_ledger(str(tmp_path))
        assert [(e["site"], e["kind"]) for e in entries] == [
            ("driver.discovery", "host_remove"), ("http_kv.request", "drop")]
        assert tinjector.stats()["fires"] == {6: 1, 0: 1}
    finally:
        tinjector.uninstall()
    assert not tinjector.armed


# ---------------------------------------------------------------------------
# the KV shard router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [0, 2, 3])
def test_shard_router_places_scopes_as_jax_routes_them(monkeypatch, shards):
    from horovod_tpu_torch.runner.http_kv import KVStoreClient, KVStoreServer
    srv = KVStoreServer(secret="s", shards=shards)
    port = srv.start()
    try:
        monkeypatch.setenv("HOROVOD_KV_SHARD_PORTS",
                           ",".join(str(p) for p in srv.shard_ports))
        client = KVStoreClient("127.0.0.1", port, secret="s")
        scopes = ["telemetry", "elastic"] + [
            tcp.slice_scope("telemetry", s) for s in range(5)]
        for scope in scopes:
            client.put(scope, "k", scope.encode())
        for scope in scopes:
            k = jcp.shard_of_scope(scope, shards)
            owner = srv if k is None else srv._shards[k]
            assert owner._httpd.store[scope]["k"] == scope.encode()
            assert srv.get(scope, "k") == scope.encode()     # read-through
            assert client.get(scope, "k") == scope.encode()
        srv.prune_scope("telemetry", ["x"])
        assert all(srv.get(s, "k") is None for s in scopes
                   if s.startswith("telemetry"))
        assert srv.get("elastic", "k") == b"elastic"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# the stall inspector and the boundary lease
# ---------------------------------------------------------------------------

def _until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_stall_inspector_warns_once_then_flags_shutdown(monkeypatch,
                                                        tmp_path):
    from horovod_tpu_torch.common.exceptions import HorovodInternalError
    from horovod_tpu_torch.metrics import instruments
    from horovod_tpu_torch.ops import stall_inspector as si_mod
    monkeypatch.setattr(si_mod.StallInspector, "CHECK_INTERVAL_SECS", 0.05)
    monkeypatch.setenv("HOROVOD_FLIGHT_DIR", str(tmp_path))
    was = instruments.enabled()
    instruments.set_enabled(True)

    def warnings():
        return instruments.STALL_EVENTS.labels("warning").get() - warn0

    warn0 = instruments.STALL_EVENTS.labels("warning").get()
    si = si_mod.StallInspector(warning_secs=0.01, shutdown_secs=1.0)
    try:
        si.record_enqueue("g1")
        assert _until(lambda: warnings() == 1)
        assert not si.shutdown_flagged
        assert _until(lambda: si.shutdown_flagged)
        assert warnings() == 1          # once until the next flush
        with pytest.raises(HorovodInternalError, match="stall"):
            si.record_enqueue("g2")
    finally:
        si.stop()
        instruments.set_enabled(was)


def test_stall_inspector_flush_resets(monkeypatch):
    from horovod_tpu_torch.ops import stall_inspector as si_mod
    monkeypatch.setattr(si_mod.StallInspector, "CHECK_INTERVAL_SECS", 0.05)
    si = si_mod.StallInspector(warning_secs=10, shutdown_secs=0.2)
    try:
        si.record_enqueue("g1")
        si.record_flush()
        time.sleep(0.3)
        assert not si.shutdown_flagged
    finally:
        si.stop()


class _Store:
    """The few TCPStore calls a follower's boundary fetch makes, over a
    dict: ``wait`` raises when a key is missing (as a store's timeout
    does), and root reads are counted."""

    def __init__(self):
        self.d = {}
        self.root_gets = 0

    def check(self, keys):
        return all(k in self.d for k in keys)

    def wait(self, keys, timeout):
        if not self.check(keys):
            raise RuntimeError("timeout")

    def get(self, key):
        if not any(part[:1] == "s" and part[1:].isdigit()
                   for part in key.split("/")):
            self.root_gets += 1
        return self.d[key]

    def set(self, key, value):
        self.d[key] = value.encode() if isinstance(value, str) else value

    def delete_key(self, key):
        self.d.pop(key, None)


def _member(lease_ms=100.0):
    import torch
    from horovod_tpu_torch.ops.fusion import FusionRuntime
    rt = FusionRuntime(1 << 20, torch.device("cpu"), rank=3, size=4,
                       store=_Store(), control_lease_ms=lease_ms)
    rt._client = rt._store
    rt._cp_role, rt._cp_slice, rt._cp_members = "member", 1, 2
    return rt


def _takeovers():
    from horovod_tpu_torch.metrics import instruments
    return instruments.FUSION_BOUNDARY_OUTCOMES.labels("takeover").get()


def test_member_takes_over_a_dead_leader_after_its_lease():
    from horovod_tpu_torch.metrics import instruments
    was = instruments.enabled()
    instruments.set_enabled(True)
    try:
        rt = _member()
        kv = rt._client
        kv.set(rt._boundary_key(0), "-1 sync - flat - - -")
        t0 = _takeovers()
        # The slice key is missing: the lease starts, no root read.
        assert rt._apply_ready_boundaries(0.001) is False
        assert kv.root_gets == 0 and rt._cp_role == "member"
        time.sleep(0.12)
        # Past the lease, with a boundary at the root the leader never
        # mirrored: the member promotes itself, applies and re-publishes.
        assert rt._apply_ready_boundaries(0.001) is False
        assert rt._cp_role == "leader" and rt._boundary_seq == 1
        assert kv.root_gets == 1
        assert rt._slice_boundary_key(0) in kv.d
        assert _takeovers() - t0 == 1
    finally:
        instruments.set_enabled(was)


def test_lease_renews_when_the_root_has_no_boundary():
    rt = _member()
    kv = rt._client
    assert rt._apply_ready_boundaries(0.001) is False
    time.sleep(0.12)
    assert rt._apply_ready_boundaries(0.001) is False
    assert rt._cp_role == "member" and rt._lease_wait0 is not None
    time.sleep(0.12)
    kv.set(rt._boundary_key(0), "-1 sync - flat - - -")
    rt._apply_ready_boundaries(0.001)
    assert rt._cp_role == "leader" and rt._boundary_seq == 1


def test_a_mirrored_boundary_is_read_from_the_slice():
    rt = _member()
    kv = rt._client
    kv.set(rt._boundary_key(0), "-1 sync - flat - - -")
    kv.set(rt._slice_boundary_key(0), "-1 sync - flat - - -")
    rt._apply_ready_boundaries(0.001)
    assert rt._cp_role == "member" and rt._boundary_seq == 1
    assert kv.root_gets == 0


# ---------------------------------------------------------------------------
# one 4-rank world, 2 slices of 2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def compute():
        from horovod_tpu_torch.runner.http_kv import KVStoreServer
        kv = KVStoreServer(secret="")
        port = kv.start()
        try:
            return helpers.run_world(
                A.control_plane_world, size=WORLD,
                args=(SEED, ROUNDS, port,
                      str(tmp_path_factory.mktemp("chaos_ledgers"))),
                env={"HOROVOD_MESH_SLICES": "2"}, local_size=2,
                timeout=240)
        finally:
            kv.stop()
    return shared(tmp_path_factory, "control_plane_world", compute)


def test_exchange_equal_flat_and_hier(world):
    want = [[A.payload(p, r) for p in range(WORLD)] for r in range(ROUNDS)]
    for w in world:
        assert w["exchange_flat"] == want and w["exchange_hier"] == want


def test_negotiation_gets_by_role(world):
    plan = jcp.exchange_plan(WORLD, 2)
    for w in world:
        flat, hier = w["stats_flat"], w["stats_hier"]
        assert flat["rounds"] == ROUNDS and flat["hier_rounds"] == 0
        assert flat["gets"] == ROUNDS * (WORLD - 1)
        assert hier["hier_rounds"] == ROUNDS
        member = w["rank"] % 2 == 1
        assert hier["gets"] == ROUNDS * (
            plan["member_gets"] if member else plan["leader_gets"])
        assert hier["gets"] == hier["gets_local"] + hier["gets_cross"] \
            + hier["gets_fanback"]


def test_fused_buckets_bit_equal_to_flat(world):
    for w in world:
        flat, hier = w["fused_flat"], w["fused_hier"]
        assert flat["buckets"] == hier["buckets"] and flat["buckets"]
        assert all(np.array_equal(a, b)
                   for a, b in zip(flat["vals"], hier["vals"]))
    assert all(np.array_equal(a, b) for w in world[1:] for a, b in
               zip(w["fused_hier"]["vals"], world[0]["fused_hier"]["vals"]))
    assert [w["fused_flat"]["role"] for w in world] == ["root"] * 4
    assert [w["fused_hier"]["role"] for w in world] == [
        "root", "leader", "leader", "member"]


def test_members_read_no_root_boundary(world):
    member = world[3]["fused_hier"]["stats"]
    assert member["fusion_root_gets"] == 0 and member["fusion_slice_gets"] > 0
    leader = world[2]["fused_hier"]["stats"]
    assert leader["fusion_root_gets"] > 0 and leader["fusion_sets"] > 0
    assert world[1]["fused_hier"]["stats"]["fusion_sets"] == 0


def test_order_mismatch_raises_naming_the_processes(world):
    for w in world:
        msg = w["order_mismatch"]
        assert msg and "order/signature mismatch" in msg
        named = [0] if w["rank"] else [1, 2, 3]
        assert f"process(es) {named}" in msg
        assert w["order_match_rows"] == 3 * WORLD


def test_chaos_drop_completes_and_schedule_repeats(world):
    for w in world:
        first, second = w["chaos"]
        assert first["ok"] and second["ok"]
        assert first["retries"] == 2 == second["retries"]
        assert first["schedule"] == second["schedule"]
        kinds = [s[3] for s in first["schedule"]]
        assert kinds[:2] == ["drop", "drop"] and "delay" in kinds
        assert {s[1] for s in first["schedule"]} == {w["rank"]}
