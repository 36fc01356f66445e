"""The port's cluster telemetry plane held against the JAX package's: the
health model on the JAX tests' scenarios, one scripted fleet of 8 agents in
2 slices (leader death and return, the job leader's move, stragglers, a
desync, a generation change) through both packages' aggregators on the same
digests and fake clock, ``top``'s frames and gates, and the port's own
digest, scrape routes and ``hvd.cluster_snapshot()``."""

import copy
import json
import time
import urllib.request

import numpy as np
import pytest

from horovod_tpu.runner.http_kv import KVStoreServer as JKV
from horovod_tpu.telemetry import aggregator as jagg
from horovod_tpu.telemetry import health as jhealth
from horovod_tpu.telemetry import top as jtop
from horovod_tpu_torch.runner.http_kv import KVStoreServer as TKV
from horovod_tpu_torch.telemetry import aggregator as tagg
from horovod_tpu_torch.telemetry import digest as tdigest
from horovod_tpu_torch.telemetry import health as thealth
from horovod_tpu_torch.telemetry import top as ttop


def _row(t, step=None, step_t=None, seq=None, findings=(), host="h"):
    return {"t": t, "host": host, "pid": 1, "step": step, "step_t": step_t,
            "steps": 0 if step is None else step,
            "wall_mean_s": 0.1, "host_dispatch_mean_s": 0.01,
            "anomalies": 0, "anomaly_kinds": {},
            "max_seq": {} if seq is None else {"global": seq},
            "findings": list(findings)}


NOW = 1000.0
# The JAX tests' scenarios (tests/test_telemetry.py, TestHealthModel).
SCENARIOS = {
    "steady": {r: _row(NOW - 0.5, step=10, step_t=NOW - 1, seq=100)
               for r in range(4)},
    "stale_and_missing": {0: _row(NOW - 10, step=5), 1: _row(NOW - 1, step=5),
                          2: None},
    "step_lag": {**{r: _row(NOW, step=20, step_t=NOW) for r in range(3)},
                 3: _row(NOW, step=10, step_t=NOW)},
    "stopped_clock": {**{r: _row(NOW, step=20, step_t=NOW) for r in range(3)},
                      3: _row(NOW, step=10, step_t=NOW - 60)},
    "seq_lag": {**{r: _row(NOW, step=20, step_t=NOW, seq=1000)
                   for r in range(3)},
                3: _row(NOW, step=20, step_t=NOW, seq=100)},
    "watchdog_named": {0: _row(NOW, step=20, step_t=NOW),
                       1: _row(NOW, step=20, step_t=NOW, findings=[
                           {"kind": "straggler", "rank": 2}]),
                       2: _row(NOW, step=20, step_t=NOW)},
    "dead_not_in_median": {0: _row(NOW, step=100, step_t=NOW),
                           1: _row(NOW, step=100, step_t=NOW),
                           2: _row(NOW - 100, step=3)},
    "no_step_data": {0: _row(NOW), 1: _row(NOW)},
}


@pytest.mark.parametrize("interval", [0.1, 1.0, 2.0])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_classify_matches_jax(name, interval):
    rows = SCENARIOS[name]
    thr = thealth.thresholds(interval=interval)
    assert thr == jhealth.thresholds(interval=interval)
    got = thealth.classify(copy.deepcopy(rows), NOW, thr)
    want = jhealth.classify(copy.deepcopy(rows), NOW, thr)
    assert got == want
    assert thealth.counts(got[0]) == jhealth.counts(want[0])


def test_health_row_matches_jax():
    from horovod_tpu.telemetry import digest as jdigest
    rng = np.random.default_rng(3)
    for d in [_digest(r, rng, 5, NOW, True) for r in range(6)] + [
            {"t": 1.0}, {"t": 2.0, "goodput": {"enabled": False}}]:
        assert tdigest.health_row(d) == jdigest.health_row(d)


def test_collect_shape():
    d = tdigest.collect(rank=7)
    assert d["rank"] == 7 and d["v"] == tdigest.SCHEMA_VERSION == 1
    assert {"t", "pid", "host", "profile", "flight", "findings"} <= set(d)
    row = tdigest.health_row(d)
    assert {"t", "step", "anomalies", "max_seq", "findings"} <= set(row)
    assert "metrics" not in row
    json.dumps(d)
    assert "metrics" not in tdigest.collect(rank=0, include_metrics=False)


# ---------------------------------------------------------------------------
# one scripted fleet through both packages
# ---------------------------------------------------------------------------

def _digest(rank, rng, rnd, now, goodput, step=None, seq=None,
            host=None, findings=()):
    """One deterministic beacon: the profile, flight, findings and goodput
    sections a rank's planes would give, drawn from ``rng``."""
    d = {"v": 1, "rank": rank, "host": host or f"host{rank}",
         "pid": 1000 + rank, "t": now,
         "profile": {"step": rnd if step is None else step,
                     "step_t": round(now - float(rng.uniform(0, 0.5)), 6),
                     "steps": rnd, "wall_mean_s": float(rng.uniform(0.05,
                                                                    0.2)),
                     "attribution_mean_s": {
                         "host_dispatch": float(rng.uniform(0, 0.01))}},
         "flight": {"anomalies": int(rng.integers(3)),
                    "by_kind": {"stall": int(rng.integers(2))},
                    "max_seq": {"global": 10 * rnd if seq is None else seq}},
         "findings": list(findings)}
    if goodput:
        d["goodput"] = {"enabled": True,
                        "goodput_ratio": float(rng.uniform(0.5, 1.0)),
                        "wall_s": float(rng.uniform(10, 20)),
                        "categories": {
                            "straggler_wait": float(rng.uniform(0, 1)),
                            "rendezvous_recovery": float(rng.uniform(0, 1))}}
    return d


class _Fleet:
    """``world`` agents of one package over one in-process KV store, ticked
    by hand on a fake clock, their digests scripted."""

    def __init__(self, agg, kv, world, slices, gen, clock, script):
        self.agg, self.kv, self.clock, self.script = agg, kv, clock, script
        self.agents = [agg.TelemetryAgent(
            kv, rank=r, world=world, num_slices=slices, interval=1.0,
            gen=gen, include_metrics=False, time_fn=lambda: clock[0])
            for r in range(world)]

    def tick(self, ranks, rnd, monkey):
        for r in ranks:
            a = self.agents[r]
            monkey.setattr(self.agg._digest, "collect",
                           lambda rank=None, include_metrics=None, r=r:
                           self.script(r, rnd, self.clock[0]))
            a.tick()

    def job(self):
        raw = self.kv.get("telemetry", "job")
        return json.loads(raw) if raw else None

    def slices(self, gen, n):
        out = {}
        for s in range(n):
            raw = self.kv.get(f"telemetry@s{s}", f"g{gen}/slice/{s}")
            out[s] = json.loads(raw) if raw else None
        return out


def _strip(obj):
    """A view without host and pid (the rest is deterministic here)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in ("host", "pid")}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def _script(seed, gen_hosts=None):
    def script(rank, rnd, now):
        rng = np.random.default_rng([seed, rank, rnd])
        step = rnd - 12 if rank == 6 and 17 <= rnd < 21 else None
        seq = 10 * rnd - 200 if rank == 2 and 21 <= rnd < 24 else None
        findings = [{"kind": "straggler", "rank": 5}] \
            if rank == 1 and rnd == 24 else ()
        host = None if gen_hosts is None else gen_hosts[rank]
        return _digest(rank, rng, rnd, now, rank % 3 != 2, step=step,
                       seq=seq, host=host, findings=findings)
    return script


# (ranks that tick, rounds) per stretch of the script.
STRETCHES = [
    (range(8), 3),                  # steady
    ([0, 1, 2, 3, 5, 6, 7], 5),     # slice 1's leader (rank 4) dies
    (range(8), 3),                  # it returns and takes back over
    ([4, 5, 6, 7], 6),              # all of slice 0 dark: the job moves
    (range(8), 4),                  # rank 6 straggles (rounds 17-20)
    (range(8), 6),                  # rank 2 desyncs (21-23); a naming (24)
]


def _run_fleet(agg, kv_cls, monkey):
    kv = kv_cls(secret="")
    clock = [1000.0]
    out = []
    try:
        fleet = _Fleet(agg, kv, 8, 2, "0", clock, _script(11))
        rnd = 0
        for ranks, n in STRETCHES:
            for _ in range(n):
                clock[0] += 1.0
                fleet.tick(list(ranks), rnd, monkey)
                out.append({"job": fleet.job(), "slices": fleet.slices(0, 2),
                            "events": [list(a._events)
                                       for a in fleet.agents]})
                rnd += 1
        # A new membership of 6 (hosts 3 and 7 gone), generation 1.
        hosts = ["host0", "host1", "host2", "host4", "host5", "host6"]
        fleet1 = _Fleet(agg, kv, 6, 2, "1", clock, _script(12, hosts))
        for _ in range(4):
            clock[0] += 1.0
            fleet1.tick(range(6), rnd, monkey)
            out.append({"job": fleet1.job(), "slices": fleet1.slices(1, 2),
                        "events": [list(a._events) for a in fleet1.agents]})
            rnd += 1
        out.append({"counters": [a.counters for a in fleet.agents
                                 + fleet1.agents]})
    finally:
        kv.stop()
    return out


@pytest.fixture(scope="module")
def fleets():
    mp = pytest.MonkeyPatch()
    try:
        return (_run_fleet(tagg, TKV, mp), _run_fleet(jagg, JKV, mp))
    finally:
        mp.undo()


def test_fleet_views_equal_jax(fleets):
    got, want = fleets
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _strip(g) == _strip(w), f"round {i}"


def test_fleet_saw_every_transition(fleets):
    got = fleets[0]
    last_gen0 = got[sum(n for _, n in STRETCHES) - 1]["job"]
    why = {(e["rank"], e["to"], e.get("why")) for e in last_gen0["events"]}
    assert (4, "dead", "beacon_stale") in why and (4, "healthy", None) in why
    assert (0, "dead", "beacon_stale") in why
    assert (6, "straggling", "step_lag") in why
    assert (2, "desynced", "collective_seq_lag") in why
    assert (5, "straggling", "watchdog_named") in why
    moved = got[sum(n for _, n in STRETCHES[:4]) - 1]["job"]
    assert moved["leader"] == 4 and moved["leader_slice"] == 1
    final = got[-2]["job"]
    assert final["gen"] == "1" and final["counts"]["healthy"] == 6
    removed = {e["host"] for e in final["events"]
               if e.get("why") == "membership_removed"}
    assert removed == {"host3", "host7"}
    assert final["goodput"]["ranks"] and final["goodput"]["ratio"] > 0


def test_top_render_and_gate_match_jax(fleets):
    for g, w in zip(fleets[0][:-1], fleets[1][:-1]):
        for now in (g["job"]["t"], g["job"]["t"] + 1.5, g["job"]["t"] + 60):
            assert ttop.render(g["job"], now=now) == jtop.render(w["job"],
                                                                 now=now)
            assert ttop.gate(g["job"], now=now) == jtop.gate(w["job"],
                                                             now=now)
    final = fleets[0][-2]["job"]
    assert ttop.gate(final, now=final["t"])
    assert not ttop.gate(final, now=final["t"] + 60)      # stale
    assert not ttop.gate(None) and ttop.render(None) == jtop.render(None)
    frames = [None, {"error": "x"}, {"saturated": True},
              {"active": 2, "slots": 4, "queue_depth": 3, "queue_limit": 8,
               "served": 9, "fill_ratio": 0.5, "slo": {"ttft_p99": 1.2},
               "cache_valid": False},
              {"active": 1, "slots": 2, "fill_ratio": 0.25}]
    for f in frames:
        assert ttop.serving_ready(f) == jtop.serving_ready(f)
        assert ttop.render_serving(f) == jtop.render_serving(f)


def test_top_main_once_reads_the_kv(monkeypatch):
    from horovod_tpu_torch.runner.secret import SECRET_ENV
    monkeypatch.delenv(SECRET_ENV, raising=False)   # the store's: none
    kv = TKV(secret="")
    port = kv.start()
    try:
        assert ttop.main(["--once", "--kv", f"127.0.0.1:{port}"]) == 1
        view = {"t": time.time(), "interval_s": 2.0, "gen": "0",
                "thresholds": {"dead_after": 6.0},
                "health": {"0": {"state": "healthy"}},
                "counts": {"healthy": 1}, "slices": {}}
        kv.put("telemetry", "job", json.dumps(view).encode())
        assert ttop.main(["--once", "--kv", f"127.0.0.1:{port}"]) == 0
        view["t"] -= 60
        kv.put("telemetry", "job", json.dumps(view).encode())
        assert ttop.main(["--once", "--kv", f"127.0.0.1:{port}"]) == 1
    finally:
        kv.stop()


# ---------------------------------------------------------------------------
# the port's agent behind the scrape endpoint and hvd.cluster_snapshot()
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def test_cluster_routes_serve_the_agent_view():
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.metrics import server as msrv
    kv = TKV(secret="")
    clock = [1000.0]
    agents = [tagg.TelemetryAgent(kv, rank=r, world=4, num_slices=2,
                                  interval=1.0, gen="0",
                                  include_metrics=True,
                                  time_fn=lambda: clock[0])
              for r in range(4)]
    was = metrics.enabled()
    metrics.set_enabled(True)
    srv = msrv.MetricsServer(port=0, addr="127.0.0.1")
    port = srv.start()
    try:
        for _ in range(3):
            clock[0] += 1.0
            for a in agents:
                a.tick()
        tagg.set_agent(agents[0])
        view = agents[0].job_view()
        assert view["counts"]["healthy"] == 4 and view["leader"] == 0
        code, body = _get(port, "/cluster/health")
        assert code == 200 and json.loads(body) == view
        assert hvd.cluster_snapshot() == view
        code, body = _get(port, "/cluster/steps")
        assert code == 200 and json.loads(body) == tagg.cluster_steps()
        assert sorted(json.loads(body)["ranks"]) == ["0", "1", "2", "3"]
        code, body = _get(port, "/cluster/metrics")
        text = body.decode()
        assert code == 200 and 'slice="0"' in text and 'slice="1"' in text
        assert "telemetry_rpcs_total" in text
        # A job view nobody refreshes goes stale; a non-leader reads the KV.
        tagg.set_agent(agents[3])
        assert hvd.cluster_snapshot() == json.loads(
            kv.get("telemetry", "job"))
    finally:
        tagg.set_agent(None)
        srv.stop()
        kv.stop()
        metrics.set_enabled(was)
    local = hvd.cluster_snapshot()
    assert local["local_only"] and local["world"] == 1


def test_start_from_config_needs_a_kv_and_a_world(monkeypatch):
    from horovod_tpu_torch.common.config import Config
    from horovod_tpu_torch.runner.secret import SECRET_ENV
    monkeypatch.delenv(SECRET_ENV, raising=False)   # the store's: none
    monkeypatch.delenv("HOROVOD_KV_ADDR", raising=False)
    monkeypatch.delenv("HOROVOD_KV_PORT", raising=False)
    cfg = Config()
    assert tagg.start_from_config(cfg, None, 0, 4) is None
    kv = TKV(secret="")
    port = kv.start()
    try:
        monkeypatch.setenv("HOROVOD_KV_ADDR", "127.0.0.1")
        monkeypatch.setenv("HOROVOD_KV_PORT", str(port))
        assert tagg.start_from_config(cfg, None, 0, 1) is None
        cfg.telemetry = False
        assert tagg.start_from_config(cfg, None, 0, 4) is None
        cfg.telemetry = True
        cfg.telemetry_interval = 0.05
        agent = tagg.start_from_config(cfg, None, 1, 4)
        assert agent is tagg.get_agent() and agent.rank == 1
        deadline = time.time() + 10
        while kv.get("telemetry@s0", "g0/rank/1") is None \
                and time.time() < deadline:
            time.sleep(0.02)
        assert kv.get("telemetry@s0", "g0/rank/1") is not None
    finally:
        tagg.stop()
        kv.stop()
    assert tagg.get_agent() is None


def test_tick_is_a_chaos_site_and_never_raises(tmp_path, monkeypatch):
    from horovod_tpu_torch.chaos import injector
    plan = {"seed": 0, "faults": [{"site": "telemetry.tick",
                                   "kind": "delay", "at": [1],
                                   "delay_ms": 1.0}]}
    monkeypatch.setenv("HOROVOD_CHAOS_PLAN", json.dumps(plan))
    monkeypatch.setenv("HOROVOD_CHAOS_LEDGER", str(tmp_path))

    class Broken:
        def get(self, scope, key):
            raise ConnectionError("down")

        put = get

    injector.install_from_env()
    try:
        agent = tagg.TelemetryAgent(Broken(), rank=0, world=2,
                                    include_metrics=False)
        for _ in range(3):
            agent.tick()            # every KV call fails: missed rounds
        assert agent.rounds == 3
        assert agent.counters["beacon_put"] == 3
        entries = injector.read_ledger(str(tmp_path))
        assert [(e["site"], e["kind"]) for e in entries] == [
            ("telemetry.tick", "delay")]
    finally:
        injector.uninstall()
