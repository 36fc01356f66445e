"""The port's autopilot (``horovod_tpu_torch/autopilot/``) held against the
JAX package's on the same inputs: the remediation policy and the driver
arm on a fake clock and a fake KV (JAX's ``_Clock`` pattern), the signal
frames over scripted snapshots, and the controller over stub runtimes and
scripted snapshots, where both leave the same decision trail and knob
trajectory tick by tick (the categorical sweep, the BO under the bounded
move, the freeze, the cross-wire trial with its adopt and its two
reverts, the overlap lever, drift, no-signal epochs, remediation, a prior).
Then the port's wiring: ``hvd.init`` arms the controller on the CPU,
``shutdown`` stops it, and a live tick steers the fusion runtime."""

import copy
import json
import os

import numpy as np
import pytest

from horovod_tpu.autopilot import controller as jax_ctrl
from horovod_tpu.autopilot import remediate as jax_rem
from horovod_tpu.autopilot import signals as jax_sig
from horovod_tpu.common.config import Config as JaxConfig
from horovod_tpu.ops import fusion as jax_fusion
from horovod_tpu.ops import wire as jax_wire
from horovod_tpu_torch.autopilot import controller as t_ctrl
from horovod_tpu_torch.autopilot import remediate as t_rem
from horovod_tpu_torch.autopilot import signals as t_sig
from horovod_tpu_torch.common.config import Config as TConfig
from horovod_tpu_torch.ops import wire as t_wire

PKGS = ("jax", "port")


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# --- the remediation policy -------------------------------------------------

def _verdict_script(seed, epochs=40):
    """Scripted epochs: verdicts over ranks 0..7 (causes, hosts, some
    host-less), the live world, host sizes, clock steps and refunds."""
    rng = np.random.default_rng(seed)
    hosts = {r: f"h{r // 2}" for r in range(8)}
    script, world = [], 8
    for _ in range(epochs):
        verdicts = {}
        for r in rng.choice(8, size=int(rng.integers(0, 4)), replace=False):
            r = int(r)
            verdicts[r] = {"cause": ("dead", "stalled", "straggler",
                                     "other")[int(rng.integers(0, 4))],
                           "host": None if rng.random() < 0.15
                           else hosts[r]}
        sizes = {h: 2 for h in set(hosts.values())} if rng.random() < 0.5 \
            else None
        script.append((verdicts, world, sizes,
                       float(rng.choice([5.0, 60.0, 400.0])),
                       f"h{int(rng.integers(0, 4))}" if rng.random() < 0.2
                       else None))
        world = max(world - int(rng.random() < 0.1), 2)
    return script


@pytest.mark.parametrize("seed,params", [
    (0, dict(hysteresis=2, max_removals=1, min_world=1)),
    (1, dict(hysteresis=1, max_removals=3, min_world=5)),
    (2, dict(hysteresis=3, max_removals=2, min_world=2, window_s=300.0)),
    (3, dict(hysteresis=1, max_removals=8, min_world=1,
             protected_hosts=("h1",))),
])
def test_remediation_policy_verdicts_equal(seed, params):
    clocks = {p: _Clock() for p in PKGS}
    pols = {"jax": jax_rem.RemediationPolicy(time_fn=clocks["jax"],
                                             **params),
            "port": t_rem.RemediationPolicy(time_fn=clocks["port"],
                                            **params)}
    for verdicts, world, sizes, dt, refund in _verdict_script(seed):
        outs = {}
        for p in PKGS:
            clocks[p].advance(dt)
            outs[p] = pols[p].observe(copy.deepcopy(verdicts), world,
                                      host_sizes=sizes)
            if refund:
                pols[p].refund(refund)
        assert outs["jax"] == outs["port"]
        assert pols["jax"].streaks() == pols["port"].streaks()


class _FakeKV:
    def __init__(self):
        self.d = {}

    def get(self, scope, key):
        return self.d.get((scope, key))

    def put(self, scope, key, value):
        self.d[(scope, key)] = value


class _Disc:
    def __init__(self, hosts):
        self.hosts = hosts

    def find_available_hosts_and_slots(self):
        return dict(self.hosts)


def test_driver_arm_verdicts_equal(monkeypatch):
    """Requests of known, unknown and floor-breaking hosts, a rate window
    and a transient KV fault: the same removals and the same acks, and the
    cooldown takes the same hosts out of discovery."""
    monkeypatch.setenv("HOROVOD_BLACKLIST_COOLDOWN_RANGE", "600,600")
    from horovod_tpu.runner.elastic.discovery import HostManager as JaxHM
    from horovod_tpu_torch.runner.elastic.discovery import HostManager as THM
    hosts = {"a": 4, "b": 4, "c": 2, "d": 1, "e": 1}
    arms, kvs, hms, clocks = {}, {}, {}, {}
    for p, hm_cls, mod in (("jax", JaxHM, jax_rem), ("port", THM, t_rem)):
        kvs[p], clocks[p] = _FakeKV(), _Clock()
        hms[p] = hm_cls(_Disc(hosts))
        arms[p] = mod.DriverArm(kvs[p], hms[p], min_world=6, max_removals=2,
                                window_s=100.0, time_fn=clocks[p])
    reqs = [("c", 5, "straggler"), ("zz", 9, "dead"), ("a", 1, "dead"),
            ("d", 10, "stalled"), ("b", 3, "dead"), ("e", 11, "straggler"),
            ("c", 5, "straggler")]
    flaky = {"jax": [2], "port": [2]}
    for p in PKGS:
        real = kvs[p].get

        def get(scope, key, real=real, left=flaky[p]):
            if key == "req/3" and left[0]:
                left[0] -= 1
                raise OSError("transient")
            return real(scope, key)
        kvs[p].get = get
    for i, (host, rank, cause) in enumerate(reqs):
        removed = {}
        for p in PKGS:
            kvs[p].put("autopilot", f"req/{i}", json.dumps(
                {"id": f"t-{i}", "rank": rank, "host": host,
                 "cause": cause}).encode())
            kvs[p].put("autopilot", "head", str(i + 1).encode())
            clocks[p].advance(40.0)
            removed[p] = arms[p].poll(hms[p].current_hosts())
        assert removed["jax"] == removed["port"], i
    assert {k: v for k, v in kvs["jax"].d.items() if k[1].startswith("ack")} \
        == {k: v for k, v in kvs["port"].d.items() if k[1].startswith("ack")}
    assert hms["jax"].current_hosts() == hms["port"].current_hosts()


# --- signal frames -----------------------------------------------------------

def _snap(t, bytes_total, dcn, steps, findings=(), flushes=0, gp=None):
    recs = [{"epoch": 0, "step": s, "t": float(s), "wall_s": 0.1 + 0.01 * s,
             "attribution": {"collective": 0.02 * s, "compute": 0.05,
                             "fusion": 0.001, "cross_wait": 0.0}}
            for s in range(steps)]
    return {
        "t": t, "wall_t": t,
        "counters": {
            "collective_bytes_total": {
                (("op", "allreduce"), ("process_set", "global")): bytes_total,
                (("op", "allgather"), ("process_set", "global")): 10.0},
            "wire_bytes_total": {
                (("dtype", "float32"), ("tier", "dcn")): dcn,
                (("dtype", "int8"), ("tier", "ici")): 2 * dcn},
            "fusion_boundary_outcomes_total": {
                (("outcome", "deferred"),): float(steps),
                (("outcome", "applied"),): 3.0 * steps},
            "dispatch_plan_events_total": {}},
        "histograms": {
            "fusion_flush_bytes": {(): (float(flushes), 1e6 * flushes)},
            "fusion_fill_ratio": {(): (float(flushes), 0.5 * flushes)}},
        "last_step_key": (0, steps - 1, float(steps - 1)) if steps else None,
        "step_records": recs, "findings": list(findings),
        "slo_burn": {"ttft_p99": 1.5} if steps > 3 else {},
        "goodput": gp or {},
    }


FRAME_CASES = {
    "deltas": (_snap(0.0, 100.0, 25.0, 2), _snap(2.5, 900.0, 80.0, 5,
                                                 flushes=3), None),
    "stragglers": (_snap(0.0, 0.0, 0.0, 0, findings=[
        {"kind": "straggler", "rank": 7, "step": 10}]),
        _snap(1.0, 5.0, 1.0, 3, findings=[
            {"kind": "straggler", "rank": 7, "step": 10},
            {"kind": "straggler", "rank": 7, "step": 20},
            {"kind": "regression", "rank": 1, "step": 20},
            {"kind": "straggler", "rank": 2, "step": 20}]), None),
    "health_goodput": (
        _snap(0.0, 0.0, 0.0, 1, gp={"enabled": True, "goodput_ratio": 0.9,
                                    "categories": {"straggler_wait": 1.0,
                                                   "productive_compute": 5}}),
        _snap(3.0, 7.0, 0.0, 4, gp={"enabled": True, "goodput_ratio": 0.8,
                                    "categories": {"straggler_wait": 1.75,
                                                   "rendezvous_recovery": 2,
                                                   "productive_compute": 9}}),
        {"world": 8, "counts": {"healthy": 6, "dead": 1, "straggling": 1},
         "health": {"3": {"state": "dead", "why": "beacon_stale",
                          "host": "127.0.0.4"},
                    "5": {"state": "straggling", "why": "watchdog_named",
                          "host": "127.0.0.6"},
                    "0": {"state": "healthy"}}}),
    "idle": (_snap(0.0, 50.0, 5.0, 2), _snap(1.0, 50.0, 5.0, 2), None),
}


@pytest.mark.parametrize("case", sorted(FRAME_CASES))
def test_signal_frames_equal(case):
    prev, cur, view = FRAME_CASES[case]
    got = t_sig.frame(copy.deepcopy(prev), copy.deepcopy(cur),
                      copy.deepcopy(view))
    want = jax_sig.frame(prev, cur, view)
    assert isinstance(got, t_sig.SignalFrame)
    assert dict(got) == dict(want)


# --- the controller ---------------------------------------------------------

class _JaxRT:
    """The knobs the JAX controller steers, on no runtime."""
    _EAGER_STRATEGY = jax_fusion.FusionRuntime._EAGER_STRATEGY
    _sync_eager_policy = jax_fusion.FusionRuntime._sync_eager_policy

    def __init__(self, wire):
        self.threshold, self._cycle_s, self.strategy = 1 << 20, 1e-3, "flat"
        self.wire_dtype = jax_wire.wire_numpy_type(wire)
        self.cross_wire = ""
        self._overlap, self._overlap_mode = True, "step"
        self._overlap_pinned = False
        self._parameter_manager = None

    def wire_name(self):
        import jax.numpy as jnp
        return jnp.dtype(self.wire_dtype).name if self.wire_dtype else ""


class _PortRT:
    def __init__(self, wire):
        self.threshold, self._cycle_s, self.strategy = 1 << 20, 1e-3, "flat"
        self.wire_dtype, self.cross_wire = wire, ""
        self._overlap, self._overlap_mode = True, "step"
        self._overlap_pinned = False
        self._parameter_manager = object()     # detached by the first tune

    def wire_name(self):
        return self.wire_dtype


_MULT = {"torus": 1.4, "torus_qcross": 1.2, "hierarchical": 1.1}


class _Script:
    """Cumulative snapshots of a run the knobs in effect shape: more bytes
    under the better strategy, threshold and cycle; DCN bytes that collapse
    under the quantized cross leg in the ``adopt`` scenario; a wall spike
    on the trial's judge epoch in ``regress``; a drift after it; one idle
    epoch; attribution that turns from comm- to compute-dominant; a dead
    rank and a watchdog straggler for the remediation arm."""

    def __init__(self, scenario):
        self.scenario = scenario
        self.k = 0
        self.bytes = self.dcn = self.flushes = 0.0
        self.recs, self.findings = [], []

    def next(self, rt, judge):
        k = self.k = self.k + 1
        idle = k == 3
        if not idle:
            thr_oct = np.log2(rt.threshold)
            mult = _MULT.get(rt.strategy, 1.0) * (
                1.1 if rt.wire_name() == "bfloat16" else 1.0)
            self.bytes += 1e9 * mult / (1.0 + 0.1 * abs(thr_oct - 23.0)) \
                / (1.0 + 0.05 * rt._cycle_s * 1e3) + 1e6 * (k % 5)
            collapse = self.scenario == "adopt" \
                and rt.strategy == "torus_qcross"
            self.dcn += 2e7 if collapse else 1e8
            self.flushes += 10
            for s in range(4):
                wall = 0.1 + 0.001 * ((k + s) % 3)
                if judge and self.scenario == "regress":
                    wall = 0.5
                if k >= 28:
                    wall = 0.9              # drift after the freeze
                comm = 0.07 if k < 6 else 0.01
                self.recs.append({
                    "epoch": 0, "step": len(self.recs), "t": float(k),
                    "wall_s": wall,
                    "attribution": {"collective": comm, "compute": 0.08 -
                                    comm + 0.01, "fusion": 0.001}})
        if k in (9, 10, 11):
            self.findings.append({"kind": "straggler", "rank": 5,
                                  "step": k})
        snap = {
            "t": float(k), "wall_t": float(k),
            "counters": {"collective_bytes_total": {
                (("op", "allreduce"),): self.bytes},
                "wire_bytes_total": {
                    (("dtype", "float32"), ("tier", "dcn")): self.dcn,
                    (("dtype", "float32"), ("tier", "ici")): 4 * self.dcn}},
            "histograms": {"fusion_flush_bytes": {
                (): (self.flushes, 1e7 * self.flushes)}},
            "last_step_key": (0, self.recs[-1]["step"], self.recs[-1]["t"])
            if self.recs else None,
            "step_records": list(self.recs),
            "findings": list(self.findings), "slo_burn": {},
            "goodput": {"enabled": True, "goodput_ratio": 0.95,
                        "categories": {"autopilot_trial": 0.1 * k}}}
        view = None
        if 8 <= k <= 12:
            view = {"world": 8, "counts": {"healthy": 7, "dead": 1},
                    "health": {"3": {"state": "dead", "why": "beacon_stale",
                                     "host": "127.0.0.4"},
                               "5": {"state": "healthy",
                                     "host": "127.0.0.6"}}}
        return snap, view


SCENARIOS = {"adopt": "", "revert": "", "regress": "",
             "sweep_wire": "bfloat16", "prior": ""}


def _prior(tmp_path):
    from horovod_tpu.sim import autopilot as jax_sim
    res = jax_sim.pretrain(8, 2, bayes_opt_max_samples=3)
    path = tmp_path / "prior.json"
    jax_sim.write_prior(str(path), res)
    return str(path)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controller_decision_trail_equal(scenario, monkeypatch, tmp_path):
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    wire = SCENARIOS[scenario]
    knobs = dict(autopilot=True, autotune_bayes_opt_max_samples=4,
                 autopilot_hysteresis=2, wire_dtype=wire,
                 autopilot_prior=_prior(tmp_path) if scenario == "prior"
                 else "")
    clocks = {p: _Clock() for p in PKGS}
    rts = {"jax": _JaxRT(wire), "port": _PortRT(wire)}
    ctrls = {"jax": jax_ctrl.AutopilotController(JaxConfig(**knobs),
                                                 time_fn=clocks["jax"]),
             "port": t_ctrl.AutopilotController(TConfig(**knobs),
                                                time_fn=clocks["port"])}
    cur = {}
    for p, sig in (("jax", jax_sig), ("port", t_sig)):
        monkeypatch.setattr(sig, "snapshot", lambda: copy.deepcopy(
            cur["snap"]))
        monkeypatch.setattr(sig, "cluster_view", lambda: copy.deepcopy(
            cur["view"]))
        monkeypatch.setattr(ctrls[p], "_runtime", lambda rt=rts[p]: rt)
        monkeypatch.setattr(ctrls[p], "_slices", lambda: 2)
    script = _Script(scenario)
    cur["snap"], cur["view"] = script.next(rts["jax"], False)
    for wire_mod in (jax_wire, t_wire):
        wire_mod.clear_wire_registry()
        wire_mod.clear_strategy_registry()
    trail = {p: [] for p in PKGS}
    try:
        for tick in range(34):
            judge = ctrls["jax"]._cross_trial is not None
            if tick:
                cur["snap"], cur["view"] = script.next(rts["jax"], judge)
            for p in PKGS:
                clocks[p].advance(10.0)
                recs = ctrls[p].tick()
                trail[p] += [{k: v for k, v in r.items() if k != "t"}
                             for r in recs]
            assert trail["port"] == trail["jax"], tick
            state = {p: (rts[p].threshold, rts[p]._cycle_s, rts[p].strategy,
                         rts[p].wire_name(), rts[p]._overlap_mode,
                         rts[p]._overlap_pinned, ctrls[p].frozen,
                         ctrls[p].epoch) for p in PKGS}
            assert state["port"] == state["jax"], tick
            for p, mod in (("jax", jax_wire), ("port", t_wire)):
                state[p] = (mod.wire_dtype_for("global", tier="dcn"),
                            mod.dispatch_strategy_for("global"))
            assert state["port"] == state["jax"], tick
    finally:
        for wire_mod in (jax_wire, t_wire):
            wire_mod.clear_wire_registry()
            wire_mod.clear_strategy_registry()
    outcomes = [(r["lever"], r["outcome"]) for r in trail["port"]]
    assert ("tuner", "frozen") in outcomes and ("tuner", "no_signal") in \
        outcomes and ("remediate", "unreachable") in outcomes
    assert rts["port"]._parameter_manager is None
    levers = {r["lever"] for r in trail["port"]}
    assert "overlap" in levers
    cross = [o for lv, o in outcomes if lv == "cross_wire"]
    want = {"adopt": ["trial", "adopted"], "regress": ["trial", "reverted"],
            "revert": ["trial", "reverted"],
            "sweep_wire": ["trial", "reverted"]}.get(scenario)
    if want is not None:
        assert cross == want, outcomes
    if scenario == "prior":
        assert outcomes[1] == ("tuner", "prior_loaded")
    if scenario == "regress":
        rev = [r for r in trail["port"] if r["outcome"] == "reverted"]
        assert rev[0]["regressed"] is True
    assert ("tuner", "drift_detected") in outcomes


# --- the port's wiring ------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    """A rank contract or knob another test left in this process's env is
    set aside: the world here is one CPU rank."""
    for k in [k for k in os.environ if k.startswith("HOROVOD_")]:
        monkeypatch.delenv(k)
    return monkeypatch


def test_init_arms_the_controller_and_shutdown_stops_it(clean_env):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    clean_env.setenv("HOROVOD_AUTOPILOT", "1")
    clean_env.setenv("HOROVOD_AUTOPILOT_INTERVAL", "300")
    clean_env.setenv("HOROVOD_AUTOTUNE", "1")
    hvd.init(device="cpu")
    try:
        ctrl = t_ctrl.get_controller()
        assert ctrl is not None and ctrl.interval == 300.0
        assert ctrl._thread is not None and ctrl._thread.is_alive()
        # The autopilot tunes the knobs itself: no flush-window tuner.
        assert fusion.get_runtime()._parameter_manager is None
    finally:
        hvd.shutdown()
    assert t_ctrl.get_controller() is None
    assert not ctrl._thread


def test_autotune_alone_builds_the_flush_window_tuner(clean_env):
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import fusion
    clean_env.setenv("HOROVOD_AUTOTUNE", "1")
    clean_env.setenv("HOROVOD_AUTOTUNE_WARMUP_SAMPLES", "0")
    clean_env.setenv("HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE", "1")
    hvd.init(device="cpu")
    try:
        assert t_ctrl.get_controller() is None
        rt = fusion.get_runtime()
        pm = rt._parameter_manager
        assert pm is not None and pm.categoricals == {"strategy": "flat"}
        import torch
        before = rt.threshold
        for i in range(4):
            hvd.allreduce(torch.ones(1024) * i, op=hvd.Average, name=f"t{i}")
        assert pm._samples or pm._cat_warmed is not None
        assert (rt.threshold, rt.strategy) != (before, "flat") or \
            rt._cycle_s != 1e-3
    finally:
        hvd.shutdown()


def test_live_tick_steers_the_runtime(clean_env):
    """Two ticks over the real planes of a one-rank CPU world: a baseline,
    then a scored epoch whose adopt or hold record names the knobs now on
    the runtime (on the scrape and the flight ring too); the manager the
    runtime held is detached."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.flight import analyze, recorder
    from horovod_tpu_torch.metrics import instruments
    from horovod_tpu_torch.ops import fusion
    from horovod_tpu_torch.profile import ledger
    hvd.init(device="cpu")
    try:
        # A record epoch of its own: the ledger keeps the records an
        # earlier test of this process closed, maybe at higher step
        # numbers.
        ledger.reset_window()
        rt = fusion.get_runtime()
        rt._parameter_manager = fusion.build_parameter_manager(
            TConfig(), rt)
        ctrl = t_ctrl.AutopilotController(TConfig(autopilot=True))
        assert [r["outcome"] for r in ctrl.tick()] == ["baseline"]
        hvd.step_marker()
        for i in range(6):
            hvd.allreduce(torch.ones(4096) * i, op=hvd.Average,
                          name=f"s{i}")
            hvd.step_marker()
        recs = [r for r in ctrl.tick() if r["lever"] == "tuner"]
        assert recs and recs[0]["outcome"] in ("adopt", "hold"), recs
        assert recs[0]["threshold"] == rt.threshold
        assert rt._parameter_manager is None
        assert recs[0]["signal"]["steps"] == 6
        text = instruments.REGISTRY.render_text()
        assert 'autopilot_decisions_total{lever="tuner"' in text
        rep = analyze.analyze_autopilot(recorder.get().events())
        assert rep["decisions"], rep
    finally:
        hvd.shutdown()
