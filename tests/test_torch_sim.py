"""The port's scale twin (``horovod_tpu_torch/sim/``) held against the JAX
package's: the discrete-event simulator's trails, the control-plane
exchange, ``TwinJob`` under chaos plans (the same report, trail and
membership), the private ``collective_step_tiers`` against
``analysis/cost.py``'s, and ``pretrain``'s prior with the four
``HOROVOD_PEAK_*`` overrides on both sides (byte-equal JSON). Then the
``python -m horovod_tpu_torch.sim`` battery and ``--pretrain`` run
in-process."""

import importlib
import json

import pytest

from horovod_tpu.analysis import cost as jax_cost
from horovod_tpu.sim import autopilot as jax_sap
from horovod_tpu.sim import control as jax_ctl
from horovod_tpu.sim import core as jax_core
from horovod_tpu_torch.sim import autopilot as t_sap
from horovod_tpu_torch.sim import control as t_ctl
from horovod_tpu_torch.sim import core as t_core

# ``chaos.plan`` is also a function of each package: import the modules.
jax_plan = importlib.import_module("horovod_tpu.chaos.plan")
t_plan = importlib.import_module("horovod_tpu_torch.chaos.plan")


def _program(core, me, n):
    """A rank's program: publish, read two peers (one key late), sleep,
    and a get that times out."""
    yield ("put", f"k/{me}", f"v{me}" * (me + 1), me % 2 == 1)
    got = []
    for p in ((me + 1) % n, (me + 3) % n):
        got.append((yield ("get", f"k/{p}", p % 2 == 0, 1.0)))
    yield ("advance", 0.001 * me)
    try:
        got.append((yield ("get", "never", False, 0.5)))
    except core.SimTimeout:
        got.append("timeout")
    return got


@pytest.mark.parametrize("n", [3, 17])
def test_simulator_trail_and_results_equal(n):
    runs = []
    for core in (t_core, jax_core, t_core):
        sim = core.Simulator(latency=core.LatencyModel(kv_us=3.0,
                                                       dcn_us=40.0,
                                                       gbps=0.5),
                             record_trail=True)
        sim.kv_hook = (lambda r, op, key: (0.002 if r == 1 else 0.0,
                                           r == n - 1 and op == "get"))
        for me in range(n):
            sim.spawn(me, _program(core, me, n))
        sim.run()
        runs.append((sim.trail, sim.results, sim.finish_t,
                     sorted(sim.killed), sim.stats))
    assert runs[0] == runs[2], "the port's simulator is deterministic"
    assert runs[0] == runs[1]


def test_latency_model_env_knobs_equal(monkeypatch):
    monkeypatch.setenv("HOROVOD_SIM_KV_US", "7.5")
    monkeypatch.setenv("HOROVOD_SIM_DCN_US", "90")
    a, b = t_core.LatencyModel.from_env(), jax_core.LatencyModel.from_env()
    assert (a.kv_us, a.dcn_us, a.gbps) == (b.kv_us, b.dcn_us, b.gbps)
    assert a.seconds(True, 1234) == b.seconds(True, 1234)


@pytest.mark.parametrize("world,slices,strategy", [
    (128, 8, "hier"), (96, 4, "hier"), (64, 1, "flat"), (40, 8, "flat")])
def test_twin_exchange_equal(world, slices, strategy):
    got = t_ctl.twin_exchange(world, slices, rounds=2, strategy=strategy,
                              record_trail=True)
    want = jax_ctl.twin_exchange(world, slices, rounds=2, strategy=strategy,
                                 record_trail=True)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


PLANS = {
    "kv_and_crash": (256, 8, 4, {"seed": 7, "faults": [
        {"site": "http_kv.request", "kind": "delay", "p": 0.02,
         "delay_ms": 25},
        {"site": "negotiation.exchange", "kind": "crash", "rank": 37,
         "at": [1], "max_fires": 1}]}),
    "crash_until_removed": (255, 8, 5, {"seed": 3, "faults": [
        {"site": "negotiation.exchange", "kind": "crash", "rank": 100,
         "at": [1], "max_fires": 1}]}),
    "straggle_hang_drop": (96, 4, 4, {"seed": 11, "faults": [
        {"site": "negotiation.exchange", "kind": "delay", "rank": 9,
         "delay_ms": 400, "every": 1},
        {"site": "negotiation.exchange", "kind": "hang", "rank": 50,
         "at": [2], "hang_s": 60.0, "max_fires": 1},
        {"site": "http_kv.request", "kind": "drop", "p": 0.01}]}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_twin_job_equal(case):
    world, slices, rounds, plan = PLANS[case]
    got = t_ctl.TwinJob(world, slices, rounds=rounds, hysteresis=2,
                        plan=t_plan.ChaosPlan.from_dict(plan),
                        record_trail=True).run()
    want = jax_ctl.TwinJob(world, slices, rounds=rounds, hysteresis=2,
                           plan=jax_plan.ChaosPlan.from_dict(plan),
                           record_trail=True).run()
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["chaos_fires"] and got["dead"]


def test_flat_reference_and_cap_equal():
    assert t_ctl.FLAT_WORLD_CAP == jax_ctl.FLAT_WORLD_CAP
    assert t_ctl.flat_reference(300, 2) == jax_ctl.flat_reference(300, 2)
    with pytest.raises(ValueError, match="exchange_plan"):
        t_ctl.twin_exchange(t_ctl.FLAT_WORLD_CAP + 1, 1)


@pytest.mark.parametrize("strategy", ["flat", "hierarchical", "torus",
                                      "torus_qcross"])
def test_collective_step_tiers_equal(strategy):
    """The twin's private copy against ``analysis/cost.py``'s."""
    for elems, world, slices, width, cross in (
            (1 << 20, 8, 2, 4, ""), (123_457, 16, 4, 2, "bfloat16"),
            (5000, 6, 3, 4, "int8"), (1 << 18, 8, 1, 4, ""),
            (777, 12, 5, 2, "")):
        got = t_sap.collective_step_tiers(elems, world, slices,
                                          strategy=strategy, width=width,
                                          cross_wire=cross)
        want = jax_cost.collective_step_tiers(elems, world, slices,
                                              strategy=strategy,
                                              width=width, cross_wire=cross)
        assert got == want, (elems, world, slices, width, cross)


PEAKS = {"HOROVOD_PEAK_TFLOPS": "989", "HOROVOD_PEAK_HBM_GBS": "3350",
         "HOROVOD_PEAK_ICI_GBS": "450", "HOROVOD_PEAK_DCN_GBS": "0.05"}


@pytest.mark.parametrize("world,slices,strategy", [
    (8, 2, "flat"), (16, 4, "torus"), (1, 1, "flat")])
def test_pretrain_prior_equal(world, slices, strategy, monkeypatch,
                              tmp_path):
    for k, v in PEAKS.items():
        monkeypatch.setenv(k, v)
    got = t_sap.pretrain(world, slices, strategy=strategy,
                         bayes_opt_max_samples=4)
    want = jax_sap.pretrain(world, slices, strategy=strategy,
                            bayes_opt_max_samples=4)
    assert got["frozen"] and want["frozen"]
    for k in ("epochs", "winner", "history"):
        assert got[k] == want[k], k
    paths = []
    for mod, name in ((t_sap, "port"), (jax_sap, "jax")):
        paths.append(tmp_path / f"{name}.json")
        mod.write_prior(str(paths[-1]), got if name == "port" else want)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_battery_exits_zero_in_process(capsys):
    from horovod_tpu_torch.sim.__main__ import main
    assert main([]) == 0
    out = capsys.readouterr().out
    assert out.count("ok: ") == 4 and "FAIL" not in out


def test_pretrain_entrypoint_writes_a_prior_the_controller_loads(tmp_path):
    """``--pretrain`` at a one-card layout, priced at the H100 row, writes
    the prior a live manager of the same space imports; a usage error
    exits 2."""
    from horovod_tpu_torch.autotune import (ParameterManager,
                                            sweep_categoricals)
    from horovod_tpu_torch.sim.__main__ import main
    path = tmp_path / "prior.json"
    assert main(["--pretrain", str(path), "--world", "1", "--slices", "1",
                 "--chip", "h100"]) == 0
    pm = ParameterManager(warmup_samples=0, steps_per_sample=1,
                          max_move_log2=1.0, categorical_knobs=(
                              sweep_categoricals("flat", "", False)))
    assert pm.import_observations(json.loads(path.read_text())) > 0
    assert pm._cat_done
    assert main(["--no-such-flag"]) == 2
