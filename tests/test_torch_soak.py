"""The port's soaks (``horovod_tpu_torch/chaos/soak.py``,
``horovod_tpu_torch/serving/soak.py``): their plans, kill budgets and
prompt sets equal the JAX package's; the serving soak's clean
single-process streams equal JAX's for the same weights (the port's
engine over JAX's soak model, loaded with ``load_flax``). The soaks
themselves run the port's elastic launcher with 8 CPU (gloo) workers, at
JAX's own sizes, and are marked ``slow`` as ``tests/test_chaos_soak.py``
and ``tests/test_serving_soak.py`` mark theirs::

    pytest tests/test_torch_soak.py -m slow
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from torch_shared import shared  # noqa: E402

from horovod_tpu.chaos import soak as jax_soak  # noqa: E402
from horovod_tpu.serving import soak as jax_ssoak  # noqa: E402
from horovod_tpu_torch.chaos import soak as t_soak  # noqa: E402
from horovod_tpu_torch.serving import soak as t_ssoak  # noqa: E402


@pytest.mark.parametrize("procs", [3, 4, 8, 16])
def test_chaos_plans_equal(procs):
    for seed in (123, 777):
        for kw in ({}, {"kill_step": 5, "straggler_rank": 1},
                   {"kill_rank": 0, "drop_step": 2}):
            plan = t_soak.default_plan(procs=procs, seed=seed, **kw)
            assert plan == jax_soak.default_plan(procs=procs, seed=seed,
                                                 **kw)
            assert t_soak.plan_kill_budget(plan) == \
                jax_soak.plan_kill_budget(plan)
        assert t_soak.autopilot_straggler_plan(procs, seed, delay_ms=90) == \
            jax_soak.autopilot_straggler_plan(procs, seed, delay_ms=90)
        for slices in (1, 2, 4):
            assert t_soak.leader_kill_plan(procs, slices, seed) == \
                jax_soak.leader_kill_plan(procs, slices, seed)
        if procs > 3:
            args = (procs, seed, 2 * procs)
            assert t_soak.goodput_badput_plan(*args) == \
                jax_soak.goodput_badput_plan(*args)
        assert t_ssoak.rolling_kill_plan(procs, seed) == \
            jax_ssoak.rolling_kill_plan(procs, seed)


def test_kill_budget_counts_every_fatal_kind():
    plan = {"faults": [
        {"kind": "crash", "max_fires": 2},
        {"kind": "hang", "at_step": [1, 4, 9]},
        {"kind": "host_remove", "at": [3]},
        {"kind": "delay", "at_step": [1, 2]},
        {"kind": "crash"}]}
    assert t_soak.plan_kill_budget(plan) == \
        jax_soak.plan_kill_budget(plan) == 7


def test_prompts_equal():
    for n, vocab, seed in ((10, 256, 5), (32, 50304, 9)):
        assert t_ssoak.soak_prompts(n, vocab, seed) == \
            jax_ssoak.soak_prompts(n, vocab, seed)


def test_discovery_lists_one_loopback_host_a_slot(tmp_path):
    path = tmp_path / "discover.sh"
    hosts = t_soak._write_discovery(str(path), 4)
    assert hosts == ["localhost", "127.0.0.2", "127.0.0.3", "127.0.0.4"]
    assert path.read_text().splitlines()[1:] == [f"echo {h}:1"
                                                 for h in hosts]
    assert os.access(path, os.X_OK)


N_REQUESTS, MAX_NEW = 4, 5


@pytest.fixture(scope="module")
def jax_streams(tmp_path_factory):
    def compute():
        import jax
        _, params, _ = jax_ssoak.soak_model()
        return (jax_ssoak.expected_streams(N_REQUESTS, MAX_NEW),
                jax.tree_util.tree_map(np.asarray, params))
    return shared(tmp_path_factory, "soak_jax_streams", compute)


def test_expected_streams_equal(jax_streams, monkeypatch):
    """The clean run every soak worker is held to: the port's engine over
    JAX's soak model (its Flax init loaded into the port's tiny GPT) makes
    JAX's token streams."""
    from horovod_tpu_torch.models import load_flax
    want, params = jax_streams
    model, cfg = t_ssoak.soak_model()
    load_flax(model, params)
    monkeypatch.setattr(t_ssoak, "soak_model", lambda: (model.eval(), cfg))
    assert t_ssoak.expected_streams(N_REQUESTS, MAX_NEW) == want


def test_soak_model_is_seeded():
    import torch
    (a, _), (b, _) = t_ssoak.soak_model(), t_ssoak.soak_model()
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert t_ssoak.expected_streams(2, 3) == t_ssoak.expected_streams(2, 3)


def test_worker_usage_error_exits_two(capsys):
    assert t_soak.main(["--nope"]) == 2
    assert "usage" in capsys.readouterr().err


# --- the soaks, at JAX's sizes (slow) -------------------------------------

@pytest.mark.slow
@pytest.mark.timeout(1500)
def test_eight_process_kill_drop_straggler_soak(tmp_path):
    evidence = t_soak.run_soak(procs=8, steps=8, seed=123,
                               workdir=str(tmp_path), reruns=1)
    assert evidence["ledger_deterministic"]
    assert evidence["kill_budget"] == 1
    assert all(r["final_world"] == 7 for r in evidence["chaos_results"])
    assert any(r["kv_retries"] >= 1 for r in evidence["chaos_results"])
    flight = evidence["flight_report"]
    kill_rank = evidence["plan"]["faults"][0]["rank"]
    assert flight["killed_ranks"] == [kill_rank]
    assert flight["cause"]["site"] == "elastic.commit"


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_slice_leader_kill_reelects_and_names_the_dead(tmp_path):
    evidence = t_soak.run_leader_kill_soak(procs=8, slices=2, steps=8,
                                           workdir=str(tmp_path))
    view = evidence["view"]
    assert evidence["victim"] == 4
    assert view["world"] == 7 and view["num_slices"] == 2
    assert view["slices"]["1"]["leader"] is not None
    assert any(e.get("host") == evidence["victim_host"]
               and e.get("to") == "dead" for e in view["events"])


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_controller_removes_the_permanent_straggler(tmp_path):
    evidence = t_soak.run_autopilot_soak(procs=8, steps=56,
                                         workdir=str(tmp_path))
    assert evidence["victim"] == 7
    rem = evidence["remediations"][0]
    assert rem["rank"] == 7 and rem["cause"] == "straggler"
    assert rem["host"] == evidence["victim_host"] == "127.0.0.8"
    assert all(r["worlds"][-1] == 7 for r in evidence["results"])


@pytest.mark.slow
@pytest.mark.timeout(1200)
def test_goodput_decomposition_conserves_and_brackets_badput(tmp_path):
    evidence = t_soak.run_goodput_soak(procs=8, steps=32,
                                       workdir=str(tmp_path))
    assert evidence["straggler_rank"] == 2 and evidence["kill_rank"] == 5
    assert evidence["injected_s"] >= 1.0
    assert "victim: rank 2" in evidence["report"]
    for r in evidence["results"]:
        assert r["goodput"]["conservation_error"] <= 0.01, r["goodput"]


@pytest.mark.slow
@pytest.mark.timeout(900)
def test_rolling_kills_drop_zero_requests(tmp_path):
    evidence = t_ssoak.run_serving_soak(procs=8, workdir=str(tmp_path))
    assert evidence["victims"] == [5, 2]
    assert evidence["kill_budget"] == 2
    for r in evidence["results"]:
        assert r["streams"] == evidence["expected"]
        assert r["final_world"] == 6
    flight = evidence["flight_report"]
    assert sorted(flight["killed_ranks"]) == [2, 5]
