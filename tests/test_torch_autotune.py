"""The port's autotune (``horovod_tpu_torch/autotune/``) held against the
JAX package's on the same numpy inputs: the Gaussian process and the
Bayesian optimizer (bit-equal: both are the same numpy and scipy code),
the categorical sweep space, the ``ParameterManager``'s proposals, clamped
moves and frozen winner for scripted scores, and its prior artifact across
packages. Then the flush-window tuner inside the fusion runtime: a 2-rank
gloo world under ``HOROVOD_AUTOTUNE=1`` whose follower forms process 0's
buckets under process 0's moving threshold, with averages bit-equal to the
same world untuned."""

import json
import os
import sys
import types

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import torch_a17_helpers as A  # noqa: E402
import torch_port_helpers as helpers  # noqa: E402
from torch_shared import shared  # noqa: E402

from horovod_tpu.autotune import bayesian_optimization as jax_bo  # noqa: E402
from horovod_tpu.autotune import gaussian_process as jax_gp  # noqa: E402
from horovod_tpu.autotune import parameter_manager as jax_pm  # noqa: E402
from horovod_tpu_torch.autotune import bayesian_optimization as t_bo  # noqa: E402
from horovod_tpu_torch.autotune import gaussian_process as t_gp  # noqa: E402
from horovod_tpu_torch.autotune import parameter_manager as t_pm  # noqa: E402

WIRES = ("", "int8", "fp8", "bfloat16", "float16")
STRATEGIES = ("flat", "hierarchical", "torus", "torus_qcross")


def _history(seed, n=9, d=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform([20.0, -2.0], [28.0, 5.0], size=(n, d))
    y = np.sin(x[:, 0]) * 1e9 + x[:, 1] * 3e8 + rng.normal(0, 1e7, n)
    return x, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gp_fit_predict_bit_equal(seed):
    x, y = _history(seed)
    test = np.random.default_rng(seed + 100).uniform(
        [20.0, -2.0], [28.0, 5.0], size=(16, 2))
    # The scores as the tuner feeds them (bytes/s, ~1e9) and normalized.
    for scale in (1.0, 1e-9):
        got = t_gp.GaussianProcessRegressor(alpha=0.8).fit(x, y * scale)
        want = jax_gp.GaussianProcessRegressor(alpha=0.8).fit(x, y * scale)
        assert (got.length, got.sigma_f) == (want.length, want.sigma_f)
        for a, b in zip(got.predict(test), want.predict(test)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_bo_next_sample_bit_equal(seed):
    """The same seeded history gives the same candidates, the same EI and
    the same next point, sample after sample."""
    x, y = _history(seed, n=5)
    bounds = [[20.0, 28.0], [-2.0, 5.0]]
    got = t_bo.BayesianOptimization(bounds, alpha=0.8, seed=seed)
    want = jax_bo.BayesianOptimization(bounds, alpha=0.8, seed=seed)
    np.testing.assert_array_equal(got.next_sample(), want.next_sample())
    for xi, yi in zip(x, y):
        got.add_sample(xi, yi)
        want.add_sample(xi, yi)
        np.testing.assert_array_equal(got.next_sample(), want.next_sample())


@pytest.mark.parametrize("has_slices", [False, True])
@pytest.mark.parametrize("wire", WIRES)
def test_sweep_categoricals_equal(wire, has_slices):
    """Every strategy, every wire, with and without slices, with the
    alltoall tier off, on and quantized: the same knob names and choice
    strings (``float8_e4m3fn`` for fp8, as JAX's dtype name)."""
    for strategy in STRATEGIES:
        for a2a in (None, "flat", "hier", "hier_qcross"):
            for a2a_cross in ("", "int8", "fp8", "bfloat16"):
                args = (strategy, wire, has_slices, a2a, a2a_cross)
                assert t_pm.sweep_categoricals(*args) == \
                    jax_pm.sweep_categoricals(*args), args


PM_CASES = {
    "numeric": dict(bayes_opt_max_samples=6),
    "bounded": dict(bayes_opt_max_samples=6, max_move_log2=1.0),
    "frozen_numerics": dict(bayes_opt_max_samples=4, max_move_log2=0),
    "sweep": dict(bayes_opt_max_samples=4, max_move_log2=1.0,
                  categorical_knobs={"strategy": ["flat", "hierarchical",
                                                  "torus"]}),
    "sweep_wire": dict(warmup_samples=2, bayes_opt_max_samples=3,
                       categorical_knobs={
                           "strategy": ["torus", "flat", "torus_qcross"],
                           "wire_dtype": ["int8", "bfloat16", "float16"]}),
}


def _pm(mod, case):
    args = dict(warmup_samples=0, steps_per_sample=1,
                initial_threshold=3 * 1024 * 1024, initial_cycle_ms=1.5)
    args.update(PM_CASES[case])
    return mod.ParameterManager(**args)


def _score(i, knobs):
    """A scripted score that depends on the knobs in effect (so the
    winner is earned) with a little deterministic noise, and a few
    non-finite epochs the tuner must clamp."""
    thr, cyc, cats = knobs
    if i in (2, 7):
        return float("nan") if i == 2 else float("inf")
    bonus = {"torus": 1.3, "hierarchical": 1.1}.get(cats.get("strategy"), 1.0)
    wire = {"bfloat16": 1.2}.get(cats.get("wire_dtype"), 1.0)
    return 1e9 * bonus * wire / (1.0 + abs(np.log2(thr) - 24.0)) \
        / (1.0 + cyc) + 1e6 * np.sin(i)


@pytest.mark.parametrize("case", sorted(PM_CASES))
def test_parameter_manager_observe_trajectory_equal(case):
    """Fed the same scores, both managers propose the same knobs at every
    sample, clamp the same moves and freeze the same winner."""
    got, want = _pm(t_pm, case), _pm(jax_pm, case)
    max_move = PM_CASES[case].get("max_move_log2")
    prev = None
    for i in range(60):
        k = got.suggest()
        assert k == want.suggest(), (i, k)
        if max_move is not None and prev is not None and got._cat_done:
            moved = np.abs(np.log2(k[:2]) - np.log2(prev[:2]))
            assert np.all(moved <= max_move + 1e-5), (i, prev, k)
        prev = k
        out = got.observe(_score(i, k))
        assert out == want.observe(_score(i, k)), i
        if not want.tuning:
            break
    assert not got.tuning and not want.tuning
    assert got.suggest() == want.suggest()
    assert got.export_observations() == want.export_observations()


def test_parameter_manager_record_windows_equal(monkeypatch):
    """The flush path: ``record`` windows closed on the same fake clock
    (steps_per_sample flushes a window, bytes over elapsed) give the same
    knobs, the invalidated windows included."""
    clocks = {}
    for mod in (t_pm, jax_pm):
        c = clocks[mod] = [0.0]
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            perf_counter=lambda c=c: c[0]))
    mgrs = {mod: mod.ParameterManager(
        warmup_samples=1, steps_per_sample=3, bayes_opt_max_samples=4,
        initial_threshold=64 << 20, initial_cycle_ms=1.0,
        categorical_knobs={"strategy": ["flat", "torus"]})
        for mod in (t_pm, jax_pm)}
    rng = np.random.default_rng(5)
    for i in range(120):
        nbytes, dt = int(rng.integers(1 << 20, 8 << 20)), rng.uniform(1e-3,
                                                                      5e-3)
        outs = []
        for mod, pm in mgrs.items():
            clocks[mod][0] += dt
            if i % 11 == 4:
                pm.invalidate_window()
            outs.append(pm.record(nbytes))
        assert outs[0] == outs[1], i
    assert not mgrs[t_pm].tuning and not mgrs[jax_pm].tuning
    assert mgrs[t_pm].suggest() == mgrs[jax_pm].suggest()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_prior_crosses_packages(direction, tmp_path):
    """A prior exported by one package's manager (through a JSON file, as
    HOROVOD_AUTOPILOT_PRIOR carries it) imports into the other's, which
    then proposes what the exporter's own re-import proposes; a prior of
    another sweep space is refused by both."""
    src, dst = (jax_pm, t_pm) if direction == "jax_to_port" \
        else (t_pm, jax_pm)
    case = "sweep_wire"
    exporter = _pm(src, case)
    for i in range(40):
        exporter.observe(_score(i, exporter.suggest()))
        if not exporter.tuning:
            break
    path = tmp_path / "prior.json"
    path.write_text(json.dumps(exporter.export_observations()))
    data = json.loads(path.read_text())
    got, want = _pm(dst, case), _pm(src, case)
    assert got.import_observations(data) == want.import_observations(data)
    assert got.suggest() == want.suggest()
    assert got._cat_done and got.categoricals == exporter.categoricals
    for i in range(8):
        assert got.observe(_score(i, got.suggest())) == \
            want.observe(_score(i, want.suggest()))
    other = dst.ParameterManager(categorical_knobs={"strategy": ["flat",
                                                                 "torus"]})
    with pytest.raises(ValueError, match="categorical space"):
        other.import_observations(data)


# --- the flush-window tuner in the fusion runtime ---------------------------

ROUNDS = 8
TUNE_ENV = {"HOROVOD_FUSION_THRESHOLD": str(1 << 20),
            "HOROVOD_CYCLE_TIME": "0"}
TUNED_ENV = dict(TUNE_ENV, HOROVOD_AUTOTUNE="1",
                 HOROVOD_AUTOTUNE_WARMUP_SAMPLES="0",
                 HOROVOD_AUTOTUNE_STEPS_PER_SAMPLE="1",
                 HOROVOD_AUTOTUNE_BAYES_OPT_MAX_SAMPLES="4")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    def compute():
        tuned = helpers.run_world_async(A.autotune_world, 2,
                                        args=(ROUNDS, 11), env=TUNED_ENV)
        plain = helpers.run_world(A.autotune_world, 2, args=(ROUNDS, 11),
                                  env=TUNE_ENV)
        return tuned.result(), plain
    return shared(tmp_path_factory, "autotune_worlds", compute)


def test_tuner_on_process_zero_only(worlds):
    tuned, plain = worlds
    assert [r["tuner"] for r in tuned] == [True, False]
    assert [r["tuner"] for r in plain] == [False, False]


def test_follower_forms_process_zeros_buckets(worlds):
    """The threshold moves (and the strategy sweeps) on process 0; the
    follower cuts every published prefix at process 0's threshold and on
    its strategy, so both processes form the same buckets, among them
    buckets of several tensors past the configured 1 MB that only a
    raised threshold closes."""
    tuned, plain = worlds
    assert tuned[0]["buckets"] == tuned[1]["buckets"]
    assert len({s for _, s, _ in tuned[0]["buckets"]}) > 1
    assert any(len(n) > 1 and 4 * sum(n) > 1 << 20
               for _, _, n in tuned[0]["buckets"])
    assert not any(len(n) > 1 and 4 * sum(n) > 1 << 20
                   for _, _, n in plain[0]["buckets"])
    assert set(plain[0]["thresholds"]) == {1 << 20}
    assert len(tuned[0]["buckets"]) < len(plain[0]["buckets"])


def test_tuned_averages_bit_equal_to_untuned(worlds):
    tuned, plain = worlds
    for rank in range(2):
        for rt, rp in zip(tuned[rank]["vals"], plain[rank]["vals"]):
            for a, b in zip(rt, rp):
                np.testing.assert_array_equal(a, b)
