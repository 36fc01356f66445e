"""GPT data-parallel training, the port against the JAX package.

JAX: ``parallel/dp.py::make_train_step`` with
``optim.DistributedOptimizer(optax.adamw(LR))`` on a 2-device sub-mesh.
Port: 2 gloo processes, each training its half of the batch through
``hvd.broadcast_parameters`` / ``broadcast_optimizer_state`` and
``hvd.DistributedOptimizer(torch.optim.AdamW(...))`` with optax's defaults
(betas 0.9/0.999, eps 1e-8, weight decay 1e-4). GPT tiny, 2 layers, fp32,
``use_flash=True`` on both sides: inside ``shard_map`` the JAX flash call
takes its plain path and the port's CPU tensors take the plain versions, so
this test holds the trajectory; ``test_torch_flash_attention.py`` holds the
kernels.

Tolerances after 3 steps, fp32:

- the step-1 reduced gradients and both Adam moments within 1e-4 of each
  tensor's largest entry, and each step's mean loss within rtol 1e-5
  (sums in another order; measured ~1e-6);
- parameters, where the step-1 reference gradient is above fp32 noise
  (|g| >= 1e-6 of the tensor's largest), within 1e-3 of the tensor's
  largest movement over the run (measured 1.9e-4, on an MLP weight; the
  movement is about LR * STEPS = 3e-3, so a port that did not step, or
  stepped the other way, is far outside);
- every parameter within atol 2 * LR: Adam's first steps move each element
  by about LR * g / |g|, so an element whose gradient is at fp32 noise
  level can step the other way in the other framework (measured 7.9e-4, on
  the QKV bias: the key bias's gradient is zero in exact arithmetic, since
  the softmax ignores a shift of a query's scores);
- the two ranks' parameters bit-equal (every rank applies the same
  reduced gradient).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models import gpt as jg
from horovod_tpu.optim import DistributedOptimizer
from horovod_tpu.parallel import TrainState, make_train_step
from horovod_tpu_torch.models import GPT, GPTConfig, load_flax_gpt

STEPS, LR, WD = 3, 1e-3, 1e-4
KW = dict(num_layers=2, max_position_embeddings=64, tp_axis=None,
          ep_axis=None, use_flash=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _named(tree):
    """A Flax-shaped tree, named and laid out as the port's parameters."""
    return {n: helpers.to_np(p) for n, p in load_flax_gpt(
        GPT(GPTConfig.tiny(**KW)), tree).named_parameters()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    def draw():
        ids = np.random.default_rng(7).integers(0, 256, (4, 48)).astype(
            np.int32)
        params = _np(jg.GPT(jg.GPTConfig.tiny(**KW)).init(
            jax.random.PRNGKey(0), jnp.asarray(ids[:1])))
        return params["params"], ids
    params, ids = shared(tmp_path_factory, "gpt_dp_slice_data", draw)
    return jg.GPT(jg.GPTConfig.tiny(**KW)), params, ids


def _loss(model, p, ids):
    logits = model.apply({"params": p}, ids)
    return optax.softmax_cross_entropy_with_integer_labels(
        logits[:, :-1].astype(jnp.float32), ids[:, 1:]).mean()


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX reference and the port's world, once for the whole run
    (``torch_shared.shared``)."""
    def compute():
        _, params, ids = data
        port = helpers.run_world_async(helpers.dp_gpt, 2,
                                       args=(params, KW, ids, STEPS, LR, WD))
        return _jax_run(data), port.result()
    return shared(tmp_path_factory, "gpt_dp_slice_runs", compute)


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[0]


def _jax_run(data):
    # The gloo world trains while JAX compiles and runs its reference.
    model, params, ids = data
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    opt = DistributedOptimizer(optax.adamw(LR, weight_decay=WD))
    step = make_train_step(lambda p, b: _loss(model, p, b["ids"]), opt, mesh,
                           donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    # Equal shards: the mean of the ranks' gradients is the full batch's.
    grads = jax.jit(jax.grad(lambda p: _loss(model, p, jnp.asarray(ids))))(
        jparams)
    state = TrainState.create(jparams, opt)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, {"ids": jnp.asarray(ids)})
        losses.append(float(loss))
    get = optax.tree_utils.tree_get
    return {"losses": losses, "grads": _named(_np(grads)),
            "params": _named(_np(state.params)),
            "mu": _named(_np(get(state.opt_state, "mu"))),
            "nu": _named(_np(get(state.opt_state, "nu")))}


@pytest.fixture(scope="module")
def port_run(runs):
    return runs[1]


def _scaled(got, want, name, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("what", ["grads", "mu", "nu"])
def test_reduced_gradients_and_adam_moments_match_jax(jax_run, port_run,
                                                      what):
    ref = jax_run[what]
    for rank in range(2):
        got = port_run[rank][what]
        assert set(got) == set(ref)
        for name in ref:
            _scaled(got[name], ref[name], f"{what} {name}")


def test_params_match_jax(data, jax_run, port_run):
    """Every element within 2 LR, and the elements whose gradient is above
    noise within 1e-3 of how far the parameter moved. A failure lists every
    parameter's worst difference beside its limit, so one that exceeds it
    can be told from a drift of all of them."""
    init, ref, grads = _named(data[1]), jax_run["params"], jax_run["grads"]
    rows, bad = [], []
    for rank in range(2):
        for name in ref:
            diff = np.abs(port_run[rank]["params"][name] - ref[name])
            g = np.abs(grads[name])
            signal = g >= 1e-6 * g.max()
            moved = np.abs(ref[name] - init[name]).max()
            for what, worst, limit in (
                    ("all", diff.max(), 2 * LR),
                    ("above noise", diff[signal].max(initial=0.0),
                     1e-3 * moved)):
                rows.append(f"rank {rank} {name} ({what}): {worst:.3e} of "
                            f"{limit:.3e}")
                if not worst <= limit:
                    bad.append(rows[-1])
    assert not bad, "over the limit: " + "; ".join(bad) + \
        "\nevery parameter:\n" + "\n".join(rows)


def test_step_losses_match_jax(jax_run, port_run):
    mean = np.mean([port_run[r]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, jax_run["losses"], rtol=1e-5)


def test_ranks_hold_identical_params(port_run):
    a, b = (port_run[r]["params"] for r in range(2))
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name
