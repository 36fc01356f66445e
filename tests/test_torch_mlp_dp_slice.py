"""The MNIST-scale MLP trained data-parallel, the port against the JAX
package: the oracle of ``hvd.DistributedOptimizer`` against
``optim/optimizer.py::DistributedOptimizer``.

JAX: ``parallel/dp.py::make_train_step`` with
``optim.DistributedOptimizer(optax.sgd(0.05, momentum=0.9))`` on a
2-device sub-mesh. Port: 2 gloo processes, each training its half of the
batch through ``hvd.broadcast_parameters`` / ``broadcast_optimizer_state``
and ``hvd.DistributedOptimizer(torch.optim.SGD(lr=0.05, momentum=0.9))``.
``models/mlp.py``'s MLP (784 -> 128 -> 64 -> 10) on 16 synthetic 28 x 28
inputs made with numpy (no MNIST download); the weights drawn with numpy
into ``jax.eval_shape``'s tree.

Tolerances after 5 steps, in fp32: parameters, momentum and each step's
mean loss within rtol 1e-4, atol 1e-5, as in the ResNet slice (products
summed in another order; measured ~1e-7). The two ranks' parameters are
bit-equal: every rank applies the same reduced gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models import mlp as jm
from horovod_tpu.optim import DistributedOptimizer
from horovod_tpu.parallel import TrainState, make_train_step
from horovod_tpu_torch.models import MLP, load_flax_mlp
from test_torch_bert import draw_params

STEPS, LR, BATCH = 5, 0.05, 16
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((BATCH, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    model = jm.MLP()
    return model, draw_params(model, x[:1], seed=10), x, y


def _port_future(data):
    _, params, x, y = data
    return helpers.run_world_async(helpers.dp_mlp, 2,
                                   args=(params, x, y, STEPS, LR))


def _named(tree):
    return {n: helpers.to_np(p) for n, p in load_flax_mlp(
        MLP(), jax.tree_util.tree_map(np.asarray, tree)).named_parameters()}


def _jax_run(data):
    # The gloo world trains while JAX compiles and runs its reference.
    model, params, x, y = data
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    opt = DistributedOptimizer(optax.sgd(LR, momentum=0.9))

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b["x"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, b["y"]).mean()

    step = make_train_step(loss_fn, opt, mesh, donate=False)
    state = TrainState.create(jax.tree_util.tree_map(jnp.asarray, params),
                              opt)
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        losses.append(float(loss))
    return {"losses": losses, "params": _named(state.params),
            "momentum": _named(optax.tree_utils.tree_get(state.opt_state,
                                                         "trace"))}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX reference and the port's world, once for the whole run
    (``torch_shared.shared``); the world runs while JAX computes."""
    def compute():
        port = _port_future(data)
        return _jax_run(data), port.result()
    return shared(tmp_path_factory, "mlp_dp_slice_runs", compute)


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_run(runs):
    return runs[1]


@pytest.mark.parametrize("what", ["params", "momentum"])
def test_params_and_momentum_match_jax(jax_run, port_run, what):
    ref = jax_run[what]
    assert len(ref) == 6
    for rank in range(2):
        got = port_run[rank][what]
        assert set(got) == set(ref)
        for name in ref:
            np.testing.assert_allclose(got[name], ref[name], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} {name}")


def test_step_losses_match_jax(jax_run, port_run):
    mean = np.mean([port_run[r]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, jax_run["losses"], rtol=RTOL, atol=ATOL)
    assert mean[-1] < mean[0]


def test_ranks_hold_identical_params(port_run):
    a, b = (port_run[r]["params"] for r in range(2))
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name
