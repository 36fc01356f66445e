"""The whole data-parallel slice against the JAX package.

JAX: ``parallel/dp.py::make_train_step`` with
``optim.DistributedOptimizer(optax.sgd(0.05, momentum=0.9))`` on a 2-device
sub-mesh, BatchNorm statistics carried as ``has_aux`` extra. Port: 2 gloo
processes, each training its half of the batch through
``hvd.broadcast_parameters`` / ``broadcast_optimizer_state`` and
``hvd.DistributedOptimizer(torch.optim.SGD(lr=0.05, momentum=0.9))`` — the
hooks, the fusion runtime and its pack/allreduce/unpack path.

Tolerances after 3 steps, in fp32: parameters, momentum, each step's mean
loss and the running statistics within rtol 1e-4, atol 1e-5 (convolution
summation order differs); the two ranks' parameters bit-equal, since every
rank applies the same reduced gradient. The batch is 64x64 images, 8 per
rank: with 4 images of 32x32 a rank's last stage is a 1x1 BatchNorm over 4
values, whose fp32 gradients are ill-conditioned enough that the two
frameworks drift apart by more than that within three steps.
The port keeps per-rank running statistics; averaged over the ranks they
equal JAX's pmean'd ``extra``, since the update is linear.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import torch_port_helpers as helpers
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models import resnet as jr
from horovod_tpu.ops.collective_ops import Average
from horovod_tpu.optim import DistributedOptimizer
from horovod_tpu.parallel import TrainState, make_train_step
from horovod_tpu_torch.models import resnet as tr

STEPS, LR, BATCH = 3, 0.05, 16
RTOL, ATOL = 1e-4, 1e-5


def _close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    model = jr.ResNet(stage_sizes=[1, 1, 1, 1],
                      block_cls=jr.BottleneckResNetBlock, num_classes=10,
                      num_filters=8, dtype=jnp.float32)
    # Jitted: Flax's eager init of even this ResNet takes ~30 s on the CPU.
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x[:1]))
    return model, variables, x, y


def jax_trajectory(data, op=Average):
    """``STEPS`` steps of ``make_train_step`` on a 2-device sub-mesh with
    ``DistributedOptimizer(optax.sgd(LR, momentum=0.9), op=op)``: the losses,
    and the parameters and momentum named as the port's ``state_dict()``."""
    model, variables, x, y = data
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    opt = DistributedOptimizer(optax.sgd(LR, momentum=0.9), op=op)

    def loss_fn(params, batch, extra):
        logits, upd = model.apply({"params": params, "batch_stats": extra},
                                  batch["x"], mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, batch["y"]).mean()
        return loss, upd["batch_stats"]

    step = make_train_step(loss_fn, opt, mesh, has_aux=True, donate=False)
    state = TrainState.create(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), opt,
        extra=jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"]))
    # Replicated on the mesh, as the step returns it: a state on one device
    # would make the second step compile again (~6 s).
    state = jax.device_put(state, NamedSharding(mesh, PartitionSpec()))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        losses.append(float(loss))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    template = tr.ResNet([1, 1, 1, 1], tr.BottleneckResNetBlock,
                         num_classes=10, num_filters=8, dtype=torch.float32)
    stats = to_np(state.extra)
    return {
        "losses": losses,
        "state": helpers.flax_as_torch_named(template, to_np(state.params),
                                             stats),
        "momentum": helpers.flax_as_torch_named(
            template, to_np(optax.tree_utils.tree_get(state.opt_state,
                                                      "trace")), stats),
    }


@pytest.fixture(scope="module")
def port_future(data):
    _, variables, x, y = data
    return helpers.run_world_async(helpers.dp_resnet, 2,
                                   args=(variables, x, y, STEPS, LR))


@pytest.fixture(scope="module")
def jax_run(data, port_future):
    # The gloo world trains while JAX compiles and runs its reference.
    return jax_trajectory(data)


@pytest.fixture(scope="module")
def port_run(port_future):
    return port_future.result()


def _params(named):
    return {k: v for k, v in named.items() if "running_" not in k}


def test_params_match_jax(jax_run, port_run):
    ref = _params(jax_run["state"])
    for rank in range(2):
        got = _params(port_run[rank]["state"])
        assert set(got) == set(ref)
        for name in ref:
            _close(got[name], ref[name], name)


def test_ranks_hold_identical_params(port_run):
    a, b = (_params(port_run[r]["state"]) for r in range(2))
    for name in a:
        assert a[name].tobytes() == b[name].tobytes(), name


def test_momentum_matches_jax(jax_run, port_run):
    ref = _params(jax_run["momentum"])
    for rank in range(2):
        got = port_run[rank]["momentum"]
        assert set(got) == set(ref)
        for name in ref:
            _close(got[name], ref[name], name)


def test_step_losses_match_jax(jax_run, port_run):
    mean = np.mean([port_run[r]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, jax_run["losses"], rtol=RTOL, atol=ATOL)


def test_rank_averaged_running_stats_match_jax(jax_run, port_run):
    stats = [k for k in jax_run["state"] if "running_" in k]
    assert stats
    for name in stats:
        mean = np.mean([port_run[r]["state"][name] for r in range(2)],
                       axis=0)
        _close(mean, jax_run["state"][name], name)
