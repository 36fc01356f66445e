"""The data-parallel slice under Adasum against the JAX package.

JAX: ``parallel/dp.py::make_train_step`` with
``optim.DistributedOptimizer(optax.sgd(0.05, momentum=0.9), op=Adasum)`` on
a 2-device sub-mesh, which combines each gradient tensor with the Adasum
tree in-jit. Port: 2 gloo processes training their halves of the batch
through ``hvd.DistributedOptimizer(torch.optim.SGD(lr=0.05, momentum=0.9),
op=hvd.Adasum)``: the hooks, the fusion runtime's Adasum route (pack, one
all-gather of the bucket, ``reduce_gathered`` with per-tensor coefficients,
unpack). Same model and data as tests/test_torch_dp_slice.py; the starting
weights follow Flax's init rules (see the ``data`` fixture).

Tolerances after 3 steps, in fp32: each step's mean loss within rtol 1e-4,
atol 1e-5, as in the Average slice (measured ~1e-7). Parameters and
momentum within 1e-3 of the tensor's scale (its largest movement from the
initial weights for a parameter, its largest entry for momentum) plus the
Average slice's atol 1e-5, for tensors that barely move (behind BatchNorm
scales that start at zero, their gradients are fp32 noise). Adasum's
coefficient ``1 - dot / (2 |g|^2)`` amplifies the frameworks' fp32
convolution-gradient differences where one rank's gradient is much smaller
than the other's: the stem's momentum reads 4.3e-4 of its largest entry,
every other tensor under 3e-5; the Average slice's element-wise 1e-4/1e-5
fails there. A wrong combine (the average, whole-bucket coefficients)
moves tensors by a tenth or more. The two ranks' parameters and momentum
are bit-equal: every rank runs the same tree on the same gathered bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.models import resnet as jr
from horovod_tpu.ops.collective_ops import Adasum
from horovod_tpu_torch.models import resnet as tr
from test_torch_dp_slice import (ATOL, BATCH, LR, RTOL, STEPS, _params,
                                 jax_trajectory)


@pytest.fixture(scope="module")
def data():
    """The Average slice's model and batch. The weights are drawn with numpy
    into the shapes Flax's init gives (``jax.eval_shape``, which compiles
    nothing: a jitted init costs ~7 s here) by Flax's rules: kernels normal
    with variance 1 / fan-in, BatchNorm scales one but zero in each block's
    last BatchNorm, variances one, biases and means zero."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    model = jr.ResNet(stage_sizes=[1, 1, 1, 1],
                      block_cls=jr.BottleneckResNetBlock, num_classes=10,
                      num_filters=8, dtype=jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x[:1])

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape)
                    / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        last_norm = name == "scale" and path[-2].key == "BatchNorm_2"
        fill = np.ones if name in ("scale", "var") and not last_norm \
            else np.zeros
        return fill(shape, np.float32)
    return model, jax.tree_util.tree_map_with_path(draw, shapes), x, y


def _port_future(data):
    _, variables, x, y = data
    return helpers.run_world_async(helpers.dp_resnet, 2,
                                   args=(variables, x, y, STEPS, LR,
                                         "Adasum"))


def _jax_run(data):
    # The gloo world trains while JAX compiles and runs its reference.
    return jax_trajectory(data, op=Adasum)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX reference and the port's world, once for the whole run
    (``torch_shared.shared``); the world runs while JAX computes."""
    def compute():
        port = _port_future(data)
        return _jax_run(data), port.result()
    return shared(tmp_path_factory, "adasum_dp_slice_runs", compute)


@pytest.fixture(scope="module")
def jax_run(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_run(runs):
    return runs[1]


def _within(got, ref, scale, name):
    err = float(np.abs(got - ref).max(initial=0))
    assert err <= 1e-3 * scale + ATOL, \
        f"{name}: {err} beyond 1e-3 of {scale} + {ATOL}"


@pytest.fixture(scope="module")
def initial(data):
    model, variables, _, _ = data
    template = tr.ResNet([1, 1, 1, 1], tr.BottleneckResNetBlock,
                         num_classes=10, num_filters=8, dtype=torch.float32)
    return _params(helpers.flax_as_torch_named(
        template, variables["params"], variables["batch_stats"]))


def test_params_match_jax(jax_run, port_run, initial):
    ref = _params(jax_run["state"])
    assert set(initial) == set(ref)
    for rank in range(2):
        got = _params(port_run[rank]["state"])
        assert set(got) == set(ref)
        for name in ref:
            moved = float(np.abs(ref[name] - initial[name]).max())
            _within(got[name], ref[name], moved, name)


def test_momentum_matches_jax(jax_run, port_run):
    ref = _params(jax_run["momentum"])
    for rank in range(2):
        got = port_run[rank]["momentum"]
        assert set(got) == set(ref)
        for name in ref:
            _within(got[name], ref[name], float(np.abs(ref[name]).max()),
                    name)


def test_step_losses_match_jax(jax_run, port_run):
    mean = np.mean([port_run[r]["losses"] for r in range(2)], axis=0)
    np.testing.assert_allclose(mean, jax_run["losses"], rtol=RTOL, atol=ATOL)


def test_ranks_hold_identical_params_and_momentum(port_run):
    for key in ("state", "momentum"):
        a, b = (_params(port_run[r][key]) for r in range(2))
        for name in a:
            assert a[name].tobytes() == b[name].tobytes(), (key, name)

