"""Synchronized BatchNorm in the port against ``torch.nn.BatchNorm2d`` on
the global batch and against the JAX package.

- ``hvd.SyncBatchNorm`` (``torch/sync_batch_norm.py``) in a 2-rank gloo
  world against ``BatchNorm2d`` on the two ranks' batches concatenated,
  with equal and with unequal per-rank batches: outputs, input gradients,
  the sum of the ranks' weight and bias gradients (each rank's are its own
  batch's, reduced later by the optimizer) and the running statistics
  (both ranks hold the global ones). rtol 1e-4, atol 1e-5: the port's
  one-pass variance E[x²] − E[x]² against BatchNorm2d's two-pass one.
- At one rank, the cases of the JAX package's
  ``tests/test_torch.py::TestTorchSyncBatchNorm`` against
  ``horovod_tpu.torch.SyncBatchNorm``: rtol 1e-5, atol 1e-5 (the port
  weights the moments by the count, and sums in another order: the bias
  gradient of ``square().sum()`` is a sum of 30 terms of size ~2 whose
  exact value is 0, so both sides read rounding noise of ~1e-6..1e-5).
- The model-side ``ops.sync_batch_norm.SyncBatchNorm`` (Flax semantics,
  NCHW) in a 2-rank world against ``horovod_tpu.ops.sync_batch_norm.
  SyncBatchNorm`` under ``shard_map`` over 2 CPU devices (NHWC, transposed
  here), gradients through ``jax.grad`` with ``check_vma=False`` as
  ``make_train_step`` takes them: outputs, gradients and the running
  statistics within rtol 1e-5, atol 1e-6.
- A small ResNet (one bottleneck block a stage, width 8, 64x64 images)
  with every BatchNorm synchronized, trained 2 steps by 2 gloo ranks
  through ``hvd.DistributedOptimizer(SGD)``, against the JAX ResNet with
  ``sync_batch_norm_axis`` through ``make_train_step`` over 2 devices, the
  weights carried by ``load_flax_variables`` (Flax's init, whose last
  BatchNorm of each block starts at zero scale, as in
  ``test_torch_dp_slice.py``): parameters, momentum, the losses and the
  running statistics within rtol 1e-4, atol 1e-5; every rank holds the
  same parameters and running statistics, bit for bit. (Drawn weights with
  every scale near 1 make this 8-image-a-rank net ill-conditioned: the
  per-rank gradients then agree only to ~5e-3 relative.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_port_helpers as helpers
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.models import resnet as jr
from horovod_tpu.ops.sync_batch_norm import SyncBatchNorm as JaxSyncBN
from horovod_tpu.optim import DistributedOptimizer
from horovod_tpu.parallel import TrainState, make_train_step
from horovod_tpu_torch.common.process_sets import global_process_set
from horovod_tpu_torch.models import resnet as tr

C = 6


def _bn_case(seed, batches, shape=(5, 4)):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((b, C) + shape) * 2.0 + 0.5).astype(
        np.float32) for b in batches]
    ws = [rng.standard_normal(x.shape).astype(np.float32) for x in xs]
    scale = (1.0 + 0.2 * rng.standard_normal(C)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return xs, ws, scale, bias


FRONTEND = {"equal": _bn_case(1, (3, 3)), "unequal": _bn_case(2, (2, 5))}
MODEL = {"model": _bn_case(3, (4, 4))}


def _cases_inputs():
    rng = np.random.default_rng(4)
    return {"forward": rng.standard_normal((8, 4, 3)).astype(np.float32),
            "backward": rng.standard_normal((6, 3, 5)).astype(np.float32),
            "eval": rng.standard_normal((16, 2)).astype(np.float32),
            "cumulative": [rng.standard_normal((10, 3)).astype(np.float32)
                           for _ in range(3)],
            "no_running_stats": rng.standard_normal((12, 2)).astype(
                np.float32)}


STEPS, LR, BATCH = 2, 0.05, 16


@pytest.fixture(scope="module")
def resnet_data():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 10, BATCH).astype(np.int32)
    model = jr.ResNet(stage_sizes=[1, 1, 1, 1],
                      block_cls=jr.BottleneckResNetBlock, num_classes=10,
                      num_filters=8, dtype=jnp.float32,
                      sync_batch_norm_axis=HVD_AXIS)
    # Flax's own init (the last BatchNorm of each block at zero scale), as
    # test_torch_dp_slice.py draws it; jitted, since eager takes ~30 s.
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x[:1]))
    return model, variables, x, y


@pytest.fixture(scope="module")
def worlds(resnet_data):
    _, variables, x, y = resnet_data
    frontend = [(k,) + v for k, v in FRONTEND.items()]
    model = [(k,) + v for k, v in MODEL.items()]
    return {
        "two": helpers.run_world_async(
            helpers.sync_bn_world, 2,
            args=({"frontend": frontend, "model": model},)),
        "one": helpers.run_world_async(
            helpers.sync_bn_world, 1, args=({"cases": _cases_inputs()},)),
        "resnet": helpers.run_world_async(
            helpers.dp_resnet_sync_bn, 2,
            args=(variables, x, y, STEPS, LR)),
    }


def _world(worlds, name):
    return worlds[name].result(timeout=180)


@pytest.mark.parametrize("case", list(FRONTEND))
def test_frontend_matches_batchnorm2d_on_the_global_batch(worlds, case):
    port = _world(worlds, "two")
    xs, ws, scale, bias = FRONTEND[case]
    bn = torch.nn.BatchNorm2d(C, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    ref = helpers._bn_pass(bn, np.concatenate(xs), np.concatenate(ws))
    tol = {"rtol": 1e-4, "atol": 1e-5}
    for key in ("y", "x_grad"):
        got = np.concatenate([port[r][case][key] for r in (0, 1)])
        np.testing.assert_allclose(got, ref[key], err_msg=key, **tol)
    for key in ("weight", "bias"):
        got = port[0][case][key] + port[1][case][key]
        np.testing.assert_allclose(got, ref[key], err_msg=key, **tol)
    for key in ("running_mean", "running_var"):
        for r in (0, 1):
            np.testing.assert_allclose(port[r][case][key], ref[key],
                                       err_msg=key, **tol)
        assert port[0][case][key].tobytes() == port[1][case][key].tobytes()
    assert int(port[0][case]["num_batches_tracked"]) == 1


def test_frontend_cases_match_jax_at_one_rank(hvd, worlds):
    import horovod_tpu.torch as hvd_torch
    port = _world(worlds, "one")[0]["cases"]
    ref = helpers.torch_sync_bn_cases(hvd_torch.SyncBatchNorm,
                                      _cases_inputs())
    assert set(port) == set(ref)
    assert port["rejects_1d"] == ref["rejects_1d"] and "at least 2D" in \
        port["rejects_1d"]
    for case in (k for k in ref if k != "rejects_1d"):
        for got, want in zip(port[case], ref[case]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=case)


def _jax_model_side(xs, ws, scale, bias):
    """The JAX module over 2 devices on the NHWC transposes: outputs,
    gradients of sum(y * w) as make_train_step takes them, and the new
    running statistics, each back in NCHW."""
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    module = JaxSyncBN(use_running_average=False, axis_name=HVD_AXIS,
                       momentum=0.9)
    nhwc = lambda a: np.ascontiguousarray(  # noqa: E731
        np.moveaxis(a, 1, -1))
    x = np.stack([nhwc(a) for a in xs])
    w = np.stack([nhwc(a) for a in ws])
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def body(xl, wl):
        def loss(p, xx):
            y, upd = module.apply({"params": p, "batch_stats": stats}, xx,
                                  mutable=["batch_stats"])
            return (y * wl[0]).sum(), (y, upd["batch_stats"])
        (_, (y, upd)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, xl[0])
        return (y[None], gx[None], gp["scale"][None], gp["bias"][None],
                upd["mean"][None], upd["var"][None])

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(HVD_AXIS),) * 2,
                              out_specs=(P(HVD_AXIS),) * 6,
                              check_vma=False))
    y, gx, gs, gb, mean, var = [np.asarray(a) for a in f(x, w)]
    back = lambda a: np.moveaxis(a, -1, 1)  # noqa: E731
    return [{"y": back(y[r]), "x_grad": back(gx[r]), "weight": gs[r],
             "bias": gb[r], "running_mean": mean[r], "running_var": var[r]}
            for r in (0, 1)]


def test_model_side_matches_jax_under_shard_map(worlds):
    port = _world(worlds, "two")
    ref = _jax_model_side(*MODEL["model"])
    for r in (0, 1):
        for key, want in ref[r].items():
            np.testing.assert_allclose(port[r]["model"][key], want,
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} {key}")
    # A forward and a backward collective for each module of each case.
    assert port[0]["launches"] == 2 * (len(FRONTEND) + len(MODEL))


@pytest.fixture(scope="module")
def jax_resnet(resnet_data):
    model, variables, x, y = resnet_data
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    opt = DistributedOptimizer(optax.sgd(LR, momentum=0.9))

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
    state = jax.device_put(state, NamedSharding(mesh, P()))
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, {"x": jnp.asarray(x), "y": jnp.asarray(y)})
        losses.append(float(loss))
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    template = tr.ResNet([1, 1, 1, 1], tr.BottleneckResNetBlock,
                         num_classes=10, num_filters=8, dtype=torch.float32,
                         sync_batch_norm=global_process_set)
    stats = to_np(state.extra)
    return {"losses": losses,
            "state": helpers.flax_as_torch_named(
                template, to_np(state.params), stats),
            "momentum": helpers.flax_as_torch_named(
                template, to_np(optax.tree_utils.tree_get(state.opt_state,
                                                          "trace")), stats)}


@pytest.mark.parametrize("what", ["state", "momentum"])
def test_sync_bn_resnet_matches_jax(worlds, jax_resnet, what):
    port = _world(worlds, "resnet")
    ref = jax_resnet[what]
    assert any("SyncBatchNorm_0" in k for k in ref)
    for r in (0, 1):
        got = port[r][what]
        assert set(got) == set(ref) - ({k for k in ref if "running_" in k}
                                       if what == "momentum" else set())
        for name in got:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{what} {name}")
    a, b = (port[r]["state"] for r in (0, 1))
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)


def test_sync_bn_resnet_losses_match_jax(worlds, jax_resnet):
    port = _world(worlds, "resnet")
    mean = np.mean([port[r]["losses"] for r in (0, 1)], axis=0)
    np.testing.assert_allclose(mean, jax_resnet["losses"], rtol=1e-4,
                               atol=1e-5)
