"""The port's ResNet against the JAX package's Flax ResNet, weights carried
across by ``load_flax_variables``, in fp32 on the CPU.

Tolerance for logits, loss, gradients and updated batch statistics: rtol
1e-4, atol 1e-5. The convolutions sum in another order in XLA and in
PyTorch, and Flax computes the batch variance as E[x^2] - E[x]^2. For a
gradient tensor whose largest magnitude m is above 1, atol is 1e-5 * m:
the stem's gradient sums every position of the batch, and its fp32
rounding noise grows with the tensor's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.models import resnet as jr
from horovod_tpu_torch.models import resnet as tr

RTOL, ATOL = 1e-4, 1e-5
BLOCKS = {"bottleneck": (jr.BottleneckResNetBlock, tr.BottleneckResNetBlock),
          "basic": (jr.ResNetBlock, tr.ResNetBlock)}
# (block, stem, image side): odd sides exercise the SAME-padding split.
CONFIGS = [("bottleneck", "conv", 32), ("bottleneck", "space_to_depth", 32),
           ("basic", "conv", 32), ("basic", "conv", 30)]


def _flax_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=CONFIGS,
                ids=lambda c: "-".join(map(str, c)))
def run(request, tmp_path_factory):
    """Each configuration once for the whole run (``torch_shared.shared``)."""
    return shared(tmp_path_factory,
                  "resnet_run_" + "-".join(map(str, request.param)),
                  lambda: _run(request.param))


def _run(config):
    block, stem, side = config
    jblock, tblock = BLOCKS[block]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, side, side, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)

    jmodel = jr.ResNet(stage_sizes=[1, 1, 1, 1], block_cls=jblock,
                       num_classes=10, num_filters=8, dtype=jnp.float32,
                       stem=stem)
    # Jitted: Flax's init op by op costs several times its compile here.
    variables = _flax_to_numpy(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                                    x[:1]))

    def loss_fn(params):
        logits, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, upd["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    tmodel = tr.ResNet([1, 1, 1, 1], tblock, num_classes=10, num_filters=8,
                       dtype=torch.float32, stem=stem)
    tr.load_flax_variables(tmodel, variables)
    tlogits = tmodel(torch.from_numpy(x))
    tloss = F.cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    return {
        "jax": {"logits": np.asarray(logits), "loss": float(loss),
                "grads": helpers.flax_as_torch_named(
                    tmodel, _flax_to_numpy(grads), variables["batch_stats"]),
                "state": helpers.flax_as_torch_named(
                    tmodel, variables["params"], _flax_to_numpy(stats))},
        "port": {"logits": helpers.to_np(tlogits), "loss": tloss.item(),
                 "grads": {n: helpers.to_np(p.grad)
                           for n, p in tmodel.named_parameters()},
                 "state": {k: helpers.to_np(v)
                           for k, v in tmodel.state_dict().items()}},
    }


def test_logits_and_loss(run):
    np.testing.assert_allclose(run["port"]["logits"], run["jax"]["logits"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(run["port"]["loss"], run["jax"]["loss"],
                               rtol=RTOL, atol=ATOL)


def test_every_gradient(run):
    port, ref = run["port"]["grads"], run["jax"]["grads"]
    assert set(port) == {k for k in ref if "running_" not in k}
    for name, g in port.items():
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g, ref[name], rtol=RTOL,
                                   atol=ATOL * scale, err_msg=name)


def test_updated_batch_stats(run):
    port, ref = run["port"]["state"], run["jax"]["state"]
    stats = [k for k in ref if "running_" in k]
    assert stats
    for name in stats:
        np.testing.assert_allclose(port[name], ref[name], rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _one_hot_probe():
    x = np.arange(16, dtype=np.float32).reshape(1, 4, 4, 1)
    kernel = np.zeros((3, 3, 1, 1), np.float32)
    kernel[0, 0] = 1.0            # the window's top-left tap
    return x, kernel


def test_strided_conv_pads_like_flax():
    """Flax SAME for a stride-2 3x3 window on 4x4 pads (0, 1): the window
    starts at row/col 0. Symmetric padding=1 starts it at -1."""
    x, kernel = _one_hot_probe()
    ref = np.asarray(fnn.Conv(1, (3, 3), (2, 2), use_bias=False).apply(
        {"params": {"kernel": kernel}}, x))[0, :, :, 0]
    np.testing.assert_array_equal(ref, [[0, 2], [8, 10]])
    conv = tr.Conv(1, 1, (3, 3), (2, 2))
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(conv(xt).detach().numpy()[0, 0], ref)
    symmetric = F.conv2d(xt, conv.weight, stride=2, padding=1)
    assert not np.array_equal(symmetric.detach().numpy()[0, 0], ref)


def test_strided_max_pool_pads_like_flax():
    x, _ = _one_hot_probe()
    ref = np.asarray(fnn.max_pool(x, (3, 3), strides=(2, 2),
                                  padding="SAME"))[0, :, :, 0]
    np.testing.assert_array_equal(ref, [[10, 11], [14, 15]])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    np.testing.assert_array_equal(tr.max_pool_same(xt, 3, 2).numpy()[0, 0],
                                  ref)
    assert not np.array_equal(
        F.max_pool2d(xt, 3, 2, padding=1).numpy()[0, 0], ref)


def test_load_flax_variables_rejects_a_missing_leaf():
    jmodel = jr.ResNet(stage_sizes=[1], block_cls=jr.ResNetBlock,
                       num_classes=3, num_filters=4, dtype=jnp.float32)
    # The tree's names and shapes are what the loader checks: zeros in
    # jax.eval_shape's tree, not an init.
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                       np.zeros((1, 8, 8, 3), np.float32)))
    tmodel = tr.ResNet([1], tr.ResNetBlock, num_classes=3, num_filters=4,
                       dtype=torch.float32)
    tr.load_flax_variables(tmodel, variables)
    del variables["params"]["Dense_0"]
    with pytest.raises(KeyError):
        tr.load_flax_variables(tmodel, variables)
