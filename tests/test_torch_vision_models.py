"""The port's VGG and Inception V3 (``horovod_tpu_torch/models/vgg.py``,
``inception.py``) against the JAX package's Flax models, on Flax's initial
weights carried across by ``load_flax_vgg`` / ``load_flax_inception``, in
fp32 on the CPU, in training mode (batch statistics, dropout rate 0).

- VGG11 with the classic head at 64 x 64 (the last grid 2 x 2, so the
  flatten order matters) and with the global-average head at 32 x 32:
  logits, the loss and every gradient; the classic head's rows taken in
  NCHW order instead (a wrong control) must fail.
- Inception's blocks A-E and the aux head alone (the loss mean(y^2)):
  outputs, every gradient and the BatchNorm running statistics after the
  training forward. Inception V3 end to end at 75 x 75 (the smallest side
  that reaches the E blocks) in inference mode, logits and every gradient;
  with the aux head at 299 x 299 (it needs the 17 x 17 grid) in training
  mode, forward only: logits, aux logits and the running statistics.
- Parameter counts on the ``meta`` device: VGG-16 138,357,544, Inception
  V3 23,834,568.

Tolerance, as ``test_torch_resnet.py``'s: rtol 1e-4, atol 1e-5 (1e-5 times
a gradient's largest magnitude where that is above 1): the convolutions
sum in another order in XLA and PyTorch, and Flax's batch variance is
E[x^2] - E[x]^2. V3's running statistics at 299: within 1e-4 of each
tensor's largest magnitude (see that test).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import torch_port_helpers as helpers
from torch_shared import shared
from horovod_tpu.models import inception as ji
from horovod_tpu.models import vgg as jv
from horovod_tpu_torch.models import inception as ti
from horovod_tpu_torch.models import vgg as tv

RTOL, ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax_init(jmodel, x, seed=0):
    """Weights drawn with numpy into the tree Flax's init gives
    (``jax.eval_shape``, which compiles nothing: a jitted init of the whole
    Inception V3 costs ~18 s here) by Flax's default rules, those of
    Inception's modules: kernels normal with variance 1 / fan-in, biases
    zero, BatchNorm scales and variances one, its biases and means zero.
    The whole-network Inception tests draw them; the others take Flax's
    own init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.standard_normal(shape)
                    / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        fill = np.ones if name in ("scale", "var") else np.zeros
        return fill(shape, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _run(jmodel, tmodel, x, y=None, nchw=False):
    """Flax's init, then one training forward and backward on both sides:
    the loss is the cross-entropy against ``y`` of the (first) output, or
    mean(out^2); with ``nchw`` the port's module takes and gives NCHW."""
    variables = _np(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x[:1]))
    stats = variables.get("batch_stats", {})

    def loss_of(out):
        out = out[0] if isinstance(out, tuple) else out
        if y is None:
            return jnp.mean(out ** 2)
        return optax.softmax_cross_entropy_with_integer_labels(out, y).mean()

    def loss_fn(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": stats}, x,
                                mutable=["batch_stats"])
        return loss_of(out), (out, upd.get("batch_stats", {}))

    (loss, (out, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    if stats:
        ti.load_flax_inception(tmodel, variables)
    else:
        tv.load_flax_vgg(tmodel, variables)
    tmodel.train()
    xt = torch.from_numpy(x)
    tout = tmodel(xt.permute(0, 3, 1, 2) if nchw else xt)
    first = tout[0] if isinstance(tout, tuple) else tout
    tloss = (F.cross_entropy(first, torch.from_numpy(y).long())
             if y is not None else (first ** 2).mean())
    tloss.backward()

    def nhwc(t):
        t = helpers.to_np(t)
        return t.transpose(0, 2, 3, 1) if nchw and t.ndim == 4 else t

    def named(params, st):
        if stats:
            return helpers.flax_as_torch_named(tmodel, params, st)
        m = tv.load_flax_vgg(copy.deepcopy(tmodel), params)
        return {k: helpers.to_np(v) for k, v in m.state_dict().items()}

    return {"jax": {"out": _np(out), "loss": float(loss),
                    "grads": named(_np(grads), stats),
                    "state": named(variables["params"], _np(new_stats))},
            "port": {"out": (tuple(map(nhwc, tout))
                             if isinstance(tout, tuple) else nhwc(tout)),
                     "loss": tloss.item(),
                     "grads": {n: helpers.to_np(p.grad)
                               for n, p in tmodel.named_parameters()},
                     "state": {k: helpers.to_np(v)
                               for k, v in tmodel.state_dict().items()}}}


def _check(run, grads=True):
    port, ref = run["port"], run["jax"]
    outs = port["out"] if isinstance(port["out"], tuple) else (port["out"],)
    refs = ref["out"] if isinstance(ref["out"], tuple) else (ref["out"],)
    assert len(outs) == len(refs)
    for got, want in zip(outs, refs):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=RTOL,
                               atol=ATOL)
    if grads:
        assert set(port["grads"]) == {k for k in ref["grads"]
                                      if "running_" not in k}
        for name, g in port["grads"].items():
            scale = max(1.0, float(np.abs(ref["grads"][name]).max()))
            np.testing.assert_allclose(g, ref["grads"][name], rtol=RTOL,
                                       atol=ATOL * scale, err_msg=name)
    stats = [k for k in ref["state"] if "running_" in k]
    for name in stats:
        np.testing.assert_allclose(port["state"][name], ref["state"][name],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    return len(stats)


def _images(side, n=2, seed=11):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, side, side, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


@pytest.fixture(scope="module")
def vgg_classic(tmp_path_factory):
    """Once for the whole run (``torch_shared.shared``)."""
    return shared(tmp_path_factory, "vgg_classic", _vgg_classic)


def _vgg_classic():
    x, y = _images(64)
    jm = jv.VGG11(num_classes=10, dtype=jnp.float32, dropout_rate=0.0)
    tm = tv.VGG11(num_classes=10, dtype=torch.float32, dropout_rate=0.0,
                  image_size=64)
    return _run(jm, tm, x, y), tm, x


def test_vgg_classic_head_matches_flax(vgg_classic):
    run, tm, _ = vgg_classic
    assert tm.fc0.in_features == 2 * 2 * 512
    _check(run)


def test_vgg_flatten_order_is_flax(vgg_classic):
    """The (c, h, w) flatten of the NCHW grid (torchvision's) against the
    same weights gives other logits: the order is Flax's (h, w, c)."""
    run, tm, x = vgg_classic
    with torch.no_grad():
        h = torch.from_numpy(x).permute(0, 3, 1, 2)
        for names in tm.stages:
            for name in names:
                h = F.relu(getattr(tm, name)(h))
            h = F.max_pool2d(h, 2, 2)
        h = h.flatten(1)                          # (c, h, w): the control
        for fc in (tm.fc0, tm.fc1):
            h = F.relu(fc(h))
        wrong = tm.head(h).numpy()
    assert np.abs(wrong - run["jax"]["out"]).max() > 100 * ATOL


def test_vgg_gap_head_matches_flax():
    x, y = _images(32)
    jm = jv.VGG11(num_classes=10, dtype=jnp.float32, classic_head=False)
    tm = tv.VGG11(num_classes=10, dtype=torch.float32, classic_head=False)
    _check(_run(jm, tm, x, y))


BLOCKS = {
    "A": (lambda: ji.InceptionA(8, dtype=jnp.float32),
          lambda: ti.InceptionA(16, 8), (2, 9, 9, 16)),
    "B": (lambda: ji.InceptionB(dtype=jnp.float32),
          lambda: ti.InceptionB(16), (2, 9, 9, 16)),
    "C": (lambda: ji.InceptionC(12, dtype=jnp.float32),
          lambda: ti.InceptionC(16, 12), (2, 9, 9, 16)),
    "D": (lambda: ji.InceptionD(dtype=jnp.float32),
          lambda: ti.InceptionD(16), (2, 9, 9, 16)),
    "E": (lambda: ji.InceptionE(dtype=jnp.float32),
          lambda: ti.InceptionE(16), (2, 5, 5, 16)),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_inception_block_matches_flax(name):
    make_j, make_t, shape = BLOCKS[name]
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    run = _run(make_j(), make_t(), x, nchw=True)
    assert _check(run) > 0


def test_inception_aux_head_matches_flax():
    x = np.random.default_rng(4).standard_normal((4, 17, 17, 24)).astype(
        np.float32)
    y = np.asarray([3, 5, 0, 9], np.int32)
    run = _run(ji.InceptionAux(10, dtype=jnp.float32),
               ti.InceptionAux(24, 10), x, y, nchw=True)
    assert _check(run) == 4


def test_inception_v3_matches_flax():
    """75 x 75 (the smallest side that reaches the E blocks), in inference
    mode: BatchNorm on the running statistics, so the whole network's
    logits and gradients are well conditioned (in training mode the D and
    E blocks' 1 x 1 grids normalise over two values, where Flax's
    E[x^2] - E[x]^2 moves the logits by ~5e-2)."""
    x, y = _images(75)
    jm = ji.InceptionV3(num_classes=10, dtype=jnp.float32, train=False)
    variables = _flax_init(jm, x[:1])

    def loss_fn(params):
        logits = jm.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    tm = ti.load_flax_inception(ti.InceptionV3(num_classes=10,
                                               dtype=torch.float32),
                                variables).eval()
    tlogits = tm(torch.from_numpy(x))
    tloss = F.cross_entropy(tlogits, torch.from_numpy(y).long())
    tloss.backward()
    np.testing.assert_allclose(helpers.to_np(tlogits), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=RTOL,
                               atol=ATOL)
    ref = helpers.flax_as_torch_named(tm, _np(grads),
                                      variables["batch_stats"])
    named = dict(tm.named_parameters())
    assert len(named) == 3 * 94 + 2
    for name, p in named.items():
        scale = max(1.0, float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(helpers.to_np(p.grad), ref[name],
                                   rtol=RTOL, atol=ATOL * scale,
                                   err_msg=name)


def test_inception_v3_aux_forward_matches_flax():
    """299 x 299 (the aux head needs the 17 x 17 grid), one image, in
    training mode: the logits, the aux logits and every running statistic
    after the forward (no gradient: the blocks' tests hold the backward).
    The statistics within 1e-4 of each tensor's largest magnitude (GPT's
    rule for gradients): ~20 BatchNorms deep, both sides carry ~1e-4 of
    fp32 noise relative to the conv sums they average."""
    x, _ = _images(299, n=1)
    jm = ji.InceptionV3(num_classes=10, dtype=jnp.float32, dropout_rate=0.0,
                        aux_logits=True)
    variables = _flax_init(jm, x)
    (logits, aux), upd = jax.jit(lambda v: jm.apply(
        v, x, mutable=["batch_stats"]))(variables)
    tm = ti.InceptionV3(num_classes=10, dtype=torch.float32,
                        dropout_rate=0.0, aux_logits=True)
    ti.load_flax_inception(tm, variables)
    # At a fixed eight threads, whatever the machine's core count: the
    # thread count sets the order in which the 299 x 299 convolutions sum
    # in fp32, and with it the last digits of the logits and statistics.
    # Eight is torch's default on an 8-core machine; worst error as a
    # share of the tolerance there (logits, statistics):
    # 2.44 and 1.74 at one thread, 1.33 and 1.03 at two, 0.71 and 1.06 at
    # four, 0.95 and 0.89 at eight (Flax's own init: 1.23/1.77, 1.49/1.14,
    # 0.50/0.94, 0.87/0.62). Under xdist the workers otherwise run one
    # thread (torch_port_helpers).
    prev = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        with torch.no_grad():
            tlogits, taux = tm.train()(torch.from_numpy(x))
    finally:
        torch.set_num_threads(prev)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(taux.numpy(), np.asarray(aux), rtol=RTOL,
                               atol=ATOL)
    ref = helpers.flax_as_torch_named(tm, variables["params"],
                                      _np(upd["batch_stats"]))
    got = {k: helpers.to_np(v) for k, v in tm.state_dict().items()}
    stats = [k for k in ref if "running_" in k]
    assert len(stats) == 2 * 96
    for name in stats:
        np.testing.assert_allclose(got[name], ref[name], rtol=0,
                                   atol=1e-4 * np.abs(ref[name]).max(),
                                   err_msg=name)
    with torch.no_grad():
        tm.eval()
        assert tm(torch.from_numpy(x)).shape == (1, 10)   # no aux in eval


@pytest.mark.parametrize("make,want", [
    (lambda: tv.VGG16(num_classes=1000), 138_357_544),
    (lambda: ti.InceptionV3(num_classes=1000), 23_834_568),
], ids=["vgg16", "inception_v3"])
def test_parameter_counts(make, want):
    with torch.device("meta"):
        model = make()
    assert sum(p.numel() for p in model.parameters()) == want
