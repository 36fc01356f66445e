"""The port's ViT (``horovod_tpu_torch/models/vit.py``) against the JAX
package's Flax ViT on the same weights (``load_flax_vit``).

ViT tiny (2 layers, hidden 64, 4 heads, patch 8) at ``image_size=40``: 5 x 5
= 25 patches, a length ragged against every tile of the flash kernels.
Flash off and on: the logits, the cross-entropy loss and all 31 parameters'
gradients against ``model.apply`` and ``jax.grad`` (the JAX flash path runs
the Pallas kernels interpreted; the port's CPU tensors take the kernels'
plain versions). Weights are drawn with numpy into ``jax.eval_shape``'s tree
(``test_torch_bert.py::draw_params``).

Tolerances, as ``test_torch_bert.py`` states them. fp32: logits rtol 1e-4 /
atol 1e-5, the loss rtol 1e-5, each gradient within 1e-4 of its tensor's
largest entry (sums in another order). bf16: logits within 0.1 and the loss
within 1e-3 relative (``test_bf16_forward_matches_flax``'s limits: 8
mantissa bits, rounded at other places by the two frameworks), each
gradient within 0.1 of its tensor's largest entry (the same 0.1 for a
backward that carries those roundings through both blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import vit as jv
from horovod_tpu_torch.models import vit as tv
from horovod_tpu_torch.models.gpt import _LEAF_NAMES
from test_torch_bert import draw_params

B, IMAGE = 2, 40


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((B, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (B,)).astype(np.int32)
    return images, labels


def _cfg(mod, **kw):
    dtype = kw.pop("dtype", "float32")
    dt = getattr(jnp if mod is jv else torch, dtype)
    return mod.ViTConfig.tiny(image_size=IMAGE, dtype=dt, **kw)


@pytest.fixture(scope="module")
def flax_params():
    images = jnp.asarray(_batch()[0][:1])
    return draw_params(jv.ViT(_cfg(jv)), images)


def _port(params, **kw):
    return tv.load_flax_vit(tv.ViT(_cfg(tv, **kw)), params)


def _flax_run(params, images, labels, **kw):
    model = jv.ViT(_cfg(jv, **kw))

    def loss_fn(p):
        logits = model.apply({"params": p}, jnp.asarray(images))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), np.asarray(logits), grads


def _port_run(params, images, labels, **kw):
    m = _port(params, **kw)
    logits = m(torch.from_numpy(images))
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())
    loss.backward()
    return m, loss, logits


def _flash_calls(monkeypatch):
    from horovod_tpu_torch.parallel import tp
    calls = []
    raw = tp.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return raw(*a, **kw)
    monkeypatch.setattr(tp, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_flax(flax_params, flash, dtype,
                                          monkeypatch):
    images, labels = _batch()
    loss, logits, grads = _flax_run(flax_params, images, labels,
                                    use_flash=flash, dtype=dtype)
    calls = _flash_calls(monkeypatch)
    tm, tloss, tlogits = _port_run(flax_params, images, labels,
                                   use_flash=flash, dtype=dtype)
    assert calls == ([False, False] if flash else [])   # non-causal flash
    assert tlogits.dtype == torch.float32               # the fp32 head
    fp32 = dtype == "float32"
    np.testing.assert_allclose(tlogits.detach().numpy(), logits,
                               rtol=1e-4 if fp32 else 0,
                               atol=1e-5 if fp32 else 0.1)
    np.testing.assert_allclose(tloss.item(), loss,
                               rtol=1e-5 if fp32 else 1e-3)
    ref = dict(_port(jax.tree_util.tree_map(np.asarray, grads))
               .named_parameters())
    named = dict(tm.named_parameters())
    assert len(named) == 31 and set(named) == set(ref)
    for name, p in named.items():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=0,
            atol=(1e-4 if fp32 else 0.1) * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("flash", [False, True])
def test_remat_matches_no_remat(flax_params, flash):
    """Gradients with each block checkpointed equal those without, bit for
    bit."""
    images, labels = _batch()
    grads = []
    for remat in (False, True):
        m, _, _ = _port_run(flax_params, images, labels, use_flash=flash,
                            remat=remat)
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def test_wrong_image_size_raises(flax_params):
    images = torch.zeros(1, IMAGE - 8, IMAGE - 8, 3)
    with pytest.raises(ValueError, match="16 patches but config.image_size="
                                         "40 implies 25"):
        _port(flax_params)(images)
    with pytest.raises(ValueError, match="16 patches"):
        jv.ViT(_cfg(jv)).apply({"params": flax_params}, jnp.asarray(images))


def test_tp_axis_raises_naming_its_item():
    """``tp_axis`` is ported (test_torch_tp.py): outside an in-step mesh the
    model is its dense form, parameter for parameter. Attention in decode
    mode, once refused naming A15, builds since A15's decode cache landed,
    and refuses a decode call without a capacity as JAX does; T5's
    encoder-decoder attention, once refused naming A14, builds since A14
    landed."""
    dense = tv.ViT(tv.ViTConfig.tiny(), generator=torch.Generator()
                   .manual_seed(0))
    named = tv.ViT(tv.ViTConfig.tiny(tp_axis="tp"),
                   generator=torch.Generator().manual_seed(0))
    a, b = dict(dense.named_parameters()), dict(named.named_parameters())
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    from horovod_tpu_torch.parallel.tp import (DecodeCache,
                                               TPCrossAttention,
                                               TPSelfAttention)
    attn = TPSelfAttention(4, 64, decode=True)
    with pytest.raises(ValueError, match="cache_len >= 1"):
        attn(torch.zeros(1, 1, 64), cache=DecodeCache())
    assert TPCrossAttention(4, 64).kv.shard.weight.shape == (128, 64)


def test_vit_b16_parameters_match_flax():
    """ViT-B/16's parameter names and shapes are Flax's (from
    ``eval_shape``: no init), through ``load_flax``'s naming and layouts."""
    shapes = jax.eval_shape(jv.ViT(jv.ViTConfig.base()).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)))["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = tuple(k.key for k in path)
        shape = leaf.shape
        if keys[-1] == "kernel":
            shape = (shape[3], shape[2], shape[0], shape[1]) \
                if len(shape) == 4 else shape[::-1]
        want[".".join(keys[:-1] + (_LEAF_NAMES[keys[-1]],))] = tuple(shape)
    with torch.device("meta"):
        m = tv.ViT(tv.ViTConfig.base())
    got = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert got == want
    assert sum(np.prod(s) for s in got.values()) == 86_566_120
    assert m.n_patches == 196                     # 14 x 14, no cls token
