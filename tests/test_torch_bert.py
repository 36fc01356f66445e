"""The port's BERT (``horovod_tpu_torch/models/bert.py``) against the JAX
package's Flax BERT on the same weights (``load_flax_bert``).

BERT tiny with 2 layers, fp32, at the ragged L = 40, flash on and off: the
MLM and NSP logits, the pre-training loss (mean MLM cross-entropy plus mean
NSP cross-entropy, ``bench.py``'s) and all 39 parameters' gradients, against
``model.apply`` and ``jax.grad`` (the JAX flash path runs the Pallas kernels
interpreted; the port's CPU tensors take the kernels' plain versions). The
weights are drawn with numpy into ``jax.eval_shape``'s tree (a jitted Flax
init costs seconds): kernels with variance 1/fan-in, the rest small and
nonzero, so a bias or norm mapped to the wrong leaf shows.

Tolerances. fp32: logits rtol 1e-4 / atol 1e-5, the loss rtol 1e-5, each
gradient within 1e-4 of its tensor's largest entry (sums in another order;
measured ~1e-6). bf16 forward: MLM logits within 0.1 and the loss within
1e-3 relative, as for GPT (8 mantissa bits; the frameworks round at other
places, as in the fused bias and the fp32 gelu). Dropout draws from torch's
stream, not JAX's, so the Flax comparisons run with dropout off; dropout
itself is held to Flax's semantics (identity when deterministic, kept
elements scaled by 1/(1 - rate)) and remat to the run without it, bit for
bit, dropout on and off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import bert as jb
from horovod_tpu_torch.models import bert as tb

L, B = 40, 2


def draw_params(model, *args, seed=0):
    """A Flax params tree in ``model.init``'s shapes, drawn with numpy:
    kernels normal with variance 1/fan-in, embeddings normal with variance
    1/features, norm scales 1 + N(0, 0.1), biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            *args)["params"]

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        z = rng.standard_normal(shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            z = z / np.sqrt(shape[-1])
        elif name == "scale":
            z = 1.0 + 0.1 * z
        else:
            z = 0.02 * z
        return z.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 1024, (B, L)).astype(np.int32)
    types = rng.integers(0, 2, (B, L)).astype(np.int32)
    labels = rng.integers(0, 1024, (B, L)).astype(np.int32)
    nsp = rng.integers(0, 2, (B,)).astype(np.int32)
    return ids, types, labels, nsp


def _cfg(mod, **kw):
    dtype = kw.pop("dtype", "float32")
    dt = getattr(jnp if mod is jb else torch, dtype)
    return mod.BertConfig.tiny(num_layers=2, dtype=dt, **kw)


@pytest.fixture(scope="module")
def flax_params():
    ids = jnp.asarray(_batch()[0][:1])
    return draw_params(jb.BertForPreTraining(_cfg(jb)), ids)


def _port(params, **kw):
    return tb.load_flax_bert(tb.BertForPreTraining(_cfg(tb, **kw)), params)


def _loss_jax(logits, labels, nsp):
    mlm, ns = logits
    return (optax.softmax_cross_entropy_with_integer_labels(mlm, labels).mean()
            + optax.softmax_cross_entropy_with_integer_labels(ns, nsp).mean())


def _loss_torch(logits, labels, nsp):
    mlm, ns = logits
    return F.cross_entropy(mlm.flatten(0, 1), labels.flatten()) \
        + F.cross_entropy(ns, nsp)


def _flash_calls(monkeypatch):
    calls = []
    raw = tb.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("causal"))
        return raw(*a, **kw)
    monkeypatch.setattr(tb, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_flax(flax_params, flash, monkeypatch):
    ids, types, labels, nsp = _batch()
    jm = jb.BertForPreTraining(_cfg(jb, use_flash=flash))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(types))
        return _loss_jax(logits, jnp.asarray(labels), jnp.asarray(nsp)), logits

    (loss, (mlm, ns)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       flax_params))
    calls = _flash_calls(monkeypatch)
    tm = _port(flax_params, use_flash=flash)
    tl = tm(torch.from_numpy(ids).long(), torch.from_numpy(types).long())
    assert calls == ([False, False] if flash else [])   # non-causal flash
    for got, want in zip(tl, (mlm, ns)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)
    tloss = _loss_torch(tl, torch.from_numpy(labels).long(),
                        torch.from_numpy(nsp).long())
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    tloss.backward()
    ref = dict(_port(jax.tree_util.tree_map(np.asarray, grads))
               .named_parameters())
    named = dict(tm.named_parameters())
    assert len(named) == 39 and set(named) == set(ref)
    for name, p in named.items():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_padding_mask_takes_the_plain_path_on_both_sides(flax_params,
                                                         monkeypatch):
    ids, types, _, _ = _batch()
    mask = np.ones((B, L), np.int32)
    mask[0, 25:] = 0
    mask[1, 33:] = 0
    want = jax.jit(jb.BertForPreTraining(_cfg(jb, use_flash=True)).apply)(
        {"params": flax_params}, jnp.asarray(ids), jnp.asarray(types),
        jnp.asarray(mask))
    calls = _flash_calls(monkeypatch)
    with torch.no_grad():
        got = _port(flax_params, use_flash=True)(
            torch.from_numpy(ids).long(), torch.from_numpy(types).long(),
            torch.from_numpy(mask))
    assert calls == []
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_bf16_forward_matches_flax(flax_params):
    ids, _, labels, nsp = _batch()
    mlm, ns = jax.jit(jb.BertForPreTraining(_cfg(jb, use_flash=True,
                                                 dtype="bfloat16")).apply)(
        {"params": flax_params}, jnp.asarray(ids))
    with torch.no_grad():
        tl = _port(flax_params, use_flash=True, dtype="bfloat16")(
            torch.from_numpy(ids).long())
    assert tl[0].dtype == tl[1].dtype == torch.float32   # fp32 heads
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(mlm), rtol=0,
                               atol=0.1)
    want = _loss_jax((mlm, ns), jnp.asarray(labels), jnp.asarray(nsp))
    got = _loss_torch(tl, torch.from_numpy(labels).long(),
                      torch.from_numpy(nsp).long())
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-3)


def test_dropout_follows_flax():
    x = torch.randn(64, 256)
    assert tb.dropout(x, 0.25, deterministic=True) is x
    assert tb.dropout(x, 0.0, deterministic=False) is x
    assert torch.equal(tb.dropout(x, 1.0, deterministic=False),
                       torch.zeros_like(x))
    y = tb.dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    z = tb.dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    assert torch.equal(y, z)               # the generator decides the mask


def test_dropout_gates_flash_as_flax_does(flax_params, monkeypatch):
    """Dropout on (deterministic False, rate > 0) takes the plain path;
    deterministic, or a rate of 0, keeps flash."""
    ids = torch.from_numpy(_batch()[0]).long()
    calls = _flash_calls(monkeypatch)
    m = _port(flax_params, use_flash=True)
    with torch.no_grad():
        det = m(ids)
        m(ids, deterministic=False, generator=torch.Generator().manual_seed(0))
        assert calls == [False, False]
        off = _port(flax_params, use_flash=True, dropout_rate=0.0)(
            ids, deterministic=False)
    assert calls == [False] * 4
    for a, b in zip(det, off):
        assert torch.equal(a, b)


@pytest.mark.parametrize("deterministic", [True, False])
def test_remat_matches_no_remat(flax_params, deterministic):
    """Gradients with each block checkpointed equal those without, bit for
    bit; with dropout on, the recomputation replays the block's masks from
    the explicit generator, and the generator ends where it would."""
    ids, types, labels, nsp = (torch.from_numpy(a).long() for a in _batch())
    out = []
    for remat in (False, True):
        m = _port(flax_params, use_flash=True, remat=remat)
        gen = torch.Generator().manual_seed(5)
        loss = _loss_torch(m(ids, types, deterministic=deterministic,
                             generator=gen), labels, nsp)
        loss.backward()
        out.append(({n: p.grad for n, p in m.named_parameters()},
                    torch.rand(4, generator=gen)))
    (g0, after0), (g1, after1) = out
    assert torch.equal(after0, after1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_load_flax_bert_refuses_missing_and_extra_leaves(flax_params):
    extra = dict(flax_params, stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray"):
        _port(extra)
    missing = {k: v for k, v in flax_params.items() if k != "nsp_head"}
    with pytest.raises(KeyError, match="no Flax variable"):
        _port(missing)
    bert = dict(flax_params["bert"],
                pos_emb={"embedding": np.zeros((3, 128), np.float32)})
    with pytest.raises(ValueError, match="pos_emb"):
        _port(dict(flax_params, bert=bert))
