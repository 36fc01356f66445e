"""The port's GPT (``horovod_tpu_torch/models/gpt.py``, blocks from
``parallel/tp.py``) against the JAX package's Flax GPT, with the Flax
initial weights carried across by ``load_flax_gpt``.

GPT tiny with 2 layers, fp32, at L = 64 and L = 100 (ragged for the flash
path), with ``use_flash`` on and off: logits, the next-token loss
(``bench.py``'s: cross-entropy of ``logits[:, :-1]`` against ``ids[:, 1:]``)
and every parameter's gradient, against ``model.apply`` and ``jax.grad``.

Tolerances. fp32: logits rtol 1e-4 / atol 1e-5; each gradient within
1e-4 of its tensor's largest entry (both sides are fp32 with sums in another
order; measured differences are ~1e-6). bf16 forward: logits within 0.1 and
the loss within 1e-3 relative, since bf16 keeps 8 mantissa bits and the two
frameworks round at different places (the port's cuBLAS-style fused bias,
an fp32 gelu); measured logit differences are ~0.03 on logits of magnitude
~3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu.models import gpt as jg
from horovod_tpu.parallel import tp as jtp
from horovod_tpu_torch.models import gpt as tg
from horovod_tpu_torch.parallel import tp as ttp
from test_torch_bert import draw_params

KW = dict(num_layers=2, max_position_embeddings=128, tp_axis=None,
          ep_axis=None)


def _ids(L):
    return np.random.default_rng(L).integers(0, 256, (2, L)).astype(np.int32)


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def flax_params():
    model = jg.GPT(jg.GPTConfig.tiny(**KW))
    # Jitted: Flax's init op by op costs several times its compile here.
    return _to_np(jax.jit(model.init)(jax.random.PRNGKey(0),
                                      jnp.asarray(_ids(8)))["params"])


def _torch_model(params, **kw):
    return tg.load_flax_gpt(tg.GPT(tg.GPTConfig.tiny(**KW, **kw)), params)


def _next_token_loss_torch(logits, ids):
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           ids[:, 1:].flatten())


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("L", [64, 100])
def test_logits_loss_and_grads_match_flax(flax_params, L, flash):
    ids = _ids(L)
    jm = jg.GPT(jg.GPTConfig.tiny(use_flash=flash, **KW))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids))
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), jnp.asarray(ids[:, 1:]))
        return loss.mean(), logits

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, logits), grads = step(
        jax.tree_util.tree_map(jnp.asarray, flax_params))

    tm = _torch_model(flax_params, use_flash=flash)
    tids = torch.from_numpy(ids).long()
    tlogits = tm(tids)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    tloss = _next_token_loss_torch(tlogits, tids)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    tloss.backward()
    ref = dict(_torch_model(_to_np(grads)).named_parameters())
    for name, p in tm.named_parameters():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_bf16_forward_matches_flax(flax_params):
    ids = _ids(64)
    jm = jg.GPT(jg.GPTConfig.tiny(use_flash=True, dtype=jnp.bfloat16, **KW))
    logits = np.asarray(jm.apply({"params": flax_params}, jnp.asarray(ids)))
    tm = _torch_model(flax_params, use_flash=True, dtype=torch.bfloat16)
    tids = torch.from_numpy(ids).long()
    with torch.no_grad():
        tlogits = tm(tids)
    assert tlogits.dtype == torch.float32          # the fp32 lm_head
    np.testing.assert_allclose(tlogits.numpy(), logits, rtol=0, atol=0.1)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits[:, :-1]), jnp.asarray(ids[:, 1:])).mean()
    np.testing.assert_allclose(_next_token_loss_torch(tlogits, tids).item(),
                               float(want), rtol=1e-3)


def test_features_only_is_the_pre_head_state(flax_params):
    tm = _torch_model(flax_params)
    ids = torch.from_numpy(_ids(16)).long()
    with torch.no_grad():
        h = tm(ids, features_only=True)
        assert h.shape == (2, 16, 64)
        assert torch.equal(tm.head(h), tm(ids))


def test_gqa_self_attention_matches_flax():
    """TPSelfAttention with 4 query heads over 2 kv heads, flash and plain,
    against the Flax module on the same weights."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 24, 32)).astype(np.float32)
    jmod = jtp.TPSelfAttention(num_heads=4, hidden_size=32, num_kv_heads=2,
                               causal=True, axis_name=None)
    params = _to_np(jmod.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    want = np.asarray(jmod.apply(params, jnp.asarray(x)))
    for flash in (False, True):
        tmod = ttp.TPSelfAttention(4, 32, num_kv_heads=2, causal=True,
                                   use_flash=flash)
        tg.load_flax_gpt(tmod, params)
        got = tmod(torch.from_numpy(x)).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_load_flax_gpt_refuses_missing_and_extra_leaves(flax_params):
    extra = dict(flax_params, stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray"):
        _torch_model(extra)
    missing = {k: v for k, v in flax_params.items() if k != "head"}
    with pytest.raises(KeyError, match="no Flax variable"):
        _torch_model(missing)
    bad = dict(flax_params, embed=dict(flax_params["embed"],
                                       pos_emb=np.zeros((3, 64))))
    with pytest.raises(ValueError, match="pos_emb"):
        _torch_model(bad)


EXPERT_OPTIONS = [{"tp_axis": "tp", "ep_axis": "ep"}, {"ep_axis": "ep"},
                  {"num_experts": 2}, {"sp_axis": "sp", "num_experts": 2}]


@pytest.mark.parametrize("kw", EXPERT_OPTIONS)
def test_expert_options_build_and_match_jax(kw):
    """The expert axis and MoE blocks (ported with A12's second half) build,
    with the tensor and sequence axes beside them or not, and with no axis
    bound give JAX's logits for the same config and Flax weights (MoE blocks
    every second layer)."""
    ids = _ids(16)
    jm = jg.GPT(jg.GPTConfig.tiny(num_layers=2, max_position_embeddings=64,
                                  **{"tp_axis": None, "ep_axis": None,
                                     **kw}))
    params = draw_params(jm, jnp.asarray(ids), seed=3)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)))
    m = tg.load_flax_gpt(tg.GPT(tg.GPTConfig.tiny(
        num_layers=2, max_position_embeddings=64, **kw)), params)
    assert isinstance(m.layer_1, tg.GPTMoEBlock) == bool(
        kw.get("num_experts"))
    got = m(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"num_experts": 2}])
def test_unported_options_name_their_roadmap_item(kw):
    """Decode, once refused naming A15, is ported: the dense model builds
    with ``decode=True`` and runs a cache feed, and without a cache ``pos``
    is not read, as JAX's model outside decode mode; the MoE model refuses
    decode with JAX's ``ValueError``."""
    import importlib
    gen = importlib.import_module("horovod_tpu_torch.models.generate")
    ids = torch.zeros(1, 4, dtype=torch.long)
    m = tg.GPT(tg.GPTConfig.tiny(num_layers=2, **kw),
               generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(m(ids, pos=3), m(ids))
    if kw:
        with pytest.raises(ValueError, match="MoE"):
            tg.GPT(tg.GPTConfig.tiny(**kw), decode=True)
        with pytest.raises(ValueError, match="MoE"):
            m(ids, pos=0, cache=gen.init_decode_cache(m, 1))
        return
    dec = tg.GPT(tg.GPTConfig.tiny(num_layers=2), decode=True)
    with torch.no_grad():
        out = dec(ids, pos=0, cache=gen.init_decode_cache(dec, 1))
    assert out.shape == (1, 4, 256)
    with pytest.raises(ValueError, match="decode cache"):
        dec(ids)


def test_decode_is_not_ported_yet():
    """Decode is ported now: a decode-mode GPT reads its cache, and refuses
    to run without one or without a position, as JAX's decode mode."""
    import importlib
    gen = importlib.import_module("horovod_tpu_torch.models.generate")
    m = tg.GPT(tg.GPTConfig.tiny(), decode=True)
    cache = gen.init_decode_cache(m, 2)
    assert cache["layer_3/attention/k"].shape == (2, 4, 64, 16)
    with pytest.raises(ValueError, match="requires pos"):
        m(torch.zeros(2, 1, dtype=torch.long), cache=cache)


@pytest.mark.parametrize("flash", [False, True])
def test_remat_matches_no_remat(flax_params, flash):
    """Each block under torch.utils.checkpoint: the same gradients, bit for
    bit, as without it."""
    ids = torch.from_numpy(_ids(40)).long()
    grads = []
    for remat in (False, True):
        m = _torch_model(flax_params, use_flash=flash, remat=remat)
        _next_token_loss_torch(m(ids), ids).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name
