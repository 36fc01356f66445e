"""The port's LLaMA (``horovod_tpu_torch/models/llama.py``) and its layers
in ``parallel/tp.py`` (``apply_rope``, ``RMSNorm``, ``TPSwiGLUMlp``, RoPE in
``TPSelfAttention``) against the JAX package's, on the same weights
(``load_flax_llama``).

LLaMA tiny with 2 layers (4 query heads over 2 kv heads), fp32, at the
ragged L = 40, flash on and off: logits, the next-token loss and every
parameter's gradient (the JAX flash path runs the Pallas kernels
interpreted, with narrow grouped K/V; the port's CPU tensors take the
kernels' plain versions). Weights drawn with numpy into ``jax.eval_shape``'s
tree, as in ``test_torch_bert.py``.

Tolerances. fp32: the layers and logits rtol 1e-4 / atol 1e-5 (RoPE's
angles and their sines agree to an ulp or two of fp32), the loss rtol 1e-5,
each gradient within 1e-4 of its tensor's largest entry. bf16: logits within
0.1 and the loss within 1e-3 relative, as for GPT; the bf16 RMSNorm within
one bf16 rounding of its magnitude (2^-8 relative), since both sides compute
in fp32 and round once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from horovod_tpu.models import llama as jl
from horovod_tpu.parallel import tp as jtp
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel import tp as ttp
from test_torch_bert import draw_params

L, B = 40, 2


def _ids(seed=2):
    return np.random.default_rng(seed).integers(0, 256, (B, L)).astype(
        np.int32)


def _cfg(mod, **kw):
    dtype = kw.pop("dtype", "float32")
    dt = getattr(jnp if mod is jl else torch, dtype)
    return mod.LlamaConfig.tiny(num_layers=2, dtype=dt, tp_axis=None, **kw)


@pytest.fixture(scope="module")
def flax_params():
    return draw_params(jl.Llama(_cfg(jl)), jnp.asarray(_ids()[:1]))


def _port(params, **kw):
    return tl.load_flax_llama(tl.Llama(_cfg(tl, **kw)), params)


def _next_token_loss(logits, ids):
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           ids[:, 1:].flatten())


def test_apply_rope_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 40, 3, 16)).astype(
        np.float32)
    for theta in (10000.0, 500000.0):
        want = jtp.apply_rope(jnp.asarray(x), jnp.arange(40, dtype=jnp.int32),
                              theta)
        got = ttp.apply_rope(torch.from_numpy(x), torch.arange(40), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)
    got = ttp.apply_rope(torch.from_numpy(x).bfloat16(), torch.arange(40),
                         1e4)
    assert got.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="even"):
        ttp.apply_rope(torch.zeros(1, 4, 1, 5), torch.arange(4), 1e4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_flax(dtype):
    rng = np.random.default_rng(4)
    x = (3.0 * rng.standard_normal((2, 7, 32))).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = fnn.RMSNorm(epsilon=1e-5, dtype=jdt).apply(
        {"params": {"scale": scale}}, jnp.asarray(x, jdt))
    norm = ttp.RMSNorm(32, tdt, epsilon=1e-5)
    tl.load_flax_llama(norm, {"scale": scale})
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=1e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_swiglu_mlp_matches_flax(activation):
    x = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(
        np.float32)
    jmod = jtp.TPSwiGLUMlp(48, 32, axis_name=None, activation=activation)
    params = draw_params(jmod, jnp.asarray(x), seed=6)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = tl.load_flax_llama(ttp.TPSwiGLUMlp(48, 32, activation=activation),
                              params)
    got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="activation"):
        ttp.TPSwiGLUMlp(48, 32, activation="relu")


@pytest.mark.parametrize("flash", [False, True])
def test_logits_loss_and_grads_match_flax(flax_params, flash):
    ids = _ids()
    jm = jl.Llama(_cfg(jl, use_flash=flash))

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(ids))
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1].astype(jnp.float32), jnp.asarray(ids[:, 1:]))
        return loss.mean(), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                       flax_params))
    tm = _port(flax_params, use_flash=flash)
    tids = torch.from_numpy(ids).long()
    tlogits = tm(tids)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               rtol=1e-4, atol=1e-5)
    tloss = _next_token_loss(tlogits, tids)
    np.testing.assert_allclose(tloss.item(), float(loss), rtol=1e-5)
    tloss.backward()
    ref = dict(_port(jax.tree_util.tree_map(np.asarray, grads))
               .named_parameters())
    named = dict(tm.named_parameters())
    assert len(named) == 15 and set(named) == set(ref)
    for name, p in named.items():
        want = ref[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_bf16_forward_matches_flax(flax_params):
    ids = _ids()
    logits = np.asarray(jax.jit(jl.Llama(_cfg(jl, use_flash=True,
                                              dtype="bfloat16")).apply)(
        {"params": flax_params}, jnp.asarray(ids)))
    with torch.no_grad():
        tlogits = _port(flax_params, use_flash=True, dtype="bfloat16")(
            torch.from_numpy(ids).long())
    assert tlogits.dtype == torch.float32          # the fp32 lm_head
    np.testing.assert_allclose(tlogits.numpy(), logits, rtol=0, atol=0.1)
    want = optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(logits[:, :-1]), jnp.asarray(ids[:, 1:])).mean()
    np.testing.assert_allclose(
        _next_token_loss(tlogits, torch.from_numpy(ids).long()).item(),
        float(want), rtol=1e-3)


def test_features_only_is_the_pre_head_state(flax_params):
    tm = _port(flax_params)
    ids = torch.from_numpy(_ids()).long()
    with torch.no_grad():
        h = tm(ids, features_only=True)
        assert h.shape == (B, L, 64)
        assert torch.equal(tm.head(h), tm(ids))


def test_remat_matches_no_remat(flax_params):
    ids = torch.from_numpy(_ids()).long()
    grads = []
    for remat in (False, True):
        m = _port(flax_params, use_flash=True, remat=remat)
        _next_token_loss(m(ids), ids).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for name in grads[0]:
        assert torch.equal(grads[0][name], grads[1][name]), name


def _feed(m, ids, pos=0):
    import importlib
    gen = importlib.import_module("horovod_tpu_torch.models.generate")
    with torch.no_grad():
        return m(ids, pos=pos, cache=gen.init_decode_cache(m, ids.shape[0]))


def _decode_tp_axis():
    # Outside an in-step mesh a tp_axis model is its dense form: it decodes.
    m = tl.Llama(tl.LlamaConfig.tiny(tp_axis="tp", num_layers=2),
                 decode=True)
    return _feed(m, torch.zeros(1, 3).long()).shape == (1, 3, 256)


def _decode_sp_axis():
    # JAX's decode refuses sp_axis.
    m = tl.Llama(tl.LlamaConfig.tiny(sp_axis="sp", kv_cache_int8=True,
                                     num_layers=2))
    with pytest.raises(ValueError, match="sp_axis"):
        _feed(m, torch.zeros(1, 3).long())
    return True


def _decode():
    m = tl.Llama(tl.LlamaConfig.tiny(num_layers=2), decode=True)
    with pytest.raises(ValueError, match="decode cache"):
        m(torch.zeros(1, 3).long())
    return _feed(m, torch.zeros(1, 3).long()).shape == (1, 3, 256)


def _int8_cache():
    import importlib
    gen = importlib.import_module("horovod_tpu_torch.models.generate")
    m = tl.Llama(tl.LlamaConfig.tiny(kv_cache_int8=True))
    cache = gen.init_decode_cache(m, 2)
    # GQA: the cache keeps the 2 kv heads, one fp32 scale per row and head
    return (cache["layer_0/attention/k"].dtype == torch.int8
            and cache["layer_0/attention/k"].shape == (2, 2, 64, 16)
            and cache["layer_0/attention/k_scale"].shape == (2, 2, 64))


def _pos_without_cache():
    # Outside decode, pos is not read (JAX's model outside decode mode).
    m = tl.Llama(tl.LlamaConfig.tiny(num_layers=2),
                 generator=torch.Generator().manual_seed(0))
    ids = torch.randint(0, 256, (1, 4), generator=torch.Generator()
                        .manual_seed(1))
    with torch.no_grad():
        return torch.equal(m(ids, pos=torch.tensor([3])), m(ids))


def _rope_rows():
    # Per-row (B, L) positions: each row rotated at its own positions.
    x = torch.randn(2, 4, 1, 8, generator=torch.Generator().manual_seed(2))
    pos = torch.tensor([[0, 1, 2, 3], [5, 6, 7, 8]])
    rows = ttp.apply_rope(x, pos, 1e4)
    return all(torch.equal(rows[b:b + 1], ttp.apply_rope(x[b:b + 1], pos[b],
                                                         1e4))
               for b in range(2))


@pytest.mark.parametrize("check", [
    _decode_tp_axis, _decode_sp_axis, _decode, _int8_cache,
    _pos_without_cache, _rope_rows,
], ids=["tp_axis", "sp_axis", "decode", "kv_cache_int8", "pos", "rope_rows"])
def test_unported_options_name_their_roadmap_item(check):
    """These once raised naming A15; decode is ported now: each option
    runs, or raises JAX's ``ValueError`` where JAX refuses it (decode with
    sp_axis)."""
    assert check()
