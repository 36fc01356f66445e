"""The port's flash attention (``horovod_tpu_torch/ops/kernels/
flash_attention.py``) against the JAX package's, on the same numpy inputs.

On the CPU the port runs its plain PyTorch versions; the JAX side runs the
Pallas kernels through the interpreter (``_fa_forward``, ``_fa_backward``,
as ``tests/test_pallas.py`` does) and, for ``flash_attention``, the padded
kernel forward with its jnp backward under ``jax.grad``.

Tolerances, the JAX file's own: rtol 2e-4 / atol 2e-5 on outputs and lse,
rtol 2e-3 / atol 2e-4 on gradients (fp32; the two sides sum in different
orders, and the Pallas forward rescales its running sum per key tile).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops.kernels import flash_attention as tf

jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=2e-3, atol=2e-4)
D = 16


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# (Lq, Lk, kv_valid, heads, kv_heads): equal and unequal lengths (both
# ways, so causal Lq > Lk has fully masked rows), a kv_valid bound, GQA.
RAW_CASES = [(64, 64, None, None, None), (32, 64, None, None, None),
             (64, 32, None, None, None), (64, 64, 40, None, None),
             (64, 64, None, 4, 2)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("lq,lk,kv_valid,heads,kv_heads", RAW_CASES)
def test_raw_forward_and_backward_match_pallas(causal, lq, lk, kv_valid,
                                               heads, kv_heads):
    bh = 4
    bkv = bh if heads is None else bh // heads * kv_heads
    q, k, v, do = _arrays(lq * 7 + lk, (bh, lq, D), (bkv, lk, D),
                          (bkv, lk, D), (bh, lq, D))
    sm = D ** -0.5
    bq, bk = jfa._pick_block(lq), jfa._pick_block(lk)
    o, lse = jfa._fa_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal, sm, bq, bk, None, kv_valid, heads,
                             kv_heads)
    got_o, got_lse = tf.fa_forward(_t(q), _t(k), _t(v), causal, sm,
                                   kv_valid=kv_valid, heads=heads,
                                   kv_heads=kv_heads)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(o), **FWD)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), **FWD)
    if heads is not None:       # the backward takes MHA shapes
        g = heads // kv_heads
        k = np.repeat(k.reshape(bh // heads, kv_heads, lk, D), g,
                      axis=1).reshape(bh, lk, D)
        v = np.repeat(v.reshape(bh // heads, kv_heads, lk, D), g,
                      axis=1).reshape(bh, lk, D)
    want = jfa._fa_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            o, lse, jnp.asarray(do), causal, sm, bq, bk,
                            None, kv_valid)
    got = tf.fa_backward(_t(q), _t(k), _t(v), got_o, got_lse, _t(do), causal,
                         sm, kv_valid=kv_valid)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **GRAD)


def test_fully_masked_rows_are_exact_zeros():
    """Causal Lq > Lk: rows i < Lq - Lk see no key, so their output, lse
    floor and gradients are exact (output and dq zero, all finite)."""
    q, k, v, do = _arrays(5, (2, 64, D), (2, 32, D), (2, 32, D), (2, 64, D))
    o, lse = tf.fa_forward(_t(q), _t(k), _t(v), True, D ** -0.5)
    assert torch.equal(o[:, :32], torch.zeros_like(o[:, :32]))
    assert torch.all(lse[:, :32] < -1e29)
    dq, dk, dv = tf.fa_backward(_t(q), _t(k), _t(v), o, lse, _t(do), True,
                                D ** -0.5)
    assert torch.equal(dq[:, :32], torch.zeros_like(dq[:, :32]))
    assert all(torch.isfinite(t).all() for t in (dq, dk, dv))


def _jax_grads(q, k, v, causal):
    from horovod_tpu.ops.pallas import flash_attention

    def loss(a, b, c):
        return jnp.sum(flash_attention(a, b, c, causal=causal) ** 2)

    out = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("L,heads,kv_heads", [(64, 2, 2), (100, 2, 2),
                                              (64, 4, 2)])
def test_autograd_matches_jax_grad(causal, L, heads, kv_heads):
    """(B, L, H, D) attention and its gradients; at L = 100 JAX pads to 128
    and masks, the port runs the ragged length as it is; (4, 2) is GQA with
    dK/dV group-summed onto the narrow heads."""
    q, k, v = _arrays(L + heads, (2, L, heads, D), (2, L, kv_heads, D),
                      (2, L, kv_heads, D))
    want_out, want = _jax_grads(q, k, v, causal)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = tf.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(out.detach().numpy(), want_out, **FWD)
    (out ** 2).sum().backward()
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=name, **GRAD)


def test_indivisible_heads_raise():
    q = torch.zeros(1, 8, 4, D)
    k = torch.zeros(1, 8, 3, D)
    with pytest.raises(ValueError, match="divide"):
        tf.flash_attention(q, k, k)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    counts = (tf.fwd_launches, tf.bwd_dq_launches, tf.bwd_dkv_launches)
    q, k, v = (torch.randn(1, 8, 2, D, requires_grad=True) for _ in range(3))
    tf.flash_attention(q, k, v, causal=True).sum().backward()
    assert (tf.fwd_launches, tf.bwd_dq_launches,
            tf.bwd_dkv_launches) == counts


def test_device_and_shape_checks():
    """Neither a non-CPU, non-CUDA device nor mismatched shapes reach a
    kernel: each raises a named error."""
    meta = torch.empty(2, 8, D, device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tf.fa_forward(meta, meta, meta, False, 1.0)
    q = torch.zeros(4, 8, D)
    with pytest.raises(ValueError, match="grouped-query"):
        tf.fa_forward(q, q[:2], q[:2], False, 1.0)
    with pytest.raises(ValueError, match="do not fit"):
        tf.fa_forward(q, q[:3], q[:3], False, 1.0, heads=4, kv_heads=2)
    with pytest.raises(TypeError, match="mix"):
        tf.fa_forward(q, q.double(), q, False, 1.0)
