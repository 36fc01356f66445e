"""The bound that the port's bf16/fp16 flash kernels are held to, on the CPU.

The tensor-core forward, dQ and dK/dV kernels round P (forward, dV) and dS
(dQ, dK) to the inputs' dtype before a product; JAX's Pallas kernels and the
port's default plain versions keep them in fp32. ``block_fwd_reference`` and
``block_bwd_reference`` with ``round_p`` round where the kernels do, and
``rounding_bounds`` states how far two versions that differ by one such
rounding may lie apart:

    |a - b| <= 2 ulp(|b|) + c (u |A| |B| + eta n)

Here the rounding plain version is held to it against the fp32 plain
version and against the interpreted Pallas kernels (JAX pads L = 100 and
197 to a block multiple and masks the padding with ``kv_valid``), and
three deliberately wrong versions must fail it: the causal diagonal off by
one, dK and dV swapped, and dQ computed with V in place of K. Small shapes:
L = 100 and 197, D = 16 and 64, bf16 and fp16, GQA in the forward.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops.kernels import flash_attention as tf

jfa = importlib.import_module("horovod_tpu.ops.pallas.flash_attention")

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}
# (L, D, dtype, GQA in the forward): 4 query heads over 2 kv heads, or MHA.
CASES = [(L, d, dt, gqa) for L in (100, 197) for d in (16, 64)
         for dt in DTYPES for gqa in (L == 197,)]
HEADS, KV_HEADS = 4, 2


def _inputs(L, d, dt, gqa, seed=0):
    """q, do (4, L, d); k, v (2 or 4, L, d) in ``dt``, from numpy."""
    rng = np.random.default_rng(seed + L * 7 + d)
    bkv = KV_HEADS if gqa else HEADS
    q, do = (rng.standard_normal((HEADS, L, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((bkv, L, d)).astype(np.float32)
            for _ in range(2))
    return [torch.from_numpy(a).to(DTYPES[dt]) for a in (q, k, v, do)]


def _mha(t, gqa):
    """k or v broadcast to the query rows, as the plain forward takes them."""
    if not gqa:
        return t
    return tf.gqa_repeat3(t, 1, KV_HEADS, HEADS // KV_HEADS)


def _ratio(got, want, bound):
    return tf.bound_ratio(got, want, bound)


def _forward(L, d, dt, gqa, round_p, q_offset=None):
    q, k, v, _ = _inputs(L, d, dt, gqa)
    k, v = _mha(k, gqa), _mha(v, gqa)
    return tf.block_fwd_reference(q, k, v, True, d ** -0.5, q_offset,
                                  round_p=round_p)


def _backward(L, d, dt, gqa, round_p, q_offset=None):
    """(dq, dk, dv) against the fp32 plain forward's o and lse."""
    q, k, v, do = _inputs(L, d, dt, gqa)
    k, v = _mha(k, gqa), _mha(v, gqa)
    o, lse = tf.block_fwd_reference(q, k, v, True, d ** -0.5)
    return tf.block_bwd_reference(q, k, v, o, lse, do, True, d ** -0.5,
                                  q_offset, round_p=round_p)


def _bounds(L, d, dt, gqa, plain):
    q, k, v, do = _inputs(L, d, dt, gqa)
    k, v = _mha(k, gqa), _mha(v, gqa)
    o, lse = tf.block_fwd_reference(q, k, v, True, d ** -0.5)
    return tf.rounding_bounds(plain, q, k, v, True, d ** -0.5, o3=o,
                              lse=lse, do3=do)


@pytest.mark.parametrize("L,d,dt,gqa", CASES)
def test_rounding_plain_within_bound_of_fp32_plain(L, d, dt, gqa):
    o_r, lse_r = _forward(L, d, dt, gqa, DTYPES[dt])
    o_f, lse_f = _forward(L, d, dt, gqa, None)
    dq_r, dk_r, dv_r = _backward(L, d, dt, gqa, DTYPES[dt])
    dq_f, dk_f, dv_f = _backward(L, d, dt, gqa, None)
    bounds = _bounds(L, d, dt, gqa, {"o": o_r, "dq": dq_r, "dk": dk_r,
                                     "dv": dv_r})
    for name, got, want in (("o", o_f, o_r), ("dq", dq_f, dq_r),
                            ("dk", dk_f, dk_r), ("dv", dv_f, dv_r)):
        assert _ratio(got, want, bounds[name]) <= 1.0, name
    assert torch.equal(lse_r, lse_f)        # l is summed in fp32 on both


@pytest.mark.parametrize("L,d,dt,gqa", CASES)
def test_rounding_changes_only_dk_and_dv_in_the_backward(L, d, dt, gqa):
    """round_p rounds dS for dQ as well as for dK (and P for dV), as the
    tensor-core dQ and dK/dV kernels do: dq, dk and dv all change, and the
    recomputed P the backward starts from does not (dv without rounding
    equals P^T dO in fp32 on both)."""
    dq_r, dk_r, dv_r = _backward(L, d, dt, gqa, DTYPES[dt])
    dq_f, dk_f, dv_f = _backward(L, d, dt, gqa, None)
    for name, r, f in (("dq", dq_r, dq_f), ("dk", dk_r, dk_f),
                       ("dv", dv_r, dv_f)):
        assert not torch.equal(r, f), name


def _pad(a, lp):
    """Zero rows from L up to lp on axis 1 (numpy, fp32)."""
    out = np.zeros(a.shape[:1] + (lp,) + a.shape[2:], np.float32)
    out[:, :a.shape[1]] = a
    return out


@pytest.mark.parametrize("L,d,dt,gqa", [(100, 16, "bfloat16", False),
                                        (197, 64, "float16", True)])
def test_rounding_plain_within_bound_of_pallas(L, d, dt, gqa):
    """The interpreted Pallas kernels keep P and dS in fp32: one rounding
    from the rounding plain version. JAX pads to a block multiple and masks
    the padding through kv_valid (q_offset stays Lk - Lq = 0)."""
    q, k, v, do = _inputs(L, d, dt, gqa)
    lp, sm, jdt = 128 * -(-L // 128), d ** -0.5, getattr(jnp, dt)
    pj = [jnp.asarray(_pad(t.float().numpy(), lp), jdt) for t in (q, k, v)]
    o_j, lse_j = jfa._fa_forward(*pj, True, sm, 128, 128, None, L,
                                 HEADS if gqa else None,
                                 KV_HEADS if gqa else None)
    km, vm = _mha(k, gqa), _mha(v, gqa)
    o_r, lse_r = tf.block_fwd_reference(q, km, vm, True, sm,
                                        round_p=DTYPES[dt])
    o_f, lse_f = tf.block_fwd_reference(q, km, vm, True, sm)
    o_j = torch.from_numpy(np.asarray(o_j, np.float32)[:, :L])
    lse_j = torch.from_numpy(np.asarray(lse_j, np.float32)[:, :L])
    bound = tf.rounding_bounds({"o": o_r}, q, km, vm, True, sm)["o"]
    assert _ratio(o_j, o_r, bound) <= 1.0
    np.testing.assert_allclose(lse_j.numpy(), lse_r.numpy(), rtol=1e-5,
                               atol=1e-4)
    # The backward on MHA shapes, against the fp32 plain forward's o, lse.
    bj = [jnp.asarray(_pad(t.float().numpy(), lp), jdt)
          for t in (q, km, vm, o_f, do)]
    lse_p = jnp.asarray(_pad(lse_f.numpy()[..., None], lp)[..., 0])
    dq_j, dk_j, dv_j = jfa._fa_backward(bj[0], bj[1], bj[2], bj[3], lse_p,
                                        bj[4], True, sm, 128, 128, None, L)
    dq_r, dk_r, dv_r = tf.block_bwd_reference(q, km, vm, o_f, lse_f, do,
                                              True, sm, round_p=DTYPES[dt])
    bounds = tf.rounding_bounds({"dq": dq_r, "dk": dk_r, "dv": dv_r}, q, km,
                                vm, True, sm, o3=o_f, lse=lse_f, do3=do)
    for name, got, want in (("dq", dq_j, dq_r), ("dk", dk_j, dk_r),
                            ("dv", dv_j, dv_r)):
        got = torch.from_numpy(np.asarray(got, np.float32)[:, :L])
        assert _ratio(got, want, bounds[name]) <= 1.0, name


@pytest.mark.parametrize("shift", [1, -1])
@pytest.mark.parametrize("L,d,dt,gqa", CASES)
def test_off_by_one_diagonal_fails_the_bound(L, d, dt, gqa, shift):
    """A version whose rows see one key more (or less) than the causal
    diagonal allows: its o, dQ, dK and dV each fall outside the bound."""
    o_r, _ = _forward(L, d, dt, gqa, DTYPES[dt])
    o_c, _ = _forward(L, d, dt, gqa, DTYPES[dt], q_offset=shift)
    dq_r, dk_r, dv_r = _backward(L, d, dt, gqa, DTYPES[dt])
    dq_c, dk_c, dv_c = _backward(L, d, dt, gqa, DTYPES[dt], q_offset=shift)
    bounds = _bounds(L, d, dt, gqa, {"o": o_r, "dq": dq_r, "dk": dk_r,
                                     "dv": dv_r})
    for name, got, want in (("o", o_c, o_r), ("dq", dq_c, dq_r),
                            ("dk", dk_c, dk_r), ("dv", dv_c, dv_r)):
        assert _ratio(got, want, bounds[name]) > 1.0, name


@pytest.mark.parametrize("L,d,dt,gqa", CASES)
def test_swapped_dkv_fails_the_bound(L, d, dt, gqa):
    _, dk_r, dv_r = _backward(L, d, dt, gqa, DTYPES[dt])
    bounds = _bounds(L, d, dt, gqa, {"dk": dk_r, "dv": dv_r})
    assert _ratio(dv_r, dk_r, bounds["dk"]) > 1.0
    assert _ratio(dk_r, dv_r, bounds["dv"]) > 1.0


@pytest.mark.parametrize("L,d,dt,gqa", CASES)
def test_dq_with_v_for_k_fails_the_bound(L, d, dt, gqa):
    """dQ = dS V instead of dS K (the operand the dQ kernel reads both ways
    swapped for the other tile it holds) falls outside the bound."""
    q, k, v, do = _inputs(L, d, dt, gqa)
    k, v = _mha(k, gqa), _mha(v, gqa)
    sm = d ** -0.5
    o, lse = tf.block_fwd_reference(q, k, v, True, sm)
    dq_r, _, _ = tf.block_bwd_reference(q, k, v, o, lse, do, True, sm,
                                        round_p=DTYPES[dt])
    # The rounded dS, as block_bwd_reference forms it, times K and times V.
    _, p, _ = tf._probs(q, k, True, sm, None, None, lse)
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    delta = (do.float() * o.float()).sum(dim=-1)
    ds = tf._rounded(p * (dp - delta[..., None]) * sm, DTYPES[dt])
    dq_k, dq_v = (torch.einsum("bqk,bkd->bqd", ds, t.float()).to(q.dtype)
                  for t in (k, v))
    assert torch.equal(dq_k, dq_r)
    bound = _bounds(L, d, dt, gqa, {"dq": dq_r})["dq"]
    assert _ratio(dq_v, dq_r, bound) > 1.0


def test_ulp_and_fully_masked_rows():
    """ulp at 1, 1.5 and 0 in each dtype; causal Lq > Lk rows that see no key
    are exact zeros in the rounding versions and bound only by the
    subnormal step."""
    one = torch.tensor([1.0, 1.5, 0.0])
    assert tf.ulp(one, torch.bfloat16).tolist() == [2.0 ** -7, 2.0 ** -7,
                                                    2.0 ** -133]
    assert tf.ulp(one, torch.float16).tolist() == [2.0 ** -10, 2.0 ** -10,
                                                   2.0 ** -24]
    g = torch.Generator().manual_seed(3)
    q, do = (torch.randn(2, 64, 16, generator=g).bfloat16() for _ in range(2))
    k, v = (torch.randn(2, 32, 16, generator=g).bfloat16() for _ in range(2))
    o, lse = tf.block_fwd_reference(q, k, v, True, 0.25,
                                    round_p=torch.bfloat16)
    assert torch.equal(o[:, :32], torch.zeros_like(o[:, :32]))
    bound = tf.rounding_bounds({"o": o}, q, k, v, True, 0.25)["o"]
    assert bound[:, :32].max().item() == 2 * 2.0 ** -133
    dq, dk, dv = tf.block_bwd_reference(q, k, v, o, lse, do, True, 0.25,
                                        round_p=torch.bfloat16)
    assert torch.equal(dq[:, :32], torch.zeros_like(dq[:, :32]))
    assert all(torch.isfinite(t.float()).all() for t in (dk, dv))
