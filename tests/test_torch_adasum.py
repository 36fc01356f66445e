"""The port's Adasum combine, tree and gathered-bucket reduction against the
JAX package's ``ops/adasum.py`` (``adasum_combine``, ``adasum_tree``) and the
Pallas kernel ``adasum_combine_pallas`` in interpret mode, as
tests/test_pallas.py runs it, on the same numpy inputs.

On the CPU the port's entry points take their plain PyTorch versions; the
CUDA kernel is held against those on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py).

Tolerances:
- fp32: rtol 1e-5, atol 1e-6 of the inputs' largest magnitude. Both sides
  sum dot and norms in fp32 but in another order, which moves a coefficient
  by ~1e-7 relative.
- bf16/fp16: two units in the last place of the dtype, at the same scale.
  Both compute in fp32 and round once; a coefficient 1e-7 apart can flip
  that rounding.
- float64: the port reads it into fp32, as JAX's ``adasum_combine`` casts to
  fp32; held to the fp32 tolerance against JAX's fp32 result.
- The edge cases with an exact answer (b = a gives a, b = 2a gives 1.5a,
  b = -a gives 0, a zero a gives b, orthogonal a and b give a + b) hold
  exactly in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops import adasum as jax_adasum
from horovod_tpu.ops.pallas import adasum_combine_pallas
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops.kernels import adasum as kernel

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16),
          "float64": (torch.float64, jnp.float32)}
_ULP = {"float32": None, "float64": None, "bfloat16": 2.0 ** -7,
        "float16": 2.0 ** -10}
# (name, shape); the inputs of each are made by _pair. Few distinct shapes:
# JAX compiles the reference once per shape and dtype.
CASES = [("random", (257,)), ("random", (7,)), ("random", (4097,)),
         ("random", (100_003,)), ("one", (1,)), ("empty", (0,)),
         ("zero_a", (257,)), ("b_is_a", (257,)), ("b_is_2a", (257,)),
         ("b_is_minus_a", (257,)), ("orthogonal", (257,))]
EXACT = {"zero_a": lambda a, b: b, "b_is_a": lambda a, b: a,
         "b_is_2a": lambda a, b: 1.5 * a,
         "b_is_minus_a": lambda a, b: np.zeros_like(a),
         "orthogonal": lambda a, b: a + b}
# Pallas in interpret mode costs ~0.3 s a call: a random pair in each dtype
# and the exact fp32 cases.
PALLAS_CASES = [(dt, ("random", (33, 17))) for dt in
                ("float32", "bfloat16", "float16")] + [
    ("float32", c) for c in CASES if c[0] in EXACT]
SEGMENTS = (7, 0, 1, 300, 4097, 33)


def _pair(name, shape, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    if name == "zero_a":
        a = np.zeros_like(a)
    elif name == "b_is_a":
        b = a.copy()
    elif name == "b_is_2a":
        b = 2 * a
    elif name == "b_is_minus_a":
        b = -a
    elif name == "orthogonal":
        a[shape[0] // 2:] = 0
        b[:shape[0] // 2] = 0
    return a, b


def _close(got, ref, dtype, scale):
    ulp = _ULP[dtype]
    if ulp is None:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 * ulp,
                                   atol=2 * ulp * scale)


_jax_combine = jax.jit(jax_adasum.adasum_combine)


def _check_combine(dtype, case, reference):
    name, shape = case
    tdt, jdt = DTYPES[dtype]
    a, b = _pair(name, shape)
    got = adasum.adasum_combine(torch.from_numpy(a).to(tdt),
                                torch.from_numpy(b).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.double().numpy()
    ref = reference(jnp.asarray(a, jdt), jnp.asarray(b, jdt))
    scale = max(1.0, float(np.abs(np.concatenate([a.ravel(), b.ravel()]))
                       .max(initial=0)))
    _close(got, np.asarray(ref, np.float64), dtype, scale)
    if name in EXACT and dtype == "float32":
        np.testing.assert_array_equal(got, EXACT[name](a, b))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{c[1]}")
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_combine_matches_jax(dtype, case):
    _check_combine(dtype, case, _jax_combine)


@pytest.mark.parametrize("dtype,case", PALLAS_CASES,
                         ids=lambda c: f"{c[0]}{c[1]}"
                         if isinstance(c, tuple) else c)
def test_combine_matches_pallas_interpret(dtype, case):
    _check_combine(dtype, case, adasum_combine_pallas)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_tree_matches_jax(n):
    rows = np.random.default_rng(n).standard_normal((n, 257)).astype(
        np.float32)
    got = adasum.adasum_tree([torch.from_numpy(r) for r in rows]).numpy()
    ref = np.asarray(jax_adasum.adasum_tree([jnp.asarray(r) for r in rows]))
    _close(got, ref, "float32", float(np.abs(rows).max()))
    # The gathered form on one segment is the same tree, bit for bit.
    gathered = torch.from_numpy(rows.copy())
    np.testing.assert_array_equal(
        adasum.reduce_gathered(gathered, (257,)).numpy(), got)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_gathered_bucket_takes_per_tensor_norms(n):
    """reduce_gathered on a bucket of tensors equals each tensor's own JAX
    tree (and the plain reduce_gathered_reference), and a control that
    takes whole-bucket norms does not."""
    total = sum(SEGMENTS)
    rng = np.random.default_rng(10 + n)
    # Tensors at different scales, so the per-tensor coefficients differ.
    scales = np.repeat([0.01, 1.0, 3.0, 0.2, 1.0, 50.0], SEGMENTS)
    rows = (rng.standard_normal((n, total)) * scales).astype(np.float32)
    got = adasum.reduce_gathered(torch.from_numpy(rows.copy()),
                                 SEGMENTS).numpy().copy()
    plain = kernel.reduce_gathered_reference(torch.from_numpy(rows),
                                             SEGMENTS).numpy()
    np.testing.assert_array_equal(got, plain)
    ref, off = [], 0
    for k in SEGMENTS:
        ref.append(np.asarray(jax_adasum.adasum_tree(
            [jnp.asarray(r[off:off + k]) for r in rows])))
        off += k
    ref = np.concatenate(ref)
    scale = float(np.abs(rows).max())
    _close(got, ref, "float32", scale)
    control = np.asarray(jax_adasum.adasum_tree(
        [jnp.asarray(r) for r in rows]))
    with pytest.raises(AssertionError):
        _close(control, ref, "float32", scale)


def test_cpu_path_launches_nothing():
    kernel.reset_launch_counts()
    g = torch.randn(4, 300)
    adasum.reduce_gathered(g, (100, 0, 200))
    adasum.adasum_combine(torch.randn(5), torch.randn(5))
    assert kernel.launches == 0


def test_segment_table_blocks_and_cache():
    numels = (0, 1, 4096, 4097, 5_000_000)
    t = kernel.segment_table(numels, torch.device("cpu"))
    assert kernel.segment_table(list(numels), torch.device("cpu")) is t
    assert t.segments == [(0, 0), (0, 1), (1, 4096), (4097, 4097),
                          (8194, 5_000_000)]
    assert t.total == 5_008_194
    # 4096 elements a block, none for an empty segment, at most 1024.
    assert t.n_blocks == 0 + 1 + 1 + 2 + 1024
    assert t.rows is None          # the card's table exists on the card only


@pytest.mark.parametrize("case", ["int_dtype", "mixed_dtype", "size",
                                  "non_contiguous", "two_d"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    a, b, out = torch.ones(6), torch.ones(6), torch.empty(6)
    table = kernel.segment_table((4, 2), torch.device("cpu"))
    if case == "int_dtype":
        a, b, out = a.int(), b.int(), out.int()
    elif case == "mixed_dtype":
        b = b.half()
    elif case == "size":
        out = torch.empty(7)
    elif case == "non_contiguous":
        a = torch.ones(6, 2)[:, 0]
    elif case == "two_d":
        a = torch.ones(2, 3)
    with pytest.raises((TypeError, ValueError)):
        kernel.combine_segments(a, b, out, table)
