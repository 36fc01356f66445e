"""The port's Adasum allreduce and allgather, run by 3 gloo processes, against
the JAX package's eager ``hvd.allreduce(..., op=hvd.Adasum)`` and
``hvd.allgather`` on a 3-member process set of the 8-device CPU mesh (each
rank's tensor one row of the stack). Three ranks make the tree carry an odd
one: ((r0, r1), r2).

Tolerances:
- fp32: rtol 1e-5, atol 1e-6 of the inputs' largest magnitude. Both sides
  compute the dot products and norms in fp32, in another order, which moves
  a coefficient by ~1e-7 relative.
- bf16/fp16: two units in the last place of the dtype at the same scale.
  Both round to the dtype after each of the two combines; a coefficient
  1e-7 apart can flip a rounding. The prescale 0.5 is exact on both sides
  and the postscale 3.0 rounds the same value once on both.
- float64: the port reads it into fp32 (the combine's contract); JAX, with
  x64 off, computes in fp32. Held to the fp32 tolerance.
- allgather: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as helpers

CASES = [("float32", 1.0, 1.0), ("float32", 0.5, 3.0),
         ("bfloat16", 1.0, 1.0), ("bfloat16", 0.5, 3.0),
         ("float16", 1.0, 1.0), ("float16", 0.5, 3.0),
         ("float64", 1.0 / 3.0, 1.0)]
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
              "float16": jnp.float16, "float64": jnp.float32}
_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
GROUP_SIZES = (7, 0, 1, 300, 33)


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(11).standard_normal((3, 5, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def port_future(rows):
    return helpers.run_world_async(helpers.adasum_collectives, 3,
                                   args=(rows, CASES, GROUP_SIZES))


@pytest.fixture(scope="module")
def trio(hvd, port_future):
    ps = hvd.add_process_set(hvd.ProcessSet([0, 1, 2]))
    yield ps
    hvd.remove_process_set(ps)


@pytest.fixture(scope="module")
def port(port_future, trio):
    return port_future.result()


def _close(got, ref, dtype, scale):
    if dtype in _ULP:
        ulp = _ULP[dtype]
        np.testing.assert_allclose(got, ref, rtol=2 * ulp,
                                   atol=2 * ulp * scale)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_allreduce_adasum_matches_jax(hvd, trio, rows, port, case):
    dt, pre, post = case
    ref = np.asarray(hvd.allreduce(jnp.asarray(rows, JAX_DTYPES[dt]),
                                   op=hvd.Adasum, prescale_factor=pre,
                                   postscale_factor=post, process_set=trio),
                     np.float64)
    scale = float(np.abs(rows).max()) * pre * post
    for rank in range(3):
        dtype, got = port[rank][("allreduce",) + case]
        assert dtype == f"torch.{dt}"
        _close(got, ref[rank], dt, scale)


def test_grouped_adasum_shares_one_bucket_with_per_tensor_norms(hvd, trio,
                                                                port):
    stacks = [np.stack([port[r]["group_inputs"][i] for r in range(3)])
              for i in range(len(GROUP_SIZES))]
    refs = hvd.grouped_allreduce([jnp.asarray(s) for s in stacks],
                                 op=hvd.Adasum, process_set=trio)
    scale = max(float(np.abs(s).max(initial=0)) for s in stacks)
    for rank in range(3):
        assert port[rank]["group_buckets"] == [list(GROUP_SIZES)]
        for got, ref in zip(port[rank]["grouped"], refs):
            _close(got, np.asarray(ref)[rank], "float32", scale)
    # One combine over the whole bucket (shared coefficients) is another
    # result: the bucket kept each tensor's own norms.
    whole = np.asarray(hvd.allreduce(
        jnp.asarray(np.concatenate(stacks, axis=1)), op=hvd.Adasum,
        process_set=trio))[0]
    with pytest.raises(AssertionError):
        _close(np.concatenate(port[0]["grouped"]), whole, "float32", scale)


def test_adasum_through_fp16_compression(port):
    for rank in range(3):
        dtype, got = port[rank]["fp16_wire"]
        assert dtype == "torch.float32"
        scale = float(np.abs(port[rank]["grouped"][-1]).max())
        _close(got, port[rank]["grouped"][-1], "float16", scale)


def test_adasum_refuses_integer_tensors(port):
    for rank in range(3):
        assert port[rank]["int"].startswith("TypeError: Adasum combines "
                                            "floating-point tensors")


def test_allgather_matches_jax(hvd, trio, rows, port):
    ref = np.asarray(hvd.allgather(jnp.asarray(rows), process_set=trio))
    for rank in range(3):
        out = port[rank]
        np.testing.assert_array_equal(out["allgather"], ref[rank])
        np.testing.assert_array_equal(out["allgather_async"],
                                      rows[:, 0].reshape(-1))
        assert out["allgather_int"] == [[0, 0], [1, 10], [2, 20]]
        assert out["allgather_scalar"] == [0.5, 1.5, 2.5]
        np.testing.assert_array_equal(out["grouped_allgather"][0], ref[rank])
        np.testing.assert_array_equal(out["grouped_allgather"][1],
                                      ref[rank][:, :1])
        # Ragged first dims gather; a mismatch beyond dim 0 is refused.
        assert out["ragged"] == [0.0, 1.0, 1.0, 2.0, 2.0, 2.0]
        assert out["ragged_tail"] == "TensorShapeMismatchError"
