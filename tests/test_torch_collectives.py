"""The port's collectives, run by 2 gloo processes, against the JAX
package's eager collectives on the same per-rank rows (a 2-member process
set on the 8-device CPU mesh, each rank's tensor one row of the stack).

Tolerances:
- fp32 Sum, Min, Max and Product: exact (the same fp32 operations in the
  same order on both sides).
- fp32 Average: rtol 1e-6. The port folds Average's 1/n into the unpack's
  postscale; JAX divides, then postscales.
- fp16/bf16: within two roundings of the dtype at the inputs' scale. The
  port scales in fp32 and rounds once (the scale kernel's contract); the
  JAX eager path scales in the buffer dtype, so the two can differ by one
  rounding wherever a scale is not a power of two.
- Fused against unfused Sum: bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as helpers

OPS = ["Sum", "Average", "Min", "Max", "Product"]
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "float16": jnp.float16}
SCALES = [(1.0, 1.0), (0.5, 3.0), (1.0 / 3.0, 1.0 / 3.0)]
CASES = [(op, dt, pre, post) for op in OPS for dt in DTYPES
         for pre, post in SCALES]
SIZES = (7, 1, 0, 33, 300)
_EPS = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}


@pytest.fixture(scope="module")
def rows():
    rng = np.random.default_rng(7)
    return {dt: rng.standard_normal((2, 5, 3)).astype(np.float32)
            for dt in DTYPES}


@pytest.fixture(scope="module")
def port(rows):
    return helpers.run_world(helpers.collectives, 2,
                             args=(rows, CASES, SIZES))


@pytest.fixture(scope="module")
def pair_set(hvd):
    ps = hvd.add_process_set(hvd.ProcessSet([0, 1]))
    yield ps
    hvd.remove_process_set(ps)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_allreduce_matches_jax(hvd, pair_set, rows, port, case):
    op, dt, pre, post = case
    ref = np.asarray(hvd.allreduce(jnp.asarray(rows[dt], DTYPES[dt]),
                                   op=getattr(hvd, op), prescale_factor=pre,
                                   postscale_factor=post,
                                   process_set=pair_set), np.float32)
    for rank in range(2):
        got = port[rank][("allreduce", op, dt, pre, post)]
        if dt == "float32" and op != "Average":
            np.testing.assert_array_equal(got, ref[rank])
        elif dt == "float32":
            np.testing.assert_allclose(got, ref[rank], rtol=1e-6, atol=0)
        else:
            eps = _EPS[dt]
            scale = max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(got, ref[rank], rtol=2 * eps,
                                       atol=2 * eps * scale)


def test_fused_equals_unfused_sum(port):
    for rank in range(2):
        for fused, single in zip(port[rank]["grouped"],
                                 port[rank]["unfused"]):
            assert fused.tobytes() == single.tobytes()
    # ... and both are the elementwise sum of the two ranks' tensors.
    for got, a, b in zip(port[0]["grouped"], port[0]["inputs"],
                         port[1]["inputs"]):
        np.testing.assert_array_equal(got, a + b)


def test_grouped_sum_matches_jax(hvd, pair_set, port):
    stacks = [jnp.asarray(np.stack([a, b]))
              for a, b in zip(port[0]["inputs"], port[1]["inputs"])]
    refs = hvd.grouped_allreduce(stacks, op=hvd.Sum, process_set=pair_set)
    for rank in range(2):
        for got, ref in zip(port[rank]["grouped"], refs):
            np.testing.assert_array_equal(got, np.asarray(ref)[rank])


def test_inplace_async_and_compression(port):
    for rank in range(2):
        out = port[rank]
        assert out["poll_type"] == "bool"
        assert out["inplace_is_a"]
        np.testing.assert_array_equal(out["inplace"], out["grouped"][0])
        for got, ref in zip(out["grouped_inplace"], out["grouped"]):
            np.testing.assert_array_equal(got, ref)
        # fp16 wire: back in fp32, within fp16 rounding of the inputs and sum.
        assert out["fp16_dtype"] == "torch.float32"
        np.testing.assert_allclose(out["fp16"], out["grouped"][1],
                                   rtol=2 * _EPS["float16"], atol=1e-3)
        assert out["int_sum"] == [3, 20]


def test_broadcast_matches_jax(hvd, pair_set, rows, port):
    ref = np.asarray(hvd.broadcast(jnp.asarray(rows["float32"]), 1,
                                   process_set=pair_set))
    for rank in range(2):
        np.testing.assert_array_equal(port[rank]["broadcast"], ref[rank])
        np.testing.assert_array_equal(port[rank]["broadcast_"], ref[rank])
        assert port[rank]["object"] == {"from": 1, "x": [1, 1, 1]}


def test_threshold_splits_buckets(port):
    # The JAX runtime's rule at a 100-byte threshold, fp32: the third 10
    # takes the pending bytes to 120 and flushes [10, 10, 10], which splits
    # where the next 10 would pass the threshold; 30 elements (120 bytes)
    # flush alone; the 5-element tail and the group of 2x30 flush together
    # and form two buckets, the group one bucket whatever the threshold.
    for rank in range(2):
        assert port[rank]["buckets"] == [[10, 10], [10], [30], [5],
                                         [30, 30]]
        for got in port[rank]["split_values"]:
            np.testing.assert_array_equal(got, np.full(got.shape, 3.0))


def test_mismatched_buckets_raise_named_error(port):
    assert [port[r]["mismatch"] for r in range(2)] == \
        ["TensorShapeMismatchError"] * 2
