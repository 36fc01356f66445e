"""The rest of the port's collective surface — ragged allgather, alltoall
(equal and with splits), reducescatter (grouped too), allgather_object and
sparse_allreduce_async — run by a 3-rank and a 2-rank gloo world, against
the JAX package's eager collectives on the same per-rank rows (a 3- and a
2-member process set of the 8-device CPU mesh, each rank's tensor one row
of the stack, or one entry of the list for the ragged gather).

Tolerances:
- allgather, alltoall and allgather_object move data: bit-equal.
- reducescatter fp32: rtol 1e-6 of the output's scale. Both sum three fp32
  values in some order; JAX divides by n and then postscales, rounding
  twice, where the port folds 1/n into the postscale and rounds once.
- reducescatter bf16: within two roundings of bf16 (2^-7 relative) at the
  output's scale: the port scales in fp32 and rounds once (the scale
  kernel's contract), JAX in bf16 after each of its steps.
- float64 reducescatter: the port keeps float64; JAX, with x64 off,
  computes in fp32: held to the fp32 tolerance. int64 Sum: exact.
- sparse allreduce: the coalesced sum (or average) of every rank's
  entries, rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as helpers
from torch_shared import shared

RS_CASES = [(op, dt, pre, post) for op in ("Sum", "Average")
            for dt in ("float32", "bfloat16")
            for pre, post in ((1.0, 1.0), (0.5, 3.0))]
_BF16_EPS = 2.0 ** -7


def _data(n, seed):
    """Per-rank inputs of an n-rank world (lists, one entry per rank)."""
    rng = np.random.default_rng(seed)

    def rows(*shape, dtype=np.float32):
        return [rng.standard_normal(shape).astype(dtype) for _ in range(n)]
    splits = [rng.integers(0, 3, n) for _ in range(n)]
    return {
        "ragged": [rng.standard_normal((r + 1, 3)).astype(np.float32)
                   for r in range(n)],
        "ragged_int": [rng.integers(-9, 9, (2 * r, 2)) for r in range(n)],
        "ragged_empty": [rng.standard_normal((0 if r == 1 else r + 2,))
                         .astype(np.float32) for r in range(n)],
        "a2a": rows(2 * n, 4),
        "a2a_rows": rows(2 * n + 1, 3),
        "splits": [s.astype(np.int64) for s in splits],
        "rs": rows(2 * n, 3),
        "rs_b": rows(n, 5),
        "rs_c": rows(4 * n),
        "rs_int": [rng.integers(-9, 9, (n, 2)) for _ in range(n)],
        "dense": [np.where(rng.random((4, 3)) < 0.4,
                           rng.standard_normal((4, 3)), 0.0)
                  .astype(np.float32) for _ in range(n)],
    }


DATA = {3: _data(3, 21), 2: _data(2, 22)}


@pytest.fixture(scope="module")
def runs(hvd, tmp_path_factory):
    """The worlds and the JAX references, once for the whole run
    (``torch_shared.shared``); the references are computed while the
    worlds run."""
    def compute():
        futures = {n: helpers.run_world_async(helpers.collectives_surface,
                                              n, args=(DATA[n], RS_CASES))
                   for n in (3, 2)}
        made = {n: hvd.add_process_set(hvd.ProcessSet(list(range(n))))
                for n in (3, 2)}
        try:
            ref = _refs(hvd, made)
        finally:
            for ps in made.values():
                hvd.remove_process_set(ps)
        return ref, {n: f.result() for n, f in futures.items()}
    return shared(tmp_path_factory, "collectives_surface_runs", compute)


@pytest.fixture(scope="module")
def refs(runs):
    return runs[0]


def _refs(hvd, sets):
    """The JAX references."""
    out = {}
    for n, ps in sets.items():
        data = DATA[n]
        stack = {k: jnp.asarray(np.stack(data[k]))
                 for k in ("a2a", "a2a_rows", "rs", "rs_b", "rs_c")}
        ref = {key: np.asarray(hvd.allgather_ragged(
            [jnp.asarray(a) for a in data[key]], process_set=ps))
            for key in ("ragged", "ragged_int", "ragged_empty")}
        ref["ragged_bf16"] = np.asarray(hvd.allgather_ragged(
            [jnp.asarray(a, jnp.bfloat16) for a in data["ragged"]],
            process_set=ps), np.float32)
        ref["a2a"] = np.asarray(hvd.alltoall(stack["a2a"], process_set=ps))
        rows, received = hvd.alltoall(stack["a2a_rows"],
                                      splits=np.stack(data["splits"]),
                                      process_set=ps)
        ref["a2a_splits"] = ([np.asarray(r) for r in rows],
                             np.asarray(received))
        for op, dt, pre, post in RS_CASES:
            ref[("rs", op, dt, pre, post)] = np.asarray(hvd.reducescatter(
                jnp.asarray(np.stack(data["rs"]), getattr(jnp, dt)),
                op=getattr(hvd, op), prescale_factor=pre,
                postscale_factor=post, process_set=ps), np.float64)
        ref["rs_group"] = [np.asarray(r) for r in hvd.grouped_reducescatter(
            [stack[k] for k in ("rs", "rs_b", "rs_c")], op=hvd.Average,
            prescale_factor=0.5, postscale_factor=3.0, process_set=ps)]
        ref["rs_f64"] = np.asarray(hvd.reducescatter(
            stack["rs"], op=hvd.Average, postscale_factor=3.0,
            process_set=ps))
        ref["objects"] = hvd.allgather_object(
            [{"rank": r, "x": [r] * r} for r in range(n)], process_set=ps)
        idx, vals = [], []
        for dense in data["dense"]:
            nz = np.nonzero(dense)
            idx.append(jnp.asarray(np.stack(nz, 1).astype(np.int64)))
            vals.append(jnp.asarray(dense[nz]))
        g_idx = np.asarray(hvd.allgather_ragged(idx, process_set=ps))
        total = np.zeros((4, 3), np.float32)
        np.add.at(total, tuple(g_idx.T),
                  np.asarray(hvd.allgather_ragged(vals, process_set=ps)))
        ref["sparse_sum"] = total
        out[n] = ref
    return out


@pytest.fixture(scope="module")
def port(runs):
    return runs[1]


WORLDS = pytest.mark.parametrize("n", [3, 2])


@WORLDS
def test_ragged_allgather_matches_jax(refs, port, n):
    data = DATA[n]
    for rank in range(n):
        out = port[n][rank]
        for key in ("ragged", "ragged_int", "ragged_empty"):
            ref = refs[n][key]
            assert out[key].shape == ref.shape, key
            np.testing.assert_array_equal(out[key], ref.astype(out[key].dtype))
        np.testing.assert_array_equal(out["ragged_bf16"],
                                      refs[n]["ragged_bf16"])
        np.testing.assert_array_equal(out["ragged_async"][0],
                                      np.concatenate(data["ragged"]))
        np.testing.assert_array_equal(out["ragged_async"][1],
                                      np.concatenate(data["ragged_int"]))


@WORLDS
def test_alltoall_matches_jax(refs, port, n):
    mat = np.stack(DATA[n]["splits"])
    rows, received = refs[n]["a2a_splits"]
    for rank in range(n):
        out = port[n][rank]
        np.testing.assert_array_equal(out["a2a"], refs[n]["a2a"][rank])
        got, recv, dtype = out["a2a_splits"]
        assert recv == [int(v) for v in received[rank]] \
            == mat[:, rank].tolist()
        assert dtype == "torch.int64"
        np.testing.assert_array_equal(got, rows[rank])
        got, recv = out["a2a_splits_bf16"]
        assert recv == mat[:, rank].tolist()
        np.testing.assert_array_equal(
            got, np.asarray(jnp.asarray(rows[rank], jnp.bfloat16),
                            np.float32))


@WORLDS
@pytest.mark.parametrize("case", RS_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_reducescatter_matches_jax(refs, port, n, case):
    dt = case[1]
    ref = refs[n][("rs",) + case]
    scale = float(np.abs(ref).max())
    for rank in range(n):
        dtype, got = port[n][rank][("rs",) + case]
        assert dtype == f"torch.{dt}" and got.shape == ref[rank].shape
        eps = 1e-6 if dt == "float32" else 2 * _BF16_EPS
        np.testing.assert_allclose(got, ref[rank], rtol=eps,
                                   atol=eps * scale)


@WORLDS
def test_grouped_reducescatter_is_one_pack_and_unpack(refs, port, n):
    f64 = refs[n]["rs_f64"]
    ints = np.stack(DATA[n]["rs_int"]).sum(0).reshape(n, -1, 2)
    for rank in range(n):
        out = port[n][rank]
        assert out["rs_group_launches"] == {"pack": 1, "unpack": 1}
        for got, ref in zip(out["rs_group"], refs[n]["rs_group"]):
            np.testing.assert_allclose(got, ref[rank], rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max())
        np.testing.assert_allclose(out["rs_f64"], f64[rank], rtol=1e-6,
                                   atol=1e-6 * np.abs(f64).max())
        np.testing.assert_array_equal(out["rs_int"], ints[rank])


@WORLDS
def test_allgather_object_and_sparse_allreduce_match_jax(refs, port, n):
    objs = [{"rank": r, "x": [r] * r} for r in range(n)]
    assert refs[n]["objects"] == objs
    total = refs[n]["sparse_sum"]
    for rank in range(n):
        out = port[n][rank]
        assert out["objects"] == objs
        assert out["sparse_callable"]
        is_sparse, got = out["sparse"]
        assert is_sparse
        np.testing.assert_allclose(got, total / n, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(out["sparse_sum"], total, rtol=1e-6,
                                   atol=1e-7)


@WORLDS
def test_refusals_raise_named_errors_on_every_rank(port, n):
    want = {"rs_not_divisible": "TensorShapeMismatchError",
            "rs_min": "ValueError",
            "rs_shapes": "TensorShapeMismatchError",
            "allgather_tail": "TensorShapeMismatchError",
            "allgather_dtype": "TensorShapeMismatchError",
            "a2a_splits_length": "TensorShapeMismatchError",
            "a2a_splits_sum": "TensorShapeMismatchError",
            "a2a_not_divisible": "TensorShapeMismatchError",
            "a2a_tail": "TensorShapeMismatchError"}
    for rank in range(n):
        out = port[n][rank]
        assert out["errors"] == want
        assert out["ici_built"] is False
        assert out["after"] == [n * (n - 1) / 2] * 2
