"""The port's ``hvd.join`` in a 3-rank gloo world armed with
``HOROVOD_JOIN_MODE=1``, against the JAX package's join on a 3-member
process set of the 8-device CPU mesh (``tests/test_collectives.py``'s
contract cases): rank 2's data runs out first and it joins at once; ranks 0
and 1 run Sum, Average, Min, Max and Product through the fusion runtime and
unfused (float64, int64), a grouped allreduce, Adasum, allgather (equal and
ragged), reducescatter, broadcast, allgather_object and a barrier without
it; rank 1 joins; rank 0 runs one more allreduce alone and joins last, so
``join()`` returns 0 on every rank, and the state resets. Then a join
within process set [1, 2] returns the global rank 2. Without the flag,
join() in a world of two processes raises.

The JAX reference joins rank 2 (``hvd.join(2)``) and computes the same
collectives on the set; its joined rank is masked out of a single
program, where the port's joined process launches the same collective with
a neutral contribution. Tolerances: fp32 Sum, Min, Max, Product, allgather
and broadcast bit-equal (two addends or none); Average rtol 1e-6 (the port
folds 1/n into the postscale), as is a sum of all three ranks (added in
another order); Adasum rtol 1e-5 (dot products summed in
another order, as in test_torch_adasum_collectives.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_helpers as helpers

OPS = ("Sum", "Average", "Min", "Max", "Product")


def _data():
    rng = np.random.default_rng(31)
    return {"x": rng.standard_normal((3, 5)).astype(np.float32),
            "ints": rng.integers(-50, 50, (3, 4)),
            "ragged": [rng.standard_normal((r + 1, 2)).astype(np.float32)
                       for r in range(3)],
            "rs": rng.standard_normal((3, 6)).astype(np.float32)}


DATA = _data()


@pytest.fixture(scope="module")
def port_futures():
    return (helpers.run_world_async(helpers.join_world, 3, args=(DATA,),
                                    env={"HOROVOD_JOIN_MODE": "1"}),
            helpers.run_world_async(helpers.join_unarmed, 2))


@pytest.fixture(scope="module")
def refs(hvd, port_futures):
    """The JAX package's results with rank 2 joined, on a 3-member set;
    every rank joins in the end, which completes and resets the join."""
    trio = hvd.add_process_set(hvd.ProcessSet([0, 1, 2]))
    x = jnp.asarray(DATA["x"])
    out = {}
    hvd.join(2)
    try:
        for op in OPS:
            out[op] = np.asarray(hvd.allreduce(
                x, op=getattr(hvd, op), postscale_factor=2.0,
                process_set=trio))
        out["adasum"] = np.asarray(hvd.allreduce(x, op=hvd.Adasum,
                                                 process_set=trio))
        out["allgather"] = np.asarray(hvd.allgather(x, process_set=trio))
        out["ragged"] = np.asarray(hvd.allgather_ragged(
            [jnp.asarray(a) for a in DATA["ragged"]], process_set=trio))
        out["rs"] = np.asarray(hvd.reducescatter(
            jnp.asarray(DATA["rs"]), op=hvd.Average, process_set=trio))
        out["broadcast"] = np.asarray(hvd.broadcast(x, 1, process_set=trio))
    finally:
        for r in range(8):
            if r != 2:
                hvd.join(r)
        hvd.remove_process_set(trio)
    return out


@pytest.fixture(scope="module")
def port(port_futures, refs):
    return [f.result() for f in port_futures]


def test_join_returns_the_last_rank_and_resets(port):
    world, _ = port
    x = DATA["x"]
    for rank in range(3):
        out = world[rank]
        assert out["armed"] is True
        assert out["join"] == 0
        np.testing.assert_allclose(out["after"], x.sum(0), rtol=1e-6)
        np.testing.assert_allclose(out["end"], x.sum(0), rtol=1e-6)
    np.testing.assert_allclose(world[0]["alone"], x[0], rtol=1e-6)


@pytest.mark.parametrize("op", OPS)
def test_allreduce_excludes_the_joined_rank(refs, port, op):
    world, _ = port
    x = DATA["x"][:2].astype(np.float64)
    plain = {"Sum": x.sum(0), "Average": x.mean(0), "Min": x.min(0),
             "Max": x.max(0), "Product": x.prod(0)}[op]
    for rank in range(2):
        out = world[rank]
        fused = out[("fused", op)]
        if op == "Average":
            np.testing.assert_allclose(fused, refs[op][rank], rtol=1e-6)
        else:
            np.testing.assert_array_equal(fused, refs[op][rank])
        np.testing.assert_allclose(out[("unfused", op)], plain, rtol=1e-12)
    ints = DATA["ints"][:2]
    assert world[0]["int_min"] == ints.min(0).tolist()
    assert world[1]["int_max"] == ints.max(0).tolist()


def test_grouped_adasum_and_gathers_drop_the_joined_rank(refs, port):
    world, _ = port
    x = DATA["x"]
    for rank in range(2):
        out = world[rank]
        np.testing.assert_allclose(out["grouped"][0], x[:2].mean(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(out["grouped"][1], 2 * x[:2, :3].mean(0),
                                   rtol=1e-6)
        np.testing.assert_allclose(out["adasum"], refs["adasum"][rank],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["adasum_f64"], refs["adasum"][rank],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out["allgather"],
                                      refs["allgather"][rank])
        assert out["allgather"].shape == (10,)
        np.testing.assert_array_equal(out["ragged"], refs["ragged"])
        assert out["ragged"].shape == (3, 2)
        np.testing.assert_allclose(out["rs"], refs["rs"][rank], rtol=1e-6)
        np.testing.assert_array_equal(out["broadcast"],
                                      refs["broadcast"][rank])
        assert out["objects"] == [0, 1]


def test_refusals_while_a_rank_has_joined(port):
    world, _ = port
    for rank in range(2):
        errors = world[rank]["errors"]
        assert errors["broadcast_joined_root"] == "HorovodInternalError"
        assert errors["alltoall"] == "HorovodInternalError"
    assert world[1]["errors"]["set_with_joined_rank"] == \
        "HorovodInternalError"


def test_join_within_a_process_set_returns_a_global_rank(port):
    world, _ = port
    assert world[1]["set_join"] == world[2]["set_join"] == 2
    np.testing.assert_array_equal(world[2]["set_sum"], DATA["x"][2])
    assert "set_join" not in world[0]


def test_join_without_the_flag_raises_across_processes(port):
    _, unarmed = port
    for out in unarmed:
        assert out == {"error": "NotImplementedError", "after": [3.0]}
