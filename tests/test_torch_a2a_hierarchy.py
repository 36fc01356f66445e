"""The hierarchical alltoall and expert parallelism against the JAX package.

One 4-process gloo world on a forced 2 x 2 slice layout
(``HOROVOD_MESH_SLICES=2``, two nodes of two; ``torch_a12_helpers.
a2a_world``):

- the eager ``hvd.alltoall`` on the oracles of
  ``test_moe_hierarchy.py::TestEagerHierarchicalAlltoall``: the exact
  hierarchical route bit-equal to the flat one, with the flat total over
  the slices on the cross tier; the int8 cross leg within 5% and never
  exact, its bytes ``wire.hierarchical_a2a_bytes``'s; a sub-block payload
  exact; a one-slice layout flat; ``HOROVOD_HIERARCHICAL_ALLTOALL``'s
  default (``hier_qcross`` over an exact cross wire);
- ``strategies.alltoall_tiered_groups`` over an in-step axis bit-equal to
  ``in_step.alltoall``; the int8 cross leg within the block-scale bound
  (``block max / 254`` an element), its backward exactly the inverse
  alltoall; ``a2a_hierarchy_for``'s resolution chain;
- ``MoEMlp`` at ep = 4 against JAX's ``MoEMlp`` under ``shard_map`` on 4
  CPU devices (outputs, aux, and the gradients of sum(y^2) + aux: input,
  router, experts), top-1 and top-2, with drops at a small capacity; the
  2-level dispatch bit-equal to the flat one; the int8 cross leg within
  5% of it; the divisibility refusal;
- process 0's alltoall strategy and cross wire carried to every rank on
  the fusion runtime's boundary stream, under a rank's own pin.

Tolerance against JAX: rtol 2e-4 / atol 1e-5 (``TestMoE``'s own, fp32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_a12_helpers as a12
import torch_port_helpers as helpers
from horovod_tpu.ops import wire
from horovod_tpu.parallel.moe import MoEMlp

N = 4
MOE_CASES = {     # name -> (port kwargs, d, f, E, T per rank, cf, k, seed)
    "k1": (dict(), 8, 16, 8, 32, 8.0, 1, 1),
    "k2": (dict(), 8, 16, 8, 32, 8.0, 2, 2),
    "k2_drop": (dict(), 8, 16, 8, 32, 1.0, 2, 3),
    "k1_hier": (dict(hierarchical=True), 8, 16, 8, 32, 8.0, 1, 1),
    "flat_q": (dict(hierarchical=False), 16, 32, 8, 128, 2.0, 1, 4),
    "int8": (dict(hierarchical=True, cross_dtype="int8"), 16, 32, 8, 128,
             2.0, 1, 4),
}
TOL = dict(rtol=2e-4, atol=1e-5)


def moe_params(rng, d, f, E):
    """``MoEMlp``'s Flax params, global, drawn with numpy (lecun-like:
    variance 1/fan-in) in place of Flax's init, which runs op by op."""
    def normal(shape, fan_in):
        return np.asarray(rng.standard_normal(shape) / np.sqrt(fan_in),
                          np.float32)
    return {"router": {"kernel": normal((d, E), d)},
            "w_in": normal((E, d, f), d), "w_out": normal((E, f, d), f)}


def _moe_cases():
    """The port's cases (global params in Flax's layout, drawn with
    numpy) and JAX's references under ``shard_map`` on 4 devices,
    as a function to call while the world runs."""
    cases, models = {}, {}
    for name, (kw, d, f, E, T, cf, k, seed) in MOE_CASES.items():
        rng = np.random.default_rng(seed)
        x = np.asarray(rng.standard_normal((N * T, d)), np.float32)
        moe = MoEMlp(num_experts=E, hidden_size=d, intermediate_size=f, k=k,
                     capacity_factor=cf, axis_name="ep", hierarchical=False)
        params = moe_params(rng, d, f, E)
        cases[name] = (dict(num_experts=E, hidden_size=d,
                            intermediate_size=f, k=k, capacity_factor=cf,
                            **kw), params, x)
        models[name] = moe

    def references():
        mesh = Mesh(np.array(jax.devices()[:N], dtype=object), ("ep",))
        specs = {"router": {"kernel": P()}, "w_in": P("ep"),
                 "w_out": P("ep")}
        refs = {}
        for name in ("k1", "k2", "k2_drop"):
            _, params, x = cases[name]

            def apply(p, xl, moe=models[name]):
                y, aux = moe.apply({"params": p}, xl)
                return y, jax.lax.pmean(aux, "ep")

            fn = jax.jit(jax.shard_map(apply, mesh=mesh,
                                       in_specs=(specs, P("ep")),
                                       out_specs=(P("ep"), P())))

            def loss(p, xg, fn=fn):
                y, aux = fn(p, xg)
                return jnp.sum(y * y) + aux, (y, aux)

            (_, (y, aux)), (gp, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
            refs[name] = {"y": np.asarray(y), "aux": float(aux),
                          "dx": np.asarray(gx),
                          "router": np.asarray(gp["router"]["kernel"]),
                          "w_in": np.asarray(gp["w_in"]),
                          "w_out": np.asarray(gp["w_out"])}
        return refs
    return cases, references


@pytest.fixture(scope="module")
def results():
    rng = np.random.default_rng(0)
    xs = {"big": np.asarray(rng.standard_normal((N, N * 512)), np.float32),
          "q": np.asarray(rng.standard_normal((N, N * 512)), np.float32),
          "small": np.arange(N * N * 8, dtype=np.float32).reshape(N, N * 8)}
    x_axis = np.asarray(rng.standard_normal((N, 8, 64, 16)), np.float32)
    g_axis = np.asarray(rng.standard_normal((N, 8, 64, 16)), np.float32)
    cases, references = _moe_cases()
    fut = helpers.run_world_async(
        a12.a2a_world, N, (xs, x_axis, g_axis, cases),
        env={"HOROVOD_MESH_SLICES": "2"}, timeout=240, local_size=2)
    refs = references()
    return {"xs": xs, "x_axis": x_axis, "g_axis": g_axis, "refs": refs,
            "cases": cases, "world": fut.result()}


def _flat_a2a(rows):
    """The flat alltoall of per-rank ``rows`` (N, m, ...): rank r gets
    block r of every rank, in rank order."""
    blocks = rows.reshape((N, N, -1) + rows.shape[2:])
    return np.stack([np.concatenate([blocks[src, r] for src in range(N)])
                     for r in range(N)])


def _eager(results, name):
    return [w["eager"][name] for w in results["world"]]


def test_eager_hier_is_bit_equal_with_flat_total_over_slices(results):
    big = results["xs"]["big"]
    per = big.shape[1]
    flat_total = N * per * 4
    want = _flat_a2a(big)
    for r, (out, booked) in enumerate(_eager(results, "flat")):
        np.testing.assert_array_equal(out, want[r])
        assert booked == {"float32/ici": flat_total // 2,
                          "float32/dcn": flat_total // 2}, booked
    h = wire.hierarchical_a2a_bytes(per, N, 2, 4)
    assert h["cross_label"] is None
    for r, (out, booked) in enumerate(_eager(results, "hier")):
        np.testing.assert_array_equal(out, want[r])
        assert booked == {"float32/ici": h["ici"], "float32/dcn": h["dcn"]}
        assert booked["float32/dcn"] == flat_total // 2       # exact


def test_eager_int8_cross_leg_bounded_and_metered(results):
    q = results["xs"]["q"]
    per = q.shape[1]
    ref = np.stack([o for o, _ in _eager(results, "flat_q")])
    np.testing.assert_array_equal(ref, _flat_a2a(q))
    got = np.stack([o for o, _ in _eager(results, "int8")])
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert 0 < rel < 0.05, rel
    h_exact = wire.hierarchical_a2a_bytes(per, N, 2, 4)
    h_int8 = wire.hierarchical_a2a_bytes(per, N, 2, 4, cross_wire="int8")
    assert h_int8["cross_label"] == "int8"
    ct = h_int8["cross_tiers"]
    for _, booked in _eager(results, "int8"):
        assert booked == {"float32/ici": h_int8["local"],
                          "int8/ici": ct["ici"], "int8/dcn": ct["dcn"]}
    assert h_int8["dcn"] < 0.3 * h_exact["dcn"]


def test_eager_sub_block_and_one_slice_stay_exact(results):
    small = results["xs"]["small"]
    want = _flat_a2a(small)
    h = wire.hierarchical_a2a_bytes(small.shape[1], N, 2, 4,
                                    cross_wire="int8")
    assert h["cross_label"] is None
    for r, (out, booked) in enumerate(_eager(results, "sub_block")):
        np.testing.assert_array_equal(out, want[r])
        assert booked == {"float32/ici": h["ici"], "float32/dcn": h["dcn"]}
    for r, (out, booked) in enumerate(_eager(results, "one_slice")):
        np.testing.assert_array_equal(out, want[r])
        assert set(booked) == {"float32/ici"}, booked    # no dcn series


def test_eager_knob_arms_the_exact_tier(results):
    """HOROVOD_HIERARCHICAL_ALLTOALL with no pin: hier_qcross over the
    expert cross wire, which never inherits the allreduce's (exact
    here); disarmed again, the flat route's bytes."""
    big = results["xs"]["big"]
    per = big.shape[1]
    want = _flat_a2a(big)
    h = wire.hierarchical_a2a_bytes(per, N, 2, 4)
    for r, (out, booked) in enumerate(_eager(results, "knob")):
        np.testing.assert_array_equal(out, want[r])
        assert booked == {"float32/ici": h["ici"], "float32/dcn": h["dcn"]}
    for _, booked in _eager(results, "disarmed"):
        assert booked == {"float32/ici": N * per * 2,
                          "float32/dcn": N * per * 2}


def test_tiered_groups_over_an_axis_match_flat(results):
    x = results["x_axis"]
    per = int(np.prod(x.shape[1:]))
    h = wire.hierarchical_a2a_bytes(per, N, 2, 4)
    for w in results["world"]:
        flat, tiered, booked = w["in_step"]["tiered"]
        np.testing.assert_array_equal(tiered, flat)
        assert booked == {"float32/ici": h["ici"], "float32/dcn": h["dcn"]}
    want = _flat_a2a(x)
    for r, w in enumerate(results["world"]):
        np.testing.assert_array_equal(w["in_step"]["tiered"][0], want[r])


def test_int8_cross_leg_within_block_bound_with_exact_backward(results):
    """Every element off by at most half a level of its block's scale on
    the one quantized leg (the row's max / 254 bounds each block's), not
    all exact; the backward bit-equal to the exact inverse alltoall of the
    cotangent (straight through)."""
    x = results["x_axis"]
    want = _flat_a2a(x)
    rows = x.shape[1] // N                     # rows from each source
    for r, w in enumerate(results["world"]):
        got, dx, booked, inverse = w["in_step"]["int8"]
        assert "int8/dcn" in booked
        errs = []
        for c in range(2):                     # the row from each slice
            part = slice(2 * c * rows, 2 * (c + 1) * rows)
            err = np.abs(got[part] - want[r][part])
            bound = np.abs(want[r][part]).max() / 254 * (1 + 1e-6)
            assert err.max() <= bound, (r, c, err.max(), bound)
            errs.append(err.max())
        assert max(errs) > 0
        np.testing.assert_array_equal(dx, inverse)


def test_hierarchy_resolution_chain(results):
    for w in results["world"]:
        c = w["in_step"]["chain"]
        assert c["default"] is None                 # nothing armed
        assert c["forced"] == (2, None)             # exact cross wire
        assert c["refused"] is None
        assert c["forced_int8"] == (2, "int8")
        assert c["hier_pin"] == (2, None)           # hier keeps it exact
        assert c["qcross_pin"] == (2, "int8")
        assert c["flat_pin"] is None


@pytest.mark.parametrize("name", ["k1", "k2", "k2_drop"])
def test_moe_ep4_matches_jax(results, name):
    ref = results["refs"][name]
    world = [w["moe"][name] for w in results["world"]]
    _, d, _, E, T, cf, k, _ = MOE_CASES[name]
    slots = E * max(1, int(cf * k * T / E)) * d
    flat = 2 * N * slots * 4              # dispatch and combine, fp32
    y = np.concatenate([w["y"] for w in world])
    np.testing.assert_allclose(y, ref["y"], **TOL)
    np.testing.assert_allclose(np.concatenate([w["dx"] for w in world]),
                               ref["dx"], **TOL)
    e = ref["w_in"].shape[0] // N
    for r, w in enumerate(world):
        np.testing.assert_allclose(w["aux"], ref["aux"], rtol=1e-5)
        np.testing.assert_allclose(w["router"], ref["router"], **TOL)
        np.testing.assert_allclose(w["w_in"], ref["w_in"][r * e:(r + 1) * e],
                                   **TOL)
        np.testing.assert_allclose(w["w_out"],
                                   ref["w_out"][r * e:(r + 1) * e], **TOL)
        # The flat exchange, half of it to the other slice.
        assert w["bytes"] == {"float32/ici": flat // 2,
                              "float32/dcn": flat // 2}, w["bytes"]
    dropped = sum(w["dropped"] for w in world)
    assert (dropped > 0) == (name == "k2_drop"), dropped


def test_moe_hierarchical_dispatch_bit_equal_to_flat(results):
    """The exact 2-level route is the flat exchange: outputs, aux and
    every gradient bit-equal."""
    for w in results["world"]:
        flat, hier = w["moe"]["k1"], w["moe"]["k1_hier"]
        for k in ("y", "dx", "router", "w_in", "w_out"):
            np.testing.assert_array_equal(hier[k], flat[k])
        assert hier["aux"] == flat["aux"]
        assert "float32/dcn" in hier["bytes"]


def test_moe_int8_cross_leg_close_to_flat(results):
    a = np.concatenate([w["moe"]["flat_q"]["y"] for w in results["world"]])
    b = np.concatenate([w["moe"]["int8"]["y"] for w in results["world"]])
    rel = np.abs(a - b).max() / (np.abs(a).max() + 1e-9)
    assert 0 < rel < 0.05, rel
    for w in results["world"]:
        assert "int8/dcn" in w["moe"]["int8"]["bytes"]


def test_moe_indivisible_experts_raise(results):
    for w in results["world"]:
        assert "not divisible by ep=4" in w["moe"]["indivisible"]


def test_boundary_stream_carries_the_alltoall_policy(results):
    """JAX's ``_sync_eager_policy`` on the followers: rank 0's pins reach
    every rank's registry through the fused allreduce's boundary; rank 1's
    own ``flat`` pin stands over the next one."""
    want = ("hier_qcross", "int8")
    for r, w in enumerate(results["world"]):
        b = w["boundary"]
        assert tuple(b["synced"]) == want, (r, b)
        assert tuple(b["pinned"]) == (("flat", "int8") if r == 1
                                      else want), (r, b)
