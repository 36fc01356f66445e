"""The port's hierarchical tiers (``horovod_tpu_torch/parallel/strategies.py``,
``common/topology.py``, the fusion runtime's strategies and the
dispatch-strategy registry) against the JAX package's on the same numpy
inputs.

One 4-rank gloo world as 2 nodes of 2 with ``HOROVOD_MESH_SLICES=2`` (a
2 x 2 layout) runs on a thread while JAX compiles its references: JAX's
strategy functions in a ``shard_map`` over a (2, 2) CPU mesh, rank r on
device r (cross r // 2, local r % 2). A 2-rank world of one node runs
beside it for the one-slice refusal.

Tolerances: none. Every sum of the local and cross legs has two operands,
so operand order cannot change it, and the port rounds the prescale,
Average's reciprocal and the postscale where XLA does: ``allreduce_torus``,
``allreduce_hierarchical``, ``allgather_hierarchical``, ``allreduce_tiered``
with an int8 cross leg over two rounds (output and residual) and the fusion
runtime's torus, hierarchical and torus_qcross buckets are bit-equal to
JAX's; the buckets' per-tier bytes equal ``hierarchical_wire_bytes``; the
refusals (Min, a process set, a one-shot ``Compression.int8`` request, a
one-slice layout) are exact flat reductions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_helpers as helpers
from horovod_tpu.common import topology as jtopo
from horovod_tpu.common.config import Config as JConfig
from horovod_tpu.common.topology import CROSS_AXIS, LOCAL_AXIS
from horovod_tpu.ops import wire as jw
from horovod_tpu.parallel import strategies as js
from horovod_tpu_torch.common import topology as ttopo
from horovod_tpu_torch.common.config import Config as TConfig
from horovod_tpu_torch.ops import wire as tw
from horovod_tpu_torch.ops.fusion import config_strategy

N = 4
FUSED = ("torus", "hierarchical", "torus_qcross")
SCALES = (1.0 / 3.0, 3.0)           # the fused buckets' pre- and postscale
TIERED = (0.5, 1.0 / 3.0)           # allreduce_tiered's
BUCKET = (4500, 1500, 701)          # 6701 elements: the torus pads by one
WORLD_ENV = {"HOROVOD_MESH_SLICES": "2", "HOROVOD_WIRE_DTYPE_DCN": "int8",
             "HOROVOD_HIERARCHICAL_ALLGATHER": "1"}
ONE_SLICE_ENV = {"HOROVOD_HIERARCHICAL_DISPATCH": "1",
                 "HOROVOD_WIRE_DTYPE_DCN": "int8"}


def _data():
    rng = np.random.default_rng(12)

    def rows(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"x": rows(N, 5001),
            "tiered": ([rows(N, 6001), rows(N, 6001)],) + TIERED,
            "g": rows(N, 3, 2), "scales": SCALES, "fused": FUSED,
            "bucket": [[rows(N, k) for k in BUCKET] for _ in range(2)],
            "ragged": [rows(k, 3) for k in (1, 3, 0, 2)],
            "one_slice": [rows(2, 5000)]}


def _per_rank(fn, *arrays):
    """``fn`` on each rank's rows in a shard_map over the (2, 2) mesh; the
    outputs stacked by rank."""
    mesh = Mesh(np.array(jax.devices()[:N]).reshape(2, 2),
                (CROSS_AXIS, LOCAL_AXIS))
    spec = P((CROSS_AXIS, LOCAL_AXIS))

    def body(*xs):
        out = fn(*[x[0] for x in xs])
        out = out if isinstance(out, tuple) else (out,)
        return tuple(o[None] for o in out)

    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=tuple(spec for _ in arrays),
                              out_specs=spec, check_vma=False))
    return [np.asarray(o) for o in f(*[jnp.asarray(a) for a in arrays])]


def _tiered_rounds(rounds, pre, post, cross):
    res = np.zeros((N, -(-rounds[0].shape[1] // 2)), np.float32)
    got = []
    for r in rounds:
        y, res = _per_rank(
            lambda x, e: js.allreduce_tiered(
                x, average=True, cross_wire=cross, residual=e,
                prescale_factor=pre, postscale_factor=post), r, res)
        got.append((y, res))
    return got


def _jax_refs(data):
    refs = {"torus": _per_rank(lambda x: js.allreduce_torus(
                x, average=True), data["x"])[0],
            "hier": _per_rank(lambda x: js.allreduce_hierarchical(
                x, average=True), data["x"])[0],
            "tiered": _tiered_rounds(data["tiered"][0], *TIERED, "int8"),
            "gather": _per_rank(js.allgather_hierarchical, data["g"])[0]}
    pre, post = SCALES
    bufs = [np.concatenate(rnd, axis=1) for rnd in data["bucket"]]
    refs["fused"] = {
        "torus": [y for y, _ in _tiered_rounds(bufs, pre, post, "")],
        "torus_qcross": [y for y, _ in _tiered_rounds(bufs, pre, post,
                                                      "int8")],
        "hierarchical": [_per_rank(lambda x: js.allreduce_hierarchical(
            x * jnp.float32(pre), average=True) * jnp.float32(post), b)[0]
            for b in bufs]}
    return refs


@pytest.fixture(scope="module")
def worlds():
    data = _data()
    hier = helpers.run_world_async(helpers.hier_world, N, args=(data,),
                                   env=WORLD_ENV, local_size=2)
    one = helpers.run_world_async(helpers.one_slice_world, 2,
                                  args=(data["one_slice"],),
                                  env=ONE_SLICE_ENV)
    refs = _jax_refs(data)
    return data, refs, hier.result(), one.result()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def test_layout_and_members(worlds):
    _, _, port, _ = worlds
    for r, out in enumerate(port):
        slices, per, node, local, cross = out["layout"]
        assert (slices, per, node) == (2, 2, (2, 2))
        assert local == [q for q in range(N)
                         if jtopo.slice_of_rank(q, 2)
                         == jtopo.slice_of_rank(r, 2)]
        assert cross == [q for q in range(N) if q % 2 == r % 2]


@pytest.mark.parametrize("name", ["torus", "hier", "gather"])
def test_strategies_bit_equal_to_jax(worlds, name):
    _, refs, port, _ = worlds
    for r, out in enumerate(port):
        np.testing.assert_array_equal(_bits(out["direct"][name]),
                                      _bits(refs[name][r]))


def test_tiered_int8_cross_bit_equal_to_jax(worlds):
    """Two rounds of ``allreduce_tiered`` with an int8 cross leg at cross
    n = 2: outputs and carried residuals."""
    _, refs, port, _ = worlds
    for r, out in enumerate(port):
        for (y, res), (jy, jres) in zip(out["direct"]["tiered"],
                                        refs["tiered"]):
            np.testing.assert_array_equal(_bits(y), _bits(jy[r]))
            np.testing.assert_array_equal(_bits(res), _bits(jres[r]))
    exact = np.mean(worlds[0]["tiered"][0][0], axis=0) * np.float32(
        TIERED[0] * TIERED[1])
    assert 0 < np.abs(port[0]["direct"]["tiered"][0][0] - exact).max() \
        < 0.05 * np.abs(exact).max()          # lossy, and near


@pytest.mark.parametrize("strategy", FUSED)
def test_fused_buckets_bit_equal_with_tier_bytes(worlds, strategy):
    data, refs, port, _ = worlds
    total = sum(BUCKET)
    cross = "int8" if strategy == "torus_qcross" else ""
    h = jw.hierarchical_wire_bytes(total, N, 2, 4, cross_wire=cross)
    want_tiers = {"local": {}, "cross": {}}
    if strategy != "hierarchical":          # JAX meters torus buckets only
        want_tiers = {"local": {"float32": h["ici"]},
                      "cross": {h["cross_label"] or "float32": h["dcn"]}}
    assert h["cross_label"] == (cross or None)
    for r, out in enumerate(port):
        for got, want in zip(out["fused"][strategy],
                             refs["fused"][strategy]):
            assert got["strategies"] == {strategy: 1}
            assert got["tiers"] == want_tiers
            np.testing.assert_array_equal(
                _bits(np.concatenate(got["outs"])), _bits(want[r]))


def test_refusals_stay_flat(worlds):
    data, _, port, one = worlds
    rows = data["bucket"][0]
    for r, out in enumerate(port):
        ref = out["refusals"]
        assert ref["min"]["strategies"] == {"flat": 1}
        for got, a in zip(ref["min"]["outs"], rows):
            np.testing.assert_array_equal(got, a.min(axis=0))
        assert ref["int8"]["strategies"] == {"flat": 1}
        assert ref["int8"]["quantized"] == 1      # the flat exchange
        assert ref["pinned"]["strategies"] == {"torus": 1}
        assert ref["registry"] == "hier"          # the pin beats the sync
        if r < 2:
            assert ref["set"]["strategies"] == {"flat": 1}
            for got, a in zip(ref["set"]["outs"], rows):
                np.testing.assert_array_equal(got, a[0] + a[1])
    for r, out in enumerate(one):
        assert out["layout"] == (1, (1, 2), "torus_qcross")
        assert out["strategies"] == {"flat": 1}
        np.testing.assert_array_equal(out["outs"][0],
                                      data["one_slice"][0].sum(axis=0))


def test_hierarchical_allgather_is_rank_major(worlds):
    data, _, port, _ = worlds
    want = np.concatenate(data["ragged"])
    for out in port:
        np.testing.assert_array_equal(out["allgather"], want)


@pytest.mark.parametrize("forced", ["", "2", "3", "4", "x"])
def test_slice_layout_equals_jax(monkeypatch, forced):
    monkeypatch.setenv("HOROVOD_MESH_SLICES", forced)
    assert ttopo.forced_slices() == jtopo.forced_slices()
    for size in (1, 2, 3, 4, 6, 8, 12):
        for k in (None, 0, 1, 2, 3, 4, 5):
            assert ttopo.slice_layout(size, k) == jtopo.slice_layout(size, k)
        _, per = jtopo.slice_layout(size)
        for rank in range(size):
            assert ttopo.slice_of_rank(rank, per) == \
                jtopo.slice_of_rank(rank, per)


def test_knobs_equal_jax(monkeypatch):
    names = ("HIERARCHICAL_ALLREDUCE", "TORUS_ALLREDUCE",
             "HIERARCHICAL_DISPATCH", "HIERARCHICAL_ALLGATHER")
    fields = ("hierarchical_allreduce", "torus_allreduce",
              "hierarchical_dispatch", "hierarchical_allgather",
              "cross_overlap", "mesh_slices", "wire_dtype_dcn")
    monkeypatch.setenv("HOROVOD_CROSS_OVERLAP", "0")
    monkeypatch.setenv("HOROVOD_MESH_SLICES", "2")
    monkeypatch.setenv("HOROVOD_WIRE_DTYPE_DCN", "fp8")
    for bits in range(16):
        for i, name in enumerate(names):
            monkeypatch.setenv(f"HOROVOD_{name}", str(bits >> i & 1))
        t, j = TConfig.from_env(), JConfig.from_env()
        assert [getattr(t, f) for f in fields] == \
            [getattr(j, f) for f in fields]
        # JAX's FusionRuntime.strategy from the same knobs.
        assert config_strategy(t) == (
            "torus_qcross" if j.hierarchical_dispatch
            else "torus" if j.torus_allreduce
            else "hierarchical" if j.hierarchical_allreduce else "flat")


def test_strategy_registry_equals_jax():
    for m in (tw, jw):
        m.clear_strategy_registry()
        seen = [m.dispatch_strategy_for("global", "hier_qcross"),
                m.runtime_sync_dispatch_strategy("hier"),
                m.dispatch_strategy_for("global"),
                m.set_dispatch_strategy("flat"),
                m.runtime_sync_dispatch_strategy("hier_qcross"),
                m.dispatch_strategy_for("global", "hier"),
                m.set_dispatch_strategy("", "set2"),
                m.dispatch_strategy_for("set2", "hier")]
        assert seen == ["hier_qcross", "hier", "hier", "flat", "flat",
                        "flat", "", "hier"], m.__name__
        with pytest.raises(ValueError):
            m.set_dispatch_strategy("torus")
        m.clear_strategy_registry()
        assert m.dispatch_strategy_for("global") == ""
