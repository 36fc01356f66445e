"""The port's quantized wire (``horovod_tpu_torch/ops/wire.py``, the fusion
runtime's quantized and cast buckets, ``Compression.int8``) against the JAX
package's ``horovod_tpu/ops/wire.py``, fused program and eager path, on
the same numpy inputs.

The JAX functions are held as XLA compiles them (the wire path always runs
jitted): there a division by a constant (``max/127``) is a product with its
fp32 reciprocal and a product feeding a sum is one fused multiply-add, and
the port rounds at the same points.

Tolerances:
- the int8 and fp8 block quantizers, their scales and ``dequantize``:
  bit-equal to the jitted JAX functions (the same fp32 operations: the
  reciprocal product for the scale, a true division by the scale, round
  half to even, the saturating casts);
- every byte-accounting function: equal;
- ``block_scaled_allreduce`` over 2 ranks (gloo) against JAX's in a
  ``shard_map`` over 2 CPU devices, output and new residual: bit-equal;
  over 3 ranks the rows are summed in row order on both sides and the
  results are bit-equal too (a 1-ulp difference in a sum could flip one
  requantized level; the test would report how many elements flip and hold
  them to one block step, max|block|/127);
- a 2-rank fused bucket, fp32 and bf16, on ``HOROVOD_WIRE_DTYPE=int8`` over
  two rounds (error feedback carried) and on ``bfloat16`` (the cast wire),
  against JAX's ``_fused_program`` on the same wire: bit-equal. The cast
  wire's scales here are powers of two and 3.0: with a prescale of 1/3,
  XLA's CPU program for the JAX cast bucket rounds the prescaled bf16
  product otherwise than one rounding to nearest (toward zero in the
  elements looked at), which the port does not copy: there the port's cast
  bucket, fp32 and bf16 tensors at a prescale of 1/3, is held bit-equal to
  a numpy oracle: the tensor and the scale in bf16, their fp32 product
  rounded once, to nearest even;
- small buckets, Min, Max and Adasum on the int8 wire: exact, and no
  quantized bucket;
- the 2-rank MLP trained with ``Compression.int8``: at every step the
  reduced gradients equal JAX's eager quantized allreduce of the same local
  gradients (its error feedback carried across the steps), bit for bit;
- two same-shaped ``Compression.int8`` tensors, interleaved, keep a
  residual each: their outputs and residuals bit-equal to those each gets
  alone (JAX's eager plan key, without the name, would share one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import torch_port_helpers as helpers
from horovod_tpu.common.topology import HVD_AXIS
from horovod_tpu.ops import wire as jw
from horovod_tpu_torch.ops import wire as tw

L = 5000                          # not a multiple of n * BLOCK: padded
MLP_STEPS, MLP_LR = 4, 0.05


def _rows(seed, n, length=L):
    """(n, length) fp32 rows whose blocks span magnitudes 1e-3..1e3, with
    an all-zero block and a block whose largest element is its last."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, length)).astype(np.float32)
    mags = np.exp(rng.uniform(-7, 7, (n, -(-length // 1024))))
    x *= np.repeat(mags, 1024, axis=1)[:, :length].astype(np.float32)
    if length >= 3072:
        x[:, 1024:2048] = 0.0
        x[:, 3071] = 3.0 * np.abs(x[:, 2048:3072]).max(axis=1)
    return x


# --- the block quantizers ---------------------------------------------------

def _quant_inputs(case):
    rng = np.random.default_rng(1)
    if case == "blocks":
        return _rows(2, 6, 1024)
    if case == "tail":                       # shorter than one block
        return rng.standard_normal((3, 700)).astype(np.float32)
    # Values whose quotient by the scale lands on, or a hair off, +-448 and
    # +-127: the block maximum, and its neighbours in fp32.
    m = np.float32(3.7)
    row = rng.uniform(-1, 1, 1024).astype(np.float32) * m
    row[:4] = [m, -m, np.nextafter(m, np.float32(0)),
               -np.nextafter(m, np.float32(0))]
    return np.stack([row, -row, row * np.float32(1e-20)])


@pytest.mark.parametrize("case", ["blocks", "tail", "edge"])
@pytest.mark.parametrize("w", ["int8", "fp8"])
def test_quantizers_bit_equal_to_jax(w, case):
    import torch
    x = _quant_inputs(case)
    qj, sj = jax.jit(jw.quantize_blocks, static_argnums=1)(jnp.asarray(x), w)
    qt, st = tw.quantize_blocks(torch.from_numpy(x), w)
    assert qt.dtype == (torch.int8 if w == "int8" else torch.float8_e4m3fn)
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy().view(np.uint32),
                                  np.asarray(sj).view(np.uint32))
    dj = np.asarray(jax.jit(jw.dequantize)(qj, sj))
    dt = tw.dequantize(qt, st).numpy()
    np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))
    assert np.isfinite(dt).all()
    if w == "fp8" and case == "edge":
        assert np.abs(qt[:2].float().numpy()).max() == 448.0


# --- byte accounting --------------------------------------------------------

ELEMS = (0, 1, 1023, 1024, 2047, 2048, 100_007, 25_557_032)
NS = (1, 2, 3, 4, 8)
WIRES = ("", "float16", "bfloat16", "int8", "fp8")


def _accounting_calls(name):
    if name in ("exchange_leg_bytes", "exchange_wire_bytes"):
        return [(e, n) for e in ELEMS for n in NS]
    if name == "quantized_eligible":
        return [(e, n, a, b) for e in ELEMS for n in NS
                for a in (True, False) for b in (True, False)]
    if name in ("ring_dcn_fraction", "a2a_dcn_fraction"):
        return [(list(m), s) for m in ([], [0], [0, 1, 2, 3], [0, 2, 5, 7],
                                       list(range(8)))
                for s in (1, 2, 4)]
    if name == "split_tiers":
        return [(b, f) for b in (0, 1, 7, 1_000_003) for f in
                (0.0, 0.25, 0.5, 1 / 3, 0.875, 1.0)]
    if name in ("hierarchical_wire_bytes", "hierarchical_a2a_bytes"):
        return [(e, n, s, i, w) for e in ELEMS for n in (2, 4, 8)
                for s in (1, 2, 4) for i in (2, 4) for w in WIRES]
    assert name == "allreduce_wire_bytes"
    return [(e * i * n, i, n, w) for e in ELEMS for n in NS for i in (2, 4)
            for w in WIRES]


@pytest.mark.parametrize("name", [
    "exchange_leg_bytes", "exchange_wire_bytes", "quantized_eligible",
    "ring_dcn_fraction", "a2a_dcn_fraction", "split_tiers",
    "hierarchical_wire_bytes", "hierarchical_a2a_bytes",
    "allreduce_wire_bytes"])
def test_byte_accounting_equals_jax(name):
    for args in _accounting_calls(name):
        assert getattr(tw, name)(*args) == getattr(jw, name)(*args), args


def test_resnet50_wire_bytes_are_a_quarter():
    """ResNet-50's 25,557,032 gradient elements at one rank: ~51 MB on the
    int8 exchange against ~204 MB for the fp32 allreduce (the formulas)."""
    q = tw.exchange_wire_bytes(25_557_032, 1)
    exact = tw.allreduce_wire_bytes(25_557_032 * 4, 4, 1, "")
    assert (q, exact) == (51_315_704, 204_456_256)
    assert 0.25 <= q / exact < 0.252


# --- the registry, the one-shot request, the error-feedback store -----------

@pytest.fixture
def clean_wire():
    for m in (tw, jw):
        m.clear_wire_registry()
        m.reset_error_feedback()
        m.consume_wire_request()
    yield
    for m in (tw, jw):
        m.clear_wire_registry()
        m.reset_error_feedback()
        m.consume_wire_request()


def test_registry_pin_beats_runtime_sync(clean_wire):
    class Cfg:
        wire_dtype, wire_dtype_dcn = "int8", ""

    for m in (tw, jw):
        seen = [m.wire_dtype_for("global", "int8"),
                m.runtime_sync_wire_dtype("bf16"),
                m.wire_dtype_for("global", "int8"),
                m.set_wire_dtype("fp16"),
                m.runtime_sync_wire_dtype("int8"),
                m.wire_dtype_for("global", ""),
                m.set_wire_dtype("", "set3"),
                m.wire_dtype_for("set3", "int8"),
                m.wire_dtype_for("set4", "fp8"),
                m.cross_wire_for("global", Cfg),
                m.set_wire_dtype("fp8", tier="dcn"),
                m.cross_wire_for("global", Cfg)]
        assert seen == ["int8", "bfloat16", "bfloat16", "float16",
                        "float16", "float16", "", "", "fp8", "int8", "fp8",
                        "fp8"], m.__name__
        with pytest.raises(ValueError):
            m.set_wire_dtype("int4")
        m.clear_wire_registry()
    import torch
    assert tw.set_wire_dtype(torch.bfloat16) == "bfloat16"
    assert tw.wire_torch_type("fp8") == torch.float8_e4m3fn
    assert tw.wire_torch_type("") is None


def test_one_shot_request_is_read_and_cleared(clean_wire):
    for m in (tw, jw):
        assert m.consume_wire_request() is None
        m.request_wire_once("int8")
        assert m.consume_wire_request() == "int8"
        assert m.consume_wire_request() is None


def test_error_feedback_evicts_the_oldest_entry_only(clean_wire):
    for m in (tw, jw):
        for i in range(m._EF_CAP):
            m.ef_put(("k", i), i)
        m.ef_put(("k", 0), "again")          # an update evicts nothing
        assert len(m.ef_keys()) == m._EF_CAP
        m.ef_put("new", -1)
        keys = m.ef_keys()
        assert len(keys) == m._EF_CAP and ("k", 0) not in keys
        assert ("k", 1) in keys and "new" in keys
        assert m.ef_pop(("k", 1)) == 1 and m.ef_get(("k", 1)) is None
        assert m.reset_error_feedback() == m._EF_CAP - 1
        assert m.ef_keys() == []


# --- the exchange and the fused buckets, in gloo worlds ---------------------

EX_CASES = [
    # (case, seed, residual, wire, average, prescale, postscale)
    ("int8", 3, False, "int8", False, 1.0, 1.0),
    ("int8_ef_avg", 4, True, "int8", True, 0.5, 1.0 / 3.0),
    ("fp8", 5, False, "fp8", False, 1.0, 1.0),
    ("fp8_ef_avg", 6, True, "fp8", True, 1.0, 3.0),
]


def _exchange_data(n):
    data = []
    for case, seed, ef, w, avg, pre, post in EX_CASES:
        rows = _rows(seed, n)
        res = (np.random.default_rng(seed + 50).standard_normal((n, L))
               .astype(np.float32) * 1e-2) if ef else None
        data.append((case, rows, res, w, avg, pre, post))
    return data


def _jax_exchange(rows, res, w, average, pre, post):
    n = rows.shape[0]
    mesh = Mesh(np.array(jax.devices()[:n]), (HVD_AXIS,))

    def body(x, *r):
        out, new = jw.block_scaled_allreduce(
            x[0], residual=r[0][0] if r else None, axis_name=HVD_AXIS,
            wire=w, average=average, prescale_factor=pre,
            postscale_factor=post)
        return (out[None],) + ((new[None],) if r else ())

    args = (rows,) + ((res,) if res is not None else ())
    f = jax.jit(jax.shard_map(body, mesh=mesh,
                              in_specs=tuple(P(HVD_AXIS) for _ in args),
                              out_specs=tuple(P(HVD_AXIS) for _ in args)))
    outs = [np.asarray(o) for o in f(*args)]
    return outs[0], outs[1] if res is not None else None


def _fused_rounds(seed, dtype, shapes, n=2, rounds=2):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal((n,) + s) * rng.lognormal(0, 2))
             .astype(np.float32) for s in shapes] for _ in range(rounds)]


SHAPES = [(3000,), (40, 30), (7,), (1, 50)]
INT8_FUSED = [
    # (case, dtype, op, prescale, postscale, rounds)
    ("f32_avg", "float32", "Average", 1.0, 1.0, _fused_rounds(7, "float32",
                                                              SHAPES)),
    ("bf16_sum", "bfloat16", "Sum", 0.5, 3.0, _fused_rounds(8, "bfloat16",
                                                            SHAPES)),
]
CAST_FUSED = [
    ("cast_f32_avg", "float32", "Average", 0.25, 1.0,
     _fused_rounds(9, "float32", SHAPES, rounds=1)),
    ("cast_bf16_sum", "bfloat16", "Sum", 0.5, 3.0,
     _fused_rounds(10, "bfloat16", SHAPES, rounds=1)),
]
# The cast wire at a prescale of 1/3, read after the flush statistics.
CAST_THIRD = [
    ("cast_f32_third", "float32", "Sum", 1.0 / 3.0, 1.0,
     _fused_rounds(15, "float32", SHAPES, rounds=1)),
    ("cast_bf16_third", "bfloat16", "Sum", 1.0 / 3.0, 1.0,
     _fused_rounds(16, "bfloat16", SHAPES, rounds=1)),
]
# Two same-shaped Compression.int8 tensors, two rounds each (the second
# reads the first's residual).
TWINS = {name: [_rows(seed + i, 2, 4096) for i in range(2)]
         for name, seed in (("twin_a", 17), ("twin_b", 19))}
EXACT = [
    ("small_sum", "Sum", _rows(11, 2, 100)),
    ("big_max", "Max", _rows(12, 2)),
    ("big_min", "Min", _rows(13, 2)),
    ("big_adasum", "Adasum", np.repeat(_rows(14, 1), 2, axis=0)),
]


@pytest.fixture(scope="module")
def worlds():
    """Every gloo world of this file, started at once on threads while the
    JAX references compile."""
    from horovod_tpu.models import mlp as jm
    from test_torch_bert import draw_params
    rng = np.random.default_rng(21)
    x = rng.standard_normal((16, 28, 28)).astype(np.float32)
    y = rng.integers(0, 10, 16).astype(np.int32)
    params = draw_params(jm.MLP(), x[:1], seed=22)
    return {
        "mlp": helpers.run_world_async(
            helpers.dp_mlp_int8, 2, args=(params, x, y, MLP_STEPS, MLP_LR)),
        "int8": helpers.run_world_async(
            helpers.wire_world, 2, args=({
                "exchange": _exchange_data(2), "fused": INT8_FUSED,
                "exact": EXACT, "shutdown": True},),
            env={"HOROVOD_WIRE_DTYPE": "int8"}),
        "cast": helpers.run_world_async(
            helpers.wire_world, 2, args=({"fused": CAST_FUSED,
                                          "late_fused": CAST_THIRD,
                                          "twins": TWINS},),
            env={"HOROVOD_WIRE_DTYPE": "bfloat16"}),
        "three": helpers.run_world_async(
            helpers.wire_world, 3, args=({"exchange": _exchange_data(3),
                                          "mismatch": True},)),
    }


def _world(worlds, name):
    return worlds[name].result(timeout=180)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", [c[0] for c in EX_CASES])
def test_exchange_matches_jax(worlds, n, case):
    port = _world(worlds, "int8" if n == 2 else "three")
    (_, rows, res, w, avg, pre, post), = [
        d for d in _exchange_data(n) if d[0] == case]
    out, new = _jax_exchange(rows, res, w, avg, pre, post)
    for r in range(n):
        got, got_res = port[r][case]
        flips = np.flatnonzero(got != out[r])
        # Row-order sums on both sides: no level flips at all.
        assert flips.size == 0, (n, case, flips.size, flips[:10])
        np.testing.assert_array_equal(got.view(np.uint32),
                                      out[r].view(np.uint32))
        if res is None:
            assert got_res is None
        else:
            np.testing.assert_array_equal(got_res.view(np.uint32),
                                          new[r].view(np.uint32))


def _jax_fused(dt, op, pre, post, rounds, wire_dtype, ef):
    from horovod_tpu.ops.collective_ops import ReduceOp
    from horovod_tpu.ops.fusion import _fused_program
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dt]
    mesh = Mesh(np.array(jax.devices()[:2]), (HVD_AXIS,))
    shapes = tuple((2,) + s for s in SHAPES)
    total = sum(int(np.prod(s)) for s in SHAPES)
    prog = _fused_program(mesh, 2, ReduceOp[op.upper()], pre, post, shapes,
                          (jnp.dtype(jdt).name,) * len(shapes), wire_dtype,
                          None, "flat", (), ef)
    res = jnp.zeros((2, total), jnp.float32)
    outs = []
    for arrays in rounds:
        got = prog(*[jnp.asarray(a, jdt) for a in arrays],
                   *((res,) if ef else ()))
        if ef:
            got, res = got[:-1], got[-1]
        outs.append([np.asarray(g, np.float32) for g in got])
    return outs


@pytest.mark.parametrize("case", [c[0] for c in INT8_FUSED + CAST_FUSED])
def test_fused_bucket_matches_jax(worlds, case):
    on_int8 = case in [c[0] for c in INT8_FUSED]
    port = _world(worlds, "int8" if on_int8 else "cast")
    (_, dt, op, pre, post, rounds), = [
        c for c in INT8_FUSED + CAST_FUSED if c[0] == case]
    ref = _jax_fused(dt, op, pre, post, rounds,
                     jnp.int8 if on_int8 else jnp.bfloat16, on_int8)
    for r in range(2):
        for i, (got, want) in enumerate(zip(port[r][case], ref)):
            # One bucket of the group, on the world's wire.
            assert got["quantized"] == (1 if on_int8 else 0)
            assert got["signature"] == (
                (f"torch.{dt}", "int8") if on_int8
                else ("torch.bfloat16", "bfloat16"))
            for g, w in zip(got["outs"], want):
                np.testing.assert_array_equal(
                    g.reshape(-1).view(np.uint32),
                    w[r].reshape(-1).view(np.uint32),
                    err_msg=f"{case} round {i} rank {r}")


def _bf16_rne(x):
    """fp32 -> bf16 (as fp32), one rounding to nearest even."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case", [c[0] for c in CAST_THIRD])
def test_cast_wire_rounds_a_third_prescale_once(worlds, case):
    """The bf16 cast bucket at a prescale of 1/3: the tensor and the scale
    in the wire dtype (JAX's rounding points), their fp32 product (exact)
    rounded once to bf16, the two ranks' summed and rounded once, the
    postscale 1 (ROADMAP C2)."""
    port = _world(worlds, "cast")
    (_, dt, op, pre, post, rounds), = [c for c in CAST_THIRD if c[0] == case]
    third = _bf16_rne(np.float32(pre))
    for r in range(2):
        got, = port[r][case]
        assert got["quantized"] == 0
        assert got["signature"] == ("torch.bfloat16", "bfloat16")
        for g, a in zip(got["outs"], rounds[0]):
            packed = _bf16_rne(_bf16_rne(a.astype(np.float32)) * third)
            want = _bf16_rne(packed[0] + packed[1])
            np.testing.assert_array_equal(
                g.reshape(-1).view(np.uint32), want.reshape(-1).view(
                    np.uint32), err_msg=f"{case} rank {r}")


def test_int8_compression_keeps_a_residual_per_tensor(worlds):
    """Two same-shaped tensors under Compression.int8, interleaved: each
    output and each error-feedback residual bit-equal to the one the tensor
    gets when it is the only one of its shape, one store key each
    (ROADMAP C1)."""
    for r, port in enumerate(_world(worlds, "cast")):
        twins = port["twins"]
        assert twins["keys"] == 2
        for name in TWINS:
            (outs, res), (outs1, res1) = twins["alone"][name], \
                twins["both"][name]
            assert len(res) == 1 and len(res1) == 1
            assert np.abs(res[0]).max() > 0          # a quantized round
            np.testing.assert_array_equal(res1[0].view(np.uint32),
                                          res[0].view(np.uint32))
            for a, b in zip(outs, outs1):
                np.testing.assert_array_equal(
                    b.view(np.uint32), a.view(np.uint32),
                    err_msg=f"{name} rank {r}")
        a, b = (twins["alone"][n][0][1] for n in TWINS)
        assert not np.array_equal(a, b)


def test_unnamed_int8_calls_keep_no_residual(worlds):
    """Two same-shaped tensors under Compression.int8 with no name,
    interleaved: the store keeps nothing, and every round's output is
    bit-equal to that round alone on an empty store, not to a round that
    reads the other tensor's residual (ROADMAP C1)."""
    for r, port in enumerate(_world(worlds, "cast")):
        twins = port["twins"]
        assert twins["unnamed_keys"] == 0
        for name in TWINS:
            got, fresh = twins["unnamed"][name], twins["fresh"][name]
            for i, (a, b) in enumerate(zip(got, fresh)):
                np.testing.assert_array_equal(
                    a.view(np.uint32), b.view(np.uint32),
                    err_msg=f"{name} round {i} rank {r}")
            # The second round with a residual differs: a shared one shows.
            assert not np.array_equal(fresh[1], twins["alone"][name][0][1])


@pytest.mark.parametrize("case", [c[0] for c in EXACT])
def test_small_and_non_sum_buckets_stay_exact(worlds, case):
    port = _world(worlds, "int8")
    (_, op, rows), = [c for c in EXACT if c[0] == case]
    want = {"Sum": rows.sum(0), "Max": rows.max(0), "Min": rows.min(0),
            "Adasum": rows[0]}[op]
    for r in range(2):
        got, quantized = port[r][case]
        assert quantized == 0
        np.testing.assert_array_equal(got, want)


def test_flush_stats_count_the_wire(worlds):
    """The int8 world's buckets: two fp32 and two bf16 rounds quantized, and
    the wire bytes by the JAX formulas."""
    port = _world(worlds, "int8")
    total = sum(int(np.prod(s)) for s in SHAPES)
    for r in range(2):
        stats = port[r]["stats"]
        assert stats["quantized"] == 4
        assert stats["wire_bytes"]["int8"] == \
            4 * jw.exchange_wire_bytes(total, 2)
    cast = _world(worlds, "cast")[0]["stats"]
    assert cast["quantized"] == 0
    assert cast["wire_bytes"]["bfloat16"] == \
        2 * jw.allreduce_wire_bytes(2 * total * 2, 2, 2, "bfloat16")


def test_residuals_are_dropped_on_shutdown(worlds):
    """``hvd.shutdown`` (and so the elastic reset) drops the residuals and
    the wire the runtime synced into the registry, not the user's pins: a
    later ``hvd.init`` without the knob runs exact."""
    port = _world(worlds, "int8")
    for r in range(2):
        before, after = port[r]["ef_keys"]
        assert before == 2 and after == 0     # the fp32 and bf16 buckets
        assert port[r]["registry"] == (("int8", "float16"), ("", "float16"))


def test_ranks_that_disagree_on_the_wire_raise(worlds):
    port = _world(worlds, "three")
    assert [port[r]["mismatch"] for r in (0, 1)] == \
        ["TensorShapeMismatchError"] * 2


# --- Compression.int8 through DistributedOptimizer --------------------------

def test_int8_compression_matches_jax_eager_path(hvd, worlds):
    """Each step's reduced gradients equal JAX's eager allreduce of the same
    local gradients under ``Compression.int8``'s one-shot request (Average
    over a 2-member set; error feedback carried per signature across the
    steps): the two large weights quantized, the biases exact."""
    mlp_port = _world(worlds, "mlp")
    ps = hvd.add_process_set(hvd.ProcessSet([0, 1]))
    jw.reset_error_feedback()
    try:
        for step in range(MLP_STEPS):
            local = [mlp_port[r]["grads"][step]["local"] for r in (0, 1)]
            for name in local[0]:
                jw.request_wire_once("int8")
                want = np.asarray(hvd.allreduce(
                    jnp.asarray(np.stack([local[0][name], local[1][name]])),
                    op=hvd.Average, process_set=ps))
                for r in (0, 1):
                    got = mlp_port[r]["grads"][step]["reduced"][name]
                    np.testing.assert_array_equal(
                        got.view(np.uint32), want[r].view(np.uint32),
                        err_msg=f"step {step} {name} rank {r}")
    finally:
        jw.reset_error_feedback()
        hvd.remove_process_set(ps)
    for r in (0, 1):
        # W0 (100352) and W1 (8192) of n x BLOCK = 2048 or more, each step.
        assert mlp_port[r]["quantized"] == 2 * MLP_STEPS
        assert mlp_port[r]["losses"][-1] < mlp_port[r]["losses"][0]
    a, b = (mlp_port[r]["params"] for r in (0, 1))
    assert all(a[k].tobytes() == b[k].tobytes() for k in a)
