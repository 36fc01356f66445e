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
    t = kernel.segment_table(numels)
    assert kernel.segment_table(list(numels)) is t
    assert t.segments == [(0, 0), (0, 1), (1, 4096), (4097, 4097),
                          (8194, 5_000_000)]
    assert t.total == 5_008_194
    s = kernel.schedule(numels, ((0, 0),), 0, torch.float32, "cpu")
    assert kernel.schedule(list(numels), ((0, 0),), 0, torch.float32,
                           torch.device("cpu")) is s
    # fp32: 3,324 elements a tile, 528 tiles a step off the card, and a
    # round of two steps (3,510,144 elements), so 5,000,000 is past a round
    # and takes the streaming route: 4096 elements a block, at most 1024.
    assert (s.tile, s.grid) == (3_324, 528)
    assert kernel.round_elems(torch.float32, "cpu") == 3_510_144
    assert s.stream == [4] and s.stream_blocks == 1024
    assert [len(c) for c in s.unit_tiles] == [0, 1, 2, 2, 0]
    assert s.steps == 1
    # The card's tables exist on the card only.
    assert s.dev_tiles is None and s.dev_rows is None
    # bf16 tiles hold twice the elements, float64 half.
    assert kernel.tile_elems(torch.bfloat16) == 2 * s.tile
    assert 2 * kernel.tile_elems(torch.float64) == s.tile


def _units(rng, count, most):
    return [(0, 0, int(n)) for n in rng.integers(0, most, count)]


@pytest.mark.parametrize("tile,grid,most", [(5, 4, 70), (7, 3, 65),
                                            (3_324, 528, 4_000_000)])
def test_round_schedule_covers_every_segment_once(tile, grid, most):
    """Every element of every unit in exactly one tile, in order; a unit
    that fits in a round (LEVEL_BUFFERS steps of one tile a CTA) within
    that many consecutive steps, never split further; a longer one in the
    streaming route and in no tile; units in order."""
    cap = kernel.LEVEL_BUFFERS * tile * grid
    units = _units(np.random.default_rng(tile), 60, most) + [
        (0, 0, cap), (0, 0, 1), (0, 0, cap + 1), (0, 0, cap // 2 + 1),
        (0, 0, cap // 2 + 1), (0, 0, cap // 2 + 1)]
    tiles, stream = kernel.plan(units, tile, grid)
    cover = {u: [] for u in range(len(units))}
    steps = {u: set() for u in range(len(units))}
    for t, entry in enumerate(tiles):
        if entry is not None:
            u, start, n = entry
            assert 0 < n <= tile
            cover[u].append((start, n))
            steps[u].add(t // grid)
    order = [e[0] for e in tiles if e is not None]
    assert order == sorted(order)
    for u, (_, _, n) in enumerate(units):
        if n > cap:
            assert u in stream and not cover[u]
            continue
        assert u not in stream
        at = 0
        for start, ln in cover[u]:
            assert start == at
            at += ln
        assert at == n
        assert not steps[u] or max(steps[u]) - min(steps[u]) \
            < kernel.LEVEL_BUFFERS, (u, n, steps[u])
    assert stream == [u for u, (_, _, n) in enumerate(units) if n > cap]


@pytest.mark.parametrize("steps", [2, 3])
def test_tile_rows_mark_the_tiles_of_a_unit_that_goes_on(steps, monkeypatch):
    """The kernel's rows: offsets, length, unit, first tile and count as
    packed; late exactly where the unit has tiles ``steps - 1`` steps on,
    which the kernel copies in while it holds this one (``steps``: the
    buffers a CTA holds, as the kernel is built)."""
    monkeypatch.setattr(kernel, "LEVEL_BUFFERS", steps)
    tile, grid = 5, 4
    units = [(0, 100, 7), (7, 107, 40), (47, 147, 3), (50, 150, 20)]
    tiles, stream = kernel.plan(units, tile, grid)
    assert not stream
    rows = torch.tensor(kernel.tile_rows(units, tiles, grid),
                        dtype=torch.int64).tolist()
    assert len(rows) == len(tiles)
    for t, (entry, row) in enumerate(zip(tiles, rows)):
        if entry is None:
            assert row == [0, 0, 0, 0]
            continue
        u, start, ln = entry
        a_off, b_off, lu, fn = row
        mine = [i for i, e in enumerate(tiles) if e and e[0] == u]
        assert (a_off, b_off) == (units[u][0] + start, units[u][1] + start)
        assert (lu & 0xffffffff, lu >> 32) == (ln, u)
        assert fn & 0xffffffff == mine[0]
        assert (fn >> 32) & 0x7fffffff == len(mine)
        assert (fn >> 63) & 1 == int(max(mine) // grid
                                     >= t // grid + steps - 1)
    if steps == 3:
        return
    # Two steps a round: the 40-element unit takes 8 tiles from slot 2,
    # steps 0-2 would be three, so the step is closed and it takes steps
    # 1-2, its step-1 tiles late.
    assert tiles[2:4] == [None, None]
    assert [(rows[t][3] >> 63) & 1 for t in range(4, 12)] == [1] * 4 + [0] * 4


def _pairs_of_jax_tree(n, monkeypatch):
    """The (left, right) row pairs JAX's adasum_tree combines, level by
    level, recorded on row indices; the result of a combine is its left
    row, as in the port's gathered buffer."""
    seen = []

    def record(a, b, *args, **kwargs):
        seen.append((a, b))
        return a
    monkeypatch.setattr(jax_adasum, "adasum_combine", record)
    jax_adasum.adasum_tree(list(range(n)))
    return seen


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_levels_take_the_pairs_of_jax_adasum_tree(n, monkeypatch):
    want = _pairs_of_jax_tree(n, monkeypatch)
    got, stride = [], 1
    while stride < n:
        got += list(kernel.level_pairs(n, stride))
        stride *= 2
    assert got == want


# Pallas in interpret mode costs a compile per shape: one segment of the
# shape the combine tests above use, and the JAX tree over every segment.
# The last spans 13 fp32 tiles (7 in bf16/fp16), so its sums go in
# the level kernel's tile order.
_LEVEL_SEGMENTS = (561, 0, 7, 300, 1, 40_000)


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_level_plain_version_matches_jax_and_pallas(dtype, k):
    """The level kernel's plain version (combine_level_reference, sums in
    the kernel's tile order), run level by level over the gathered rows as
    reduce_gathered runs the kernel, agrees with JAX's adasum_tree per
    tensor and with the interpreted Pallas combine's tree on the first
    tensor. Tolerance: the combine's (fp32 as above, two ulps in
    bf16/fp16) at each level of the tree, since a rounding one side flips
    at a level passes on to the next."""
    tdt, jdt = DTYPES[dtype]
    total = sum(_LEVEL_SEGMENTS)
    rng = np.random.default_rng(20 + k)
    scales = np.repeat([1.0, 0.5, 3.0, 0.05, 2.0, 0.3], _LEVEL_SEGMENTS)
    rows = (rng.standard_normal((k, total)) * scales).astype(np.float32)
    rows = np.asarray(jnp.asarray(rows, jdt).astype(jnp.float32))
    gathered = torch.from_numpy(rows.copy()).to(tdt)
    flat, stride = gathered.view(-1), 1
    while stride < k:
        kernel.combine_level_reference(flat, flat, flat, kernel.schedule(
            _LEVEL_SEGMENTS, kernel.level_pairs(k, stride), total, tdt,
            "cpu"))
        stride *= 2
    got = gathered[0].double().numpy()
    depth = int(np.ceil(np.log2(k)))
    ulp = _ULP[dtype]
    rtol, atol = (1e-5, 1e-6) if ulp is None else (2 * ulp, 2 * ulp)
    off = 0
    for i, n in enumerate(_LEVEL_SEGMENTS):
        seg = [jnp.asarray(r[off:off + n], jdt) for r in rows]
        scale = max(1.0, float(np.abs(rows[:, off:off + n]).max(initial=0)))
        want = [np.asarray(jax_adasum.adasum_tree(seg), np.float64)]
        if i == 0:
            level = seg
            while len(level) > 1:
                nxt = [adasum_combine_pallas(level[j], level[j + 1])
                       for j in range(0, len(level) - 1, 2)]
                level = nxt + level[len(level) - len(level) % 2:]
            want.append(np.asarray(level[0], np.float64))
        for w in want:
            np.testing.assert_allclose(got[off:off + n], w,
                                       rtol=depth * rtol,
                                       atol=depth * atol * scale)
        off += n


@pytest.mark.parametrize("case", ["int_dtype", "mixed_dtype", "size",
                                  "non_contiguous", "two_d"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    a, b, out = torch.ones(6), torch.ones(6), torch.empty(6)
    table = kernel.segment_table((4, 2))
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
