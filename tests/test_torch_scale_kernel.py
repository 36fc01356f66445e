"""The port's fusion-buffer scale entry points against the JAX package's
``ops/pallas/kernels.py::scale_buffers`` (Pallas, interpret mode on the CPU,
as tests/test_pallas.py runs it), and the host side of the table the kernel
takes by value (no card needed: the rows, their split into one table per
launch, and the checks that build them).

On the CPU the port's ``pack_scale``/``unpack_scale`` take their plain
PyTorch versions; the CUDA kernel is held against those on the card by
chip_smoke.py. Tolerance: bit-equal. Both sides multiply once in fp32 by
the fp32 scale and round once to the tensor's dtype.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.pallas import scale_buffers
from horovod_tpu_torch.ops.kernels import scale_buffers as sb
from horovod_tpu_torch.ops.kernels import pack_scale, unpack_scale

SHAPES = [(5,), (3, 7), (0,), (1,), (2, 2, 2), (1023,), (4, 0, 3), (129, 3)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
SCALES = [0.5, 1.0 / 3.0, 2.5]


def _bits(a):
    """fp32 bit patterns; widening bf16/fp16 to fp32 is exact and one to
    one, so equal bits here are equal bits in the original dtype."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_pack_scale_bit_equal_to_scale_buffers(dtype, scale):
    tdt, jdt = DTYPES[dtype]
    arrays = _inputs(0)
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    flat = torch.empty(sum(t.numel() for t in ts), dtype=tdt)
    assert pack_scale(ts, flat, scale) is flat
    ref = scale_buffers([jnp.asarray(a, jdt) for a in arrays], scale)
    expected = np.concatenate([np.asarray(o, np.float32).reshape(-1)
                               for o in ref])
    np.testing.assert_array_equal(_bits(flat.float().numpy()),
                                  _bits(expected))


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_unpack_scale_bit_equal_to_scale_buffers(dtype, scale):
    tdt, jdt = DTYPES[dtype]
    sizes = [int(np.prod(s)) for s in SHAPES]
    flat_np = np.random.default_rng(1).standard_normal(sum(sizes)).astype(
        np.float32)
    flat = torch.from_numpy(flat_np).to(tdt)
    ts = [torch.full(s, 7.0, dtype=tdt) for s in SHAPES]
    unpack_scale(flat, ts, scale)
    (ref,) = scale_buffers([jnp.asarray(flat_np, jdt)], scale)
    ref = np.asarray(ref, np.float32)
    off = 0
    for t, n, s in zip(ts, sizes, SHAPES):
        assert tuple(t.shape) == s and t.dtype == tdt
        np.testing.assert_array_equal(_bits(t.float().numpy().reshape(-1)),
                                      _bits(ref[off:off + n]))
        off += n


def test_round_trip_and_cpu_path_launches_nothing():
    sb.reset_launch_counts()
    ts = [torch.randn(3, 4), torch.randn(0), torch.randn(5)]
    flat = torch.empty(17)
    pack_scale(ts, flat, 2.0)
    out = [torch.empty_like(t) for t in ts]
    unpack_scale(flat, out, 0.5)
    for t, o in zip(ts, out):
        assert torch.equal(t, o)   # x * 2 * 0.5 is exact in fp32
    assert sb.pack_launches == 0 and sb.unpack_launches == 0


@pytest.mark.parametrize("case", ["int_dtype", "mixed_dtype", "size",
                                  "non_contiguous", "buffer_2d"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    ts, flat = [torch.ones(4), torch.ones(2)], torch.empty(6)
    if case == "int_dtype":
        ts, flat = [t.int() for t in ts], flat.int()
    elif case == "mixed_dtype":
        # fp32/fp16/bf16 tensors may fill a buffer of another of the three
        # (the mixed-dtype form); a float64 tensor may not.
        ts = [ts[0], ts[1].double()]
    elif case == "size":
        flat = torch.empty(7)
    elif case == "non_contiguous":
        ts, flat = [torch.ones(4, 2).t()], torch.empty(8)
    elif case == "buffer_2d":
        flat = torch.empty(2, 3)
    with pytest.raises((TypeError, ValueError)):
        pack_scale(ts, flat, 1.0)
    with pytest.raises((TypeError, ValueError)):
        unpack_scale(flat, ts, 1.0)



def test_table_rows_are_pointer_numel_offset():
    """One row per tensor in order, offsets the running sum, and the grid's
    x size for ~4 elements a thread at the bucket's mean size."""
    ts = [torch.empty(s) for s in ((3, 4), (0,), (5000,), (7,))]
    flat = torch.empty(5019)
    rows, blocks_x = sb.table_rows(ts, sb._check(ts, flat, "test"))
    assert list(zip(*rows)) == [(ts[0].data_ptr(), 12, 0),
                                (ts[1].data_ptr(), 0, 12),
                                (ts[2].data_ptr(), 5000, 12),
                                (ts[3].data_ptr(), 7, 5012)]
    assert blocks_x == 2        # mean 1254 elements over 256 x 4 a block
    big = [torch.empty(256 * 4 * 5000)]
    assert sb.table_rows(big, [big[0].numel()])[1] == 4096


@pytest.mark.parametrize("n", [1, sb._MAX_ROWS, sb._MAX_ROWS + 1, 3000])
def test_launch_tables_cover_a_bucket_in_order(n):
    """A table per launch of at most _MAX_ROWS rows, each laid out as the
    kernel copies it (pointers, then numels, then offsets); together they
    hold every row once, in order, with offsets into the whole buffer."""
    rows = ([1000 + 8 * i for i in range(n)], [i % 5 for i in range(n)],
            [7 * i for i in range(n)])
    tables = sb.launch_tables(rows)
    assert len(tables) == -(-n // sb._MAX_ROWS)
    got = [[], [], []]
    for t in tables:
        m = len(t) // 3
        assert len(t) == 3 * m and 1 <= m <= sb._MAX_ROWS
        assert t.typecode == "q" and t.itemsize == 8
        for k in range(3):
            got[k] += t[k * m:(k + 1) * m].tolist()
    assert got == [list(r) for r in rows]


@pytest.mark.parametrize("where", [0, 2, -1])
@pytest.mark.parametrize("kind", ["dtype", "device"])
def test_check_names_the_tensor_it_refuses(kind, where):
    """The checks run a pass per attribute over the whole bucket; the one
    tensor of a dtype the kernel does not take or of another device,
    wherever it sits, is refused and named."""
    ts = [torch.ones(2) for _ in range(5)]
    ts[where] = (torch.ones(2, dtype=torch.float64) if kind == "dtype"
                 else torch.empty(2, device="meta"))
    with pytest.raises(TypeError, match="float64 on cpu" if kind == "dtype"
                       else "on meta"):
        sb._check(ts, torch.empty(10), "pack_scale")
