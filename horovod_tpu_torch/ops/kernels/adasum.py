"""The Adasum combine, segment by segment, as a hand-written CUDA kernel.

Port of ``horovod_tpu/ops/pallas/kernels.py`` ``_adasum_kernel`` /
``adasum_combine_pallas``: in one pass and in fp32, ``dot(a, b)``, ``|a|^2``
and ``|b|^2``, then ``ca * a + cb * b`` with the eps guards of
``horovod_tpu/ops/adasum.py::adasum_combine``. Here the two vectors are flat
and cut into segments, one per tensor of a fusion bucket, and each segment
gets its own coefficients: :func:`combine_segments` is one Adasum combine
per tensor of a bucket, in two launches (``csrc/adasum.cu``, sm_90a) whatever
the number of tensors. The TPU kernel's (8, 128) padding and its VMEM element
cap are TPU layout moves and have no counterpart; nothing here has a size
cap.

Beside it, the plain PyTorch versions: :func:`adasum_combine_reference`
(the JAX ``adasum_combine``), :func:`combine_segments_reference` and
:func:`reduce_gathered_reference` (each tensor's Adasum tree over the ranks'
rows of a gathered bucket). A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises. ``launches`` counts kernel launches
(two per :func:`combine_segments` call on the card) and nothing else.
"""

import ctypes

import torch

from horovod_tpu_torch.ops.kernels import _build

EPS = 1e-30

# Launch counter: one per kernel launch, never for the plain versions.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.float64: 3}
DTYPES = tuple(_DTYPE_CODES)
_THREADS = 256                 # kThreads in csrc/adasum.cu
_ELEMS_PER_BLOCK = 16 * _THREADS
_MAX_BLOCKS_PER_SEGMENT = 1024  # longer segments: grid-stride in the block
_MAX_TABLES = 256              # runaway-signature guard for the table cache
_P = ctypes.c_void_p
_SIGNATURES = {
    "hvd_adasum_partials": [_P, ctypes.c_int64, _P, _P, _P, ctypes.c_int, _P],
    "hvd_adasum_apply": [_P, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int,
                         ctypes.c_float, _P],
}

_tables = {}


def reset_launch_counts():
    global launches
    launches = 0


class SegmentTable:
    """The segments of a flat vector, one per tensor of ``numels``, in order:
    ``segments`` lists (offset, numel). On a CUDA device it also holds the
    kernel's table on the card, one int64 row (offset, numel, first block,
    blocks) per block, and ``n_blocks``, the grid of each launch."""

    __slots__ = ("segments", "total", "n_blocks", "rows")

    def __init__(self, numels, device):
        self.segments, rows, off = [], [], 0
        for n in map(int, numels):
            if n < 0:
                raise ValueError(f"segment lengths must be >= 0, got {n}")
            self.segments.append((off, n))
            blocks = min(-(-n // _ELEMS_PER_BLOCK), _MAX_BLOCKS_PER_SEGMENT)
            rows += [(off, n, len(rows), blocks)] * blocks
            off += n
        self.total = off
        self.n_blocks = len(rows)
        self.rows = None
        if device.type == "cuda" and rows:
            self.rows = torch.tensor(rows, dtype=torch.int64).to(device)


def segment_table(numels, device):
    """The :class:`SegmentTable` of ``numels`` on ``device``, built once per
    bucket signature and kept (on the card, for a CUDA device)."""
    key = (tuple(map(int, numels)), torch.device(device))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= _MAX_TABLES:
            _tables.clear()
        table = _tables[key] = SegmentTable(*key)
    return table


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def adasum_combine_reference(a, b, eps=EPS):
    """``horovod_tpu.ops.adasum.adasum_combine`` in PyTorch: sums in fp32,
    the result cast back to ``a.dtype``."""
    af, bf = a.float(), b.float()
    dot, na, nb = (af * bf).sum(), (af * af).sum(), (bf * bf).sum()
    ca = torch.where(na > eps, 1.0 - dot / (2.0 * na.clamp_min(eps)), 1.0)
    cb = torch.where(nb > eps, 1.0 - dot / (2.0 * nb.clamp_min(eps)), 1.0)
    return (ca * af + cb * bf).to(a.dtype)


def combine_segments_reference(a, b, out, table, eps=EPS):
    """Plain version of :func:`combine_segments`: the combine of each
    segment on its own."""
    for off, n in table.segments:
        if n:
            out[off:off + n] = adasum_combine_reference(a[off:off + n],
                                                        b[off:off + n], eps)
    return out


def reduce_gathered_reference(gathered, numels, eps=EPS):
    """Plain version of ``ops.adasum.reduce_gathered``: for each tensor of the
    bucket on its own, the Adasum tree over the ranks' rows of ``gathered``
    (n, total): pairs (0, 1), (2, 3), ... at each level, an odd last one
    carried, as ``horovod_tpu.ops.adasum.adasum_tree``. Returns a new
    (total,) tensor."""
    out, off = [], 0
    for n in numels:
        level = [gathered[r, off:off + n] for r in range(gathered.shape[0])]
        while len(level) > 1:
            nxt = [adasum_combine_reference(level[i], level[i + 1], eps)
                   for i in range(0, len(level) - 1, 2)]
            if len(level) % 2:
                nxt.append(level[-1])
            level = nxt
        out.append(level[0])
        off += n
    return torch.cat(out) if out else gathered.new_empty(0)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _check(a, b, out, table):
    for t in (a, b, out):
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError("combine_segments: a, b and out must be "
                             "contiguous 1-D tensors")
        if t.dtype != a.dtype or t.device != a.device:
            raise TypeError(f"combine_segments: tensors mix {t.dtype} on "
                            f"{t.device} with {a.dtype} on {a.device}")
        if t.numel() != table.total:
            raise ValueError(f"combine_segments: the segments hold "
                             f"{table.total} elements, a tensor {t.numel()}")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"combine_segments: dtype {a.dtype} is not one of "
                        f"{list(DTYPES)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"combine_segments: tensors on {a.device} are not "
                         "supported")


def _launch(name, device, *args):
    fn = getattr(_build.load("adasum"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() = "
                           f"{err}")


def combine_segments(a, b, out, table, eps=EPS):
    """``out[seg] = adasum_combine(a[seg], b[seg])`` for every segment of
    ``table`` (from :func:`segment_table`), each with its own coefficients.
    ``a``, ``b`` and ``out`` are contiguous 1-D tensors of one dtype on one
    device, ``table.total`` long; ``out`` may be ``a``. On the card: two
    launches on the current stream."""
    global launches
    _check(a, b, out, table)
    if a.device.type == "cpu":
        return combine_segments_reference(a, b, out, table, eps)
    if table.n_blocks:
        if table.rows is None or table.rows.device != a.device:
            raise ValueError(f"combine_segments: the segment table is not on "
                             f"{a.device}")
        partials = torch.empty(3 * table.n_blocks, dtype=torch.float32,
                               device=a.device)
        code = _DTYPE_CODES[a.dtype]
        rows, n = table.rows.data_ptr(), table.n_blocks
        _launch("hvd_adasum_partials", a.device, rows, n, a.data_ptr(),
                b.data_ptr(), partials.data_ptr(), code)
        launches += 1
        _launch("hvd_adasum_apply", a.device, rows, n, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), partials.data_ptr(), code,
                float(eps))
        launches += 1
    return out
