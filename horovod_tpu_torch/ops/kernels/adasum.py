"""The Adasum combine, segment by segment, as hand-written CUDA kernels.

Port of ``horovod_tpu/ops/pallas/kernels.py`` ``_adasum_kernel`` /
``adasum_combine_pallas``: in fp32, ``dot(a, b)``, ``|a|^2`` and ``|b|^2``,
then ``ca * a + cb * b`` with the eps guards of
``horovod_tpu/ops/adasum.py::adasum_combine``. Here the vectors are flat and
cut into segments, one per tensor of a fusion bucket, and a unit is one
segment of one pair (a, b): each unit gets its own coefficients. A
:class:`Schedule` holds every unit of one call; on the card
(``csrc/adasum.cu``, sm_90a) it is

- one cooperative launch of the level kernel for every unit that fits in a
  round (the tiles that all CTAs of the grid hold in shared memory at
  once, ``LEVEL_BUFFERS`` steps of one tile a CTA): a and b are read from
  device memory once;
- two launches of the streaming route (partials, then apply) for the units
  longer than a round, if there are any.

:func:`combine_pairs` runs one Adasum tree level of a gathered bucket in
place (every pair of rows (i, i + s) at once); :func:`combine_segments`
runs one pair of separate vectors. The TPU kernel's (8, 128) padding and
its VMEM element cap are TPU layout moves and have no counterpart.

Beside them, the plain PyTorch versions: :func:`combine_level_reference`
(per-unit sums in the level kernel's tile order, the card's yardstick; or
whole sums, the CPU path), :func:`adasum_combine_reference` (the JAX
``adasum_combine``), :func:`combine_segments_reference` and
:func:`reduce_gathered_reference` (each tensor's Adasum tree over the ranks'
rows of a gathered bucket). A CPU tensor takes the plain version; a CUDA
tensor launches the kernels or raises, and a refused cooperative launch
raises too. ``launches`` counts the level kernel's launches and
``stream_launches`` the streaming route's, and nothing else.
"""

import ctypes

import torch

from horovod_tpu_torch.ops.kernels import _build

EPS = 1e-30

# Launch counters: one per kernel launch, never for the plain versions.
launches = 0           # the level kernel: one per call with a unit in a round
stream_launches = 0    # the streaming route: two per call with a long unit

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.float64: 3}
DTYPES = tuple(_DTYPE_CODES)
LEVEL_THREADS = 256            # kLevelThreads in csrc/adasum.cu
LEVEL_BUFFERS = 2              # kBuffers: the steps a CTA holds at once
LEVEL_SMEM_BYTES = 52 * 1024   # a CTA's dynamic shared memory: its tiles'
# a and b, a region each, in 16-byte chunks
_REGION_BYTES = LEVEL_SMEM_BYTES // (2 * LEVEL_BUFFERS) // 16 * 16
# The grid of a schedule built off the card (the CPU path, where only the
# tile order matters): four CTAs on each of an H100's 132 SMs.
DEFAULT_GRID = 528
_STREAM_THREADS = 256          # kStreamThreads in csrc/adasum.cu
_ELEMS_PER_BLOCK = 16 * _STREAM_THREADS
_MAX_BLOCKS_PER_UNIT = 1024    # longer units: grid-stride in the block
_MAX_CACHED = 256              # runaway-signature guard for the caches
_P = ctypes.c_void_p
_SIGNATURES = {
    "hvd_adasum_level_grid": [ctypes.c_int, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int)],
    "hvd_adasum_level": [_P, ctypes.c_int64, ctypes.c_int, _P, _P, _P, _P,
                         _P, ctypes.c_int64, ctypes.c_uint64, ctypes.c_int,
                         ctypes.c_int, ctypes.c_float, _P],
    "hvd_adasum_partials": [_P, ctypes.c_int64, _P, _P, _P, ctypes.c_int, _P],
    "hvd_adasum_apply": [_P, ctypes.c_int64, _P, _P, _P, _P, ctypes.c_int,
                         ctypes.c_float, _P],
}

_tables = {}
_schedules = {}
_grids = {}


def reset_launch_counts():
    global launches, stream_launches
    launches = 0
    stream_launches = 0


def tile_elems(dtype):
    """The elements of one tile: a region of shared memory holds them at
    any alignment of the row (one 16-byte chunk of slack)."""
    itemsize = torch.empty(0, dtype=dtype).element_size()
    return (_REGION_BYTES // 16 - 1) * (16 // itemsize)


def plan(units, tile, grid):
    """The steps of a call: ``units`` are (a offset, b offset, numel).

    Returns ``(tiles, stream)``: ``tiles[t]`` is the t-th tile, which CTA
    ``t % grid`` takes at step ``t // grid``, as (unit, start, length), or
    None for a slot its step leaves empty; ``stream`` lists the units longer
    than a round, what the grid holds at once (``LEVEL_BUFFERS`` steps),
    which take the streaming route. Units go in order; one that fits in a
    round is cut into near-equal tiles of at most ``tile`` elements, all
    within ``LEVEL_BUFFERS`` consecutive steps (a step that would leave too
    few for them is closed, and its slots left empty)."""
    steps = LEVEL_BUFFERS
    tiles, stream = [], []
    for u, (_, _, n) in enumerate(units):
        if n == 0:
            continue
        if n > steps * tile * grid:
            stream.append(u)
            continue
        k = -(-n // tile)
        chunk = -(-n // k)
        cuts = [(s, min(chunk, n - s)) for s in range(0, n, chunk)]
        used = len(tiles) % grid
        if used and used + len(cuts) > steps * grid:
            tiles += [None] * (grid - used)
        tiles += [(u, s, ln) for s, ln in cuts]
    return tiles, stream


class SegmentTable:
    """The segments of a flat vector, one per tensor of ``numels``, in
    order: ``segments`` lists (offset, numel); ``total`` is their sum."""

    __slots__ = ("segments", "total")

    def __init__(self, numels):
        self.segments, off = [], 0
        for n in map(int, numels):
            if n < 0:
                raise ValueError(f"segment lengths must be >= 0, got {n}")
            self.segments.append((off, n))
            off += n
        self.total = off


def segment_table(numels):
    """The :class:`SegmentTable` of ``numels``, built once per bucket
    signature and kept (on the host)."""
    key = tuple(map(int, numels))
    table = _tables.get(key)
    if table is None:
        if len(_tables) >= _MAX_CACHED:
            _tables.clear()
        table = _tables[key] = SegmentTable(key)
    return table


def tile_rows(units, tiles, grid):
    """The level kernel's rows of ``tiles`` (from :func:`plan`), as its
    ``Tile`` lays them out: the tile's offsets in a and b (int64 each),
    then int32 length and unit, int32 first tile of the unit, and 31 bits
    of the unit's tile count under a late bit, two to an int64 word. Late:
    the unit has tiles ``LEVEL_BUFFERS - 1`` steps on, which the kernel
    copies in at this tile's step, so the tile is written out only after
    that step's arrivals. An empty slot is a row of zeros."""
    first, count = {}, {}
    for t, entry in enumerate(tiles):
        if entry is not None:
            first.setdefault(entry[0], t)
            count[entry[0]] = count.get(entry[0], 0) + 1
    rows = []
    for t, entry in enumerate(tiles):
        if entry is None:
            rows.append((0, 0, 0, 0))
            continue
        u, start, ln = entry
        a_off, b_off, _ = units[u]
        n = count[u]
        late = (first[u] + n - 1) // grid >= t // grid + LEVEL_BUFFERS - 1
        word = first[u] | (n | late << 31) << 32
        rows.append((a_off + start, b_off + start, ln | u << 32,
                     word - (1 << 64) if late else word))  # as an int64
    return rows


class Schedule:
    """Every unit of one call, for one dtype on one device.

    ``units``: (a offset, b offset, numel), each segment of each pair of
    rows; ``tile`` and ``grid``: elements a tile, CTAs a step; ``tiles``
    and ``stream`` as :func:`plan` returns them; ``unit_tiles[u]``: unit u's
    (start, length) tiles, in order; ``steps``; ``stream_blocks``: the
    streaming route's grid. On a CUDA device it also holds, on the card,
    the level kernel's tile rows, slots, and epoch-tagged counters and
    coefficients, and the streaming route's rows and partials; ``epoch``
    counts the level kernel's launches over it. Every call over one
    schedule shares that state, so :func:`combine_level` orders each call
    after the last one, whatever its stream (``last_stream``), and refuses
    to be captured in a CUDA graph, whose replays would repeat one
    epoch."""

    __slots__ = ("units", "tile", "grid", "tiles", "stream", "unit_tiles",
                 "steps", "stream_blocks", "device", "dev_tiles", "slots",
                 "sync", "dev_rows", "partials", "epoch", "last_stream")

    def __init__(self, units, dtype, device, grid):
        self.units, self.device, self.grid = units, device, grid
        self.tile = tile_elems(dtype)
        self.tiles, self.stream = plan(units, self.tile, grid)
        self.steps = -(-len(self.tiles) // grid)
        self.unit_tiles = [[] for _ in units]
        for t in self.tiles:
            if t is not None:
                self.unit_tiles[t[0]].append(t[1:])
        rows = []
        for u in self.stream:
            a_off, b_off, n = units[u]
            blocks = min(-(-n // _ELEMS_PER_BLOCK), _MAX_BLOCKS_PER_UNIT)
            rows += [(a_off, b_off, n, len(rows), blocks)] * blocks
        self.stream_blocks = len(rows)
        self.epoch = 0
        self.last_stream = None
        self.dev_tiles = self.slots = self.sync = None
        self.dev_rows = self.partials = None
        if device.type != "cuda":
            return
        if self.tiles:
            host = tile_rows(units, self.tiles, grid)
            self.dev_tiles = torch.tensor(host, dtype=torch.int64).to(device)
            self.slots = torch.empty(3 * len(host), dtype=torch.float32,
                                     device=device)
            # Each unit's counter, then its two tagged coefficient words.
            self.sync = torch.zeros(3 * len(units), dtype=torch.int64,
                                    device=device)
        if rows:
            self.dev_rows = torch.tensor(rows, dtype=torch.int64).to(device)
            self.partials = torch.empty(3 * len(rows), dtype=torch.float32,
                                        device=device)


def round_elems(dtype, device):
    """The longest unit the level kernel takes on ``device``: a round,
    ``LEVEL_BUFFERS`` steps of one tile a CTA; a longer one takes the
    streaming route."""
    return LEVEL_BUFFERS * tile_elems(dtype) * level_grid(
        dtype, torch.device(device))


def level_grid(dtype, device):
    """The level kernel's grid on ``device`` (the CTAs that fit on the card
    at once, by the occupancy calculator); ``DEFAULT_GRID`` off the card."""
    if device.type != "cuda":
        return DEFAULT_GRID
    key = (dtype, device)
    grid = _grids.get(key)
    if grid is None:
        fn = _function("hvd_adasum_level_grid")
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(_DTYPE_CODES[dtype], LEVEL_SMEM_BYTES, ctypes.byref(out))
        if err != 0:
            raise RuntimeError(f"hvd_adasum_level_grid failed: cudaError "
                               f"{err} (the level kernel needs a cooperative "
                               "launch)")
        grid = _grids[key] = out.value
    return grid


def schedule(numels, pairs, row_stride, dtype, device):
    """The :class:`Schedule` of segments ``numels`` over each pair (i, j) of
    ``pairs``: unit (i * row_stride + offset, j * row_stride + offset, n)
    for each pair and segment, pair by pair. Built once per (signature,
    dtype, device) and kept."""
    device = torch.device(device)
    key = (tuple(map(int, numels)), tuple(pairs), int(row_stride), dtype,
           device)
    sched = _schedules.get(key)
    if sched is None:
        table = segment_table(key[0])
        units = [(i * row_stride + off, j * row_stride + off, n)
                 for i, j in pairs for off, n in table.segments]
        grid = level_grid(dtype, device)
        if len(_schedules) >= _MAX_CACHED:
            _schedules.clear()
        sched = _schedules[key] = Schedule(units, dtype, device, grid)
    return sched


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _coefficients(dot, na, nb, eps):
    ca = torch.where(na > eps, 1.0 - dot / (2.0 * na.clamp_min(eps)), 1.0)
    cb = torch.where(nb > eps, 1.0 - dot / (2.0 * nb.clamp_min(eps)), 1.0)
    return ca, cb


def adasum_combine_reference(a, b, eps=EPS):
    """``horovod_tpu.ops.adasum.adasum_combine`` in PyTorch: sums in fp32,
    the result cast back to ``a.dtype``."""
    af, bf = a.float(), b.float()
    ca, cb = _coefficients((af * bf).sum(), (af * af).sum(), (bf * bf).sum(),
                           eps)
    return (ca * af + cb * bf).to(a.dtype)


def _tile_order_sums(af, bf, cuts):
    """dot, |a|^2 and |b|^2 summed as the level kernel sums them across
    tiles: each tile's sums; thread k of the unit's last CTA adds tiles k,
    k + LEVEL_THREADS, ... in order; then the block's order (each warp's
    shuffle tree, then the warps in order). ``cuts``: the tiles' (start,
    length), equal but for a shorter last one."""
    if len(cuts) == 1:
        return torch.stack([(af * bf).sum(), (af * af).sum(),
                            (bf * bf).sum()])
    k, chunk = len(cuts), cuts[0][1]
    pad = k * chunk - af.numel()
    x = torch.nn.functional.pad(af, (0, pad)).view(k, chunk)
    y = torch.nn.functional.pad(bf, (0, pad)).view(k, chunk)
    sums = torch.stack([(x * y).sum(1), (x * x).sum(1), (y * y).sum(1)])
    threads = sums.new_zeros(3, LEVEL_THREADS)
    for r in range(0, k, LEVEL_THREADS):
        m = min(LEVEL_THREADS, k - r)
        threads[:, :m] += sums[:, r:r + m]
    lanes = threads.view(3, -1, 32)
    idx = torch.arange(32, device=af.device)
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, :, idx ^ o]
    total = lanes[:, 0, 0]
    for w in range(1, lanes.shape[1]):
        total = total + lanes[:, w, 0]
    return total


def combine_level_reference(a, b, out, sched, eps=EPS, tile_order=True):
    """Plain version of one call of the kernels: for every unit (a_off,
    b_off, n) of ``sched``, ``out[a_off:a_off + n]`` takes the combine of
    ``a[a_off:]`` and ``b[b_off:]`` with the unit's own coefficients, its
    sums in the level kernel's tile order (whole sums for a unit of the
    streaming route, or for every unit without ``tile_order``, as the JAX
    combine sums). ``a``, ``b`` and ``out`` are flat; ``out`` may be
    ``a``."""
    results = []
    for u, (a_off, b_off, n) in enumerate(sched.units):
        if n == 0:
            continue
        af = a[a_off:a_off + n].float()
        bf = b[b_off:b_off + n].float()
        dot, na, nb = _tile_order_sums(
            af, bf, sched.unit_tiles[u] if tile_order and sched.unit_tiles[u]
            else [(0, n)])
        ca, cb = _coefficients(dot, na, nb, eps)
        results.append((a_off, n, (ca * af + cb * bf).to(out.dtype)))
    for a_off, n, r in results:        # every unit read before any write
        out[a_off:a_off + n] = r
    return out


def combine_segments_reference(a, b, out, table, eps=EPS):
    """Each segment of ``table`` combined on its own, whole sums."""
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
# The kernels
# ---------------------------------------------------------------------------

def _check(what, tensors, total):
    a = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dim() != 1 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: the vectors must be contiguous 1-D "
                             "tensors")
        if t.dtype != a.dtype or t.device != a.device:
            raise TypeError(f"{what}: tensors mix {t.dtype} on {t.device} "
                            f"with {a.dtype} on {a.device}")
        if t.numel() != total:
            raise ValueError(f"{what}: the segments hold {total} elements, "
                             f"a vector {t.numel()}")
    if a.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {a.dtype} is not one of "
                        f"{list(DTYPES)}")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {a.device} are not supported")


def _function(name):
    fn = getattr(_build.load("adasum"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, device, *args):
    fn = _function(name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def combine_level(a, b, out, sched, eps=EPS):
    """Every unit of ``sched`` (from :func:`schedule`): ``out[a_off:][:n] =
    adasum_combine(a[a_off:][:n], b[b_off:][:n])``, each unit with its own
    coefficients. ``a``, ``b`` and ``out`` are flat tensors of one dtype on
    the schedule's device; ``out`` may be ``a``, never ``b``. On the card:
    one cooperative launch of the level kernel for the units within a round,
    and two launches of the streaming route for the longer ones, on the
    current stream, after the schedule's last call on any stream."""
    global launches, stream_launches
    if a.device.type == "cpu":
        return combine_level_reference(a, b, out, sched, eps,
                                       tile_order=False)
    if a.device != sched.device:
        raise ValueError(f"combine_level: the schedule is for "
                         f"{sched.device}, the tensors on {a.device}")
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("combine_level: the Adasum kernels cannot be "
                           "captured in a CUDA graph (each launch takes the "
                           "next epoch of its counters from the host)")
    _after_last_call(sched, a.device)
    if sched.dev_tiles is not None:
        launch_level(a, b, out, sched, eps)
        launches += 1
    if sched.dev_rows is not None:
        code = _DTYPE_CODES[a.dtype]
        rows, n = sched.dev_rows.data_ptr(), sched.stream_blocks
        _launch("hvd_adasum_partials", a.device, rows, n, a.data_ptr(),
                b.data_ptr(), sched.partials.data_ptr(), code)
        stream_launches += 1
        _launch("hvd_adasum_apply", a.device, rows, n, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), sched.partials.data_ptr(), code,
                float(eps))
        stream_launches += 1
    return out


def _after_last_call(sched, device):
    """Orders a call over ``sched`` after its last one: on another stream
    than that one's, the current stream waits for it, and the schedule's
    tensors are marked in use there for the caching allocator."""
    stream = torch.cuda.current_stream(device)
    last = sched.last_stream
    if last is not None and last != stream:
        stream.wait_stream(last)
        for t in (sched.dev_tiles, sched.slots, sched.sync, sched.dev_rows,
                  sched.partials):
            if t is not None:
                t.record_stream(stream)
    sched.last_stream = stream


def launch_level(a, b, out, sched, eps=EPS):
    """The level kernel's cooperative launch over ``sched``'s tiles, the
    next epoch of its counters; raises if the launch is refused. Checks
    nothing and counts nothing: :func:`combine_level` does both."""
    epoch = sched.epoch + 1
    _launch("hvd_adasum_level", a.device, sched.dev_tiles.data_ptr(),
            len(sched.tiles), sched.grid, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), sched.slots.data_ptr(), sched.sync.data_ptr(),
            len(sched.units), epoch, _REGION_BYTES,
            _DTYPE_CODES[a.dtype], float(eps))
    sched.epoch = epoch


def combine_segments(a, b, out, table, eps=EPS):
    """``out[seg] = adasum_combine(a[seg], b[seg])`` for every segment of
    ``table`` (from :func:`segment_table`), each with its own coefficients.
    ``a``, ``b`` and ``out`` are contiguous 1-D tensors of one dtype on one
    device, ``table.total`` long; ``out`` may be ``a``."""
    _check("combine_segments", (a, b, out), table.total)
    numels = [n for _, n in table.segments]
    return combine_level(a, b, out, schedule(numels, ((0, 0),), 0, a.dtype,
                                             a.device), eps)


def level_pairs(n_rows, stride):
    """The pairs of rows of one Adasum tree level at ``stride`` (1, 2, 4,
    ...): (i, i + stride) for i = 0, 2 stride, ... while i + stride <
    n_rows, the JAX ``adasum_tree``'s pairs with the odd one carried."""
    return tuple((i, i + stride)
                 for i in range(0, n_rows - stride, 2 * stride))


def combine_pairs(gathered, numels, stride, eps=EPS):
    """One Adasum tree level of a gathered bucket, in place: ``gathered``
    (n, total), row r what rank r packed; every pair (i, i + stride) of
    :func:`level_pairs` becomes ``row i <- combine(row i, row i + stride)``,
    per segment of ``numels``. On the card, every pair and segment in one
    call of the kernels (one launch, unless a segment is longer than a
    round)."""
    if gathered.dim() != 2 or not gathered.is_contiguous():
        raise ValueError(f"combine_pairs: expected a contiguous (ranks, "
                         f"total), got {tuple(gathered.shape)}")
    n, total = gathered.shape
    flat = gathered.view(-1)
    _check("combine_pairs", (flat,), n * segment_table(numels).total)
    pairs = level_pairs(n, stride)
    if pairs:
        combine_level(flat, flat, flat, schedule(
            numels, pairs, total, gathered.dtype, gathered.device), eps)
    return gathered
