"""Fusion-buffer pack+prescale and unpack+postscale.

Port of ``horovod_tpu/ops/pallas/kernels.py`` ``_scale_kernel`` /
``scale_buffer`` / ``scale_buffers`` (``(x as fp32 * scale)`` cast back, one
launch for a whole list of tensors). On the card the two entry points are one
CUDA kernel each (``csrc/scale_buffers.cu``, sm_90a), one launch per fusion
bucket:

- :func:`pack_scale` writes every tensor of a bucket, scaled, into its slot
  of the flat fusion buffer;
- :func:`unpack_scale` writes each slot of the flat buffer, scaled, back into
  its tensor, in place (for the optimizer, ``p.grad``).

The tensors and the buffer may differ in dtype (fp32, fp16 and bf16 each):
the scale is then applied in the buffer's dtype, which is what the quantized
wire (bf16/fp16 gradients into an fp32 work buffer) and the 16-bit cast wire
(fp32 gradients into a bf16/fp16 buffer) need to round where the JAX fused
program rounds. A bucket whose tensors mix dtypes takes one launch per
dtype.

The TPU kernel's (8, 128) row padding and its VMEM element cap are TPU layout
moves and have no counterpart here.

The kernel reads a table of (pointer, numel, offset) rows, one per tensor,
that goes to the card as a kernel parameter (by value): each launch costs
the host a pass over the tensors and nothing else, with no device table to
allocate, copy or keep. A kept table would not pay: a training step's
gradients come back at new addresses from step to step (ResNet-50's did at
every step), so most launches would have to build one again. A bucket of
more than ``_MAX_ROWS`` tensors takes one launch per ``_MAX_ROWS``.

A CPU tensor takes the plain PyTorch version beside the kernel
(:func:`pack_scale_reference`, :func:`unpack_scale_reference`); a CUDA tensor
launches the kernel or raises. The module-level ``pack_launches`` and
``unpack_launches`` count kernel launches, and nothing else.
"""

import array
import ctypes
import itertools
import operator

import torch

from horovod_tpu_torch.ops.kernels import _build

# Launch counters: one per kernel launch, never for the plain version.
pack_launches = 0
unpack_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_THREADS = 256            # kThreads in csrc/scale_buffers.cu
_ELEMS_PER_THREAD = 4     # grid x sized for ~4 elements a thread on average
_MAX_BLOCKS_X = 4096      # larger tensors are covered by the grid-stride loop
_MAX_ROWS = 256           # kMaxRows: the rows one launch's parameters hold
_DTYPE_OF = operator.attrgetter("dtype")
_DEVICE_OF = operator.attrgetter("device")

DTYPES = tuple(_DTYPE_CODES)


def reset_launch_counts():
    global pack_launches, unpack_launches
    pack_launches = 0
    unpack_launches = 0


def _check(tensors, flat, what):
    """Refuses what the kernel does not take; returns the tensors' numels.
    One pass over the tensors per attribute (``map`` over the unbound
    methods): the host's cost of a launch is mostly this."""
    if not isinstance(flat, torch.Tensor) or flat.dim() != 1 \
            or not flat.is_contiguous():
        raise ValueError(f"{what}: the fusion buffer must be a contiguous "
                         "1-D tensor")
    if flat.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {flat.dtype} is not one of "
                        f"{list(_DTYPE_CODES)}")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {flat.device} are not supported")
    device = flat.device
    if not set(map(_DTYPE_OF, tensors)) <= _DTYPE_CODES.keys() \
            or not set(map(_DEVICE_OF, tensors)) <= {device}:
        t = next(t for t in tensors
                 if t.dtype not in _DTYPE_CODES or t.device != device)
        raise TypeError(f"{what}: tensor {t.dtype} on {t.device} does not "
                        f"match the buffer's {flat.dtype} on {device} (the "
                        f"kernel takes {list(_DTYPE_CODES)})")
    if not all(map(torch.Tensor.is_contiguous, tensors)):
        raise ValueError(f"{what}: tensors must be contiguous")
    numels = list(map(torch.Tensor.numel, tensors))
    total = sum(numels)
    if total != flat.numel():
        raise ValueError(f"{what}: the tensors hold {total} elements but the "
                         f"buffer {flat.numel()}")
    return numels


def _f32_scale(scale):
    return torch.tensor(float(scale), dtype=torch.float32)


def pack_scale_reference(tensors, out_flat, scale):
    """Plain version of :func:`pack_scale`: each tensor rounded to the
    buffer's dtype, concatenated in fp32, scaled, rounded into
    ``out_flat``."""
    if tensors:
        dt = out_flat.dtype
        cat = torch.cat([t.reshape(-1).to(dt).float() for t in tensors])
        out_flat.copy_((cat * _f32_scale(scale)).to(dt))
    return out_flat


def unpack_scale_reference(flat, tensors, scale):
    """Plain version of :func:`unpack_scale`: scale the buffer in fp32,
    round to its dtype, and copy each slice into its tensor (rounding to the
    tensor's dtype)."""
    scaled = (flat.float() * _f32_scale(scale)).to(flat.dtype)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(scaled[off:off + n].view(t.shape))
        off += n
    return tensors


def table_rows(tensors, numels, offsets=None):
    """The kernel's rows, as (pointers, numels, offsets), and the grid's x
    size: ~4 elements a thread for a tensor of the bucket's mean size.
    ``offsets`` default to the running sum of ``numels``. Host only."""
    if offsets is None:
        offsets = list(itertools.accumulate(numels, initial=0))[:-1]
    mean = max(sum(numels) // max(len(numels), 1), 1)
    blocks_x = min(max(-(-mean // (_THREADS * _ELEMS_PER_THREAD)), 1),
                   _MAX_BLOCKS_X)
    return (list(map(torch.Tensor.data_ptr, tensors)), numels,
            offsets), blocks_x


def launch_tables(rows):
    """The rows cut into one table per launch, each as the kernel takes it:
    an int64 array of its pointers, then its numels, then its offsets, at
    most ``_MAX_ROWS`` rows. Host only."""
    ptrs, numels, offsets = rows
    tables = []
    for i in range(0, len(ptrs), _MAX_ROWS):
        table = array.array("q", ptrs[i:i + _MAX_ROWS])
        table.extend(numels[i:i + _MAX_ROWS])
        table.extend(offsets[i:i + _MAX_ROWS])
        tables.append(table)
    return tables


_fns = {}


def _fn(name):
    """The kernel entry point ``name``, bound with its argument types
    once."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("scale_buffers"), name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(fn_name, tables, blocks_x, flat, scale, tensor_dtype=None):
    """One launch of ``fn_name`` per table of :func:`launch_tables`, on the
    current stream, for tensors of ``tensor_dtype`` (default: the buffer's);
    returns the number of launches. The tables are copied into the
    launches' parameters before this returns."""
    fn, scale = _fn(fn_name), float(scale)
    code = _DTYPE_CODES[flat.dtype]
    tcode = _DTYPE_CODES[tensor_dtype or flat.dtype]
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        for table in tables:
            err = fn(table.buffer_info()[0], len(table) // 3, blocks_x,
                     flat.data_ptr(), code, tcode, scale, stream)
            if err != 0:
                raise RuntimeError(f"{fn_name} launch failed: "
                                   f"cudaGetLastError() = {err}")
    return len(tables)


def _launch_bucket(fn_name, tensors, numels, flat, scale):
    """The launches of one bucket: one per table, and, when its tensors mix
    dtypes, one set of tables per dtype (rows keep their offsets into the
    whole buffer)."""
    dtypes = set(map(_DTYPE_OF, tensors))
    if len(dtypes) == 1:
        rows, blocks_x = table_rows(tensors, numels)
        return _launch(fn_name, launch_tables(rows), blocks_x, flat, scale,
                       tensors[0].dtype)
    offsets = list(itertools.accumulate(numels, initial=0))
    n = 0
    for dt in sorted(dtypes, key=_DTYPE_CODES.get):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dt]
        rows, blocks_x = table_rows([tensors[i] for i in idx],
                                    [numels[i] for i in idx],
                                    [offsets[i] for i in idx])
        n += _launch(fn_name, launch_tables(rows), blocks_x, flat, scale, dt)
    return n


def pack_scale(tensors, out_flat, scale):
    """``out_flat[off_i : off_i + n_i] = (t_i as fp32 * scale) -> dtype`` for
    every tensor of one bucket, in one launch (one per ``_MAX_ROWS``
    tensors, and per tensor dtype). ``out_flat`` holds exactly the tensors'
    elements, in order; the scale is applied in its dtype."""
    global pack_launches
    tensors = list(tensors)
    numels = _check(tensors, out_flat, "pack_scale")
    if out_flat.device.type == "cpu":
        return pack_scale_reference(tensors, out_flat, scale)
    if out_flat.numel():
        pack_launches += _launch_bucket("hvd_scale_pack", tensors, numels,
                                        out_flat, scale)
    return out_flat


def unpack_scale(flat, tensors, scale):
    """Inverse of :func:`pack_scale`: each tensor's slot of ``flat``, scaled
    in fp32 and rounded to ``flat``'s dtype, is written into the tensor in
    place, in one launch."""
    global unpack_launches
    tensors = list(tensors)
    numels = _check(tensors, flat, "unpack_scale")
    if flat.device.type == "cpu":
        return unpack_scale_reference(flat, tensors, scale)
    if flat.numel():
        unpack_launches += _launch_bucket("hvd_scale_unpack", tensors, numels,
                                          flat, scale)
    return tensors
