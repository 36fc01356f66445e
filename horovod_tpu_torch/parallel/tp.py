"""Tensor-parallel transformer layers: the JAX package's ``parallel/tp.py``.

Port of ``ColumnParallelDense``, ``RowParallelDense``, ``apply_rope``,
``plain_attention``, ``TPSelfAttention`` (full sequence, RoPE, grouped-query
K/V, its tp head split and its sequence-parallel route),
``TPCrossAttention`` (T5's encoder-decoder attention, with its fused K/V of
the memory projected once and fed back), ``TPMlp``, ``TPSwiGLUMlp`` and
``TPTransformerBlock``, with Flax's ``LayerNorm`` and ``RMSNorm``.

Axes are the in-step axes of ``ops/in_step.py``. A layer sizes its
parameters by the size of its ``axis_name`` when it is constructed: inside
``in_step.axes(mesh)`` a column-parallel layer holds ``features / n``
output columns and a row-parallel one ``in / n`` input rows; outside, as
JAX's modules outside ``shard_map``, every layer is its dense form. At call
time a bound axis adds the collectives: Megatron's "f" (``copy_to_axis``:
the identity forward, the cotangent summed over tp backward, what JAX's
varying-axes transpose gives) at a column-parallel input, and the
row-parallel sum ("g", whenever the axis is bound, as JAX's ``psum`` is;
at size 1 the identity, as XLA compiles a ``psum`` over one device) before
the replicated bias is added once.

Weights. ``shard_init``/``tp_shard_rng`` have no draw-for-draw counterpart
(torch's generator is not JAX's): a sharded ``Dense`` draws one seed from the
model's generator, the same on every rank, and its shard's weights from that
seed with the shard index folded in (:func:`shard_generator`). Weights for
parity with JAX come through ``models/gpt.py::load_flax``, which slices each
sharded Flax leaf as JAX lays it out.

Flax semantics kept on purpose:

- Submodules carry Flax's names (``qkv``/``out``/``in`` with a ``shard``
  Dense, the row-parallel ``bias`` added after the product, ``ln_attn``,
  ``ln_mlp``, ``attention``, ``mlp``), so ``models/gpt.py::load_flax``
  maps a Flax tree onto a module by name.
- ``Dense(dtype=..., precision=...)``: fp32 parameters, input, kernel and
  bias cast to ``dtype`` for the product; ``precision`` as Flax's, None
  (DEFAULT: TF32 for an fp32 product on CUDA) or ``"highest"``
  (:func:`at_precision`, below). No layer of the JAX package sets one, and
  no layer here does; plain attention's fp32 einsums run at DEFAULT.
- ``LayerNorm``: epsilon 1e-6, statistics in fp32, output cast to ``dtype``;
  ``RMSNorm``: fp32 mean square, fp32 ``scale`` (here ``weight``), output
  in ``dtype``.
- ``gelu`` is the tanh approximation (``flax.linen.gelu``'s default).

:func:`remat` is ``nn.remat`` for a block: ``torch.utils.checkpoint``.

Decoding against a KV cache: JAX keeps the cache in a mutable Flax
collection and builds a second module over the same parameters
(``decode=True``); the port keeps one module and one set of weights, and
the cache is an explicit :class:`DecodeCache`, passed down the model as
``cache=`` (``TPSelfAttention.forward(x, pos=..., cache=...)``), keyed by
the Flax cache path (``layer_0/attention/k``). Its tensors are allocated
once at full capacity, and every token writes into them in place at the
cursor: a host int on the shared-cursor path, a (B,) device tensor of
per-row positions on the serving path. ``decode=True`` stays accepted, as
JAX's spelling: such a module refuses to run without a cache.
"""

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.autograd.graph import get_gradient_edge, saved_tensors_hooks
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch.common.topology import TP_AXIS
from horovod_tpu_torch.ops import in_step
from horovod_tpu_torch.ops.kernels.flash_attention import flash_attention
from horovod_tpu_torch.ops.wire import symmetric_int8_quantize
from horovod_tpu_torch.parallel import sequence

# ---------------------------------------------------------------------------
# fp32 products at the precision the JAX package asks for
# ---------------------------------------------------------------------------
# A Flax layer that sets no ``precision`` (``nn.Dense``, ``nn.Conv``,
# ``jnp.einsum``; no model of the JAX package sets one) runs its products at
# ``lax.Precision.DEFAULT``, which on an H100 means TensorFloat-32 for fp32
# operands (JAX's own ``lax.Precision`` docstring); ``"highest"`` asks for
# full fp32. The port's ``Dense`` takes the same ``precision`` argument:
#
# - ``None``: fp32 products in TF32 on CUDA;
# - ``"highest"``: fp32 products in full fp32.
#
# Convolutions and plain attention's einsums always run at DEFAULT, as their
# JAX counterparts do.
#
# PyTorch chooses with process-wide flags
# (``torch.backends.cuda.matmul.allow_tf32`` for products,
# ``torch.backends.cudnn.allow_tf32`` for convolutions). :func:`at_precision`
# sets them around one function's forward and, through a
# ``torch.autograd.Function``, around its backward products too, which
# autograd runs later under whatever the flags are then; each time it puts
# them back as it found them. So the user's own products, and anything else
# the process runs, keep the flags the user chose.
#
# Precision changes nothing on the CPU, and bf16/fp16 products do not read
# the flags: there the function runs as it is, with no wrapper.

PRECISIONS = (None, "highest")


def check_precision(precision):
    """``precision`` if the port knows it, else ``ValueError``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of "
                         f"{list(PRECISIONS)} (JAX's DEFAULT and HIGHEST)")
    return precision


def allows_tf32(precision):
    """Whether ``precision`` lets an fp32 product run in TF32."""
    return check_precision(precision) is None


@contextlib.contextmanager
def tf32_flags(allow):
    """Both TF32 flags set to ``allow`` inside, restored on the way out."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = saved


class _Scoped(torch.autograd.Function):
    """``fn(*args)`` with its forward and its backward under
    :func:`tf32_flags`. The forward builds ``fn``'s own graph on detached
    inputs and keeps that graph's edge, not its output, so the output is
    freed with the caller's last use of it; the backward differentiates the
    graph, as the flags ask. Once differentiable: a double backward
    raises.

    The inner graph keeps its saved tensors itself, past any saved-tensor
    hooks of the caller: under :func:`remat`'s checkpoint, they would be
    dropped and refilled from the recomputation by graph task, and the
    backward's ``autograd.grad`` is a graph task of its own, so every scoped
    product of a block would recompute the whole block once more."""

    @staticmethod
    def forward(ctx, fn, allow, *args):
        inputs = [a.detach().requires_grad_(a.requires_grad)
                  if isinstance(a, torch.Tensor) else a for a in args]
        with torch.enable_grad(), tf32_flags(allow), \
                saved_tensors_hooks(_kept, _kept):
            out = fn(*inputs)
        ctx.allow, ctx.inputs = allow, inputs
        ctx.edge = get_gradient_edge(out) if out.requires_grad else None
        return out.detach()

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        wanted = [i for i, a in enumerate(ctx.inputs)
                  if isinstance(a, torch.Tensor) and a.requires_grad]
        grads = [None] * len(ctx.inputs)
        if wanted and ctx.edge is not None:
            with tf32_flags(ctx.allow):
                got = torch.autograd.grad(
                    ctx.edge, [ctx.inputs[i] for i in wanted], grad,
                    allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        ctx.inputs = ctx.edge = None
        return (None, None, *grads)


def _kept(t):
    # The data without its history: a tensor that its own node saves (a
    # softmax's output) would otherwise close a cycle through autograd's
    # C++ graph (node -> saved tensor -> node) that the collector cannot
    # see, and a forward whose backward never runs would keep its graph.
    return t.detach()


def at_precision(precision, fn, *args):
    """``fn(*args)``, its fp32 products at ``precision``: under the TF32
    flags it asks for, forward and backward, when an argument is an fp32
    CUDA tensor; else ``fn(*args)`` as it is. ``fn`` returns one tensor."""
    allow = allows_tf32(precision)
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if not any(t.is_cuda and t.dtype == torch.float32 for t in tensors):
        return fn(*args)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _Scoped.apply(fn, allow, *args)
    with tf32_flags(allow):
        return fn(*args)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def lecun_normal_(w, fan_in, generator=None):
    """``flax.linen.initializers.lecun_normal``: a normal truncated at two
    standard deviations, rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


def shard_generator(generator, shard):
    """The generator a tensor-parallel shard draws from: ``generator`` as
    it is unsharded (``shard`` None or of one shard), else a new one seeded
    from one draw of ``generator`` (the same draw on every rank, so the
    replicated parameters drawn after stay alike) with the shard index
    folded in, as ``tp_shard_rng`` folds the tp coordinate into JAX's key."""
    if shard is None or shard[1] == 1:
        return generator
    dev = generator.device if generator is not None else torch.device("cpu")
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=dev))
    return torch.Generator(device=dev).manual_seed(
        (seed * 1_000_003 + int(shard[0]) + 1) % 2 ** 63)


class FlaxKernel(nn.Parameter):
    """A parameter that Flax names ``kernel``, kept in torch's layout: a
    Dense weight (out, in) for Flax's (in, out), a convolution's OIHW for
    Flax's HWIO. :meth:`to_flax` turns a tensor of its shape into Flax's
    layout and :meth:`from_flax` back: ``load_flax`` loads through the
    latter, and PowerSGD matrixizes through the former, as the JAX package
    matrixizes its Flax leaves. A subclass, since ``copy.deepcopy`` and
    ``Module.to`` keep a parameter's type but not its attributes."""

    @staticmethod
    def to_flax(t):
        return t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t()

    @staticmethod
    def from_flax(t):
        return t.permute(3, 2, 0, 1) if t.dim() == 4 else t.t()


def flax_view(p, t):
    """``t``, a tensor of parameter ``p``'s shape (its gradient, say), in
    the layout of ``p``'s Flax leaf: a :class:`FlaxKernel` transposed, any
    other parameter as it is."""
    return FlaxKernel.to_flax(t) if isinstance(p, FlaxKernel) else t


def from_flax_view(p, t):
    """The inverse of :func:`flax_view`."""
    return FlaxKernel.from_flax(t) if isinstance(p, FlaxKernel) else t


class Dense(nn.Linear):
    """``flax.linen.Dense``: fp32 weight (out, in) and bias, the product in
    ``dtype`` at ``precision`` (forward and backward)."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32, precision=None):
        super().__init__(in_features, features, bias=use_bias)
        self.weight = FlaxKernel(self.weight.detach())
        self.dtype = dtype
        self.precision = check_precision(precision)
        self.shard_of = None        # (index, n) of a tensor-parallel shard

    def reset_parameters(self, generator=None):
        generator = shard_generator(generator, getattr(self, "shard_of",
                                                       None))
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return at_precision(self.precision, F.linear, x.to(dt),
                            self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(dtype=dtype)`` over the last axis: fp32
    statistics, epsilon 1e-6, fp32 scale and bias, output in ``dtype``."""

    def __init__(self, features, dtype=torch.float32, epsilon=1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias,
                         self.epsilon)
        return y.to(self.dtype)


class RMSNorm(nn.Module):
    """``flax.linen.RMSNorm(epsilon, dtype)`` over the last axis: the mean
    square in fp32, ``x * (rsqrt(ms + eps) * scale)`` in fp32 with an fp32
    ``scale`` (here ``weight``), output in ``dtype``."""

    def __init__(self, features, dtype=torch.float32, epsilon=1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(features))

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x):
        xf = x.float()
        ms = xf.square().mean(dim=-1, keepdim=True)
        return (xf * (torch.rsqrt(ms + self.epsilon) * self.weight)).to(
            self.dtype)


def reset_flax_(model, generator=None):
    """Flax's default initializers, drawn from ``generator``, on every
    ``Dense``, norm and ``nn.Embedding`` (``flax.linen.Embed``: variance
    1/features) of ``model``."""
    for m in model.modules():
        if isinstance(m, (Dense, LayerNorm, RMSNorm)):
            m.reset_parameters(generator)
        elif isinstance(m, nn.Embedding):
            lecun_normal_(m.weight, m.weight.shape[1], generator)


def remat(block, args, generator=None):
    """``block(*args)`` under non-reentrant ``torch.utils.checkpoint``, as
    ``nn.remat`` wraps a block in JAX: its activations are dropped after
    the forward and recomputed in the backward; as it is when no gradient
    is being recorded. Checkpoint restores the default generators for the
    recomputation; ``generator``, an explicit one the block draws dropout
    from, is put back to its state at the block's entry for it too, and
    left where the forward left it after."""
    if not torch.is_grad_enabled():
        return block(*args)
    if generator is None:
        return checkpoint(block, *args, use_reentrant=False)
    start, calls = generator.get_state(), []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return block(*a)
        now = generator.get_state()
        generator.set_state(start)
        try:
            return block(*a)
        finally:
            generator.set_state(now)
    return checkpoint(run, *args, use_reentrant=False)


class ColumnParallelDense(nn.Module):
    """Linear layer split on its output dim: ``features`` is the global
    width, each shard of ``axis_name`` holds ``features / n`` columns (a
    Dense named ``shard``) and gives the matching activation shard."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32, axis_name=TP_AXIS):
        super().__init__()
        n = in_step.axis_size_or_1(axis_name)
        if features % n:
            raise ValueError(f"features {features} not divisible by tp={n}")
        self.axis_name = axis_name
        self.shard = Dense(in_features, features // n, use_bias, dtype)
        if n > 1:
            self.shard.shard_of = (in_step.axis_index(axis_name), n)

    def forward(self, x):
        return self.shard(in_step.copy_to_axis(x, self.axis_name))


class RowParallelDense(nn.Module):
    """Linear layer split on its input dim: consumes a column-parallel
    activation shard (``in_features / n`` of it), sums the partial products
    over ``axis_name`` whenever it is bound, then adds the replicated bias
    once."""

    def __init__(self, in_features, features, use_bias=True,
                 dtype=torch.float32, axis_name=TP_AXIS):
        super().__init__()
        n = in_step.axis_size_or_1(axis_name)
        if in_features % n:
            raise ValueError(f"in_features {in_features} not divisible by "
                             f"tp={n}")
        self.dtype = dtype
        self.axis_name = axis_name
        self.shard = Dense(in_features // n, features, False, dtype)
        if n > 1:
            self.shard.shard_of = (in_step.axis_index(axis_name), n)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        y = in_step.reduce_from_axis(self.shard(x), self.axis_name)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


def apply_rope(x, positions, theta):
    """Rotary position embedding (rotate-half pairing), rotated in fp32 and
    cast back to ``x``'s dtype. ``x``: (B, L, h, d), d even; ``positions``:
    (L,) token positions, or (B, L) per-row positions (the decode cache's
    serving path, each row at its own offset)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta, x.device))


def rope_cos_sin(positions, d, theta, device):
    """The fp32 (cos, sin) of :func:`apply_rope`'s angles, shaped to
    broadcast over (B, L, h, d/2)."""
    if d % 2:
        raise ValueError(f"rope needs an even head_dim, got {d}")
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                  device=device) / d)            # (d/2,)
    ang = positions.to(device=device, dtype=torch.float32)[..., None] * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]                  # broadcast batch
    return cos, sin


def rotate(x, cos, sin):
    """``x`` rotated by :func:`rope_cos_sin`'s (cos, sin), in fp32."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def plain_attention(q, k, v, out_dtype, mask=None, bias=None, causal=False):
    """Scaled scores, optional additive ``bias`` (h, Lq, Lk), -1e9 causal
    (end-aligned) and key masking (``mask`` (B, Lk), True on valid keys),
    fp32 softmax. q/k/v: (B, L, h, d). Both einsums at DEFAULT."""
    return at_precision(None, _plain_attention, q, k, v, out_dtype, mask,
                        bias, causal)


def _plain_attention(q, k, v, out_dtype, mask, bias, causal):
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    if bias is not None:
        scores = scores + bias[None].to(scores.dtype)
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = torch.ones(lq, lk, dtype=torch.bool,
                          device=q.device).tril(lk - lq)
        scores = scores.masked_fill(~keep, -1e9)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
    probs = torch.softmax(scores.float(), dim=-1).to(out_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# ---------------------------------------------------------------------------
# The decode cache
# ---------------------------------------------------------------------------


class DecodeCache:
    """Every cached attention's KV decode cache, keyed by its Flax cache
    path: ``<module path>/k`` and ``/v``, or int8 with ``/k_scale`` and
    ``/v_scale`` fp32 for an int8 cache, and the cursor ``/idx``, a host
    int. ``sub(name)`` is the view a submodule reads (its entries under
    ``name/``); every view shares the one store.

    K and V are held (B, kv heads, capacity, head_dim), the scales (B, kv
    heads, capacity): the layout whose batched products the attend runs
    without a copy. JAX's tree holds them (B, capacity, kv heads, ...);
    ``models/gpt.py``'s ``cache_from_flax``/``cache_to_numpy`` swap the two
    axes.

    The tensors are written in place, so a decode step allocates none of
    them; a beam reorder gathers into a spare buffer of the same shape
    (``spare``), kept here, and swaps the two.

    ``feed`` is the scratch of one model forward (:meth:`for_feed`): what
    every layer of that feed reads alike (the masks, the rotations), made
    by the first layer and read by the rest. A view with none (an
    attention called on its own) makes its own each call."""

    def __init__(self, entries=None, prefix="", spares=None, feed=None):
        self.entries = {} if entries is None else entries
        self.prefix = prefix
        self.spares = {} if spares is None else spares
        self.feed = feed

    def sub(self, name):
        if not name:
            return self
        return DecodeCache(self.entries, f"{self.prefix}{name}/",
                           self.spares, self.feed)

    def for_feed(self):
        """This view with a fresh ``feed``: a model's cached forward
        takes one, and its layers share it."""
        return DecodeCache(self.entries, self.prefix, self.spares, {})

    def __getitem__(self, key):
        return self.entries[self.prefix + key]

    def __setitem__(self, key, value):
        self.entries[self.prefix + key] = value

    def items(self):
        """(path, value) of every entry under this view, the path whole."""
        return [(k, v) for k, v in self.entries.items()
                if k.startswith(self.prefix)]

    def spare(self, path):
        """A buffer shaped as entry ``path`` for a gather to land in."""
        t = self.entries[path]
        s = self.spares.get(path)
        if s is None or s.shape != t.shape or s.dtype != t.dtype \
                or s.device != t.device:
            s = self.spares[path] = torch.empty_like(t)
        return s

    def map(self, fn):
        """A new cache: ``fn`` of every tensor, the cursors as they are."""
        return DecodeCache({k: fn(v) if torch.is_tensor(v) else v
                            for k, v in self.entries.items()})

    def nbytes(self):
        """Bytes of every tensor (the cursors live on the host)."""
        return sum(v.numel() * v.element_size()
                   for v in self.entries.values() if torch.is_tensor(v))


def _grouped_attend(qg, keys, vals, bias, invalid, dtype):
    """The cached attend: grouped queries (B, kv, g, s, d) against the
    narrow (B, kv, L, d) cache, no broadcast of K/V (query head j of group
    n is head n * g + j); ``bias`` (kv, g, 1, L) added to the scores;
    ``invalid`` (broadcast to (B, kv, g, s, L)) masked at -1e9; an fp32
    softmax. Returns (B, kv, g, s, d)."""
    B, kv, g, s, d = qg.shape
    scores = torch.matmul(qg.reshape(B, kv, g * s, d),
                          keys.transpose(-1, -2)) / math.sqrt(d)
    scores = scores.view(B, kv, g, s, -1)
    if bias is not None:
        scores = scores + bias[None].to(scores.dtype)
    scores = scores.masked_fill(invalid, -1e9)
    probs = torch.softmax(scores, dim=-1, dtype=torch.float32).to(dtype)
    return torch.matmul(probs.view(B, kv, g * s, -1), vals).view(
        B, kv, g, s, d)


class TPSelfAttention(nn.Module):
    """Multi-head self-attention with heads sharded over ``axis_name``: a
    fused column-parallel QKV projection (shard s holds ``[q_s|k_s|v_s]``
    for its ``num_heads / n`` heads and ``num_kv_heads / n`` kv heads) and
    a row-parallel output projection, one sum per block.
    ``num_kv_heads`` < ``num_heads`` is grouped-query attention: the flash
    kernels and the sequence-parallel schemes keep K/V narrow, the plain
    path broadcasts them. ``rope_theta`` rotates Q and K at their global
    positions (under ``sp_axis``, the shard's). ``sp_axis`` routes
    attention over the token shards by ``sp_impl`` (``"ring"`` or
    ``"ulysses"``, ``parallel/sequence.py``).

    Decoding: ``forward(x, pos=..., cache=...)`` runs ``x`` (B, s) tokens
    against the layer's entries of a :class:`DecodeCache` of capacity
    ``cache_len`` (``kv_cache_int8``: int8 rows with an fp32 scale per
    (row, position, kv head)); :meth:`init_cache` allocates them."""

    def __init__(self, num_heads, hidden_size, dtype=torch.float32,
                 causal=False, use_flash=False, sp_axis=None, decode=False,
                 num_kv_heads=None, rope_theta=None, use_bias=True,
                 axis_name=TP_AXIS, sp_impl="ring", cache_len=0,
                 kv_cache_int8=False):
        super().__init__()
        n = in_step.axis_size_or_1(axis_name)
        kv_heads = num_kv_heads or num_heads
        if num_heads % n or kv_heads % n:
            raise ValueError(f"num_heads {num_heads} / num_kv_heads "
                             f"{kv_heads} not divisible by tp={n}")
        if num_heads % kv_heads:
            raise ValueError(f"num_kv_heads {kv_heads} must divide num_heads "
                             f"{num_heads}")
        self.num_heads = num_heads
        self.num_kv_heads = kv_heads
        self.local_heads, self.local_kv = num_heads // n, kv_heads // n
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.causal = causal
        self.use_flash = use_flash
        self.rope_theta = rope_theta
        self.sp_axis, self.sp_impl = sp_axis, sp_impl
        self.decode = decode
        self.cache_len = cache_len
        self.kv_cache_int8 = kv_cache_int8
        self.qkv = ColumnParallelDense(
            hidden_size, (num_heads + 2 * kv_heads) * self.head_dim,
            use_bias=use_bias, dtype=dtype, axis_name=axis_name)
        self.out = RowParallelDense(num_heads * self.head_dim, hidden_size,
                                    use_bias=use_bias, dtype=dtype,
                                    axis_name=axis_name)

    def _attend(self, q, k, v, mask, bias=None):
        """The sequence-parallel schemes, flash (``use_flash``, no mask) or
        plain attention. Narrow K/V are broadcast only for the plain
        path."""
        flash = self.use_flash and mask is None
        if bias is not None and (self.sp_axis is not None or flash):
            raise ValueError("additive attention bias is supported on the "
                             "plain path only (not flash/sp)")
        if self.sp_axis is not None:
            if mask is not None:
                raise ValueError(
                    "padding masks are not supported with sp_axis (causal "
                    "masking is handled inside the sp schemes)")
            if self.sp_impl == "ring":
                return sequence.ring_attention(
                    q, k, v, axis_name=self.sp_axis, causal=self.causal,
                    use_flash=self.use_flash)
            if self.sp_impl == "ulysses":
                return sequence.ulysses_attention(
                    q, k, v, axis_name=self.sp_axis, causal=self.causal,
                    use_flash=self.use_flash)
            raise ValueError(f"unknown sp_impl {self.sp_impl!r}")
        if flash:
            return flash_attention(q, k, v, causal=self.causal)
        g = q.shape[2] // k.shape[2]
        if g > 1:
            k = k.repeat_interleave(g, dim=2)
            v = v.repeat_interleave(g, dim=2)
        return plain_attention(q, k, v, out_dtype=self.dtype, mask=mask,
                               bias=bias, causal=self.causal)

    def init_cache(self, cache, batch, device):
        """Zeroed entries at full capacity for ``batch`` rows under
        ``cache`` (this layer's view), the cursor at 0."""
        if self.cache_len < 1:
            raise ValueError("decode=True requires cache_len >= 1")
        shape = (batch, self.local_kv, self.cache_len, self.head_dim)
        dt = torch.int8 if self.kv_cache_int8 else self.dtype
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=dt, device=device)
            if self.kv_cache_int8:
                cache[f"{name}_scale"] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=device)
        cache["idx"] = 0

    def _decode_attend(self, q, k, v, cache, bias=None, pos=None):
        """``s`` query tokens against the cache: q (B, s, h, d), k/v (B, s,
        kv, d). The new K/V rows go in place at the cursor ``idx`` (RoPE
        at the cache positions first, so the cache holds rotated K), or,
        with ``pos`` a (B,) tensor, row b's at ``pos[b] + i`` (the cursor
        then still advances by s, as JAX's does, and is not read). Query i
        sees cache positions <= idx + i (per row: <= pos[b] + i), causal
        within the chunk. ``bias``: (local heads, 1, cache_len), one
        token's T5 relative-position row. A write past the capacity
        raises; it is never clamped. The masks and rotations are made once
        a feed, for every layer (``DecodeCache.feed``)."""
        B, s, h, d = q.shape
        kv = k.shape[2]
        L = self.cache_len
        if tuple(cache["k"].shape) != (B, kv, L, d):
            raise ValueError(f"the decode cache holds "
                             f"{tuple(cache['k'].shape)} rows for a ({B}, "
                             f"{kv}, {L}, {d}) feed")
        idx = cache["idx"]
        per_row = torch.is_tensor(pos) and pos.dim() == 1
        if s > L:
            raise ValueError(f"{s} tokens exceed the decode cache's "
                             f"capacity {L}")
        dev = q.device
        feed = {} if cache.feed is None else cache.feed

        def once(key, make):
            # Keyed by what it is made of, so layers whose cursors differ
            # never share it.
            if key not in feed:
                feed[key] = make()
            return feed[key]
        ar = once(("arange", L), lambda: torch.arange(L, device=dev))
        if per_row:
            if bias is not None:
                raise ValueError("per-row decode positions do not compose "
                                 "with an attention bias (T5 relative "
                                 "positions feed the shared-cursor path)")
            at = ("rows", s, L)

            def rows():
                # Checked where it costs no wait on the card: positions on
                # the host (on the card an index past the end is a device
                # assert, never a clamp).
                if not pos.is_cuda and (int(pos.min()) < 0
                                        or int(pos.max()) + s > L):
                    raise ValueError(
                        f"per-row positions {pos.tolist()} + {s} exceed "
                        f"the decode cache's capacity {L}")
                posm = pos.to(dev, torch.long)[:, None] + ar[:s]   # (B, s)
                return posm, (ar[None, None, :]
                              > posm[:, :, None])[:, None, None]
            posm, invalid = once(at, rows)
        else:
            if idx + s > L:
                raise ValueError(f"the decode cache is full: cursor {idx} + "
                                 f"{s} tokens exceed its capacity {L}")
            at = ("cursor", idx, s, L)
            invalid = once(at, lambda: ar[None, :] > (idx + ar[:s])[:, None])
        if self.rope_theta is not None:
            cos, sin = once(at + ("rope", d, self.rope_theta),
                            lambda: rope_cos_sin(
                                posm if per_row else ar[idx:idx + s],
                                d, self.rope_theta, dev))
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)  # K kept rotated
        rows = {"k": k, "v": v}
        if self.kv_cache_int8:
            for name, t in list(rows.items()):
                # one fp32 scale per (B, s, kv) row, over the head dim
                rows[name], rows[f"{name}_scale"] = symmetric_int8_quantize(
                    t.float())
        for name, t in rows.items():
            if per_row:
                cache[name][once(("arange", B), lambda: torch.arange(
                    B, device=dev))[:, None], :, posm] = t
            else:
                cache[name][:, :, idx:idx + s] = t.transpose(1, 2)
        cache["idx"] = idx + s
        keys, vals = cache["k"], cache["v"]
        if self.kv_cache_int8:
            keys = (keys.float() * cache["k_scale"][..., None]).to(q.dtype)
            vals = (vals.float() * cache["v_scale"][..., None]).to(q.dtype)
        # Query head j reads kv head j // g, as the plain path's
        # repeat_interleave pairs them.
        g = h // kv
        if bias is not None:
            bias = bias.reshape(kv, g, 1, L)
        qg = q.reshape(B, s, kv, g, d).permute(0, 2, 3, 1, 4)
        out = at_precision(None, _grouped_attend, qg, keys, vals, bias,
                           invalid, self.dtype)
        return out.permute(0, 3, 1, 2, 4).reshape(B, s, h, d)

    def forward(self, x, mask=None, bias=None, pos=None, cache=None):
        """``x`` (B, L, hidden). With ``cache`` (this layer's view of a
        :class:`DecodeCache`), the decode route: ``x`` holds s tokens at
        the cursor, or at the (B,) per-row positions ``pos``. Without it
        ``pos`` is not read, as JAX's module outside decode mode."""
        if cache is None and self.decode:
            raise ValueError("decode mode reads a decode cache: pass cache= "
                             "(generate.init_decode_cache)")
        if cache is not None:
            if self.sp_axis is not None or mask is not None:
                raise ValueError(
                    "decode mode supports neither sp_axis nor masks")
            if bias is not None and x.shape[1] != 1:
                raise ValueError(
                    f"decode with an attention bias (T5 relative "
                    f"positions) feeds ONE token per call, got "
                    f"{x.shape[1]}")
            if self.cache_len < 1:
                raise ValueError("decode=True requires cache_len >= 1")
        hd = self.head_dim
        q, k, v = self.qkv(x).split(
            [self.local_heads * hd, self.local_kv * hd,
             self.local_kv * hd], dim=-1)
        q, k, v = (t.unflatten(-1, (-1, hd)) for t in (q, k, v))
        if cache is not None:
            out = self._decode_attend(q, k, v, cache, bias=bias, pos=pos)
            return self.out(out.flatten(-2))
        if self.rope_theta is not None:
            L = x.shape[-2]
            off = 0
            if in_step.axis_size_or_1(self.sp_axis) > 1:
                off = in_step.axis_index(self.sp_axis) * L
            positions = off + torch.arange(L, device=x.device)
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)
        out = self._attend(q, k, v, mask, bias=bias)
        return self.out(out.flatten(-2))


class TPCrossAttention(nn.Module):
    """Encoder-decoder attention with heads sharded over ``axis_name``: the
    queries from a column-parallel ``q`` over the decoder stream, K and V
    from one fused column-parallel ``kv`` over ``memory`` (shard s holds
    ``[k_s|v_s]``), plain attention with ``memory_mask`` (B, Lk) True on
    valid keys, and a row-parallel ``out``: one sum over the axis a block,
    as :class:`TPSelfAttention`."""

    def __init__(self, num_heads, hidden_size, dtype=torch.float32,
                 axis_name=TP_AXIS, use_bias=True):
        super().__init__()
        n = in_step.axis_size_or_1(axis_name)
        if num_heads % n:
            raise ValueError(f"num_heads {num_heads} not divisible by tp={n}")
        self.head_dim = hidden_size // num_heads
        self.dtype = dtype
        self.q = ColumnParallelDense(hidden_size, hidden_size,
                                     use_bias=use_bias, dtype=dtype,
                                     axis_name=axis_name)
        self.kv = ColumnParallelDense(hidden_size, 2 * hidden_size,
                                      use_bias=use_bias, dtype=dtype,
                                      axis_name=axis_name)
        self.out = RowParallelDense(hidden_size, hidden_size,
                                    use_bias=use_bias, dtype=dtype,
                                    axis_name=axis_name)

    def forward(self, x, memory, memory_mask=None, cached_kv=None,
                project_only=False):
        """``project_only=True`` returns the fused K/V of ``memory`` (``x``
        ignored): a decode loop projects the static memory once and feeds
        the result back each step as ``cached_kv``."""
        if project_only:
            return self.kv(memory)
        q = self.q(x)
        kv = cached_kv if cached_kv is not None else self.kv(memory)
        k, v = kv.chunk(2, dim=-1)
        q, k, v = (t.unflatten(-1, (-1, self.head_dim)) for t in (q, k, v))
        out = plain_attention(q, k, v, out_dtype=self.dtype,
                              mask=memory_mask)
        return self.out(out.flatten(-2))


class TPMlp(nn.Module):
    """Column-parallel expansion, tanh gelu, row-parallel contraction: one
    sum over ``axis_name`` per block."""

    def __init__(self, intermediate_size, hidden_size, dtype=torch.float32,
                 axis_name=TP_AXIS):
        super().__init__()
        setattr(self, "in", ColumnParallelDense(
            hidden_size, intermediate_size, dtype=dtype, axis_name=axis_name))
        self.out = RowParallelDense(intermediate_size, hidden_size,
                                    dtype=dtype, axis_name=axis_name)

    def forward(self, x):
        h = getattr(self, "in")(x)
        return self.out(F.gelu(h, approximate="tanh"))


class TPSwiGLUMlp(nn.Module):
    """Gated MLP: a fused column-parallel ``gate_up`` projection (shard s
    holds ``[gate_s|up_s]``), ``act(gate) * up`` with ``"silu"`` (SwiGLU)
    or ``"gelu"`` (tanh; GEGLU), and a row-parallel ``out`` contraction."""

    ACTIVATIONS = {"silu": F.silu,
                   "gelu": lambda h: F.gelu(h, approximate="tanh")}

    def __init__(self, intermediate_size, hidden_size, dtype=torch.float32,
                 use_bias=False, activation="silu", axis_name=TP_AXIS):
        super().__init__()
        if activation not in self.ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; choose "
                             f"from {sorted(self.ACTIVATIONS)}")
        self.act = self.ACTIVATIONS[activation]
        self.gate_up = ColumnParallelDense(hidden_size, 2 * intermediate_size,
                                           use_bias=use_bias, dtype=dtype,
                                           axis_name=axis_name)
        self.out = RowParallelDense(intermediate_size, hidden_size,
                                    use_bias=use_bias, dtype=dtype,
                                    axis_name=axis_name)

    def forward(self, x):
        g, u = self.gate_up(x).chunk(2, dim=-1)
        return self.out(self.act(g) * u)


class TPTransformerBlock(nn.Module):
    """Pre-LN block: x + attention(ln_attn(x)), then + mlp(ln_mlp(x)); two
    sums over ``axis_name``, the norms replicated."""

    def __init__(self, num_heads, hidden_size, intermediate_size,
                 dtype=torch.float32, causal=False, use_flash=False,
                 sp_axis=None, decode=False, axis_name=TP_AXIS,
                 sp_impl="ring", cache_len=0, kv_cache_int8=False):
        super().__init__()
        self.ln_attn = LayerNorm(hidden_size, dtype)
        self.attention = TPSelfAttention(
            num_heads, hidden_size, dtype=dtype, causal=causal,
            use_flash=use_flash, sp_axis=sp_axis, decode=decode,
            axis_name=axis_name, sp_impl=sp_impl, cache_len=cache_len,
            kv_cache_int8=kv_cache_int8)
        self.ln_mlp = LayerNorm(hidden_size, dtype)
        self.mlp = TPMlp(intermediate_size, hidden_size, dtype=dtype,
                         axis_name=axis_name)

    def forward(self, x, mask=None, pos=None, cache=None):
        x = x + self.attention(self.ln_attn(x), mask, pos=pos,
                               cache=None if cache is None
                               else cache.sub("attention"))
        return x + self.mlp(self.ln_mlp(x))
