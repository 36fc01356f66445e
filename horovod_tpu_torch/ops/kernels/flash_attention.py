"""Flash attention: forward, dQ and dK/dV as hand-written CUDA kernels.

Port of ``horovod_tpu/ops/pallas/flash_attention.py``. Three kernels in
``csrc/flash_attention.cu`` (sm_90a) replace the Pallas ones:

- ``_fa_kernel`` (via ``_fa_forward``): the online-softmax forward, returning
  ``o`` and the fp32 per-row logsumexp;
- ``_fa_bwd_dq_kernel`` and ``_fa_bwd_dkv_kernel`` (via ``_fa_backward``):
  the backward against a given logsumexp, recomputing ``P = exp(S - lse)``.

Beside them are their plain PyTorch versions (:func:`block_fwd_reference`,
:func:`block_bwd_reference`, counterparts of ``_jnp_block_fwd`` and
``_jnp_block_bwd``). All share one contract on ``(BH, L, D)`` tensors:
end-aligned causal with ``q_offset = Lk - Lq`` unless given; keys at or past
``kv_valid`` are masked; masked scores are ``NEG_INF``; a fully masked row
gives a zero output and zero gradients; lse is fp32; outputs are in the
inputs' dtype.

Numbers. In fp32 the kernels compute as the plain versions do, in fp32
throughout. In bf16 and fp16 all three kernels run their products on the
tensor cores and, as FlashAttention does, round P (forward, dV) and dS (dQ,
dK) to the inputs' dtype before the product; the plain versions keep them
in fp32 (as JAX does) unless asked to round where the kernels do
(``round_p``). The two are held to :func:`rounding_bounds`, which follows
from one rounding of an operand on each side.

Entry points:

- :func:`fa_forward` / :func:`fa_backward`: the raw ``(o, lse)`` forward and
  ``(dq, dk, dv)`` backward, as ring attention calls them per hop;
- :func:`flash_attention`: ``(B, L, H, D)`` attention as a
  ``torch.autograd.Function``. Grouped-query K/V stay narrow in the forward
  (the kernel reads them through the kv row map); the backward broadcasts
  them once, runs the MHA backward and group-sums dK/dV.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises (head dims 16, 32, 64 and 128). Unlike the JAX wrapper, nothing pads:
the kernels mask their own ragged last tile, and there is no fallback to
plain attention. ``fwd_launches``, ``bwd_dq_launches`` and
``bwd_dkv_launches`` count kernel launches and nothing else.
"""

import ctypes

import torch

from horovod_tpu_torch.ops.kernels import _build

NEG_INF = -1e30      # finite big-negative: no inf - inf NaNs in the masking
HEAD_DIMS = (16, 32, 64, 128)

# Launch counters: one per kernel launch, never for the plain versions.
fwd_launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
DTYPES = tuple(_DTYPE_CODES)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "hvd_flash_fwd": [_P] * 5 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
    "hvd_flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
    "hvd_flash_bwd_dkv": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
}


def reset_launch_counts():
    global fwd_launches, bwd_dq_launches, bwd_dkv_launches
    fwd_launches = bwd_dq_launches = bwd_dkv_launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's yardstick)
# ---------------------------------------------------------------------------

def _mask(s, causal, q_offset, kv_valid):
    """``s`` (BH, Lq, Lk) with masked scores set to ``NEG_INF``."""
    lq, lk = s.shape[-2:]
    if q_offset is None:
        q_offset = lk - lq
    if kv_valid is None:
        kv_valid = lk
    ok = None
    keys = torch.arange(lk, device=s.device)
    if kv_valid < lk:
        ok = (keys < kv_valid)[None, :]
    if causal:
        rows = q_offset + torch.arange(lq, device=s.device)
        c = rows[:, None] >= keys[None, :]
        ok = c if ok is None else ok & c
    if ok is None:
        return s
    return s.masked_fill(~ok, NEG_INF)


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` and read back as fp32; as it is when
    ``dtype`` is None."""
    return x if dtype is None else x.to(dtype).float()


def _probs(q3, k3, causal, scale, q_offset, kv_valid, lse=None):
    """(visible, p, m) of the scores: p = exp(s - m) with m the row max (the
    forward), or exp(s - lse) against a given lse (the backward, m None);
    p is zero where a score is masked. A fully masked row has lse ~ NEG_INF,
    where exp(s - lse) would not vanish: the zeros are explicit, as in the
    kernels."""
    s = torch.einsum("bqd,bkd->bqk", q3.float(), k3.float()) * scale
    s = _mask(s, causal, q_offset, kv_valid)
    ok = s > NEG_INF * 0.5
    m = s.amax(dim=-1) if lse is None else None
    p = torch.where(ok, torch.exp(s - (m if lse is None else lse)[..., None]),
                    0.0)
    return ok, p, m


def block_fwd_reference(q3, k3, v3, causal, scale, q_offset=None,
                        kv_valid=None, round_p=None):
    """Plain forward on (BH, L, D): returns (o, lse), with the kernel's
    contract. ``round_p`` (a dtype) rounds P to it before P V, as the bf16
    and fp16 kernels do; the row sum l stays fp32. None keeps P in fp32, as
    JAX's ``_jnp_block_fwd`` does."""
    _, p, m = _probs(q3, k3, causal, scale, q_offset, kv_valid)
    l = p.sum(dim=-1).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", _rounded(p, round_p),
                     v3.float()) / l[..., None]
    return o.to(q3.dtype), m + torch.log(l)


def block_bwd_reference(q3, k3, v3, o3, lse, do3, causal, scale,
                        q_offset=None, kv_valid=None, round_p=None):
    """Plain backward against a given lse: (dq, dk, dv). With the block's own
    lse this is the exact attention gradient; with a ring-wide lse, one hop's
    share of it. ``round_p`` (a dtype) rounds P before dV = P^T dO and dS
    before dQ = dS K and dK = dS^T Q, as the bf16 and fp16 kernels do. None
    keeps both in fp32, as JAX's ``_jnp_block_bwd`` does."""
    qf, kf, vf, of, dof = (t.float() for t in (q3, k3, v3, o3, do3))
    _, p, _ = _probs(q3, k3, causal, scale, q_offset, kv_valid, lse)
    dv = torch.einsum("bqk,bqd->bkd", _rounded(p, round_p), dof)
    dp = torch.einsum("bqd,bkd->bqk", dof, vf)
    delta = (dof * of).sum(dim=-1)
    ds = p * (dp - delta[..., None]) * scale
    ds_r = _rounded(ds, round_p)
    dq = torch.einsum("bqk,bkd->bqd", ds_r, kf)
    dk = torch.einsum("bqk,bqd->bkd", ds_r, qf)
    return dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype)


# The restated bound of the bf16/fp16 kernels against a plain version.
# u: unit roundoff (half an ulp at 1: 8 and 11 significant bits); eta: half
# the subnormal step, the largest error of rounding a value below the
# normal range. Both sides round P (and dS) once, each within u of the
# exact value or eta below it: c = 2. gamma: the relative error of an fp32
# sum of D products in any order, D * 2^-23 (one fp32 ulp at 1 per addition,
# as a tensor-core accumulation may truncate where IEEE rounds).
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
SUBNORMAL_HALF_STEP = {torch.bfloat16: 2.0 ** -134, torch.float16: 2.0 ** -25}
ROUNDING_C = 2.0
FP32_SUM_UNIT = 2.0 ** -23
_SIGNIFICAND_BITS = {torch.bfloat16: 8, torch.float16: 11}


def ulp(x, dtype):
    """The spacing of ``dtype``'s values at |x|, elementwise, in fp32:
    2^(e - p) for |x| in [2^(e-1), 2^e) and p significand bits, and the
    subnormal step at zero and below the normal range."""
    bits = _SIGNIFICAND_BITS[dtype]
    tiny = torch.finfo(dtype).tiny * 2.0 ** (1 - bits)     # subnormal step
    _, e = torch.frexp(x.float().abs())
    step = torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                       (e - bits).float())
    return torch.where(x == 0, tiny, step).clamp_min(tiny)


def rounding_bounds(plain, q3, k3, v3, causal, scale, q_offset=None,
                    kv_valid=None, o3=None, lse=None, do3=None):
    """Per-element bounds on |kernel - plain| of the outputs of the bf16 and
    fp16 kernels, which round P (and dS) to the inputs' dtype before a
    product, against a plain version on the same inputs, rounding or not:

        |kernel - plain| <= 2 ulp(|plain|) + c (u |A| |B| + eta n [+ f]),
                                                           c = ROUNDING_C

    ``plain`` maps any of "o", "dq", "dk", "dv" to the plain version's
    output. |A| |B| is the product over absolute values: |P| |V| / l for o
    (P against the row max), |dS| |K| for dQ, |dS|^T |Q| for dK and
    |P|^T |dO| for dV (P against ``lse``, dS with its scale); n is the same
    product with the visible entries of the rounded operand set to one. The
    2 ulp cover the two final roundings. dQ alone adds
    f = gamma (P scale (|dO| |V|^T + rowsum |dO| |O|)) |K|: each side forms
    dP - delta from two fp32 sums, and where they cancel (a row that sees
    one key has dS = 0 exactly) what is left is their fp32 error, which
    reaches dQ row by row unsummed (dK sums it over query rows, under its
    rounding term). Returns {name: bound}, fp32."""
    dt = q3.dtype
    u, eta = UNIT_ROUNDOFF[dt], SUBNORMAL_HALF_STEP[dt]
    out = {}

    def bound(name, mag, n, f=0.0):
        out[name] = 2 * ulp(plain[name], dt) + ROUNDING_C * (
            u * mag + eta * n + f)

    if "o" in plain:
        ok, p, _ = _probs(q3, k3, causal, scale, q_offset, kv_valid)
        l = p.sum(dim=-1).clamp_min(1e-30)[..., None]
        va = v3.float().abs()
        bound("o", torch.einsum("bqk,bkd->bqd", p, va) / l,
              torch.einsum("bqk,bkd->bqd", ok.float(), va) / l)
    if plain.keys() & {"dq", "dk", "dv"}:
        ok, p, _ = _probs(q3, k3, causal, scale, q_offset, kv_valid, lse)
        dof = do3.float()
        if "dv" in plain:
            bound("dv", torch.einsum("bqk,bqd->bkd", p, dof.abs()),
                  torch.einsum("bqk,bqd->bkd", ok.float(), dof.abs()))
        if plain.keys() & {"dq", "dk"}:
            dp = torch.einsum("bqd,bkd->bqk", dof, v3.float())
            delta = (dof * o3.float()).sum(dim=-1)
            ds = (p * (dp - delta[..., None]) * scale).abs()
        if "dq" in plain:
            ka, doa = k3.float().abs(), dof.abs()
            sums = (torch.einsum("bqd,bkd->bqk", doa, v3.float().abs())
                    + (doa * o3.float().abs()).sum(dim=-1)[..., None])
            gamma = q3.shape[-1] * FP32_SUM_UNIT
            bound("dq", torch.einsum("bqk,bkd->bqd", ds, ka),
                  torch.einsum("bqk,bkd->bqd", ok.float(), ka),
                  gamma * torch.einsum("bqk,bkd->bqd", p * scale * sums,
                                       ka))
        if "dk" in plain:
            qa = q3.float().abs()
            bound("dk", torch.einsum("bqk,bqd->bkd", ds, qa),
                  torch.einsum("bqk,bqd->bkd", ok.float(), qa))
    return out


def bound_ratio(got, want, bound):
    """max |got - want| / bound over the elements: within the bound iff <= 1
    (0 for empty tensors)."""
    if not got.numel():
        return 0.0
    return ((got.float() - want.float()).abs() / bound).max().item()


def gqa_repeat3(t3, b, kv, g):
    """(B*KV, L, D) -> (B*KV*g, L, D): each kv head's rows repeated g times
    contiguously, the query row layout (B*heads, L, D)."""
    _, L, D = t3.shape
    return t3.reshape(b, kv, 1, L, D).expand(b, kv, g, L, D).reshape(
        b * kv * g, L, D)


def gqa_fold3(t3, b, kv, g):
    """Group-sum (B*heads, L, D) gradients onto the narrow kv rows: the
    backward of :func:`gqa_repeat3`."""
    _, L, D = t3.shape
    return t3.reshape(b, kv, g, L, D).sum(dim=2).reshape(
        b * kv, L, D).to(t3.dtype)


# ---------------------------------------------------------------------------
# Raw entry points
# ---------------------------------------------------------------------------

def _check(what, tensors, d):
    t0 = tensors[0]
    for t in tensors:
        if not isinstance(t, torch.Tensor) or t.dim() != 3:
            raise ValueError(f"{what}: expected (rows, L, D) tensors")
        if t.dtype != t0.dtype or t.device != t0.device:
            raise TypeError(f"{what}: tensors mix {t.dtype} on {t.device} "
                            f"with {t0.dtype} on {t0.device}")
        if t.shape[-1] != d:
            raise ValueError(f"{what}: head dims differ ({t.shape[-1]} vs "
                             f"{d})")
    if t0.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t0.dtype} is not one of {DTYPES}")
    if t0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors on {t0.device} are not supported")
    if t0.device.type == "cuda":
        if d not in HEAD_DIMS:
            raise ValueError(f"{what}: the CUDA kernels take head dims "
                             f"{HEAD_DIMS}, got {d}")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{what}: CUDA tensors must be contiguous")


def _groups(bh, rows_kv, heads, kv_heads):
    """(heads, kv_heads) as the kernel takes them; MHA is (1, 1)."""
    if heads is None or kv_heads is None or heads == kv_heads:
        if rows_kv != bh:
            raise ValueError(f"k/v carry {rows_kv} rows for {bh} query rows; "
                             "pass heads and kv_heads for grouped-query "
                             "attention")
        return 1, 1
    if kv_heads <= 0 or heads % kv_heads or bh % heads \
            or rows_kv != bh // heads * kv_heads:
        raise ValueError(f"grouped-query shapes do not fit: {bh} query rows, "
                         f"{rows_kv} kv rows, heads {heads}, kv_heads "
                         f"{kv_heads}")
    return heads, kv_heads


def _launch(name, stream_device, *args):
    # A model's forward needs no hvd.init, so its first flash launch may
    # come before anything built the source; no lock is held here.
    _build.build(("flash_attention",))
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    with torch.cuda.device(stream_device):
        stream = torch.cuda.current_stream(stream_device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaGetLastError() = "
                           f"{err}")


def _aligned(t):
    """``t``, or a fresh copy when it is bf16/fp16 and its data is not
    16-byte aligned: the tensor-core kernels read rows with 16-byte copies,
    the fp32 kernels element by element."""
    if t.dtype == torch.float32 or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _int32(name, x):
    x = int(x)
    if not -2 ** 31 <= x < 2 ** 31:
        raise ValueError(f"{name} {x} does not fit the kernel's int32")
    return x


def fa_forward(q, k, v, causal, sm_scale, q_offset=None, kv_valid=None,
               heads=None, kv_heads=None):
    """(BH, Lq, D) x (BHkv, Lk, D)^2 -> (o, lse). ``heads``/``kv_heads``
    (BHkv = BH / heads * kv_heads) turn on grouped-query attention: the
    kernel reads each kv row for its ``heads / kv_heads`` query rows, with no
    broadcast."""
    global fwd_launches
    _check("fa_forward", (q, k, v), q.shape[-1])
    if k.shape != v.shape:
        raise ValueError(f"fa_forward: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    bh, lq, d = q.shape
    lk = k.shape[1]
    hs, kvs = _groups(bh, k.shape[0], heads, kv_heads)
    q_offset = lk - lq if q_offset is None else q_offset
    kv_valid = lk if kv_valid is None else kv_valid
    if q.device.type == "cpu":
        if hs != kvs:
            g = hs // kvs
            k = gqa_repeat3(k, bh // hs, kvs, g)
            v = gqa_repeat3(v, bh // hs, kvs, g)
        return block_fwd_reference(q, k, v, causal, sm_scale, q_offset,
                                   kv_valid)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    if q.numel():
        _launch("hvd_flash_fwd", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, lq,
                _int32("Lk", lk), d, _int32("q_offset", q_offset),
                _int32("kv_valid", min(kv_valid, lk)), int(bool(causal)),
                float(sm_scale), hs, kvs, _DTYPE_CODES[q.dtype])
        fwd_launches += 1
    return o, lse


def fa_backward(q, k, v, o, lse, do, causal, sm_scale, q_offset=None,
                kv_valid=None):
    """(dq, dk, dv) of attention against ``lse`` on MHA shapes: one dQ
    kernel over query tiles and one dK/dV kernel over key tiles.
    ``delta = rowsum(dO * O)`` is a torch expression, as it sits outside the
    ``pallas_call`` in JAX."""
    global bwd_dq_launches, bwd_dkv_launches
    _check("fa_backward", (q, k, v, o, do), q.shape[-1])
    bh, lq, d = q.shape
    lk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != bh or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError("fa_backward: q/o/do must be (BH, Lq, D) and k/v "
                         "(BH, Lk, D)")
    if lse.shape != (bh, lq) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"fa_backward: lse must be fp32 ({bh}, {lq}) on "
                         f"{q.device}")
    q_offset = lk - lq if q_offset is None else q_offset
    kv_valid = lk if kv_valid is None else kv_valid
    if q.device.type == "cpu":
        return block_bwd_reference(q, k, v, o, lse, do, causal, sm_scale,
                                   q_offset, kv_valid)
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    common = (_int32("Lk", lk), d, _int32("q_offset", q_offset),
              _int32("kv_valid", min(kv_valid, lk)), int(bool(causal)),
              float(sm_scale), _DTYPE_CODES[q.dtype])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    if q.numel():
        _launch("hvd_flash_bwd_dq", q.device, *ptrs, dq.data_ptr(), bh, lq,
                *common)
        bwd_dq_launches += 1
    if k.numel() and lq:
        _launch("hvd_flash_bwd_dkv", q.device, *ptrs, dk.data_ptr(),
                dv.data_ptr(), bh, lq, *common)
        bwd_dkv_launches += 1
    elif k.numel():
        dk.zero_()
        dv.zero_()
    return dq, dk, dv


# ---------------------------------------------------------------------------
# (B, L, H, D) attention with autograd
# ---------------------------------------------------------------------------

def _to3(t):
    b, L, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, L, d).contiguous()


def _from3(t3, b, h):
    _, L, d = t3.shape
    return t3.reshape(b, h, L, d).permute(0, 2, 1, 3)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        b, lq, h, _ = q.shape
        lk, kv = k.shape[1], k.shape[2]
        q3, k3, v3 = _to3(q), _to3(k), _to3(v)
        o3, lse = fa_forward(q3, k3, v3, causal, sm_scale, lk - lq, lk, h, kv)
        ctx.save_for_backward(q3, k3, v3, o3, lse)
        ctx.meta = (causal, sm_scale, b, h, kv, lq, lk)
        return _from3(o3, b, h)

    @staticmethod
    def backward(ctx, do):
        q3, k3, v3, o3, lse = ctx.saved_tensors
        causal, sm_scale, b, h, kv, lq, lk = ctx.meta
        g = h // kv
        if g > 1:
            k3, v3 = gqa_repeat3(k3, b, kv, g), gqa_repeat3(v3, b, kv, g)
        dq, dk, dv = fa_backward(q3, k3.contiguous(), v3.contiguous(), o3,
                                 lse, _to3(do), causal, sm_scale, lk - lq, lk)
        if g > 1:
            dk, dv = gqa_fold3(dk, b, kv, g), gqa_fold3(dv, b, kv, g)
        return _from3(dq, b, h), _from3(dk, b, kv), _from3(dv, b, kv), \
            None, None


def flash_attention(q, k, v, causal=False, sm_scale=None):
    """Attention over (B, L, H, D) tensors; k/v may carry fewer (grouped)
    heads than q, which must divide the query heads. ``sm_scale`` defaults
    to ``1/sqrt(D)``. Differentiable in q, k and v."""
    h, kv = q.shape[2], k.shape[2]
    if kv != h and (kv == 0 or h % kv):
        raise ValueError(
            f"kv heads {kv} must divide query heads {h} (grouped-query)")
    if sm_scale is None:
        sm_scale = 1.0 / q.shape[-1] ** 0.5
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
