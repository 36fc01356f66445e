"""The PyTorch port's CUDA kernels on the card, against their plain
versions. Marked ``cuda``: they skip where no GPU is visible. This file
imports torch and the port only, so on a machine with a GPU and no JAX it
runs without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_cuda_kernels.py

Tolerances: the scale kernels bit-equal (one fp32 multiply and one
rounding on both sides), on buckets of one launch and of several, and on
a grouped reducescatter's rank-major tables. The flash kernels in fp32, and lse in every dtype, within
atol + rtol * |plain| of the plain versions: both compute in fp32 and round
once, but sum in another order (~1e-6 relative in fp32): 1e-4 relative
(lse 1e-5). The bf16/fp16 forward, dQ and dK/dV kernels run their products
on the tensor cores and round P and dS to the input type before the
product, as FlashAttention does: they are held to the plain versions that
round at the same points (``round_p``) within ``rounding_bounds``,
2 ulp(|plain|) + c (u |A| |B| + eta n) with c = 2, u the dtype's unit
roundoff and eta half its subnormal step, which follows from one rounding
of an operand on each side (dQ adds the fp32 error of dP - delta where the
two cancel); a version with the causal diagonal off by one must fail it.
Fully masked rows must be exact zeros, and reruns
bit-identical (no atomics). The Adasum combine per segment within a share
of the segment's largest plain value: 1e-5 in fp32 and float64 (the dot
product and norms are summed in another order, which moves a coefficient by
~1e-6), two ulps at that value in bf16 and fp16 (one rounding that a
coefficient can flip), against both plain versions (sums in the level
kernel's tile order, and whole sums), on both of its routes (the level
kernel, and the streaming one for a tensor past a round); its exact cases
(b = a, 2a, -a; a zero; orthogonal a and b) bit-exact in fp32. An fp32
Dense at DEFAULT precision within the TF32 bound c 2^-11 |x| |W| of a
float64 product (c = 4 + 2^-9 + (k + 1) 2^-13 for depth k: each operand
rounded to TF32, at worst by truncation, and k fp32 additions), which a
bf16 product fails. Remat on tiny fp32 GPT and LLaMA: gradients bit-equal
to the run without it (the recomputation repeats the same kernels on the
same inputs, and none uses atomics), and a lower peak of allocated memory.
Elastic at 1 rank: after a fault and the reset of ``hvd.elastic.run`` the
group is a new NCCL one on cuda:0, the scale kernels launch and the reduced
gradients equal the local ones bit for bit (Average over one rank is x1);
a ``TorchState`` commit of CUDA tensors stays on the card and restores
bit for bit.
"""

import pytest
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch.ops import adasum
from horovod_tpu_torch.ops.kernels import adasum as ak
from horovod_tpu_torch.ops.kernels import flash_attention as fa
from horovod_tpu_torch.ops.kernels import scale_buffers as sb
from horovod_tpu_torch.parallel.tp import Dense

pytestmark = pytest.mark.cuda


def tf32_product_c(k):
    """c of the TF32 bound of an fp32 product of depth ``k`` (above)."""
    return 4.0 + 2.0 ** -9 + (k + 1) * 2.0 ** -13


def tf32_ratio(y, a, b):
    """max |y - a b| / (2^-11 |a| |b|) over the product ``y`` of ``a``
    (m, k) and ``b`` (k, n), in float64."""
    a, b = a.double(), b.double()
    err = (y.double() - a @ b).abs_()
    scale = (a.abs() @ b.abs()).mul_(2.0 ** -11).clamp_min_(1e-300)
    return err.div_(scale).max().item()

SHAPES = [(0,), (1,), (7,), (3, 5), (1023,), (64, 3, 3, 3), (300_001,)]
DTYPES = [torch.float32, torch.bfloat16, torch.float16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tensors(dev, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype) for s in SHAPES]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_pack_scale_bit_equal_to_plain(dev, dtype):
    ts = _tensors(dev, dtype, 0)
    total = sum(t.numel() for t in ts)
    got = torch.empty(total, dtype=dtype, device=dev)
    ref = torch.empty_like(got)
    before = sb.pack_launches
    sb.pack_scale(ts, got, 1.0 / 3.0)
    torch.cuda.synchronize()
    assert sb.pack_launches == before + 1
    sb.pack_scale_reference(ts, ref, 1.0 / 3.0)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_unpack_scale_bit_equal_to_plain(dev, dtype):
    total = sum(torch.Size(s).numel() for s in SHAPES)
    g = torch.Generator(device=dev).manual_seed(1)
    flat = torch.randn(total, generator=g, device=dev).to(dtype)
    got = [torch.empty(s, dtype=dtype, device=dev) for s in SHAPES]
    ref = [torch.empty_like(t) for t in got]
    before = sb.unpack_launches
    sb.unpack_scale(flat, got, 0.5)
    torch.cuda.synchronize()
    assert sb.unpack_launches == before + 1
    sb.unpack_scale_reference(flat, ref, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_scale_bucket_past_one_launch_bit_equal(dev, dtype):
    """A bucket of more tensors than one launch's table holds takes one
    launch per _MAX_ROWS tensors and stays bit-equal to the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(30)
    n = 2 * sb._MAX_ROWS + 5
    ts = [torch.randn(1 + i % 37, generator=g, device=dev).to(dtype)
          for i in range(n)]
    flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype, device=dev)
    p0, u0 = sb.pack_launches, sb.unpack_launches
    sb.pack_scale(ts, flat, 1.0 / 3.0)
    outs = [torch.empty_like(t) for t in ts]
    sb.unpack_scale(flat, outs, 3.0)
    torch.cuda.synchronize()
    assert (sb.pack_launches - p0, sb.unpack_launches - u0) == (3, 3)
    assert torch.equal(flat, sb.pack_scale_reference(
        ts, torch.empty_like(flat), 1.0 / 3.0))
    want = sb.unpack_scale_reference(flat, [torch.empty_like(t) for t in ts],
                                     3.0)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_scale_on_a_side_stream_queued_behind_work(dev, dtype):
    """As the fusion runtime runs them: pack and unpack on a side stream,
    queued behind a sleep, so they run long after the wrapper returned and
    its host rows were dropped and their memory reused (the table travels
    in the launch's parameters). Bit-equal to the plain version."""
    side = torch.cuda.Stream(dev)
    ts = _tensors(dev, dtype, 40)
    flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype, device=dev)
    outs = [torch.empty_like(t) for t in ts]
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)
        for _ in range(3):
            sb.pack_scale(ts, flat, 0.5)
            sb.unpack_scale(flat, outs, 4.0)
            # Host garbage where the last rows were.
            junk = [sb.launch_tables(([0] * len(ts),) * 3)
                    for _ in range(8)]
            del junk
    side.synchronize()
    assert torch.equal(flat, sb.pack_scale_reference(
        ts, torch.empty_like(flat), 0.5))
    want = sb.unpack_scale_reference(flat, [torch.empty_like(t) for t in ts],
                                     4.0)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))


def test_cuda_tensors_never_reach_the_plain_version(dev, monkeypatch):
    def refuse(*args):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(sb, "pack_scale_reference", refuse)
    monkeypatch.setattr(sb, "unpack_scale_reference", refuse)
    ts = _tensors(dev, torch.float32, 2)
    flat = torch.empty(sum(t.numel() for t in ts), device=dev)
    sb.pack_scale(ts, flat, 2.0)
    sb.unpack_scale(flat, ts, 0.5)
    torch.cuda.synchronize()


def test_fused_allreduce_on_the_card(dev):
    """1-rank world over NCCL: a grouped Average lands in place through one
    pack and one unpack launch; x * 1 * (1/1) is exact."""
    hvd.init()
    try:
        ts = _tensors(dev, torch.float32, 3)
        want = [t.clone() for t in ts]
        p0, u0 = sb.pack_launches, sb.unpack_launches
        out = hvd.grouped_allreduce_(ts, op=hvd.Average)
        torch.cuda.synchronize()
        assert (sb.pack_launches - p0, sb.unpack_launches - u0) == (1, 1)
        assert all(o is t for o, t in zip(out, ts))
        assert all(torch.equal(t, w) for t, w in zip(ts, want))
    finally:
        hvd.shutdown()


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_rank_major_pack_and_unpack_bit_equal(dev, dtype, n):
    """A grouped reducescatter's tables over n ranks: the pack's rows are
    every tensor's row blocks, rank-major (contiguous views at their own
    addresses), the unpack's one rank's (m/n, ...) outputs; each one
    launch, bit-equal to the plain version."""
    from horovod_tpu_torch.ops.collective_ops import rank_major_blocks
    g = torch.Generator(device=dev).manual_seed(50 + n)
    shapes = [(n,), (3 * n, 5), (n, 3, 16, 16), (8 * n, 7), (2 * n, 1)]
    ts = [torch.randn(s, generator=g, device=dev).to(dtype) for s in shapes]
    blocks = rank_major_blocks(ts, n)
    assert len(blocks) == n * len(ts)
    flat = torch.empty(sum(t.numel() for t in ts), dtype=dtype, device=dev)
    outs = [torch.empty((t.shape[0] // n,) + t.shape[1:], dtype=dtype,
                        device=dev) for t in ts]
    p0, u0 = sb.pack_launches, sb.unpack_launches
    sb.pack_scale(blocks, flat, 0.5)
    sb.unpack_scale(flat[:flat.numel() // n], outs, 1.0 / 3.0)
    torch.cuda.synchronize()
    assert (sb.pack_launches - p0, sb.unpack_launches - u0) == (1, 1)
    assert torch.equal(flat, sb.pack_scale_reference(
        blocks, torch.empty_like(flat), 0.5))
    want = sb.unpack_scale_reference(flat[:flat.numel() // n],
                                     [torch.empty_like(o) for o in outs],
                                     1.0 / 3.0)
    assert all(torch.equal(a, b) for a, b in zip(outs, want))


def test_grouped_reducescatter_on_the_card(dev):
    """1-rank world over NCCL: a grouped Average reducescatter is one pack
    and one unpack launch, rounds x * prescale and y * postscale once each,
    and stays on the card."""
    hvd.init()
    try:
        g = torch.Generator(device=dev).manual_seed(60)
        ts = [torch.randn(s, generator=g, device=dev).bfloat16()
              for s in ((6, 5), (4,), (2, 3, 3))]
        p0, u0 = sb.pack_launches, sb.unpack_launches
        out = hvd.grouped_reducescatter(ts, op=hvd.Average,
                                        prescale_factor=0.5,
                                        postscale_factor=3.0)
        torch.cuda.synchronize()
        assert (sb.pack_launches - p0, sb.unpack_launches - u0) == (1, 1)
        for o, t in zip(out, ts):
            assert o.is_cuda and o.dtype == t.dtype
            assert torch.equal(o, ((t.float() * 0.5).bfloat16().float()
                                   * 3.0).bfloat16())
    finally:
        hvd.shutdown()


FLASH_TOL = {torch.float32: (1e-5, 1e-4)}
HALF = [torch.bfloat16, torch.float16]
# (BH, Lq, Lk, D, causal, kv_valid, heads, kv_heads): every head dim at the
# ragged L = 197, Lq < Lk and Lq > Lk (fully masked rows), kv_valid, GQA,
# the GPT-2 small main path's shape, and the BERT-Large (non-causal, L =
# 128) and LLaMA-400M (16 query heads over 8 kv heads, L = 1024) paths'
# shapes at a reduced BH.
FLASH_CASES = [(4, 197, 197, 64, True, None, None, None),
               (4, 197, 197, 16, False, None, None, None),
               (4, 197, 197, 32, False, None, None, None),
               (4, 197, 197, 128, True, None, None, None),
               (4, 96, 160, 32, True, None, None, None),
               (4, 160, 96, 64, True, None, None, None),
               (4, 130, 200, 64, False, 150, None, None),
               (24, 197, 197, 64, True, None, 12, 4),
               (96, 1024, 1024, 64, True, None, None, None),
               (32, 128, 128, 64, False, None, None, None),
               (32, 1024, 1024, 64, True, None, 16, 8)]


def _close(got, want, dtype, name):
    atol, rtol = FLASH_TOL[dtype]
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        f"{name}: max abs err {diff.max().item()}"


def _flash_inputs(dev, dtype, case, seed=None):
    """q, do (BH, Lq, D); k, v (BHkv, Lk, D) and their MHA broadcast."""
    bh, lq, lk, d, causal, kv_valid, heads, kvh = case
    g = torch.Generator(device=dev).manual_seed(
        lq * 3 + d if seed is None else seed)
    bkv = bh if heads is None else bh // heads * kvh
    q, do = (torch.randn(bh, lq, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(bkv, lk, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    if heads is None:
        return q, k, v, do, k, v
    b, grp = bh // heads, heads // kvh
    return q, k, v, do, fa.gqa_repeat3(k, b, kvh, grp).contiguous(), \
        fa.gqa_repeat3(v, b, kvh, grp).contiguous()


def _within_bound(got, want, bound, name):
    r = fa.bound_ratio(got, want, bound)
    assert r <= 1.0, f"{name}: {r} of the rounding bound"


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_kernels_match_plain(dev, dtype, case):
    """fp32: every output within FLASH_TOL. bf16/fp16: o, dQ, dK and dV
    within the rounding bound of the plain versions that round P and dS;
    lse within 1e-5 relative of the fp32 plain version."""
    bh, lq, lk, d, causal, kv_valid, heads, kvh = case
    q, k, v, do, km, vm = _flash_inputs(dev, dtype, case)
    sm = d ** -0.5
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    o, lse = fa.fa_forward(q, k, v, causal, sm, kv_valid=kv_valid,
                           heads=heads, kv_heads=kvh)
    torch.cuda.synchronize()
    o_p, lse_p = fa.block_fwd_reference(q, km, vm, causal, sm, None,
                                        kv_valid)
    assert torch.allclose(lse, lse_p, rtol=1e-5, atol=1e-4)
    grads = fa.fa_backward(q, km, vm, o, lse, do, causal, sm,
                           kv_valid=kv_valid)
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        tuple(n + 1 for n in before)
    ref = fa.block_bwd_reference(q, km, vm, o, lse, do, causal, sm, None,
                                 kv_valid)
    if dtype == torch.float32:
        _close(o, o_p, dtype, "o")
        for got, want, name in zip(grads, ref, ("dq", "dk", "dv")):
            _close(got, want, dtype, name)
    else:
        o_r, _ = fa.block_fwd_reference(q, km, vm, causal, sm, None,
                                        kv_valid, round_p=dtype)
        dq_r, dk_r, dv_r = fa.block_bwd_reference(
            q, km, vm, o, lse, do, causal, sm, None, kv_valid, round_p=dtype)
        plain = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
        bounds = fa.rounding_bounds(plain, q, km, vm, causal, sm, None,
                                    kv_valid, o3=o, lse=lse, do3=do)
        for got, name in ((o, "o"), (grads[0], "dq"), (grads[1], "dk"),
                          (grads[2], "dv")):
            _within_bound(got, plain[name], bounds[name], name)
    if causal and lq > lk:
        assert torch.equal(o[:, :lq - lk], torch.zeros_like(o[:, :lq - lk]))
        assert torch.equal(grads[0][:, :lq - lk],
                           torch.zeros_like(grads[0][:, :lq - lk]))


@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_flash_off_by_one_diagonal_fails_the_bound(dev, dtype):
    """The check that passes the tensor-core kernels rejects a plain version
    whose rows see one key more than the causal diagonal allows."""
    case = (4, 197, 197, 64, True, None, None, None)
    q, k, v, do, _, _ = _flash_inputs(dev, dtype, case)
    sm = 64 ** -0.5
    o, lse = fa.fa_forward(q, k, v, True, sm)
    got = dict(zip(("dq", "dk", "dv"),
                   fa.fa_backward(q, k, v, o, lse, do, True, sm)), o=o)
    o_r, _ = fa.block_fwd_reference(q, k, v, True, sm, round_p=dtype)
    plain = dict(zip(("dq", "dk", "dv"), fa.block_bwd_reference(
        q, k, v, o, lse, do, True, sm, round_p=dtype)), o=o_r)
    o_c, _ = fa.block_fwd_reference(q, k, v, True, sm, 1, round_p=dtype)
    ctl = dict(zip(("dq", "dk", "dv"), fa.block_bwd_reference(
        q, k, v, o, lse, do, True, sm, 1, round_p=dtype)), o=o_c)
    bounds = fa.rounding_bounds(plain, q, k, v, True, sm, o3=o, lse=lse,
                                do3=do)
    for name in ("o", "dq", "dk", "dv"):
        _within_bound(got[name], plain[name], bounds[name], name)
        assert fa.bound_ratio(ctl[name], plain[name], bounds[name]) > 1.0, \
            name


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_reruns_are_bit_identical(dev, dtype):
    """Each output tile is written by one block, with no atomics: two runs
    on the same inputs agree bit for bit."""
    case = (24, 523, 523, 64, True, None, None, None)
    q, k, v, do, _, _ = _flash_inputs(dev, dtype, case, seed=21)
    runs = []
    for _ in range(2):
        o, lse = fa.fa_forward(q, k, v, True, 0.125)
        runs.append((o, lse) + fa.fa_backward(q, k, v, o, lse, do, True,
                                              0.125))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_flash_takes_inputs_off_16_byte_alignment(dev, dtype):
    """The tensor-core kernels copy rows 16 bytes at a time: a contiguous
    view whose data starts off a 16-byte boundary is copied first, and
    gives what an aligned copy of it gives."""
    case = (4, 197, 197, 64, True, None, None, None)
    q, k, v, do, _, _ = _flash_inputs(dev, dtype, case)
    flat = torch.empty(q.numel() + 1, dtype=dtype, device=dev)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 and q_off.is_contiguous()
    before = fa.fwd_launches
    o, lse = fa.fa_forward(q_off, k, v, True, 0.125)
    want, _ = fa.fa_forward(q, k, v, True, 0.125)
    grads = fa.fa_backward(q_off, k, v, o, lse, do, True, 0.125)
    want_grads = fa.fa_backward(q, k, v, o, lse, do, True, 0.125)
    torch.cuda.synchronize()
    assert fa.fwd_launches == before + 2
    assert torch.equal(o, want)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_flash_autograd_on_the_card(dev):
    """(B, L, H, D) attention with GQA through autograd launches one kernel
    of each kind, and its output and gradients match autograd through the
    plain forward (K/V broadcast to the query heads) on the same card."""
    g = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn(2, 197, 12, 64, generator=g, device=dev)
    k, v = (torch.randn(2, 197, 4, 64, generator=g, device=dev)
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
    out = fa.flash_attention(*leaves, causal=True)
    (out ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches) == \
        tuple(n + 1 for n in before)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    q3 = ref[0].permute(0, 2, 1, 3).reshape(24, 197, 64)
    k3, v3 = (fa.gqa_repeat3(t.permute(0, 2, 1, 3).reshape(8, 197, 64),
                             2, 4, 3) for t in ref[1:])
    o3, _ = fa.block_fwd_reference(q3, k3, v3, True, 64 ** -0.5)
    want = o3.reshape(2, 12, 197, 64).permute(0, 2, 1, 3)
    (want ** 2).sum().backward()
    _close(out.detach(), want.detach(), torch.float32, "out")
    # Autograd differentiates the plain forward by another formula (through
    # the softmax's exp and sum, not P * (dP - delta)), and each gradient
    # entry sums ~200 terms that cancel: the two differ by ~1e-6 of the
    # tensor's largest entry, so the bound scales with the tensor.
    for a, b, name in zip(leaves, ref, "qkv"):
        assert a.grad.shape == b.grad.shape
        err = (a.grad - b.grad).abs().max().item()
        assert err <= 1e-5 * b.grad.abs().max().item(), f"d{name}: {err}"


def test_cuda_flash_never_reaches_the_plain_version(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(fa, "block_fwd_reference", refuse)
    monkeypatch.setattr(fa, "block_bwd_reference", refuse)
    for dtype in DTYPES:
        before = (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches)
        q = torch.randn(1, 64, 2, 32, device=dev, dtype=dtype,
                        requires_grad=True)
        fa.flash_attention(q, q, q, causal=True).sum().backward()
        torch.cuda.synchronize()
        assert (fa.fwd_launches, fa.bwd_dq_launches,
                fa.bwd_dkv_launches) == tuple(n + 1 for n in before)


def _remat_model(name, remat):
    from horovod_tpu_torch.models import GPT, GPTConfig, Llama, LlamaConfig
    if name == "gpt":
        return GPT(GPTConfig.tiny(max_position_embeddings=512, use_flash=True,
                                  remat=remat),
                   generator=torch.Generator(device="cuda").manual_seed(3))
    return Llama(LlamaConfig.tiny(use_flash=True, remat=remat),
                 generator=torch.Generator(device="cuda").manual_seed(3))


@pytest.mark.parametrize("name", ["gpt", "llama"])
def test_fp32_remat_on_the_card(dev, name):
    """Tiny fp32 GPT and LLaMA (4 layers, flash, 8 x 512 tokens), whose
    products at DEFAULT precision go through ``at_precision``'s scoped
    graph: with each block checkpointed, the same gradients bit for bit as
    without, each block recomputed once (4 more forward launches, not one
    more per scoped product) and a lower peak of allocated memory."""
    ids = torch.randint(0, 256, (8, 512), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(4))
    out = {}
    for remat in (False, True):
        with torch.device(dev):
            m = _remat_model(name, remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = fa.fwd_launches
        logits = m(ids)
        torch.nn.functional.cross_entropy(
            logits[:, :-1].flatten(0, 1), ids[:, 1:].flatten()).backward()
        torch.cuda.synchronize()
        out[remat] = (fa.fwd_launches - before,
                      torch.cuda.max_memory_allocated(dev) - base,
                      {n: p.grad for n, p in m.named_parameters()})
    (n0, mem0, g0), (n1, mem1, g1) = out[False], out[True]
    assert (n0, n1) == (4, 8)
    assert mem1 < mem0, (mem1, mem0)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def test_flash_refuses_an_unsupported_head_dim(dev):
    q = torch.randn(2, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        fa.fa_forward(q, q, q, False, 1.0)


ADASUM_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
ADASUM_TOL = {torch.float32: 1e-5, torch.float64: 1e-5,
              torch.bfloat16: 2 * 2.0 ** -7, torch.float16: 2 * 2.0 ** -10}
# A bucket: empty, single and odd segments, one of exactly one streaming
# block's 4096 elements and one past it, and one of 4,194,305 elements:
# past a round of the level kernel in fp32 and float64 (3,510,144 and
# 1,755,072 elements on an H100: the streaming route, past 1024 blocks, so
# grid-stride), within one in bf16 and fp16.
ADASUM_SEGMENTS = (0, 1, 7, 4096, 4097, 300_001, 4_194_305, 64 * 3 * 3 * 3)


def _segment_errors(got, want, numels):
    """max |got - want| / max |want| of each segment."""
    errs, off = [], 0
    for n in numels:
        g, w = got[off:off + n].double(), want[off:off + n].double()
        off += n
        if n:
            errs.append(((g - w).abs().max()
                         / w.abs().max().clamp_min(1e-30)).item())
    return errs


def _adasum_pair(dev, dtype, numels, seed):
    """a and b, each segment at its own scale, so per-segment coefficients
    differ."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 2), device=dev)
                       for i, n in enumerate(numels)])
    return [(torch.randn(scale.numel(), generator=g, device=dev) * scale)
            .to(dtype) for _ in range(2)]


def _check_both_routes(dev, dtype, numels, seed):
    a, b = _adasum_pair(dev, dtype, numels, seed)
    table = ak.segment_table(numels)
    sched = ak.schedule(numels, ((0, 0),), 0, dtype, dev)
    got = torch.empty_like(a)
    before = (ak.launches, ak.stream_launches)
    ak.combine_segments(a, b, got, table)
    torch.cuda.synchronize()
    assert (ak.launches - before[0], ak.stream_launches - before[1]) == (
        int(bool(sched.tiles)), 2 * int(bool(sched.stream)))
    for want in (ak.combine_level_reference(a, b, torch.empty_like(a),
                                            sched),
                 ak.combine_segments_reference(a, b, torch.empty_like(a),
                                               table)):
        errs = _segment_errors(got, want, numels)
        assert max(errs) <= ADASUM_TOL[dtype], errs
    return sched


@pytest.mark.parametrize("dtype", ADASUM_DTYPES, ids=str)
def test_adasum_kernel_matches_plain(dev, dtype):
    sched = _check_both_routes(dev, dtype, ADASUM_SEGMENTS, 11)
    assert bool(sched.stream) == (dtype in (torch.float32, torch.float64))


@pytest.mark.parametrize("dtype", ADASUM_DTYPES, ids=str)
def test_adasum_both_routes_and_rounds_match_plain(dev, dtype):
    """A unit one element past a round (the streaming route), one that
    fills a round exactly, and three of just over half a round, which the
    schedule keeps within a round's steps each."""
    cap = ak.round_elems(dtype, dev)
    numels = (cap + 1, 5, cap, cap // 2 + 1, 3, cap // 2 + 1, cap // 2 + 1)
    sched = _check_both_routes(dev, dtype, numels, 13)
    assert sched.stream == [0] and sched.steps >= 6


@pytest.mark.parametrize("case", ["zero_a", "b_is_a", "b_is_2a",
                                  "b_is_minus_a", "orthogonal"])
def test_adasum_kernel_exact_cases(dev, case):
    g = torch.Generator(device=dev).manual_seed(12)
    a = torch.randn(300_001, generator=g, device=dev)
    b = torch.randn(300_001, generator=g, device=dev)
    want = {"zero_a": lambda: b, "b_is_a": lambda: a,
            "b_is_2a": lambda: 1.5 * a, "b_is_minus_a": lambda: 0 * a,
            "orthogonal": lambda: a + b}
    if case == "zero_a":
        a = torch.zeros_like(a)
    elif case == "b_is_a":
        b = a.clone()
    elif case == "b_is_2a":
        b = 2 * a
    elif case == "b_is_minus_a":
        b = -a
    else:
        a[150_000:] = 0
        b[:150_000] = 0
    out = adasum.adasum_combine(a, b)
    torch.cuda.synchronize()
    assert torch.equal(out, want[case]())


@pytest.mark.parametrize("k", [2, 3, 4, 5])
def test_adasum_reduce_gathered_launches_per_combine(dev, k):
    """One launch per tree level for the whole bucket: ceil(log2 k)."""
    g = torch.Generator(device=dev).manual_seed(k)
    numels = ADASUM_SEGMENTS[:6]
    gathered = torch.randn(k, sum(numels), generator=g, device=dev)
    want = ak.reduce_gathered_reference(gathered, numels)
    before = (ak.launches, ak.stream_launches)
    got = adasum.reduce_gathered(gathered, numels)
    torch.cuda.synchronize()
    assert (ak.launches - before[0], ak.stream_launches - before[1]) == (
        (k - 1).bit_length(), 0)
    assert got.data_ptr() == gathered.data_ptr()       # in place, row 0
    assert max(_segment_errors(got, want, numels)) <= 1e-5


def test_cuda_adasum_never_reaches_the_plain_version(dev, monkeypatch):
    """Neither route reaches a plain version on the card, and a refused
    cooperative launch (here a grid past what the card holds at once)
    raises rather than giving way to one."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version called on CUDA tensors")
    for name in ("adasum_combine_reference", "combine_segments_reference",
                 "reduce_gathered_reference", "combine_level_reference"):
        monkeypatch.setattr(ak, name, refuse)
    gathered = torch.randn(3, 1000, device=dev)
    adasum.reduce_gathered(gathered, (600, 400))
    adasum.adasum_combine(gathered[1], gathered[2])
    long = ak.round_elems(torch.float32, dev)
    x = torch.randn(2, long + 1, device=dev)
    adasum.reduce_gathered(x, (long + 1,))
    torch.cuda.synchronize()
    grid = ak.level_grid(torch.float32, dev)
    monkeypatch.setattr(ak, "_schedules", {})
    monkeypatch.setitem(ak._grids, (torch.float32, dev), 64 * grid)
    before = ak.launches
    with pytest.raises(RuntimeError, match="hvd_adasum_level"):
        adasum.reduce_gathered(torch.randn(2, 1000, device=dev), (600, 400))
    assert ak.launches == before
    torch.cuda.synchronize()


def test_adasum_one_signature_on_two_streams(dev):
    """Calls over one schedule (its slots, counters and epoch) from two
    streams, queued with no sync between them, each match the plain
    version: a call waits for the last call's stream."""
    numels = (600_001, 400_000, 7)
    table = ak.segment_table(numels)
    pairs = [_adasum_pair(dev, torch.float32, numels, 30 + i)
             for i in range(6)]
    outs = [torch.empty_like(a) for a, _ in pairs]
    streams = (torch.cuda.Stream(dev), torch.cuda.Stream(dev))
    torch.cuda.synchronize()
    for i, ((a, b), out) in enumerate(zip(pairs, outs)):
        with torch.cuda.stream(streams[i % 2]):
            ak.combine_segments(a, b, out, table)
    torch.cuda.synchronize()
    for (a, b), out in zip(pairs, outs):
        want = ak.combine_segments_reference(a, b, torch.empty_like(a), table)
        assert max(_segment_errors(out, want, numels)) <= \
            ADASUM_TOL[torch.float32]


def test_adasum_refuses_cuda_graph_capture(dev):
    """A captured launch would replay one epoch of the counters: the
    combine raises under capture and launches nothing."""
    gathered = torch.randn(2, 1000, device=dev)
    adasum.reduce_gathered(gathered, (600, 400))   # schedule built outside
    torch.cuda.synchronize()
    before = ak.launches
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            adasum.reduce_gathered(gathered, (600, 400))
    assert ak.launches == before
    torch.cuda.synchronize()


def test_adasum_kernel_refuses_what_it_does_not_take(dev):
    table = ak.segment_table((4, 2))
    ints = torch.ones(6, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        ak.combine_segments(ints, ints, ints.clone(), table)
    a = torch.ones(6, 2, device=dev)[:, 0]
    with pytest.raises(ValueError):
        ak.combine_segments(a, a, torch.empty(6, device=dev), table)


def test_adasum_allreduce_on_the_card(dev):
    """1-rank world over NCCL: an Adasum group lands in place through one
    pack, one all-gather and one unpack; a tree of one leaf launches no
    combine, and x * 1 is exact. float64 takes the unfused route."""
    hvd.init()
    try:
        ts = _tensors(dev, torch.float32, 4)
        want = [t.clone() for t in ts]
        counts = (sb.pack_launches, sb.unpack_launches, ak.launches)
        out = hvd.grouped_allreduce_(ts, op=hvd.Adasum)
        x64 = torch.randn(33, dtype=torch.float64, device=dev)
        y64 = hvd.allreduce(x64, op=hvd.Adasum)
        torch.cuda.synchronize()
        assert (sb.pack_launches - counts[0], sb.unpack_launches - counts[1],
                ak.launches - counts[2]) == (1, 1, 0)
        assert all(o is t for o, t in zip(out, ts))
        assert all(torch.equal(t, w) for t, w in zip(ts, want))
        assert torch.equal(y64, x64)
        with pytest.raises(TypeError):
            hvd.allreduce(torch.ones(3, dtype=torch.int32, device=dev),
                          op=hvd.Adasum)
    finally:
        hvd.shutdown()


def test_dense_runs_tf32_within_its_bound(dev):
    """An fp32 Dense at DEFAULT precision (the lm_head's, here at 1024 x
    768 -> 4096) within the TF32 bound c 2^-11 |x| |W| of a float64
    product, forward and both backward products, on positive inputs
    (no cancellation: the bound is tight); a bf16 product fails the
    forward's bound; the TF32 flags are as they were afterwards."""
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand(1024, 768, generator=g, device=dev).requires_grad_()
    layer = Dense(768, 4096, use_bias=False).to(dev)
    with torch.no_grad():
        layer.weight.copy_(torch.rand(4096, 768, generator=g, device=dev)
                           / 768 ** 0.5)
    gy = torch.rand(1024, 4096, generator=g, device=dev)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    y = layer(x)
    y.backward(gy)
    torch.cuda.synchronize()
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags
    w = layer.weight.detach()
    xd = x.detach()
    assert tf32_ratio(y, xd, w.T) <= tf32_product_c(768)
    assert tf32_ratio(x.grad, gy, w) <= tf32_product_c(4096)
    assert tf32_ratio(layer.weight.grad, gy.T, xd) <= tf32_product_c(1024)
    control = (xd.bfloat16() @ w.bfloat16().T).float()
    assert tf32_ratio(control, xd, w.T) > tf32_product_c(768)


def test_elastic_reset_brings_a_new_nccl_group_up_on_the_card(dev):
    """A fault in hvd.elastic.run at 1 rank: the group is aborted, the
    commit restored and a new NCCL group built on cuda:0, through which the
    next step's gradients go (pack and unpack launches, bit-equal to the
    local gradients)."""
    import torch.distributed as dist
    hvd.init()
    try:
        g = torch.Generator(device=dev).manual_seed(70)
        model = torch.nn.Linear(16, 8).to(dev)
        opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
            named_parameters=model.named_parameters())
        x = torch.randn(4, 16, generator=g, device=dev)
        state = hvd.TorchState(model, opt, step=0)
        state.commit()
        seen = {}

        @hvd.elastic.run
        def train(state):
            if not seen:
                seen["pg"] = dist.distributed_c10d._get_default_group()
                raise hvd.HorovodInternalError("injected")
            local = {}
            hooks = [p.register_hook(
                lambda grad, p=p: local.__setitem__(p, grad.clone()))
                for p in model.parameters()]
            p0, u0 = sb.pack_launches, sb.unpack_launches
            opt.zero_grad()
            model(x).square().sum().backward()
            opt.synchronize()
            torch.cuda.synchronize()
            for h in hooks:
                h.remove()
            return (dist.distributed_c10d._get_default_group(),
                    sb.pack_launches - p0, sb.unpack_launches - u0,
                    all(torch.equal(p.grad, local[p])
                        for p in model.parameters()))

        pg, packs, unpacks, equal = train(state)
        assert pg is not seen["pg"]
        assert dist.get_backend() == "nccl" and hvd.device() == dev
        assert packs > 0 and unpacks > 0 and equal
        opt._remove_hooks()
    finally:
        hvd.shutdown()


def test_torch_state_commit_stays_on_the_card(dev):
    from horovod_tpu_torch.torch.elastic import TorchState
    model = torch.nn.Linear(8, 4).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model(torch.ones(2, 8, device=dev)).sum().backward()
    opt.step()
    state = TorchState(model=model, optimizer=opt, noise=torch.ones(3,
                                                                    device=dev))
    state.save()
    saved = list(state._saved_model_state.values()) + [
        v for s in state._saved_optimizer_state["state"].values()
        for v in s.values() if torch.is_tensor(v)] + [
        state._saved_state["noise"]]
    assert saved and all(t.device == dev for t in saved)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        model.weight.add_(1.0)
    state.noise = None
    state.restore()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items())
    assert state.noise.device == dev
