#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (horovod_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py [--seed 0] [--steps 10] [--warmup 2] [--batch 64]

(``--launched-worker gpt|fail|cpu_world|elastic|elastic_cpu`` is this
script as a worker that the launch phases start through hvdrun-torch.)

Phases, one JSON line each (each with its seconds):

1. env: card, PyTorch, CUDA and nvcc versions. No CUDA device: exit 1.
2. build: compile every kernel source with nvcc (one process per source,
   all at once) into build/kernels/, timed; ptxas's registers and spills
   of the tensor-core flash kernels beside their dynamic shared memory.
   Checks: every instance reported, no spills at D = 64, and the dQ kernel
   with no spills and no stack at any head dim.
3. kernel_vs_plain: each scale kernel against its plain PyTorch version on
   the card, on the gradient shapes of the main paths (ResNet-50's, GPT-2
   small's up to its 38.6M-element token table and lm_head, BERT-Large's,
   LLaMA-400M's and ViT-B/16's, the last three from copies on the meta
   device) plus edge cases (0 and 1 element, odd sizes, a tensor longer
   than a grid row), in fp32, bf16 and fp16; and the rank-major tables of
   a grouped reducescatter over 4 and 8 ranks on ViT-B/16's gradients (the
   pack's row blocks, the unpack's (m/n, ...) outputs). Bit-equal,
   synchronising after every launch.
4. train: the main path. Launch counts are zeroed, then hvd.init() on
   cuda:0, ResNet-50 (bf16 activations, fp32 parameters, 1000 classes) on a
   fixed synthetic batch made from --seed, SGD(lr=0.1, momentum=0.9) in
   hvd.DistributedOptimizer, broadcast_parameters and
   broadcast_optimizer_state, warm-up and timed steps; the counts are read
   right after. Checks: finite, falling loss; at least 2 pack and 2 unpack
   launches a step; on one step the reduced gradients equal the local ones
   bit for bit (Average over 1 rank is x1.0). Reported: for each launch of
   the scale kernels, whether its rows (pointers and numels) were those of
   an earlier launch, that is, what a table kept on the card per signature
   would have hit (the wrapper passes its table by value instead).
5. timing: each kernel alone (back-to-back launches over prebuilt tables),
   its wrapper as the runtime calls it, its plain version and one PyTorch
   call for the same function, at the fp32 buckets the main path formed
   (CUDA events, median of 30), beside the least time the card could take.

6. flash_vs_plain: the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain PyTorch versions on the card, synchronising after
   every launch: fp32, bf16 and fp16; causal and not; head dims 16, 32, 64
   and 128 at the ragged length 197; Lq < Lk and Lq > Lk (causal, with fully
   masked rows that must be exact zeros); kv_valid < Lk; GQA with 12 query
   heads over 4 kv heads; the GPT path's L = 1024, D = 64; in bf16 the
   BERT path's (BH = 512, L = 128, not causal), the LLaMA path's (128
   query rows over 64 kv rows, L = 1024, causal) and the ViT path's (BH =
   1536, L = 196, not causal: the last 64-key tile holds 4 keys). fp32, and lse
   in every dtype, within tolerance; the bf16/fp16 forward, dQ and dK/dV,
   which round P and dS on the tensor cores, within the rounding bound (c
   and u printed) of the plain versions that round where they do, and a
   plain version with the causal diagonal off by one (at BERT's and ViT's
   shapes: one that drops each row's last key; at ViT's by 10x or more)
   must fail that bound on every output.
   The max abs error and bound ratio of each case.
7. train_gpt: the second main path. Launch counts are zeroed, then GPT-2
   small at full width (vocab 50304, 12 layers, 12 heads, hidden 768, bf16
   activations, fp32 parameters, flash attention, untied fp32 lm_head) on
   8 x 1024 token ids made from --seed, next-token loss, AdamW(lr=1e-4,
   weight_decay=1e-4) in hvd.DistributedOptimizer after broadcast_parameters
   and broadcast_optimizer_state, --warmup and 8 timed steps; the counts are
   read right after. Checks: finite, falling loss; 12 forward, 12 dQ and 12
   dK/dV flash launches every step; one pack and one unpack launch for
   every fusion bucket of every step; on one step the reduced gradients
   equal the local ones bit for bit. Reported: the kept-table tally as in
   train. Then, outside the main path,
   gpt_flash_vs_plain: one step's loss and per-tensor gradients with flash
   attention against a copy of the model on plain attention (same weights,
   same batch), and two deliberately wrong controls (attention not causal;
   dK and dV swapped in the backward) that the same limits must reject.
   Both run their fp32 products (the lm_head) at DEFAULT precision, TF32,
   as the JAX model does on an H100; then
   precision: the lm_head's product at full shape (8192 x 768 -> 50304)
   through the port's Dense at DEFAULT, forward and both backward products,
   against float64 within the TF32 bound c 2^-11 |a| |b| (c printed), where
   a bf16 product must fail the forward's bound; the TF32 flags unchanged
   after; DEFAULT and "highest" timed in turns.
8. train_bert: the third path. BERT-Large (MLM + NSP; vocab 30522, 24
   layers, 16 heads, hidden 1024, bf16 activations, fp32 parameters and
   heads, flash, no padding mask, dropout off) on 32 x 128 token ids and
   MLM and NSP labels from --seed, AdamW(lr=1e-5) as in train_gpt; the
   same checks with 24 + 24 + 24 flash launches a step. Then
   bert_flash_vs_plain: one step's loss and per-tensor gradients with flash
   against a copy on bert.py's plain attention path, within
   BERT_CMP_LIMITS, which flash masked causally and dK and dV swapped must
   fail (and, unchecked, the kernels against their plain versions through
   the same step).
9. train_llama: the fourth path. LLaMA-400M (bench.py's config at 1024
   positions: 16 query heads over 8 kv heads, RoPE, RMSNorm, SwiGLU) on
   8 x 1024 token ids, next-token loss, AdamW(lr=1e-4); the same checks.
   Then remat on those weights and that batch: one step of a copy without
   and one with (48 forward launches, 24 dQ and 24 dK/dV; gradients equal
   bit for bit; a lower peak of allocated memory), and the same model and
   optimizer trained on with remat (48 + 24 + 24 launches a step); the
   GQA backward's repeat and fold timed alone, unchecked. Then
   llama_flash_vs_plain as for BERT, against plain attention with K/V
   repeated, within LLAMA_CMP_LIMITS; controls: flash not causal, dK and
   dV swapped.
10. train_vit: the fifth path. ViT-B/16 (bench.py's leg: hidden 768, 12
   layers, 12 heads, MLP 3072, patch 16, 1000 classes, 86,566,120
   parameters) on 128 bf16 images of 224 x 224 x 3 and labels from
   --seed, cross-entropy, AdamW(lr=1e-4); the same checks with 12 + 12 +
   12 flash launches a step (non-causal, L = 196). Then remat on the
   trained weights and batch: one step of a copy without and one with (24
   forward launches; gradients equal bit for bit; a lower peak); then the
   model timed on without and with remat: images/s as the median of 5
   repeats, the device's busy ms a step (torch.profiler) and the peak of
   allocated memory. Then vit_flash_vs_plain as for BERT, against plain
   attention, within VIT_CMP_LIMITS; controls: flash masked causally, dK
   and dV swapped.
11. collectives: at 1 rank over NCCL, on CUDA tensors in fp32 and bf16:
   ragged allgather (grouped and async too), alltoall with and without
   splits, grouped reducescatter Sum and Average with a prescale and a
   postscale (bit-equal to one rounding of x * prescale and of
   y * postscale / n; one pack and one unpack launch each),
   allgather_object, sparse_allreduce_async and join() (returns 0); every
   tensor output on the card.
12. timing_flash: each flash kernel alone at the GPT path's shapes
   (BH = 96, L = 1024, D = 64, bf16, causal), then at BERT's, LLaMA's and
   ViT's,
   its plain version and torch's scaled_dot_product_attention (forward, and
   backward alone; enable_gqa for LLaMA; for timing only, the port never
   calls it), CUDA events, median of repeats, beside the least time the
   card could take: achieved TFLOP/s and the share of that bound for
   each.

13. adasum_vs_plain: the Adasum combine kernels against their plain
   versions on the card, synchronising after every launch: ResNet-50's 161
   gradient shapes as one bucket of segments (each at its own scale) and
   edge cases (0 and 1 element, odd sizes, a segment past a round and past
   1024 streaming blocks, a zero a, b = a, 2a, -a, orthogonal a and b; the
   exact ones bit-exact in fp32), in fp32, bf16, fp16 and float64; then in
   each dtype a bucket that reaches both routes (a tensor one element past
   a round, so the streaming route, and tensors the schedule must keep
   within a round's steps), against the plain version in the level kernel's tile
   order and the one with whole sums; the max error of each case beside
   its tolerance.
14. train_adasum: the Adasum path. Launch counts are zeroed, then a fresh
   ResNet-50 as in train with hvd.DistributedOptimizer(SGD, op=hvd.Adasum):
   each bucket is packed, all-gathered and reduced by
   ops.adasum.reduce_gathered, then unpacked. Checks: finite, falling loss;
   one pack and one unpack launch per bucket every step; no combine launch
   (one rank is a tree of one leaf); on one step the reduced gradients
   equal the local ones bit for bit.
15. adasum_gathered: the combine kernel through reduce_gathered at the
   path's shapes: ResNet-50's gradients for K batches from --seed (what K
   ranks would hold), packed in train_adasum's bucket layout and stacked as
   the all-gather leaves them, for K = 4 and 3. Checks: within tolerance of
   the plain version; ceil(log2 K) launches per bucket, one per tree level,
   and none of the streaming route; a control with whole-bucket
   coefficients fails the same limit.
16. timing_adasum: one combine over the path's fp32 buckets (a tree level
   at K = 2): the level kernel alone, through the wrapper, the plain
   version, beside the byte bound and its share (no single PyTorch call
   computes it), with each bucket's steps, grid and shared memory.

17. launch: the port's launcher on the card: ``python -m
   horovod_tpu_torch.runner -np 1 -H localhost:1 --cycle-time-ms 1`` on
   this script as ``--launched-worker gpt``, which loads the kernels the
   build phase built, calls hvd.init() (the card, NCCL) and trains GPT-2
   small as train_gpt does, with its checks; it prints its HOROVOD_* rank
   contract, its launches and buckets a step, the buckets its timer closed,
   its new signatures a step and its losses. Checks: exit code 0, the
   1-slot contract on cuda:0, every flash and both scale kernels launched,
   buckets closed by the timer, loss falling, reduced gradients bit-equal.
   Control: a worker that exits 1 (``--launched-worker fail``) makes the
   launcher return 1, and its process is gone.
18. launch_cpu_world: ``-np 2`` through the launcher with workers on the
   CPU (gloo; NCCL refuses two ranks on one card), each sleeping seeded
   times before CPU_WORLD_TENSORS async allreduces. Checks: each slot's
   contract, the same buckets on both ranks with some closed by rank 0's
   timer, the sums. A CPU run, printed as one.
19. cycle: GPT-2 small and ResNet-50, in this process, at HOROVOD_CYCLE_TIME
   0 and 1 ms: buckets, timer-closed buckets and new signatures a step,
   tokens/s or images/s (median of repeats), the device's busy ms and
   share (torch.profiler). Printed, not checked.
20. train_elastic: ResNet-50 as in train (deterministic cuDNN), first 8
   steps without a fault, then the elastic path: launch counts zeroed, 8
   steps under hvd.elastic.run with TorchState(model, optimizer, step)
   committed after each; at step 4, after the optimizer step and before
   the commit, the training function raises HorovodInternalError, as a
   failed collective does; the counts read after. Checks: after the
   restore every parameter, buffer and momentum equals the commit bit for
   bit, and the uncommitted state of step 4 does not (the control); one
   re-init, a new NCCL group on cuda:0 and the state on the card; pack and
   unpack launches in every step before and after the reset; finite,
   falling loss; the final weights equal the run without the fault bit for
   bit. Reported: commit ms a step (median), the reset's abort, restore,
   init and sync ms, seconds from the fault to the first step after it,
   images/s with and without a commit each step (medians of repeats in
   turns), the commit copy's size and the peak of allocated memory.
21. launch_elastic: ``python -m horovod_tpu_torch.runner -np 1 --min-np 1
   --max-np 1 --host-discovery-script build/elastic/launch/discover.sh``
   on this script as ``--launched-worker elastic``: the same loop and
   fault in a worker of the elastic driver. Checks: exit code 0, the
   1-slot contract, train_elastic's checks but the comparison with the
   run without the fault, the re-init at the unchanged version 1 (after
   the 30 s wait for a new version, printed), the worker reaped.
22. launch_elastic_cpu_world: tests/test_elastic_failure.py's three
   scenarios through the elastic launcher with CPU (gloo) workers
   (``--launched-worker elastic_cpu``; NCCL refuses two ranks on one
   card), at once: a worker killed at step 3 of 6 (w == [12] * 4, worlds
   [2, 2, 2, 1, 1, 1]), a graceful removal (the survivor's pid and
   uncommitted attribute kept), a host added (scaled up in place). A CPU
   run, printed as one.

The train phases run with the fusion runtime's cycle thread live (1 ms, the
default): each step's pack and unpack launches are held to the buckets that
closed in that step, by the timer, the threshold or synchronize.

Then the kernels line, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed check raises, and the script exits
non-zero.
"""

import argparse
import contextlib
import ctypes
import functools
import gc
import json
import math
import os
import pathlib
import random
import signal
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, same data sheet
FLASH_SOURCE = "horovod_tpu_torch/ops/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = {
    "flash_fwd": "horovod_tpu/ops/pallas/flash_attention.py:125",
    "flash_bwd_dq": "horovod_tpu/ops/pallas/flash_attention.py:311",
    "flash_bwd_dkv": "horovod_tpu/ops/pallas/flash_attention.py:387",
}
# The flash kernels whose bf16/fp16 instances run on the tensor cores.
REDESIGNED = dict.fromkeys(
    ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"),
    "redesigned: bf16/fp16 products on the tensor cores (mma.sync)")
# Their entry points in the build log, in the order hvd_flash_mma_smem
# numbers them.
MMA_KERNELS = {"flash_fwd": "fa_fwd_mma_kernel",
               "flash_bwd_dkv": "fa_bwd_dkv_mma_kernel",
               "flash_bwd_dq": "fa_bwd_dq_mma_kernel"}
ADASUM_SOURCE = "horovod_tpu_torch/ops/kernels/csrc/adasum.cu"
ADASUM_REPLACES = "horovod_tpu/ops/pallas/kernels.py:76"
# Tolerance of the Adasum kernel against its plain version, by dtype, as a
# share of each segment's largest plain value: max |kernel - plain| /
# max |plain|. Both compute in fp32 and round once; they sum the dot product
# and the norms in another order, which moves a coefficient by ~1e-6: 1e-5
# in fp32 (and float64, read into fp32); in bf16 and fp16 it can flip the
# one rounding, so two ulps of the dtype at the segment's largest value.
ADASUM_TOL = {"float32": 1e-5, "float64": 1e-5, "bfloat16": 2 * 2.0 ** -7,
              "float16": 2 * 2.0 ** -10}
# Rank counts of the gathered-bucket check (K = 3 carries an odd one).
ADASUM_RANKS = (4, 3)

# TF32 keeps 10 explicit bits of the fp32 mantissa: unit roundoff 2^-11.
TF32_UNIT = 2.0 ** -11


def tf32_product_c(k):
    """c of the elementwise bound |y - a b| <= c 2^-11 (|a| |b|) of an fp32
    product of depth ``k`` run at TF32: each operand rounded to TF32 at
    worst by truncation (2^-10 each, 4 units for a term, 2^-9 units of
    second order) and ``k`` fp32 additions in any order (at most k 2^-24 of
    the sum of absolute terms: k 2^-13 units)."""
    return 4.0 + 2.0 ** -9 + (k + 1) * 2.0 ** -13


def tf32_ratio(y, a, b):
    """max |y - a b| / (2^-11 |a| |b|) over the elements of the product
    ``y`` of ``a`` (m, k) and ``b`` (k, n), both sides in float64: the
    product's error in TF32 units of its own scale."""
    a, b = a.double(), b.double()
    err = (y.double() - a @ b).abs_()
    scale = (a.abs() @ b.abs()).mul_(TF32_UNIT).clamp_min_(1e-300)
    return err.div_(scale).max().item()

# Tolerance of the fp32 flash kernels against their plain versions:
# |kernel - plain| <= atol + rtol * |plain|. Both compute in fp32 and round
# once, but sum in another order (the kernel rescales its running sum per
# 64-key tile), which moves the value by ~1e-6 relative: held at 1e-4. The
# bf16/fp16 kernels are held to fa.rounding_bounds instead.
FLASH_TOL = {"float32": (1e-5, 1e-4)}
SHORT = {"float32": "f32", "bfloat16": "bf16", "float16": "f16"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps=30, inner=1):
    """Median over ``reps`` of the device time between two events around
    ``inner`` back-to-back calls, per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phase_env(torch):
    from horovod_tpu_torch.ops.kernels import _build
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    emit({"phase": "env", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return card


def ptxas_rows(report, smem_bytes):
    """ptxas's registers and spills for the tensor-core flash kernels, by
    kernel, element type and head dim, beside their dynamic shared memory
    ``smem_bytes(which, d)`` (ptxas counts only static shared memory)."""
    import re
    rows = []
    for mangled, info in sorted(report.items()):
        for which, (name, entry) in enumerate(MMA_KERNELS.items()):
            m = re.search(entry + r"I(\w+?)Li(\d+)E", mangled)
            if m:
                d = int(m.group(2))
                rows.append({"kernel": name, "dtype": "bfloat16" if "bfloat"
                             in m.group(1) else "float16", "D": d,
                             "dynamic_smem_bytes": smem_bytes(which, d),
                             **info})
    return rows


def phase_build():
    from horovod_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    per_source = _build.build()
    seconds = time.perf_counter() - t0
    smem = _build.load("flash_attention").hvd_flash_mma_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    ptxas = ptxas_rows(_build.ptxas_report("flash_attention"), smem)
    emit({"phase": "build", "seconds": seconds, "per_source": per_source,
          "dir": str(_build.BUILD_DIR), "ptxas_tensor_core_flash": ptxas})
    n = len(MMA_KERNELS)
    check(len(ptxas) == n * 2 * 4, f"ptxas reports every tensor-core flash "
          f"instance ({n} kernels x 2 types x 4 head dims): {len(ptxas)}")

    def clean(r):
        return r.get("spill_stores", 0) == 0 == r.get("spill_loads", 0)
    check(all(clean(r) for r in ptxas if r["D"] == 64),
          "no spills in the D = 64 tensor-core flash kernels")
    check(all(clean(r) and r.get("stack_bytes", 0) == 0 for r in ptxas
              if r["kernel"] == "flash_bwd_dq"),
          "no spills and no stack in the dQ kernel at any head dim")


def phase_kernel_vs_plain(torch, shapes_by_path, dev, seed):
    """``shapes_by_path``: the gradient shapes of each main path; each
    path's list goes through one pack and one unpack launch per dtype."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    edge = [(0,), (1,), (7,), (1023,), (100_003,), (3_000_001,)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    max_err, pre, post = 0.0, 0.5, 1.0 / 3.0
    for dt, shapes in ((dt, s) for s in shapes_by_path.values()
                       for dt in sb.DTYPES):
        ts = [torch.randn(s, generator=gen, device=dev).to(dt)
              for s in shapes + edge]
        total = sum(t.numel() for t in ts)
        flat_k = torch.empty(total, dtype=dt, device=dev)
        flat_p = torch.empty_like(flat_k)
        sb.pack_scale(ts, flat_k, pre)
        torch.cuda.synchronize()
        sb.pack_scale_reference(ts, flat_p, pre)
        torch.cuda.synchronize()
        max_err = max(max_err, (flat_k.float() - flat_p.float()).abs().max()
                      .item())
        check(torch.equal(flat_k, flat_p), f"pack_scale {dt} bit-equal")
        out_k = [torch.empty_like(t) for t in ts]
        out_p = [torch.empty_like(t) for t in ts]
        sb.unpack_scale(flat_k, out_k, post)
        torch.cuda.synchronize()
        sb.unpack_scale_reference(flat_k, out_p, post)
        torch.cuda.synchronize()
        for a, b in zip(out_k, out_p):
            if a.numel():
                max_err = max(max_err,
                              (a.float() - b.float()).abs().max().item())
            check(torch.equal(a, b), f"unpack_scale {dt} bit-equal")
        del ts, flat_k, flat_p, out_k, out_p
    rank_major = rank_major_vs_plain(torch, shapes_by_path["vit_b16"], dev,
                                     gen, pre, post)
    max_err = max(max_err, rank_major.pop("max_abs_err"))
    emit({"phase": "kernel_vs_plain", "edge_tensors": len(edge),
          "rank_major": rank_major,
          "paths": {name: {"tensors": len(shapes),
                           "elements": sum(int(torch.Size(s).numel())
                                           for s in shapes),
                           "largest": max(int(torch.Size(s).numel())
                                          for s in shapes)}
                    for name, shapes in shapes_by_path.items()},
          "dtypes": [str(d) for d in sb.DTYPES], "prescale": pre,
          "postscale": post, "bit_equal": True, "max_abs_err": max_err})
    return max_err


def rank_major_vs_plain(torch, shapes, dev, gen, pre, post):
    """The tables of a grouped reducescatter over n ranks, as
    collective_ops lays them out (``rank_major_blocks``: block r of every
    tensor, then block r + 1), for n = 4 and 8 over ``shapes`` whose first
    dim divides by n: the pack's rows (the blocks) and the unpack's (one
    rank's outputs, (m/n, ...) each), launched directly, bit-equal to the
    plain version in fp32, bf16 and fp16."""
    from horovod_tpu_torch.ops.collective_ops import rank_major_blocks
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    report, max_err = {}, 0.0
    for n in (4, 8):
        kept = [s for s in shapes if s[0] % n == 0]
        for dt in sb.DTYPES:
            ts = [torch.randn(s, generator=gen, device=dev).to(dt)
                  for s in kept]
            blocks = rank_major_blocks(ts, n)
            total = sum(t.numel() for t in ts)
            flat_k = torch.empty(total, dtype=dt, device=dev)
            flat_p = torch.empty_like(flat_k)
            p0 = sb.pack_launches
            sb.pack_scale(blocks, flat_k, pre)
            torch.cuda.synchronize()
            check(sb.pack_launches - p0 == -(-len(blocks) // sb._MAX_ROWS),
                  f"the rank-major pack at n = {n} launched")
            sb.pack_scale_reference(blocks, flat_p, pre)
            check(torch.equal(flat_k, flat_p),
                  f"rank-major pack, n = {n}, {dt}: bit-equal")
            outs_k = [torch.empty((t.shape[0] // n,) + t.shape[1:],
                                  dtype=dt, device=dev) for t in ts]
            outs_p = [torch.empty_like(o) for o in outs_k]
            mine = flat_k[:total // n]
            sb.unpack_scale(mine, outs_k, post)
            torch.cuda.synchronize()
            sb.unpack_scale_reference(mine, outs_p, post)
            check(all(torch.equal(a, b) for a, b in zip(outs_k, outs_p)),
                  f"rank-major unpack, n = {n}, {dt}: bit-equal")
            max_err = max([max_err, (flat_k.float() - flat_p.float()).abs()
                           .max().item()]
                          + [(a.float() - b.float()).abs().max().item()
                             for a, b in zip(outs_k, outs_p) if a.numel()])
        report[n] = {"tensors": len(kept), "left_out": len(shapes) - len(kept),
                     "blocks": n * len(kept),
                     "elements": sum(int(torch.Size(s).numel())
                                     for s in kept)}
    return {"shapes": "ViT-B/16's gradients", "by_ranks": report,
            "bit_equal": True, "max_abs_err": max_err,
            "note": "left_out: shapes whose first dim does not divide by n "
                    "(reducescatter refuses them)"}


def reduced_equals_local(torch, model, step):
    """Run ``step`` once with a tensor hook on every parameter that copies
    its local gradient before accumulation, and check that the reduced
    gradients the optimizer stepped with equal those copies bit for bit
    (Average over 1 rank is x1.0). Returns the step's loss."""
    local = {}
    hooks = [p.register_hook(
        lambda g, p=p: local.__setitem__(p, g.detach().clone()))
        for p in model.parameters()]
    try:
        loss = step()
    finally:
        for h in hooks:
            h.remove()
    torch.cuda.synchronize()
    check(len(local) == len(list(model.parameters())),
          "a local gradient for every parameter")
    check(all(torch.equal(p.grad, g) for p, g in local.items()),
          "reduced gradients equal the local ones bit for bit")
    return loss


def buckets_since(mark):
    """The fusion buckets closed since ``mark`` (a ``flush_stats()``
    reading), oldest first, as (trigger, signature), and how many of them
    the cycle timer closed and how many had a new signature."""
    from horovod_tpu_torch.ops import fusion
    rt = fusion.get_runtime()
    now = rt.flush_stats()
    n = now["buckets"] - mark["buckets"]
    check(n <= fusion._RECENT, f"{n} buckets in one reading")
    return rt.recent_buckets(n), [
        n, now["closed_by"]["cycle"] - mark["closed_by"]["cycle"],
        now["new_signatures"] - mark["new_signatures"]]


def scale_launches(buckets):
    """The pack (or unpack) launches of ``buckets``: one per bucket, one
    more per ``_MAX_ROWS`` tensors past the first ``_MAX_ROWS``."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    return sum(-(-len(sig[-1]) // sb._MAX_ROWS) for _, sig in buckets)


def step_buckets_report(per_bucket_step, warmup):
    """Buckets, buckets the timer closed and new signatures of each step,
    and their means over the steps after warm-up."""
    timed = per_bucket_step[warmup:]
    return {"buckets_timer_new_signatures_per_step": per_bucket_step,
            "after_warmup_mean": {
                k: statistics.mean(s[i] for s in timed)
                for i, k in enumerate(("buckets", "timer_closed",
                                       "new_signatures"))}}


class KeptTableTally:
    """While active, counts for every launch of the scale kernels whether
    its rows (each tensor's pointer and numel) were those of an earlier
    launch: a hit for a table kept on the card per signature, else a build.
    The wrapper passes its table by value and keeps none; this measures
    what keeping them would have saved. Wraps ``sb.table_rows``."""

    def __init__(self, sb):
        self.sb, self.seen, self.builds, self.hits = sb, set(), 0, 0

    def __enter__(self):
        raw = self.raw = self.sb.table_rows

        def rows(tensors, numels):
            out = raw(tensors, numels)
            key = (tuple(out[0][0]), tuple(numels))
            if key in self.seen:
                self.hits += 1
            else:
                self.seen.add(key)
                self.builds += 1
            return out
        self.sb.table_rows = rows
        return self

    def __exit__(self, *exc):
        self.sb.table_rows = self.raw

    def counts(self):
        return (self.builds, self.hits)


def kept_table_report(per_step, warmup, col):
    """The would-be table builds and hits of each step (columns ``col`` and
    ``col + 1`` of ``per_step``), and their sums and hit share over the
    steps after warm-up."""
    timed = per_step[warmup:]
    builds = sum(s[col] for s in timed)
    hits = sum(s[col + 1] for s in timed)
    return {"kept_table_builds_hits_per_step": [s[col:col + 2]
                                                for s in per_step],
            "kept_table_after_warmup": {
                "builds": builds, "hits": hits,
                "hit_share": hits / max(builds + hits, 1)}}


def phase_train(torch, hvd, model, dev, args, card):
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    sb.reset_launch_counts()                 # the main path starts here
    hvd.init()
    check(hvd.size() == 1 and hvd.device() == dev,
          f"1-rank world on {dev}, got {hvd.size()} on {hvd.device()}")
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    tally = KeptTableTally(sb)

    def counts():
        return (sb.pack_launches, sb.unpack_launches) + tally.counts()

    # Warm-up; the last warm-up step also checks the reduction.
    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + args.steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the main path ends
    losses = [l.item() for l in losses]
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(all(s[0] >= 2 and s[1] >= 2 for s in per_step),
          f">= 2 pack and unpack launches a step: {per_step}")
    check(all(s[0] == s[1] == scale_launches(c) for s, c in
              zip(per_step, closed)),
          f"a pack and an unpack launch per bucket (per 256 tensors) every "
          f"step, the timer's buckets too: {per_step}, {per_bucket}")
    buckets = [[n for _, n in sig[-1]] for _, sig in closed[-1]
               if sig[4] == str(torch.float32)]
    emit({"phase": "train", "model": "ResNet-50", "batch": args.batch,
          "image": [224, 224, 3], "dtype": "bfloat16", "param_dtype":
          "float32", "params": sum(p.numel() for p in model.parameters()),
          "warmup": args.warmup, "steps": args.steps, "losses": losses,
          "step_ms": 1e3 * elapsed / args.steps,
          "images_per_sec": args.batch * args.steps / elapsed,
          "launches_per_step": [s[:2] for s in per_step],
          "launches": launches,
          **kept_table_report(per_step, args.warmup, 2),
          **step_buckets_report(per_bucket, args.warmup),
          "cycle_time_ms": get_runtime()._cycle_s * 1e3,
          "fp32_buckets_last_step": [{"tensors": len(b), "elements": sum(b)}
                                     for b in buckets],
          "reduced_equals_local_bitwise": True,
          "fusion_threshold": get_runtime().threshold, "card": card})
    return launches, buckets


def phase_timing(torch, buckets, dev, seed):
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    rows, s = [], 1.0 / 3.0
    for numels in buckets:
        ts = [torch.randn(n, generator=gen, device=dev) for n in numels]
        outs = [torch.empty_like(t) for t in ts]
        flat = torch.empty(sum(numels), device=dev)
        nbytes = 2 * flat.numel() * flat.element_size() + 24 * len(ts)
        pack_rows, pack_bx = sb.table_rows(ts, numels)
        unpack_rows, unpack_bx = sb.table_rows(outs, numels)
        pack_tables = sb.launch_tables(pack_rows)
        unpack_tables = sb.launch_tables(unpack_rows)
        rows.append({
            "tensors": len(ts), "elements": flat.numel(),
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "pack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_pack", pack_tables, pack_bx, flat, s), inner=10),
            "pack_wrapper_ms": event_ms(lambda: sb.pack_scale(ts, flat, s)),
            "pack_plain_ms": event_ms(
                lambda: sb.pack_scale_reference(ts, flat, s)),
            "pack_library_ms": event_ms(
                lambda: torch.cat(ts, out=flat).mul_(s)),
            "unpack_ms": event_ms(lambda: sb._launch(
                "hvd_scale_unpack", unpack_tables, unpack_bx, flat, s),
                inner=10),
            "unpack_wrapper_ms": event_ms(
                lambda: sb.unpack_scale(flat, outs, s)),
            "unpack_plain_ms": event_ms(
                lambda: sb.unpack_scale_reference(flat, outs, s)),
            "unpack_library_ms": event_ms(
                lambda: torch._foreach_mul(list(flat.split(numels)), s)),
        })
    total = {k: sum(r[k] for r in rows) for k in rows[0]
             if k.endswith("_ms")}
    emit({"phase": "timing", "dtype": "float32", "per_bucket": rows,
          "per_step": total,
          "note": "ms: the kernel alone, 10 back-to-back launches over "
                  "prebuilt host tables (each launch copies its table into "
                  "its parameters); wrapper_ms: pack_scale/unpack_scale as "
                  "the runtime calls them, checks and table built each "
                  "call; library: torch.cat(out=).mul_ for pack, and for "
                  "unpack torch._foreach_mul over the buffer's slices, "
                  "which returns new tensors and does not write into the "
                  "gradients as unpack does"})
    return total


def segment_errors(torch, got, want, numels):
    """max |got - want| / max |want| over each non-empty segment, and the
    largest absolute difference."""
    rel, worst_abs, off = [], 0.0, 0
    for n in numels:
        if n:
            g = got[off:off + n].double()
            w = want[off:off + n].double()
            diff = (g - w).abs().max().item()
            worst_abs = max(worst_abs, diff)
            rel.append(diff / max(w.abs().max().item(), 1e-30))
        off += n
    return rel, worst_abs


def phase_adasum_vs_plain(torch, shapes, dev, seed):
    """The Adasum kernel against its plain version: ResNet-50's gradient
    shapes as one bucket of segments, each at its own scale, in every dtype;
    then edge cases, each as a bucket of one segment. Synchronises after
    every launch."""
    from horovod_tpu_torch.ops.kernels import adasum as ak
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    numels = [int(torch.Size(s).numel()) for s in shapes]
    rows, worst = [], 0.0
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        table = ak.segment_table(numels)
        scale = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 2), device=dev)
                           for i, n in enumerate(numels)])
        a, b = ((torch.randn(table.total, generator=gen, device=dev)
                 * scale).to(dt) for _ in range(2))
        got = torch.empty_like(a)
        ak.combine_segments(a, b, got, table)
        torch.cuda.synchronize()
        want = ak.combine_segments_reference(a, b, torch.empty_like(a),
                                             table)
        torch.cuda.synchronize()
        rel, err = segment_errors(torch, got, want, numels)
        worst = max(worst, err)
        rows.append({"case": "resnet50_gradients", "dtype": name,
                     "segments": len(numels), "elements": table.total,
                     "max_rel": max(rel), "max_abs_err": err,
                     "tolerance": ADASUM_TOL[name]})
        check(max(rel) <= ADASUM_TOL[name], f"adasum {name} on ResNet-50's "
              f"shapes: {max(rel)} beyond {ADASUM_TOL[name]}")
        del a, b, got, want, scale

    def pair(case, n):
        a = torch.randn(n, generator=gen, device=dev)
        b = torch.randn(n, generator=gen, device=dev)
        if case == "zero_a":
            a = torch.zeros_like(a)
        elif case == "b_is_a":
            b = a.clone()
        elif case == "b_is_2a":
            b = 2 * a
        elif case == "b_is_minus_a":
            b = -a
        elif case == "orthogonal":
            a[n // 2:] = 0
            b[:n // 2] = 0
        return a, b
    exact = {"zero_a": lambda a, b: b, "b_is_a": lambda a, b: a,
             "b_is_2a": lambda a, b: 1.5 * a,
             "b_is_minus_a": lambda a, b: torch.zeros_like(a),
             "orthogonal": lambda a, b: a + b}
    # A segment past 1024 blocks of 4096 elements grid-strides in the block.
    edge = [("random", 0), ("random", 1), ("random", 7), ("random", 4097),
            ("random", 100_003), ("random", 4_194_305)] + [
        (c, 300_001) for c in exact]
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        for case, n in edge:
            a, b = (t.to(dt) for t in pair(case, n))
            table = ak.segment_table((n,))
            got = torch.empty_like(a)
            ak.combine_segments(a, b, got, table)
            torch.cuda.synchronize()
            want = ak.combine_segments_reference(a, b, torch.empty_like(a),
                                                 table)
            torch.cuda.synchronize()
            rel, err = segment_errors(torch, got, want, (n,))
            worst = max(worst, err)
            bit_exact = None
            if case in exact and dt == torch.float32:
                bit_exact = bool(torch.equal(got, exact[case](a, b)))
                check(bit_exact, f"adasum {case} is exact in fp32")
            rows.append({"case": case, "dtype": name, "segments": 1,
                         "elements": n, "max_rel": max(rel, default=0.0),
                         "max_abs_err": err, "tolerance": ADASUM_TOL[name],
                         "bit_exact": bit_exact})
            check(max(rel, default=0.0) <= ADASUM_TOL[name],
                  f"adasum {case} {name} n={n}: {rel} beyond "
                  f"{ADASUM_TOL[name]}")
    routes = []
    for dt in ak.DTYPES:
        name = str(dt).split(".")[-1]
        cap = ak.round_elems(dt, dev)
        # Past a round (the streaming route); a round filled exactly; three
        # just over half a round, which the schedule keeps within a round's
        # steps.
        numels = (cap + 1, 5, cap, cap // 2 + 1, 3, cap // 2 + 1,
                  cap // 2 + 1)
        table = ak.segment_table(numels)
        sched = ak.schedule(numels, ((0, 0),), 0, dt, dev)
        check(sched.stream == [0] and sched.steps >= 6,
              f"{name}: the routes case reaches both routes "
              f"(stream {sched.stream}, steps {sched.steps})")
        scale = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 2), device=dev)
                           for i, n in enumerate(numels)])
        a, b = ((torch.randn(table.total, generator=gen, device=dev)
                 * scale).to(dt) for _ in range(2))
        got = torch.empty_like(a)
        before = (ak.launches, ak.stream_launches)
        ak.combine_segments(a, b, got, table)
        torch.cuda.synchronize()
        launched = (ak.launches - before[0], ak.stream_launches - before[1])
        check(launched == (1, 2), f"{name}: one level launch and two "
              f"streaming launches, got {launched}")
        for plain, want in (
                ("level_tile_order", ak.combine_level_reference(
                    a, b, torch.empty_like(a), sched)),
                ("whole_sums", ak.combine_segments_reference(
                    a, b, torch.empty_like(a), table))):
            torch.cuda.synchronize()
            rel, err = segment_errors(torch, got, want, numels)
            worst = max(worst, err)
            routes.append({"case": "both_routes", "dtype": name,
                           "plain": plain, "elements": table.total,
                           "round_elements": cap, "steps": sched.steps,
                           "max_rel": max(rel), "max_abs_err": err,
                           "tolerance": ADASUM_TOL[name]})
            check(max(rel) <= ADASUM_TOL[name], f"adasum both routes {name} "
                  f"against {plain}: {max(rel)} beyond {ADASUM_TOL[name]}")
        del a, b, got, want, scale
    emit({"phase": "adasum_vs_plain", "cases": len(rows) + len(routes),
          "rows": rows, "routes": routes, "max_abs_err": worst,
          "metric": "max_rel: max |kernel - plain| / max |plain| per "
                    "segment; bit_exact: fp32 cases with an exact answer; "
                    "routes: a bucket with a unit past a round (the "
                    "streaming route) and units the schedule keeps within "
                    "a round's steps, against the plain version in the "
                    "level kernel's tile order and the one with whole sums",
          "tolerance": ADASUM_TOL})
    return worst


def adasum_buckets(torch, hvd, closed):
    """The fp32 Adasum buckets among ``closed`` (one step's, from
    :func:`buckets_since`): [[(parameter name, numel), ...], ...]."""
    return [[(name.split(".", 1)[1], n) for name, n in sig[-1]]
            for _, sig in closed
            if sig[1] == int(hvd.Adasum) and sig[4] == str(torch.float32)]


def phase_train_adasum(torch, hvd, model, dev, args, card):
    """The Adasum main path: ResNet-50 with hvd.DistributedOptimizer(SGD,
    op=hvd.Adasum) on the 1-rank world hvd.init() made for ``train``."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import adasum as ak
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    torch.cuda.synchronize()

    sb.reset_launch_counts()                 # the Adasum path starts here
    ak.reset_launch_counts()
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   op=hvd.Adasum)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    tally = KeptTableTally(sb)

    def counts():
        return (sb.pack_launches, sb.unpack_launches,
                ak.launches + ak.stream_launches) \
            + tally.counts()

    def step():
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()

    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + args.steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(zip(("scale_pack", "scale_unpack", "adasum_combine"),
                        counts()))           # the Adasum path ends
    tables = kept_table_report(per_step, args.warmup, 3)
    per_step = [s[:3] for s in per_step]
    opt._remove_hooks()
    losses = [l.item() for l in losses]
    buckets = adasum_buckets(torch, hvd, closed[-1])
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(buckets and all(
        s[0] == s[1] == scale_launches(c) and s[2] == 0
        for s, c in zip(per_step, closed)),
          f"a pack and an unpack launch per Adasum bucket (per 256 tensors) "
          f"and no combine (one rank) every step: {per_step}, {per_bucket}")
    emit({"phase": "train_adasum", "model": "ResNet-50", "op": "Adasum",
          "batch": args.batch, "warmup": args.warmup, "steps": args.steps,
          "losses": losses, "step_ms": 1e3 * elapsed / args.steps,
          "images_per_sec": args.batch * args.steps / elapsed,
          "launches_per_step": per_step,
          "launches_per_step_columns": list(launches), "launches": launches,
          **tables, **step_buckets_report(per_bucket, args.warmup),
          "fp32_buckets_last_step": [{"tensors": len(b),
                                      "elements": sum(n for _, n in b)}
                                     for b in buckets],
          "reduced_equals_local_bitwise": True,
          "note": "one rank: the gather leaves a tree of one leaf, so the "
                  "combine kernel does not run in this path; "
                  "adasum_gathered drives it on the path's buckets",
          "card": card})
    return launches, buckets


def phase_adasum_gathered(torch, model, buckets, dev, args):
    """The combine kernel through the route's own post-gather function at
    the path's shapes: ResNet-50's gradients for K batches from ``seed``
    (what K ranks would hold; --batch images each), packed in each
    bucket's layout and stacked as the all-gather leaves them, through
    ops.adasum.reduce_gathered, for
    each K of ADASUM_RANKS. Held against reduce_gathered_reference; a
    control with whole-bucket coefficients must fail the same limit."""
    import torch.nn.functional as F

    from horovod_tpu_torch.ops.adasum import reduce_gathered
    from horovod_tpu_torch.ops.kernels import adasum as ak

    params = dict(model.named_parameters())
    names = list(params)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    grads = []
    for _ in range(max(ADASUM_RANKS)):
        x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
        y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
        loss = F.cross_entropy(model(x), y)
        # autograd.grad: the optimizer's gradient hooks do not fire.
        g = torch.autograd.grad(loss, [params[n] for n in names])
        grads.append(dict(zip(names, g)))
    limit = ADASUM_TOL["float32"]
    rows, total_launches, worst = [], 0, 0.0
    for k in ADASUM_RANKS:
        for bucket in buckets:
            numels = [n for _, n in bucket]
            gathered = torch.stack([
                torch.cat([grads[r][name].reshape(-1) for name, _ in bucket])
                for r in range(k)])
            want = ak.reduce_gathered_reference(gathered, numels)
            whole = ak.reduce_gathered_reference(gathered, [sum(numels)])
            torch.cuda.synchronize()
            ak.reset_launch_counts()
            got = reduce_gathered(gathered, numels)
            torch.cuda.synchronize()
            launches, streamed = ak.launches, ak.stream_launches
            total_launches += launches + streamed
            rel, err = segment_errors(torch, got, want, numels)
            ctl, _ = segment_errors(torch, whole, want, numels)
            worst = max(worst, err)
            levels = (k - 1).bit_length()
            rows.append({"ranks": k, "tensors": len(numels),
                         "elements": sum(numels), "launches": launches,
                         "stream_launches": streamed, "levels": levels,
                         "max_rel": max(rel), "max_abs_err": err,
                         "control_whole_bucket_max_rel": max(ctl)})
            check(launches == levels and streamed == 0,
                  f"ceil(log2 K) = {levels} level launches and no "
                  f"streaming one for K = {k}, got {launches} and "
                  f"{streamed}")
            check(max(rel) <= limit, f"reduce_gathered K = {k}: {max(rel)} "
                  f"beyond {limit}")
            # A bucket of one tensor has one coefficient pair either way.
            check(len(numels) == 1 or max(ctl) > limit,
                  f"the whole-bucket control K = {k} ({max(ctl)}) is "
                  f"rejected by the limit {limit}")
            del gathered, want, whole
        check(any(r["tensors"] > 1 and r["ranks"] == k for r in rows),
              f"a bucket of more than one tensor for the control, K = {k}")
    emit({"phase": "adasum_gathered", "rows": rows, "limit": limit,
          "max_abs_err": worst, "launches": total_launches,
          "metric": "max_rel: max |kernel - plain| / max |plain| per tensor "
                    "of the bucket; the control takes one coefficient pair "
                    "for the whole bucket and must exceed the limit"})
    return total_launches, worst


def phase_timing_adasum(torch, buckets, dev, seed):
    """One combine of two ranks' rows at the fp32 bucket shapes of the
    Adasum path (a tree level at K = 2): the level kernel alone, the
    wrapper, the plain version; summed over the buckets, beside the byte
    bound, with each bucket's steps, grid and shared memory."""
    from horovod_tpu_torch.ops.kernels import adasum as ak
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    rows = []
    for bucket in buckets:
        numels = [n for _, n in bucket]
        total = sum(numels)
        gathered = torch.randn(2, total, generator=gen, device=dev)
        flat = gathered.view(-1)
        sched = ak.schedule(numels, ak.level_pairs(2, 1), total,
                            torch.float32, dev)
        check(not sched.stream, "no ResNet-50 tensor is past a round")
        nbytes = 3 * total * gathered.element_size()
        rows.append({
            "tensors": len(numels), "elements": total,
            "steps": sched.steps, "grid": sched.grid,
            "tiles": len(sched.tiles),
            "empty_tiles": sched.tiles.count(None),
            "tile_elements": sched.tile,
            "dynamic_smem_bytes": ak.LEVEL_SMEM_BYTES,
            "bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "ms": event_ms(lambda: ak.launch_level(flat, flat, flat, sched),
                           inner=10),
            "wrapper_ms": event_ms(
                lambda: ak.combine_pairs(gathered, numels, 1)),
            "plain_ms": event_ms(lambda: ak.combine_level_reference(
                flat, flat, flat, sched), reps=5),
        })
        del gathered, flat
    total = {k: sum(r[k] for r in rows) for k in ("bound_ms", "ms",
                                                  "wrapper_ms", "plain_ms")}
    total["bound_share"] = total["bound_ms"] / total["ms"]
    emit({"phase": "timing_adasum", "dtype": "float32", "per_bucket": rows,
          "per_combine": total,
          "elements": sum(r["elements"] for r in rows),
          "library_ms": None,
          "note": "one combine of every gradient of the step (rows 0 and 1 "
                  "of a gathered bucket, in place); ms: the level kernel "
                  "alone, 10 cooperative launches back to back; "
                  "wrapper_ms: combine_pairs as reduce_gathered calls it; "
                  "plain_ms: combine_level_reference; bound: each input "
                  "and output byte once (3 N x 4 B) at 3.35 TB/s; library: "
                  "none, no single PyTorch call computes this combine"})
    return total


# The GPT main path: bench.py's GPT-2 small, 8 x 1024 tokens a step.
GPT_BATCH, GPT_SEQ, GPT_STEPS = 8, 1024, 8
GPT_HIDDEN, GPT_HEADS, GPT_LAYERS, GPT_VOCAB = 768, 12, 12, 50304
GPT_HEAD_DIM = GPT_HIDDEN // GPT_HEADS
# The attention shape every flash launch of that path sees.
MAIN_FLASH_CASE = ("bfloat16", GPT_BATCH * GPT_HEADS, GPT_SEQ, GPT_SEQ,
                   GPT_HEAD_DIM, True, None, None, None)


# The BERT path: bench.py's BERT-Large leg (bench.py:452-500), 32 x 128
# tokens a step, MLM + NSP, dropout off (deterministic), so flash engages.
BERT_BATCH, BERT_SEQ, BERT_STEPS = 32, 128, 8
BERT_PARAMS = 367_480_636           # 303 Flax leaves (jax.eval_shape)
# The LLaMA path: bench.py's LLaMA-400M leg (bench.py:596-611) at 1024
# positions, 8 x 1024 tokens a step, 16 query heads over 8 kv heads.
LLAMA_BATCH, LLAMA_SEQ, LLAMA_STEPS = 8, 1024, 8
LLAMA_PARAMS = 348_701_696          # 147 Flax leaves
# The attention shapes every flash launch of those paths sees.
BERT_FLASH_CASE = ("bfloat16", BERT_BATCH * 16, BERT_SEQ, BERT_SEQ, 64,
                   False, None, None, None)
LLAMA_FLASH_CASE = ("bfloat16", LLAMA_BATCH * 16, LLAMA_SEQ, LLAMA_SEQ, 64,
                    True, None, 16, 8)
# The ViT path: bench.py's ViT-B/16 leg (bench.py:643-675), 128 bf16 images
# of 224 x 224 x 3 a step: 14 x 14 = 196 patches (no cls token), so the
# flash kernels' last 64-key tile holds 4 keys.
VIT_BATCH, VIT_IMAGE, VIT_STEPS = 128, 224, 8
VIT_PARAMS = 86_566_120             # 152 Flax leaves (jax.eval_shape)
VIT_SEQ = (VIT_IMAGE // 16) ** 2
VIT_FLASH_CASE = ("bfloat16", VIT_BATCH * 12, VIT_SEQ, VIT_SEQ, 64, False,
                  None, None, None)
PATH_FLASH_CASES = {"bert": BERT_FLASH_CASE, "llama": LLAMA_FLASH_CASE,
                    "vit": VIT_FLASH_CASE}
# Repeats of the ViT step's timing (images/s is their median), steps each.
VIT_REPEATS, VIT_REPEAT_STEPS = 5, 5


def gpt_config(torch, use_flash):
    from horovod_tpu_torch.models import GPTConfig
    # bench.py's GPT-2 small: untied fp32 lm_head, 163,109,376 parameters.
    return GPTConfig(vocab_size=GPT_VOCAB, hidden_size=GPT_HIDDEN,
                     num_layers=GPT_LAYERS, num_heads=GPT_HEADS,
                     intermediate_size=3072,
                     max_position_embeddings=GPT_SEQ, dtype=torch.bfloat16,
                     tp_axis=None, ep_axis=None, use_flash=use_flash)


def flash_cases():
    """(dtype name, BH, Lq, Lk, D, causal, kv_valid, heads, kv_heads)."""
    cases = []
    for dt in ("float32", "bfloat16", "float16"):
        for d in (16, 32, 64, 128):
            for causal in (True, False):
                cases.append((dt, 4, 197, 197, d, causal, None, None, None))
        cases += [(dt, 4, 128, 320, 64, True, None, None, None),
                  (dt, 4, 320, 128, 64, True, None, None, None),
                  (dt, 4, 320, 128, 32, False, None, None, None),
                  (dt, 4, 197, 300, 32, False, 250, None, None),
                  (dt, 4, 300, 300, 64, True, 250, None, None),
                  (dt, 24, 197, 197, 64, True, None, 12, 4),
                  # the main path's shape; fewer rows outside its dtype
                  MAIN_FLASH_CASE if dt == MAIN_FLASH_CASE[0] else
                  (dt, 24) + MAIN_FLASH_CASE[2:]]
    return cases + list(PATH_FLASH_CASES.values())


def phase_flash_vs_plain(torch, dev, seed):
    """Each flash kernel against its plain version on the card. fp32:
    FLASH_TOL against the plain versions; lse in every dtype within 1e-5
    relative. bf16/fp16 forward, dQ and dK/dV: the rounding bound against
    the plain versions that round P and dS where the kernels do; a plain
    version with the causal diagonal off by one goes through the same check
    and must fail it on every output."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    rows, worst, main_err, ratios, controls = [], {}, {}, {}, []
    path_err, key_controls = {}, []
    for case in flash_cases():
        dt, bh, lq, lk, d, causal, kv_valid, heads, kvh = case
        dtype = getattr(torch, dt)
        bkv = bh if heads is None else bh // heads * kvh
        q, do = (torch.randn(bh, lq, d, generator=gen, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(bkv, lk, d, generator=gen, device=dev).to(dtype)
                for _ in range(2))
        sm = d ** -0.5
        o, lse = fa.fa_forward(q, k, v, causal, sm, kv_valid=kv_valid,
                               heads=heads, kv_heads=kvh)
        torch.cuda.synchronize()
        if heads is not None:      # the backward takes MHA shapes
            g, b = heads // kvh, bh // heads
            k = fa.gqa_repeat3(k, b, kvh, g).contiguous()
            v = fa.gqa_repeat3(v, b, kvh, g).contiguous()
        o_p, lse_p = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                            kv_valid)
        grads = fa.fa_backward(q, k, v, o, lse, do, causal, sm,
                               kv_valid=kv_valid)
        torch.cuda.synchronize()
        ref = fa.block_bwd_reference(q, k, v, o, lse, do, causal, sm, None,
                                     kv_valid)
        errs, rounded = {}, dt != "float32"
        tol_checks = [("lse", lse, lse_p, (1e-4, 1e-5))]
        if not rounded:
            atol, rtol = FLASH_TOL[dt]
            tol_checks += [("flash_fwd", o, o_p, (atol, rtol)),
                           ("flash_bwd_dq", grads[0], ref[0], (atol, rtol)),
                           ("flash_bwd_dk", grads[1], ref[1], (atol, rtol)),
                           ("flash_bwd_dv", grads[2], ref[2], (atol, rtol))]
        for name, got, want, tol in tol_checks:
            diff = (got.float() - want.float()).abs()
            errs[name] = diff.max().item()
            bound = tol[0] + tol[1] * want.float().abs()
            check(bool((diff <= bound).all()),
                  f"{name} {case}: max abs err {errs[name]} beyond atol "
                  f"{tol[0]} + rtol {tol[1]}")
        ratio = {}
        if rounded:
            o_r, _ = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                            kv_valid, round_p=dtype)
            dq_r, dk_r, dv_r = fa.block_bwd_reference(
                q, k, v, o, lse, do, causal, sm, None, kv_valid,
                round_p=dtype)
            plain = {"o": o_r, "dq": dq_r, "dk": dk_r, "dv": dv_r}
            bounds = fa.rounding_bounds(plain, q, k, v, causal, sm, None,
                                        kv_valid, o3=o, lse=lse, do3=do)
            for name, key, got in (("flash_fwd", "o", o),
                                   ("flash_bwd_dq", "dq", grads[0]),
                                   ("flash_bwd_dk", "dk", grads[1]),
                                   ("flash_bwd_dv", "dv", grads[2])):
                errs[name] = (got.float() - plain[key].float()).abs().max() \
                    .item()
                ratio[key] = fa.bound_ratio(got, plain[key], bounds[key])
                check(ratio[key] <= 1.0, f"{name} {case}: {ratio[key]} of "
                      f"the rounding bound")
            if causal and lq == lk:
                # The control: every row sees one key more than it may.
                o_c, _ = fa.block_fwd_reference(q, k, v, causal, sm, 1,
                                                kv_valid, round_p=dtype)
                grads_c = fa.block_bwd_reference(
                    q, k, v, o, lse, do, causal, sm, 1, kv_valid,
                    round_p=dtype)
                ctl = {key: fa.bound_ratio(got, plain[key], bounds[key])
                       for key, got in zip(("o", "dq", "dk", "dv"),
                                           (o_c,) + grads_c)}
                controls.append([SHORT[dt], bh, lq, d] + [
                    float(f"{ctl[key]:.3g}")
                    for key in ("o", "dq", "dk", "dv")])
                check(min(ctl.values()) > 1.0, f"the off-by-one diagonal "
                      f"control {case} {ctl} is rejected by the bound")
            elif case in (BERT_FLASH_CASE, VIT_FLASH_CASE):
                # The non-causal control: every row misses its last key (at
                # ViT's L = 196, a key of the 4-key ragged tile).
                o_c, _ = fa.block_fwd_reference(q, k, v, causal, sm, None,
                                                lk - 1, round_p=dtype)
                grads_c = fa.block_bwd_reference(
                    q, k, v, o, lse, do, causal, sm, None, lk - 1,
                    round_p=dtype)
                ctl = {key: fa.bound_ratio(got, plain[key], bounds[key])
                       for key, got in zip(("o", "dq", "dk", "dv"),
                                           (o_c,) + grads_c)}
                key_controls.append([SHORT[dt], bh, lq, d] + [
                    float(f"{ctl[key]:.3g}")
                    for key in ("o", "dq", "dk", "dv")])
                check(min(ctl.values()) > 1.0, f"the last-key-dropped "
                      f"control {case} {ctl} is rejected by the bound")
                check(case != VIT_FLASH_CASE or min(ctl.values()) >= 10.0,
                      f"the last-key-dropped control at ViT's shape {ctl} "
                      f"fails the bound by 10x or more")
            for key, r in ratio.items():
                ratios[key] = max(ratios.get(key, 0.0), r)
        if causal and lq - lk > 0:
            n = lq - lk           # rows that see no key at all
            check(bool((o[:, :n] == 0).all() and (grads[0][:, :n] == 0).all()),
                  f"fully masked rows are exact zeros {case}")
        errs["flash_bwd_dkv"] = max(errs.pop("flash_bwd_dk"),
                                    errs.pop("flash_bwd_dv"))
        for name, e in errs.items():
            worst[name] = max(worst.get(name, 0.0), e)
        if case == MAIN_FLASH_CASE:
            main_err = dict(errs, bound_ratio=ratio)
        for path, path_case in PATH_FLASH_CASES.items():
            if case == path_case:
                path_err[path] = dict(errs, bound_ratio=ratio)
        rows.append([SHORT[dt], bh, lq, lk, d, int(causal), kv_valid, heads,
                     kvh] + [float(f"{errs[n]:.3g}") for n in
                             ("flash_fwd", "lse", "flash_bwd_dq",
                              "flash_bwd_dkv")]
                    + [float(f"{ratio[key]:.3g}") if ratio else None
                       for key in ("o", "dq", "dk", "dv")])
    check(main_err, f"the main path's shape {MAIN_FLASH_CASE} was checked")
    check(controls, "the off-by-one control ran")
    check(len(path_err) == len(PATH_FLASH_CASES) and len(key_controls) == 2,
          f"the BERT, LLaMA and ViT shapes were checked, with their "
          f"controls: {sorted(path_err)}")
    emit({"phase": "flash_vs_plain", "cases": len(rows),
          "columns": ["dtype", "BH", "Lq", "Lk", "D", "causal", "kv_valid",
                      "heads", "kv_heads", "err_o", "err_lse", "err_dq",
                      "err_dkv", "bound_ratio_o", "bound_ratio_dq",
                      "bound_ratio_dk", "bound_ratio_dv"],
          "rows": rows, "max_abs_err": worst, "main_shape_err": main_err,
          "path_shape_err": path_err,
          "tolerance": {k: {"atol": a, "rtol": r}
                        for k, (a, r) in FLASH_TOL.items()},
          "lse_tolerance": {"atol": 1e-4, "rtol": 1e-5},
          "rounding_bound": {
              "form": "|kernel - plain| <= 2 ulp(|plain|) + c (u |A||B| "
                      "+ eta n [+ f]); f for dQ alone: gamma (P scale "
                      "(|dO||V|^T + rowsum |dO||O|)) |K|, gamma = D "
                      "fp32_sum_unit, the fp32 error of dP - delta where "
                      "the two cancel",
              "c": fa.ROUNDING_C, "fp32_sum_unit": fa.FP32_SUM_UNIT,
              "u": {str(t).split(".")[-1]: u
                    for t, u in fa.UNIT_ROUNDOFF.items()},
              "eta": {str(t).split(".")[-1]: e
                      for t, e in fa.SUBNORMAL_HALF_STEP.items()},
              "worst_ratio": ratios},
          "worst_dq_ratio": ratios.get("dq"),
          "off_by_one_control": {"columns": ["dtype", "BH", "L", "D",
                                             "ratio_o", "ratio_dq",
                                             "ratio_dk", "ratio_dv"],
                                 "rows": controls, "rejected": True},
          "last_key_dropped_control": {
              "columns": ["dtype", "BH", "L", "D", "ratio_o", "ratio_dq",
                          "ratio_dk", "ratio_dv"],
              "rows": key_controls, "rejected": True,
              "note": "the non-causal BERT and ViT shapes: a plain version "
                      "whose rows miss their last key (kv_valid = L - 1; "
                      "at ViT's, the 10x it must fail by)"},
          "reason": "fp32, and lse: kernel and plain both compute in "
                    "fp32 and round once; they sum in another order (~1e-6 "
                    "relative in fp32), which can flip the final rounding: "
                    "1e-4 relative in fp32 (lse 1e-5). bf16/fp16 o, dQ, dK, "
                    "dV: the tensor-core kernels round P and dS to the "
                    "input type before the product; held to the plain "
                    "versions that round at the same points, within one "
                    "rounding of an operand on each side",
          "fully_masked_rows_exact_zero": True})
    return main_err, path_err


def next_token_loss(F, logits, ids):
    return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                           ids[:, 1:].flatten())


def build_gpt(torch, dev, seed):
    from horovod_tpu_torch.models import GPT
    model = GPT(gpt_config(torch, use_flash=True),
                generator=torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == 163_109_376, f"GPT-2 small (lm_head untied) has "
          f"163,109,376 parameters, this model {n_params}")
    return model


FLASH_COUNTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
STEP_COUNTS = FLASH_COUNTS + ("scale_pack", "scale_unpack")
ADAMW = "AdamW(lr={lr}, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)"


def train_steps(torch, hvd, model, loss, args, steps, flash, lr=None,
                opt=None):
    """A transformer path's steps. With ``lr``: the launch counts zeroed
    (the path starts here), then AdamW(lr) in hvd.DistributedOptimizer
    after broadcast_parameters and broadcast_optimizer_state; with ``opt``,
    that optimizer goes on, the counts zeroed first too. --warmup and
    ``steps`` timed steps of ``loss()``, the last warm-up step checking the
    reduction; the counts are read right after (the path ends). Checks:
    finite, falling loss; ``flash`` (forward, dQ, dK/dV) launches every
    step; a pack and an unpack launch per fusion bucket every step.
    Returns the optimizer and the run's readings."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    fa.reset_launch_counts()              # the path starts here
    sb.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    if opt is None:
        opt = torch.optim.AdamW(model.parameters(), lr=lr,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        hvd.broadcast_optimizer_state(opt, root_rank=0)

    tally = KeptTableTally(sb)

    def counts():
        return (fa.fwd_launches, fa.bwd_dq_launches, fa.bwd_dkv_launches,
                sb.pack_launches, sb.unpack_launches) + tally.counts()

    def step():
        opt.zero_grad()
        value = loss()
        value.backward()
        opt.step()
        return value.detach()

    losses, per_step, closed, per_bucket = [], [], [], []
    with tally:
        for i in range(args.warmup + steps):
            if i == args.warmup:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            c0, m0 = counts(), get_runtime().flush_stats()
            losses.append(reduced_equals_local(torch, model, step)
                          if i == args.warmup - 1 else step())
            per_step.append([b - a for a, b in zip(c0, counts())])
            got, row = buckets_since(m0)
            closed.append(got)
            per_bucket.append(row)
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(zip(STEP_COUNTS, counts()))     # the path ends
    tables = kept_table_report(per_step, args.warmup, 5)
    per_step = [s[:5] for s in per_step]
    losses = [l.item() for l in losses]
    buckets = [[n for _, n in sig[-1]] for _, sig in closed[-1]]
    check(all(map(math.isfinite, losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls: {losses}")
    check(all(s[:3] == list(flash) for s in per_step),
          f"{flash} fwd, dQ and dK/dV flash launches a step: {per_step}")
    # Buckets the timer closed included: each step's pack and unpack
    # launches are those of the buckets that closed in it.
    check(all(r[0] > 0 and s[3] == s[4] == scale_launches(c)
              for s, r, c in zip(per_step, per_bucket, closed)),
          f"a pack and an unpack launch per bucket (per 256 tensors) every "
          f"step: {per_step}, {per_bucket}")
    return opt, {
        "warmup": args.warmup, "steps": steps, "losses": losses,
        "step_ms": 1e3 * elapsed / steps, "elapsed": elapsed,
        "launches_per_step": per_step,
        "launches_per_step_columns": list(launches), "launches": launches,
        **tables, **step_buckets_report(per_bucket, args.warmup),
        "cycle_time_ms": get_runtime()._cycle_s * 1e3,
        "fp32_buckets_last_step": [{"tensors": len(b), "elements": sum(b)}
                                   for b in buckets],
        "reduced_equals_local_bitwise": True,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def phase_train_gpt(torch, hvd, model, dev, args, card):
    import torch.nn.functional as F

    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, cfg.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    _, run = train_steps(torch, hvd, model,
                         lambda: next_token_loss(F, model(ids), ids), args,
                         GPT_STEPS, (cfg.num_layers,) * 3, lr=1e-4)
    elapsed = run.pop("elapsed")
    emit({"phase": "train_gpt", "model": "GPT-2 small", "params": n_params,
          "batch": GPT_BATCH, "seq": GPT_SEQ, "dtype": "bfloat16",
          "param_dtype": "float32", "optimizer": ADAMW.format(lr=1e-4),
          **run,
          "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS / elapsed,
          "fp32_products": "DEFAULT precision: TF32 (lm_head, forward "
                           "and backward)",
          "matmul_allow_tf32_outside_the_products":
              torch.backends.cuda.matmul.allow_tf32,
          "card": card})
    return model, ids, run["launches"]


# Limits of one GPT step with flash attention against the same step on
# plain attention (bf16 activations: plain attention rounds its scores to
# bf16 and its normalised probabilities; the bf16 kernels keep scores in
# fp32 and round P, and dS, before a product). Each sits between the
# reading of that sound pair and the readings of two deliberately wrong
# controls, which these limits must reject (see gpt_flash_vs_plain). Read
# on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel, grad_rel, attn_cos),
# with all three kernels on the tensor cores (dQ rounding dS too): seed 0:
# flash 6.4e-7, 1.15e-2 (lm_head), 0.9999944; not causal 0.176, 1.15,
# 0.43; dK and dV swapped 6.4e-7, 1.41, 0.14 (the swap leaves the forward,
# so only the gradients reject it). Seed 1: flash 2.2e-5, 1.16e-2,
# 0.9999939; not causal 0.191, 1.31, 0.35; swapped 2.2e-5, 1.41, 0.15. The
# loss reading is not the kernels' rounding of P and dS: the same step
# through the plain flash versions reads 1.5e-5 (seed 0) and 1.4e-5 (seed
# 1) rounding them as the kernels do, 2.6e-5 and 8.2e-6 in fp32, so it
# moves with the weights and data more than with that rounding.
GPT_CMP_LIMITS = {"loss_rel": 1e-4, "grad_rel": 3e-2, "attn_cos_min": 0.9999}


def phase_flash_vs_plain_model(torch, model, ids, dev):
    """One forward and backward of the trained model with flash attention
    against a copy on plain attention: same weights, same batch, no
    optimizer (and no gradient hooks) on any copy. Compared: the loss, each
    parameter's gradient (relative error of the whole tensor) and the
    cosine of the attention weights' gradient alone. Two controls go
    through the same comparison and must fail it: flash attention that is
    not causal (a wrong forward), and dK and dV swapped in the backward (a
    wrong backward that leaves the loss and every per-tensor gradient norm
    as they were)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, causal=True, ctx=contextlib.nullcontext):
        with torch.device(dev):
            m = GPT(gpt_config(torch, use_flash))
        m.load_state_dict(model.state_dict())
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = causal
        with ctx():
            loss = next_token_loss(F, m(ids), ids)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    lp, gp = run(use_flash=False)
    attn = [n for n in gp if ".attention." in n]

    def reading(lf, gf, lp=lp, gp=gp):
        rel = {n: ((gf[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
               .item() for n in gp}
        worst = max(rel, key=rel.get)
        cos = F.cosine_similarity(torch.cat([gf[n].flatten() for n in attn]),
                                  torch.cat([gp[n].flatten() for n in attn]),
                                  dim=0).item()
        return {"loss": lf, "loss_rel": abs(lf - lp) / abs(lp),
                "grad_rel": rel[worst], "grad_rel_worst": worst,
                "attn_cos": cos}

    def within(r):
        return (r["loss_rel"] <= GPT_CMP_LIMITS["loss_rel"]
                and r["grad_rel"] <= GPT_CMP_LIMITS["grad_rel"]
                and r["attn_cos"] >= GPT_CMP_LIMITS["attn_cos_min"])

    flash_run = run(use_flash=True)
    flash = reading(*flash_run)
    rounding_run = run(use_flash=True,
                       ctx=functools.partial(plain_flash, True))
    # Readings, not checks: where the difference to plain attention comes
    # from. The same step through the plain flash versions, rounding as the
    # kernels do and not, each against plain attention, and the kernels
    # against the rounding one.
    sources = {"plain_flash_rounding": reading(*rounding_run),
               "plain_flash_fp32": reading(*run(
                   use_flash=True, ctx=functools.partial(plain_flash, False))),
               "flash_vs_plain_flash_rounding": reading(*flash_run,
                                                        *rounding_run)}
    controls = {"not_causal": reading(*run(use_flash=True, causal=False)),
                "swapped_dkv": reading(*run(use_flash=True,
                                            ctx=swapped_dkv))}
    emit({"phase": "gpt_flash_vs_plain", "loss_plain": lp, "flash": flash,
          "controls": controls, "sources": sources,
          "limits": GPT_CMP_LIMITS,
          "attention_tensors": len(attn),
          "note": "grad_rel: |g_flash - g_plain| / |g_plain| of the worst "
                  "parameter; attn_cos: cosine of the attention weights' "
                  "gradients alone; each control must fall outside the "
                  "limits"})
    check(within(flash), f"flash vs plain attention on one GPT step "
          f"{flash} within {GPT_CMP_LIMITS}")
    for name, r in controls.items():
        check(not within(r), f"control {name} {r} is rejected by the "
              f"limits {GPT_CMP_LIMITS}")


@contextlib.contextmanager
def swapped_dkv():
    """fa_backward with dK and dV swapped: a wrong backward that leaves the
    loss and every per-tensor gradient norm as they were."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    raw = fa.fa_backward

    def wrong(*a, **kw):
        dq, dk, dv = raw(*a, **kw)
        return dq, dv, dk
    fa.fa_backward = wrong
    try:
        yield
    finally:
        fa.fa_backward = raw


@contextlib.contextmanager
def plain_flash(rounding):
    """fa_forward and fa_backward replaced by their plain versions on the
    card (K/V repeated to the query heads under grouped-query attention),
    which round P (and dS) to the inputs' dtype where the bf16 kernels do,
    or keep them in fp32: to tell the kernels' rounding from the rest of the
    difference to plain attention."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    raw = fa.fa_forward, fa.fa_backward

    def fwd(q, k, v, causal, scale, q_offset=None, kv_valid=None,
            heads=None, kv_heads=None):
        if heads is not None and heads != kv_heads:
            b, g = q.shape[0] // heads, heads // kv_heads
            k = fa.gqa_repeat3(k, b, kv_heads, g)
            v = fa.gqa_repeat3(v, b, kv_heads, g)
        return fa.block_fwd_reference(
            q, k, v, causal, scale, q_offset, kv_valid,
            round_p=q.dtype if rounding else None)

    def bwd(q, k, v, o, lse, do, causal, scale, q_offset=None,
            kv_valid=None):
        return fa.block_bwd_reference(
            q, k, v, o, lse, do, causal, scale, q_offset, kv_valid,
            round_p=q.dtype if rounding else None)
    fa.fa_forward, fa.fa_backward = fwd, bwd
    try:
        yield
    finally:
        fa.fa_forward, fa.fa_backward = raw


def grad_readings(torch, F, run, limits, controls):
    """``run(use_flash, control)`` -> (loss, {name: grad}) of one forward
    and backward of a fresh copy of the model, ``control`` None or one of
    ``controls``, a deliberately wrong flash run. The flash run against the
    plain one: the loss's relative difference, the worst parameter's
    |g_flash - g_plain| / |g_plain| and the cosine of the attention
    weights' gradients; each control must fall outside ``limits``, the
    flash run inside."""
    lp, gp = run(False, None)
    attn = [n for n in gp if ".attention." in n]

    def reading(lf, gf, lp=lp, gp=gp):
        rel = {n: ((gf[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
               .item() for n in gp}
        worst = max(rel, key=rel.get)
        cos = F.cosine_similarity(torch.cat([gf[n].flatten() for n in attn]),
                                  torch.cat([gp[n].flatten() for n in attn]),
                                  dim=0).item()
        return {"loss": lf, "loss_rel": abs(lf - lp) / abs(lp),
                "grad_rel": rel[worst], "grad_rel_worst": worst,
                "attn_cos": cos}

    def within(r):
        return (r["loss_rel"] <= limits["loss_rel"]
                and r["grad_rel"] <= limits["grad_rel"]
                and r["attn_cos"] >= limits["attn_cos_min"])

    flash_run = run(True, None)
    flash = reading(*flash_run)
    ctl = {name: reading(*run(True, name)) for name in controls}
    # A reading, not a check: the kernels against their plain versions
    # rounding P and dS as they do, through the same step.
    source = reading(*flash_run, *run(True, "plain_flash"))
    out = {"loss_plain": lp, "flash": flash, "controls": ctl,
           "flash_vs_plain_flash_rounding": source,
           "limits": limits, "attention_tensors": len(attn),
           "within": within(flash),
           "controls_rejected": {n: not within(r) for n, r in ctl.items()}}
    return out, within


def check_readings(name, out, within):
    emit({"phase": name, **out,
          "note": "grad_rel: |g_flash - g_plain| / |g_plain| of the worst "
                  "parameter; attn_cos: cosine of the attention weights' "
                  "gradients alone; each control must fall outside the "
                  "limits"})
    check(within(out["flash"]), f"{name}: flash vs plain attention "
          f"{out['flash']} within {out['limits']}")
    for ctl, r in out["controls"].items():
        check(not within(r), f"{name}: control {ctl} {r} is rejected by "
              f"the limits {out['limits']}")


def bert_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import BertConfig
    return BertConfig.large(dtype=torch.bfloat16, use_flash=use_flash, **kw)


def llama_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import LlamaConfig
    return LlamaConfig.bench(max_position_embeddings=LLAMA_SEQ,
                             dtype=torch.bfloat16, use_flash=use_flash, **kw)


def build_on(torch, dev, make, seed):
    """``make(generator)`` built on ``dev``, its weights drawn there from
    ``seed``."""
    with torch.device(dev):
        return make(torch.Generator(device=dev).manual_seed(seed)).train()


def bert_loss(F, model, batch):
    """bench.py's pre-training loss: mean MLM plus mean NSP cross-entropy."""
    ids, labels, nsp = batch
    mlm, ns = model(ids)
    return F.cross_entropy(mlm.flatten(0, 1), labels.flatten()) \
        + F.cross_entropy(ns, nsp)


def phase_train_bert(torch, hvd, dev, args, card):
    """BERT-Large (MLM + NSP) at full width and depth, bf16, flash, on
    32 x 128 token ids, MLM and NSP labels from --seed; no padding mask,
    deterministic (dropout off). AdamW(lr=1e-5)."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import BertForPreTraining
    model = build_on(torch, dev, lambda g: BertForPreTraining(
        bert_config(torch, True), generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == BERT_PARAMS, f"BERT-Large has {BERT_PARAMS:,} "
          f"parameters, this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
    batch = (torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev),
             torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev),
             torch.randint(0, 2, (BERT_BATCH,), generator=gen, device=dev))
    _, run = train_steps(torch, hvd, model,
                         lambda: bert_loss(F, model, batch), args,
                         BERT_STEPS, (cfg.num_layers,) * 3, lr=1e-5)
    elapsed = run.pop("elapsed")
    emit({"phase": "train_bert", "model": "BERT-Large (MLM + NSP)",
          "params": n_params, "batch": BERT_BATCH, "seq": BERT_SEQ,
          "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, non-causal; no padding mask, deterministic",
          "optimizer": ADAMW.format(lr=1e-5), **run,
          "sequences_per_sec": BERT_BATCH * BERT_STEPS / elapsed,
          "card": card})
    return model, batch, run["launches"]


# Limits of one step with flash attention against the same step on the
# model's plain attention path, for BERT-Large (bert.py's own plain path:
# bf16 score products, an fp32 softmax, probabilities rounded to bf16) and
# LLaMA-400M (plain attention with K/V repeated), at the weights the main
# path ends with. Like GPT_CMP_LIMITS, each sits between the readings of
# the sound pair and those of the controls, which must fall outside. Read
# on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel, grad_rel, attn_cos),
# seeds 0, 1 and 2. BERT: flash 4.8e-5 / 2.2e-5 / 8.2e-5, 0.025 / 0.021 /
# 0.019, >= 0.9998; causal flash 5.1e-4 / 3.2e-4 / 6.6e-4, 8.5-9.2,
# 0.89-0.97; dK and dV swapped 1.6-2.0, 0.18-0.21. LLaMA: flash 1.7e-4 /
# 4.6e-7 / 5.0e-4, 0.034-0.035, ~0.9999; not causal 1.7-1.9, 1.4,
# <= 0.012; dK and dV swapped 1.2, 0.11-0.12. The step through the plain
# flash versions rounding as the kernels do reads 3.4e-7 to 7.4e-5 in the
# loss and 0.021-0.030 in the worst gradient against the kernels: most of
# the loss's difference is plain attention's own rounding, and the
# gradients' is the propagation of bf16 rounding through 24 layers.
BERT_CMP_LIMITS = {"loss_rel": 3e-4, "grad_rel": 0.1, "attn_cos_min": 0.999}
LLAMA_CMP_LIMITS = {"loss_rel": 2e-3, "grad_rel": 0.1, "attn_cos_min": 0.999}


def phase_bert_flash_vs_plain(torch, model, batch, dev):
    """One forward and backward of the trained BERT with flash attention
    against a copy on bert.py's plain path (same weights, same batch, no
    optimizer); controls: flash with causal masking switched on, and dK
    and dV swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import BertForPreTraining
    from horovod_tpu_torch.models import bert as bert_mod

    @contextlib.contextmanager
    def causal():
        raw = bert_mod.flash_attention
        bert_mod.flash_attention = lambda q, k, v, causal=False: raw(
            q, k, v, causal=True)
        try:
            yield
        finally:
            bert_mod.flash_attention = raw

    controls = {"causal": causal, "swapped_dkv": swapped_dkv}
    contexts = dict(controls, plain_flash=functools.partial(plain_flash,
                                                            True))

    def run(use_flash, control):
        with torch.device(dev):
            m = BertForPreTraining(bert_config(torch, use_flash))
        m.load_state_dict(model.state_dict())
        with contexts.get(control, contextlib.nullcontext)():
            loss = bert_loss(F, m, batch)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("bert_flash_vs_plain", *grad_readings(
        torch, F, run, BERT_CMP_LIMITS, controls))


def phase_train_llama(torch, hvd, dev, args, card):
    """LLaMA-400M (bench.py's config at 1024 positions) at full width and
    depth, bf16, flash with grouped-query K/V, on 8 x 1024 token ids from
    --seed, next-token loss, AdamW(lr=1e-4). Then remat on the trained
    weights and batch: one step of a copy without and one with remat
    (gradients equal bit for bit, 24 more forward launches, peak memory of
    each), and the same model and optimizer trained on with remat."""
    import dataclasses

    import torch.nn.functional as F

    from horovod_tpu_torch.models import Llama
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    model = build_on(torch, dev, lambda g: Llama(
        llama_config(torch, True), generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == LLAMA_PARAMS, f"LLaMA-400M at {LLAMA_SEQ} positions "
          f"has {LLAMA_PARAMS:,} parameters, this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 7)
    ids = torch.randint(0, cfg.vocab_size, (LLAMA_BATCH, LLAMA_SEQ),
                        generator=gen, device=dev)
    layers = cfg.num_layers
    opt, run = train_steps(torch, hvd, model,
                           lambda: next_token_loss(F, model(ids), ids), args,
                           LLAMA_STEPS, (layers,) * 3, lr=1e-4)
    tokens = LLAMA_BATCH * LLAMA_SEQ
    elapsed = run.pop("elapsed")
    run["tokens_per_sec"] = tokens * LLAMA_STEPS / elapsed

    # Remat: one step of fresh copies on the trained weights, no optimizer.
    one = {}
    for remat in (False, True):
        with torch.device(dev):
            m = Llama(llama_config(torch, True, remat=remat))
        m.load_state_dict(model.state_dict())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        next_token_loss(F, m(ids), ids).backward()
        torch.cuda.synchronize()
        one[remat] = {
            "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                         fa.bwd_dkv_launches],
            "peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "grads": {n: p.grad for n, p in m.named_parameters()}}
        del m
    off, on = one[False], one[True]
    check(off["launches"] == [layers] * 3, f"{layers} launches of each flash "
          f"kernel without remat: {off['launches']}")
    check(on["launches"] == [2 * layers, layers, layers],
          f"remat: {2 * layers} forward launches ({layers} recomputed), "
          f"{layers} dQ and {layers} dK/dV: {on['launches']}")
    unequal = [n for n in off["grads"]
               if not torch.equal(off["grads"][n], on["grads"][n])]
    check(not unequal, f"remat gradients equal those without, bit for bit: "
          f"{unequal[:5]}")
    check(on["peak_mem_gb"] < off["peak_mem_gb"],
          f"remat lowers the step's peak memory: {on['peak_mem_gb']} vs "
          f"{off['peak_mem_gb']} GB")
    del one, off["grads"], on["grads"]

    # The same model and optimizer trained on with remat; the weights of the
    # main path's end are kept for llama_flash_vs_plain.
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}
    model.config = dataclasses.replace(cfg, remat=True)
    _, remat_run = train_steps(torch, hvd, model,
                               lambda: next_token_loss(F, model(ids), ids),
                               args, LLAMA_STEPS,
                               (2 * layers, layers, layers), opt=opt)
    model.config = cfg
    remat_elapsed = remat_run.pop("elapsed")
    remat_run["tokens_per_sec"] = tokens * LLAMA_STEPS / remat_elapsed
    gqa = gqa_copy_ms(torch, fa, dev, layers)
    emit({"phase": "train_llama", "model": "LLaMA-400M (bench config)",
          "params": n_params, "batch": LLAMA_BATCH, "seq": LLAMA_SEQ,
          "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
          "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, causal, grouped-query K/V",
          "optimizer": ADAMW.format(lr=1e-4), **run,
          "remat_one_step": {
              "launches_without": off["launches"],
              "launches_with": on["launches"],
              "grads_bit_equal": True,
              "peak_mem_gb_without": off["peak_mem_gb"],
              "peak_mem_gb_with": on["peak_mem_gb"],
              "peak_mem_note": "the step's peak of allocated memory above "
                               "what was allocated before it (the weights "
                               "of its copy and what earlier phases hold)"},
          "remat_training": {k: remat_run[k] for k in (
              "steps", "losses", "step_ms", "tokens_per_sec",
              "launches_per_step", "buckets_timer_new_signatures_per_step",
              "peak_mem_gb")},
          "gqa_backward_repeat_fold": gqa, "card": card})
    return trained, ids, run["launches"]


def gqa_copy_ms(torch, fa, dev, layers):
    """Device ms a step of the GQA backward's copies at the LLaMA path's
    shapes (unchecked): K and V repeated to the query heads, dK and dV
    group-summed back, for every layer; CUDA events, median of 10."""
    _, bh, L, _, d, _, _, h, kvh = LLAMA_FLASH_CASE
    b, g = bh // h, h // kvh
    gen = torch.Generator(device=dev).manual_seed(17)
    k, v = (torch.randn(b * kvh, L, d, generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    dk, dv = (torch.randn(bh, L, d, generator=gen, device=dev).bfloat16()
              for _ in range(2))

    def copies():
        for _ in range(layers):
            fa.gqa_repeat3(k, b, kvh, g).contiguous()
            fa.gqa_repeat3(v, b, kvh, g).contiguous()
            fa.gqa_fold3(dk, b, kvh, g)
            fa.gqa_fold3(dv, b, kvh, g)
    nbytes = layers * 2 * (bh + b * kvh) * L * d * 2 * 2
    ms = event_ms(copies, reps=10)
    return {"ms_per_step": ms, "layers": layers, "group": g,
            "bytes_per_step": nbytes,
            "bytes_bound_ms": 1e3 * nbytes / H100_BYTES_PER_S,
            "note": "K and V repeated (gqa_repeat3 + contiguous) and dK, dV "
                    "folded (gqa_fold3) for every layer; bytes: each copy's "
                    "reads and writes once"}


def phase_llama_flash_vs_plain(torch, state, ids, dev):
    """One forward and backward of LLaMA at the weights ``state`` (the main
    path's, before remat trains on) with flash attention against a copy on
    plain attention with K/V repeated; controls: flash without causal
    masking, and dK and dV swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import Llama
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, control):
        with torch.device(dev):
            m = Llama(llama_config(torch, use_flash))
        m.load_state_dict(state)
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = control != "not_causal"
        ctx = {"swapped_dkv": swapped_dkv,
               "plain_flash": functools.partial(plain_flash, True)}.get(
                   control, contextlib.nullcontext)
        with ctx():
            loss = next_token_loss(F, m(ids), ids)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("llama_flash_vs_plain", *grad_readings(
        torch, F, run, LLAMA_CMP_LIMITS, ("not_causal", "swapped_dkv")))


def vit_config(torch, use_flash, **kw):
    from horovod_tpu_torch.models import ViTConfig
    return ViTConfig.base(dtype=torch.bfloat16, use_flash=use_flash, **kw)


def vit_loss(F, model, batch):
    images, labels = batch
    return F.cross_entropy(model(images), labels)


def busy_us(intervals):
    """Length of the union of (start, end) intervals (as
    scripts/profile_torch_port.py measures it; a copy, since a module named
    ``scripts`` elsewhere on the path could shadow that directory)."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_ms(torch, step, steps=2):
    """torch.profiler over ``steps`` calls of ``step``: the device's busy
    ms a step (the union of its kernels' and copies' intervals) and its
    busy share of the window."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    events = list(prof.events())
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    check(device, "torch.profiler recorded device time")
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    return busy / 1e3 / steps, busy / span


def phase_train_vit(torch, hvd, dev, args, card):
    """ViT-B/16 at full width and depth, bf16, flash (non-causal, L = 196),
    on 128 bf16 images and labels from --seed, AdamW(lr=1e-4). Then remat
    on the trained weights and batch: one step of a copy without and one
    with (gradients equal bit for bit, 12 more forward launches, peak
    memory of each); then the model and optimizer timed on, with and
    without remat: images/s (the median of repeats), the device's busy ms
    a step (torch.profiler) and the peak of allocated memory."""
    import dataclasses

    import torch.nn.functional as F

    from horovod_tpu_torch.models import ViT
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    model = build_on(torch, dev, lambda g: ViT(vit_config(torch, True),
                                               generator=g), args.seed)
    cfg = model.config
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == VIT_PARAMS, f"ViT-B/16 has {VIT_PARAMS:,} parameters, "
          f"this model {n_params}")
    gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
    batch = (torch.randn((VIT_BATCH, VIT_IMAGE, VIT_IMAGE, 3), generator=gen,
                         device=dev).to(torch.bfloat16),
             torch.randint(0, cfg.num_classes, (VIT_BATCH,), generator=gen,
                           device=dev))
    layers = cfg.num_layers
    opt, run = train_steps(torch, hvd, model,
                           lambda: vit_loss(F, model, batch), args,
                           VIT_STEPS, (layers,) * 3, lr=1e-4)
    run["images_per_sec"] = VIT_BATCH * VIT_STEPS / run.pop("elapsed")
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    one = {}
    for remat in (False, True):
        with torch.device(dev):
            m = ViT(vit_config(torch, True, remat=remat))
        m.load_state_dict(trained)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_launch_counts()
        vit_loss(F, m, batch).backward()
        torch.cuda.synchronize()
        one[remat] = {
            "launches": [fa.fwd_launches, fa.bwd_dq_launches,
                         fa.bwd_dkv_launches],
            "peak_mem_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
            "grads": {n: p.grad for n, p in m.named_parameters()}}
        del m
    off, on = one[False], one[True]
    check(off["launches"] == [layers] * 3, f"{layers} launches of each flash "
          f"kernel without remat: {off['launches']}")
    check(on["launches"] == [2 * layers, layers, layers],
          f"remat: {2 * layers} forward launches, {layers} dQ and {layers} "
          f"dK/dV: {on['launches']}")
    unequal = [n for n in off["grads"]
               if not torch.equal(off["grads"][n], on["grads"][n])]
    check(not unequal, f"remat gradients equal those without, bit for bit: "
          f"{unequal[:5]}")
    check(on["peak_mem_gb"] < off["peak_mem_gb"],
          f"remat lowers the step's peak memory: {on['peak_mem_gb']} vs "
          f"{off['peak_mem_gb']} GB")
    del one, off["grads"], on["grads"]

    def step():
        opt.zero_grad()
        vit_loss(F, model, batch).backward()
        opt.step()

    timed = {}
    for remat in (False, True):
        model.config = dataclasses.replace(cfg, remat=remat)
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rates = []
        for _ in range(VIT_REPEATS):
            t0 = time.perf_counter()
            for _ in range(VIT_REPEAT_STEPS):
                step()
            torch.cuda.synchronize()
            rates.append(VIT_BATCH * VIT_REPEAT_STEPS
                         / (time.perf_counter() - t0))
        busy_ms, busy_share = device_ms(torch, step)
        q1, med, q3 = statistics.quantiles(rates, n=4)
        timed["remat" if remat else "no_remat"] = {
            "images_per_sec_median": statistics.median(rates),
            "images_per_sec_q1_q3": [q1, q3], "images_per_sec": rates,
            "device_busy_ms_per_step": busy_ms,
            "device_busy_share": busy_share,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    model.config = cfg
    emit({"phase": "train_vit", "model": "ViT-B/16", "params": n_params,
          "batch": VIT_BATCH, "image": [VIT_IMAGE, VIT_IMAGE, 3],
          "tokens": VIT_SEQ, "dtype": "bfloat16", "param_dtype": "float32",
          "attention": "flash, non-causal, L = 196 (the last key tile "
                       "holds 4 keys)",
          "optimizer": ADAMW.format(lr=1e-4), **run,
          "remat_one_step": {
              "launches_without": off["launches"],
              "launches_with": on["launches"], "grads_bit_equal": True,
              "peak_mem_gb_without": off["peak_mem_gb"],
              "peak_mem_gb_with": on["peak_mem_gb"],
              "peak_mem_note": "the step's peak of allocated memory above "
                               "what was allocated before it"},
          "timed": timed,
          "timed_note": f"{VIT_REPEATS} repeats of {VIT_REPEAT_STEPS} steps "
                        "of the trained model and optimizer (host clock to "
                        "a synchronize); device_busy: torch.profiler over 2 "
                        "steps, the union of the device's kernel and copy "
                        "intervals; peak: allocated memory over the "
                        "repeats, weights and optimizer state included",
          "card": card})
    return trained, batch, run["launches"]


# Limits of one ViT-B/16 step with flash attention against the same step on
# plain attention (plain_attention: fp32 scores' softmax, probabilities
# rounded to bf16), at the weights the main path ends with; like
# BERT_CMP_LIMITS they sit between the sound pair's readings and the
# controls' (flash masked causally; dK and dV swapped), which must fall
# outside. Read on an NVIDIA H100 80GB HBM3 at 700 W as (loss_rel,
# grad_rel, attn_cos), seeds 0, 1 and 2: flash 7.3e-5 / 4.6e-5 / 3.7e-5,
# 0.0071 / 0.0068 / 0.0071 (patch_embed), >= 0.999997; causal flash
# 2.42 / 2.17 / 3.17, 4.6 / 4.1 / 5.0, 0.50 / 0.58 / 0.48; dK and dV
# swapped 1.413-1.416, <= 0.146. The step through the plain flash versions
# rounding as the kernels do reads 9.0e-6 to 9.2e-5 in the loss and
# 0.0067-0.0069 in the worst gradient against the kernels.
VIT_CMP_LIMITS = {"loss_rel": 3e-4, "grad_rel": 0.05, "attn_cos_min": 0.9999}


def phase_vit_flash_vs_plain(torch, state, batch, dev):
    """One forward and backward of ViT-B/16 at the weights ``state`` with
    flash attention against a copy on plain attention (same weights, same
    batch, no optimizer); controls: flash masked causally, and dK and dV
    swapped in the backward."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ViT
    from horovod_tpu_torch.parallel.tp import TPSelfAttention

    def run(use_flash, control):
        with torch.device(dev):
            m = ViT(vit_config(torch, use_flash))
        m.load_state_dict(state)
        for mod in m.modules():
            if isinstance(mod, TPSelfAttention):
                mod.causal = control == "causal"
        ctx = {"swapped_dkv": swapped_dkv,
               "plain_flash": functools.partial(plain_flash, True)}.get(
                   control, contextlib.nullcontext)
        with ctx():
            loss = vit_loss(F, m, batch)
            loss.backward()
        return loss.item(), {n: p.grad for n, p in m.named_parameters()}

    check_readings("vit_flash_vs_plain", *grad_readings(
        torch, F, run, VIT_CMP_LIMITS, ("causal", "swapped_dkv")))


def phase_collectives(torch, hvd, dev):
    """The rest of the collective surface at 1 rank over NCCL, on CUDA
    tensors in fp32 and bf16, each against what the JAX package's
    semantics give at n = 1, every tensor output on the card: ragged
    allgather (a 0-d tensor and a group too), alltoall with and without
    splits, reducescatter Sum and Average with a prescale and a postscale
    (the pack rounds x * prescale once, the unpack y * postscale / n once:
    bit-equal to that) and grouped (one pack and one unpack launch),
    allgather_object, sparse_allreduce_async and join(), which returns 0.
    Returns the scale kernels' launches."""
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb
    gen = torch.Generator(device=dev).manual_seed(23)
    sb.reset_launch_counts()                # the collectives path starts
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn(6, 5, generator=gen, device=dev).to(dt)
        outs = {"allgather": hvd.allgather(x),
                "allgather_0d": hvd.allgather(x[0, 0]),
                "alltoall": hvd.alltoall(x)}
        out, received = hvd.alltoall(x, splits=[4])
        outs.update(alltoall_splits=out, received_splits=received)
        check(torch.equal(outs["allgather"], x)
              and torch.equal(outs["allgather_0d"], x[0, :1])
              and torch.equal(outs["alltoall"], x)
              and torch.equal(out, x[:4])
              and received.tolist() == [4] and received.dtype == torch.int64,
              f"allgather and alltoall at 1 rank, {dt}")
        group = [x, x[:2, :3].contiguous() * 2,
                 torch.randn(5, 7, generator=gen, device=dev).to(dt)]
        p0, u0 = sb.pack_launches, sb.unpack_launches
        for op, pre, post in ((hvd.Sum, 1.0, 1.0), (hvd.Average, 0.5, 3.0)):
            got = hvd.grouped_reducescatter(group, op=op, prescale_factor=pre,
                                            postscale_factor=post)
            want = [((t.float() * pre).to(dt).float() * post).to(dt)
                    for t in group]
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"grouped reducescatter {op} at 1 rank, {dt}: bit-equal "
                  f"to one rounding of x * prescale and of y * postscale")
            outs[f"reducescatter_{op.name.lower()}"] = got[0]
        check((sb.pack_launches - p0, sb.unpack_launches - u0) == (2, 2),
              f"one pack and one unpack launch per grouped reducescatter, "
              f"{dt}")
        ragged = [h.synchronize() for h in hvd.grouped_allgather_async(
            [x[:3], x[:0]])]
        check(torch.equal(ragged[0], x[:3]) and ragged[1].shape == (0, 5),
              f"grouped_allgather_async at 1 rank, {dt}")
        dense = torch.where(x.float() > 0.5, x.float(), 0.0)
        sparse = hvd.sparse_allreduce_async(dense.to_sparse_coo(), name="sp",
                                            op=hvd.Average)
        got = hvd.synchronize(sparse)
        check(got.is_sparse and torch.equal(got.coalesce().to_dense(), dense),
              f"sparse_allreduce_async at 1 rank, {dt}")
        outs["sparse"] = got
        check(all(t.is_cuda for t in outs.values()),
              f"every output on the card: "
              f"{[k for k, t in outs.items() if not t.is_cuda]}")
        rows[str(dt)] = sorted(outs)
    obj = {"rank": hvd.rank(), "x": [1, 2]}
    check(hvd.allgather_object(obj) == [obj], "allgather_object at 1 rank")
    joined = hvd.join()
    check(joined == 0, f"join() at 1 rank returns 0, got {joined}")
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the path ends
    emit({"phase": "collectives", "ranks": hvd.size(),
          "backend": "gloo" if hvd.gloo_enabled() else "nccl",
          "checked": rows, "allgather_object": True, "join": joined,
          "launches": launches,
          "note": "1 rank over NCCL: every result equals what the JAX "
                  "package's semantics give at n = 1; the grouped "
                  "reducescatter packs its tensors rank-major with the "
                  "prescale (one launch), reduce-scatters once and unpacks "
                  "with the postscale (one launch)"})
    return launches


def phase_precision(torch, dev, seed):
    """The lm_head's product at full shape (8192 x 768 -> 50304, fp32)
    through the port's Dense at DEFAULT precision, forward and both
    backward products, against float64: each within the TF32 bound
    c 2^-11 |a| |b| (c from the product's depth, printed), on positive
    inputs, where the bound is tight, and on signed ones; a bf16 product,
    the control, must fail the forward's bound. The same layer at
    "highest", and the TF32 flags before and after, show where TF32 ran.
    Then the times of DEFAULT and "highest", forward and forward+backward,
    in this call."""
    from horovod_tpu_torch.parallel.tp import Dense
    m, k, n = GPT_BATCH * GPT_SEQ, GPT_HIDDEN, GPT_VOCAB
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    layer = Dense(k, n, use_bias=False).to(dev)
    rows = {}
    for data in ("positive", "signed"):
        draw = torch.rand if data == "positive" else torch.randn
        x = draw(m, k, generator=gen, device=dev)
        w = draw(n, k, generator=gen, device=dev) / k ** 0.5
        gy = draw(m, n, generator=gen, device=dev)
        with torch.no_grad():
            layer.weight.copy_(w)
        row = {}
        for p in (None, "highest"):
            layer.precision = p
            layer.weight.grad = None
            xg = x.clone().requires_grad_()
            y = layer(xg)
            y.backward(gy)
            torch.cuda.synchronize()
            check((torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32) == flags,
                  f"the TF32 flags are as they were after precision {p}")
            row[p or "default"] = {
                "forward": tf32_ratio(y, x, w.T),
                "grad_input": tf32_ratio(xg.grad, gy, w),
                "grad_weight": tf32_ratio(layer.weight.grad, gy.T, x)}
            del y, xg
        row["bf16_control_forward"] = tf32_ratio(
            (x.bfloat16() @ w.bfloat16().T).float(), x, w.T)
        rows[data] = row
        del x, w, gy
    c = {"forward": tf32_product_c(k), "grad_input": tf32_product_c(n),
         "grad_weight": tf32_product_c(m)}
    for data, row in rows.items():
        for what, limit in c.items():
            check(row["default"][what] <= limit, f"{data} {what} at DEFAULT "
                  f"({row['default'][what]}) within c = {limit}")
    check(rows["positive"]["bf16_control_forward"] > c["forward"],
          f"the bf16 control ({rows['positive']['bf16_control_forward']}) "
          f"fails the forward's bound c = {c['forward']}")
    check(rows["positive"]["default"]["forward"]
          > 4 * rows["positive"]["highest"]["forward"],
          "the DEFAULT forward carries TF32's error, not fp32's: "
          f"{rows['positive']}")
    x = torch.randn(m, k, generator=gen, device=dev)
    gy = torch.randn(m, n, generator=gen, device=dev)
    ms = {}
    for p in (None, "highest", None, "highest"):
        layer.precision = p
        xg = x.clone().requires_grad_()

        def fwd_bwd():
            layer(xg).backward(gy)
        key = p or "default"
        ms.setdefault(f"{key}_forward_ms", []).append(
            event_ms(lambda: layer(x), reps=10))
        ms.setdefault(f"{key}_forward_backward_ms", []).append(
            event_ms(fwd_bwd, reps=10))
    layer.precision = None
    flops = 2 * m * k * n
    emit({"phase": "precision", "shape": {"tokens": m, "hidden": k,
                                          "vocab": n},
          "ratio_units": "max |y - float64| / (2^-11 |a| |b|)",
          "c": c, "ratios": rows, "ms": ms,
          "default_forward_tflops": flops / min(ms["default_forward_ms"])
          / 1e9,
          "highest_forward_tflops": flops / min(ms["highest_forward_ms"])
          / 1e9,
          "flags_unchanged": True,
          "note": "c = 4 + 2^-9 + (k + 1) 2^-13: each operand rounded to "
                  "TF32 (truncated at worst), k fp32 additions in any "
                  "order; positive inputs make the bound tight, where the "
                  "bf16 control's rounding of its output (up to 8 units) "
                  "must exceed it; ms: CUDA events, median of 10, DEFAULT "
                  "and highest in turns"})
    return ms


def flash_work(bh, lq, lk, d, itemsize, causal=True, bh_kv=None):
    """Operations and bytes of each kernel, counting the visible (query,
    key) pairs only (all of them when not causal) and each input and output
    once; ``bh_kv`` the forward's narrow K/V rows under grouped-query
    attention (the backward kernels take them repeated to ``bh``)."""
    if causal:
        pairs = bh * sum(min(lk, max(0, i + lk - lq + 1)) for i in range(lq))
    else:
        pairs = bh * lq * lk
    t_q, t_k = bh * lq * d * itemsize, bh * lk * d * itemsize
    t_kv = (bh if bh_kv is None else bh_kv) * lk * d * itemsize
    row = bh * lq * 4                       # an fp32 value per query row
    return {"flash_fwd": (4 * d * pairs, t_q + 2 * t_kv + t_q + row),
            "flash_bwd_dq": (6 * d * pairs, 2 * t_q + 2 * t_k + 2 * row
                             + t_q),
            "flash_bwd_dkv": (8 * d * pairs, 2 * t_q + 2 * t_k + 2 * row
                              + 2 * t_k)}


def flash_timing(torch, dev, seed, b, h, kvh, L, d, causal):
    """Each flash kernel alone at (B, H over KVH, L, D), bf16, launched
    directly (no wrapper's host work between launches, which at BERT's
    short rows outlasts the kernel): the forward on the narrow K/V, the
    backward kernels on K/V repeated to the query heads, as the path calls
    them;
    their plain versions; scaled_dot_product_attention (enable_gqa where
    KVH < H), forward and backward alone, for timing only. Rows with the
    bound, and SDPA's times."""
    from horovod_tpu_torch.ops.kernels import flash_attention as fa
    bh, sm, dt = b * h, d ** -0.5, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(bh, L, d, generator=gen, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(b * kvh, L, d, generator=gen, device=dev).to(dt)
            for _ in range(2))
    heads = (h, kvh) if kvh != h else (None, None)
    o, lse = fa.fa_forward(q, k, v, causal, sm, None, None, *heads)
    km, vm = ((fa.gqa_repeat3(t, b, kvh, h // kvh).contiguous()
               for t in (k, v)) if kvh != h else (k, v))
    delta = (do.float() * o.float()).sum(-1)
    dq, dk, dv = (torch.empty_like(t) for t in (q, km, vm))
    ptrs = (q.data_ptr(), km.data_ptr(), vm.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    common = (L, d, 0, L, int(causal), sm, 2)
    groups = (h, kvh) if kvh != h else (1, 1)
    ms = {
        "flash_fwd": event_ms(lambda: fa._launch(
            "hvd_flash_fwd", dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), bh, L, *common[:5], sm, *groups,
            2),
            reps=20, inner=5),
        "flash_bwd_dq": event_ms(lambda: fa._launch(
            "hvd_flash_bwd_dq", dev, *ptrs, dq.data_ptr(), bh, L, *common),
            reps=20, inner=5),
        "flash_bwd_dkv": event_ms(lambda: fa._launch(
            "hvd_flash_bwd_dkv", dev, *ptrs, dk.data_ptr(), dv.data_ptr(),
            bh, L, *common), reps=20, inner=5),
    }
    plain_fwd = event_ms(lambda: fa.block_fwd_reference(q, km, vm, causal,
                                                        sm), reps=10)
    plain_bwd = event_ms(lambda: fa.block_bwd_reference(
        q, km, vm, o, lse, do, causal, sm), reps=10)
    q4 = q.view(b, h, L, d).detach().requires_grad_()
    k4, v4 = (t.view(b, kvh, L, d).detach().requires_grad_() for t in (k, v))
    gqa = {"enable_gqa": True} if kvh != h else {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd = event_ms(lambda: sdpa(q4, k4, v4, is_causal=causal, **gqa),
                        reps=20, inner=5)
    out4 = sdpa(q4, k4, v4, is_causal=causal, **gqa)
    do4 = do.view(b, h, L, d)
    sdpa_bwd = event_ms(lambda: torch.autograd.grad(
        out4, (q4, k4, v4), do4, retain_graph=True), reps=20, inner=5)
    work = flash_work(bh, L, L, d, 2, causal, b * kvh)
    rows = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        rows[name] = {
            "ms": ms[name], "flops": flops, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "plain_ms": plain_fwd if name == "flash_fwd" else plain_bwd,
            "library_ms": sdpa_fwd if name == "flash_fwd" else sdpa_bwd,
            "tflops": flops / ms[name] / 1e9,
            "bound_share": 1e3 * max(t_ops, t_bytes) / ms[name]}
        if name != "flash_fwd":
            rows[name]["plain_and_library_cover"] = (
                "dq, dk and dv in one call, the same time for flash_bwd_dq "
                "and flash_bwd_dkv")
    shape = {"BH": bh, "L": L, "D": d, "dtype": "bfloat16", "causal": causal}
    if kvh != h:
        shape.update(heads=h, kv_heads=kvh, BH_kv=b * kvh)
    return rows, {"shape": shape, "sdpa_fwd_ms": sdpa_fwd,
                  "sdpa_bwd_ms": sdpa_bwd,
                  "sdpa_fwd_bwd_ms": sdpa_fwd + sdpa_bwd,
                  "sdpa_fwd_tflops": work["flash_fwd"][0] / sdpa_fwd / 1e9,
                  "sdpa_bwd_tflops": (work["flash_bwd_dq"][0]
                                      + work["flash_bwd_dkv"][0])
                  / sdpa_bwd / 1e9}


def phase_timing_flash(torch, dev, seed):
    """The flash kernels timed at the GPT main path's shape (the kernels
    line's rows), then at the BERT, LLaMA and ViT paths' shapes."""
    d = MAIN_FLASH_CASE[4]
    rows, main = flash_timing(torch, dev, seed + 5, GPT_BATCH, GPT_HEADS,
                              GPT_HEADS, GPT_SEQ, d, True)
    paths = {}
    for path, (b, case) in (("bert", (BERT_BATCH, BERT_FLASH_CASE)),
                            ("llama", (LLAMA_BATCH, LLAMA_FLASH_CASE)),
                            ("vit", (VIT_BATCH, VIT_FLASH_CASE))):
        _, bh, L, _, d, causal, _, h, kvh = case
        h = h or bh // b
        path_rows, extra = flash_timing(torch, dev, seed + 5, b, h,
                                        kvh or h, L, d, causal)
        paths[path] = {**extra, "kernels": path_rows}
    emit({"phase": "timing_flash", **main, "kernels": rows, "paths": paths,
          "note": "ms: CUDA events, median of 20 runs of 5 back-to-back "
                  "launches, each kernel launched directly; tflops: the "
                  "visible pairs' "
                  "operations over ms; bound_share: bound_ms / ms; "
                  "plain_ms of both backward "
                  "kernels is the plain backward, which computes dq, dk and "
                  "dv together; library: scaled_dot_product_attention "
                  "(is_causal as the path; enable_gqa for LLaMA's grouped "
                  "K/V) forward, and its backward alone, timed here only; "
                  "ViT: L = 196, non-causal, the last key tile ragged"})
    return rows, paths


def path_shapes(torch):
    """The parameter shapes of the BERT, LLaMA and ViT paths' models, from
    copies on the meta device (no memory, no weights)."""
    from horovod_tpu_torch.models import BertForPreTraining, Llama, ViT
    with torch.device("meta"):
        models = {"bert_large": BertForPreTraining(bert_config(torch, True)),
                  "llama_400m": Llama(llama_config(torch, True)),
                  "vit_b16": ViT(vit_config(torch, True))}
    return {name: [tuple(p.shape) for p in m.parameters()]
            for name, m in models.items()}


# ---------------------------------------------------------------------------
# The launcher and the cycle thread: launch, launch_cpu_world, cycle.
# ---------------------------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parent
CONTRACT = ("HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
            "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE")
LAUNCH_TIMEOUT = 420                # seconds, the launched GPT worker's run
CPU_WORLD_TENSORS = 24
CYCLE_REPEATS, CYCLE_STEPS = 3, 5
CYCLE_ORDER = (0.0, 1.0, 1.0, 0.0)  # ms, in turns: host speed drifts


def start_launcher(args, np_, kind, launcher=None, worker=()):
    """``python -m horovod_tpu_torch.runner -np np_ -H localhost:np_
    --cycle-time-ms 1`` (``launcher`` in place of ``-np``/``-H``: the
    elastic flags) on this script's ``--launched-worker kind`` with
    ``worker``'s extra arguments, in a session of its own."""
    cmd = [sys.executable, "-m", "horovod_tpu_torch.runner",
           *(launcher or ["-np", str(np_), "-H", f"localhost:{np_}"]),
           "--cycle-time-ms", "1", "--start-timeout", "120", sys.executable,
           str(ROOT / "chip_smoke.py"), "--launched-worker", kind,
           "--seed", str(args.seed), "--warmup", str(args.warmup),
           "--batch", str(args.batch), *worker]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)


def finish_launcher(proc, timeout, kind):
    """Wait for a :func:`start_launcher` process, killing its session whole
    past ``timeout``. Returns the exit code, the workers' JSON lines (the
    launcher prefixes each with its tag and ``<stdout>``) and the tail of
    the output."""
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise RuntimeError(f"chip_smoke check failed: hvdrun-torch ({kind}) "
                           f"ran past {timeout} s:\n{out[-4000:]}")
    lines = [json.loads(line[line.index("{"):]) for line in out.splitlines()
             if '{"phase": "launched_worker"' in line]
    return proc.returncode, lines, out[-4000:]


def run_launcher(args, np_, kind, timeout, launcher=None):
    return finish_launcher(start_launcher(args, np_, kind, launcher),
                           timeout, kind)


def gone(pid, wait_s=10.0):
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.1)
    return False


def launched_worker(args):
    """``--launched-worker``: this script as a process hvdrun-torch
    started. ``gpt``: hvd.init() on the card, GPT-2 small trained as in
    train_gpt (the same checks) with the cycle timer on; ``fail``:
    hvd.init(), then exit 1; ``cpu_world``: hvd.init(device="cpu") and
    jittered async allreduces."""
    import torch
    import torch.nn.functional as F

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    kind = args.launched_worker
    if kind == "cpu_world":
        return cpu_world_worker(torch, hvd, args)
    if kind == "elastic":
        return elastic_launched_worker(torch, hvd, args)
    if kind == "elastic_cpu":
        return elastic_cpu_worker(torch, hvd, args)
    hvd.init()
    contract = {k: os.environ[k] for k in CONTRACT}
    if kind == "fail":
        emit({"phase": "launched_worker", "kind": kind, "pid": os.getpid(),
              "contract": contract})
        sys.exit(1)
    dev = hvd.device()
    check(dev == torch.device("cuda", hvd.local_rank()),
          f"the launched worker runs on cuda:<local_rank>, got {dev}")
    model = build_gpt(torch, dev, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    ids = torch.randint(0, model.config.vocab_size, (GPT_BATCH, GPT_SEQ),
                        generator=gen, device=dev)
    _, run = train_steps(torch, hvd, model,
                         lambda: next_token_loss(F, model(ids), ids), args,
                         GPT_STEPS, (model.config.num_layers,) * 3, lr=1e-4)
    elapsed = run.pop("elapsed")
    emit({"phase": "launched_worker", "kind": kind, "pid": os.getpid(),
          "contract": contract, "device": str(dev),
          "cycle_time_ms": get_runtime()._cycle_s * 1e3,
          "tokens_per_sec": GPT_BATCH * GPT_SEQ * GPT_STEPS / elapsed,
          **run})
    hvd.shutdown()
    return 0


def cpu_world_worker(torch, hvd, args):
    """One rank of a 2-process gloo world: CPU_WORLD_TENSORS async
    allreduces, each after a seeded sleep (rank 1 up to 8 cycles, rank 0
    up to 4), then their values and the buckets this rank formed."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    hvd.init(device="cpu")
    rank, rt = hvd.rank(), get_runtime()
    delays = random.Random(args.seed + rank)
    mark = rt.flush_stats()
    handles = []
    for i in range(CPU_WORLD_TENSORS):
        time.sleep(delays.uniform(0.0, 0.008 if rank == 1 else 0.004))
        dt = (torch.float32, torch.bfloat16)[i % 2]
        handles.append(hvd.allreduce_async(
            torch.full((3 + 7 * i,), float(rank + 1), dtype=dt),
            op=hvd.Sum, name=f"cpu_world.{i}"))
    values_ok = all(torch.equal(h.synchronize().float(),
                                torch.full((3 + 7 * i,), 3.0))
                    for i, h in enumerate(handles))
    closed, row = buckets_since(mark)
    emit({"phase": "launched_worker", "kind": "cpu_world", "rank": rank,
          "contract": {k: os.environ[k] for k in CONTRACT},
          "backend": "gloo" if hvd.gloo_enabled() else "nccl",
          "buckets": [[why, sig[4], [n for _, n in sig[-1]]]
                      for why, sig in closed],
          "buckets_timer_new_signatures": row, "values_ok": values_ok})
    hvd.shutdown()
    return 0


def phase_launch(torch, args, card):
    """The port's launcher on the card: ``-np 1`` on the GPT worker, and a
    worker that exits 1 as the control. Returns the worker's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    rc, lines, log = run_launcher(args, 1, "gpt", LAUNCH_TIMEOUT)
    check(rc == 0 and len(lines) == 1,
          f"the launched GPT-2 small worker exits 0 (rc {rc}):\n{log}")
    w = lines[0]
    check(w["contract"] == dict(zip(CONTRACT, "010101")),
          f"the worker got the launcher's 1-slot contract: {w['contract']}")
    check(w["device"] == "cuda:0", f"the worker ran on cuda:0: {w['device']}")
    check(all(w["launches"][k] > 0 for k in STEP_COUNTS),
          f"the worker launched every flash and both scale kernels: "
          f"{w['launches']}")
    timer = sum(r[1] for r in w["buckets_timer_new_signatures_per_step"])
    check(timer > 0, f"the cycle timer closed buckets in the worker: "
          f"{w['buckets_timer_new_signatures_per_step']}")
    check(w["losses"][-1] < w["losses"][0] and w[
          "reduced_equals_local_bitwise"], f"the worker's loss falls and its "
          f"reduced gradients equal the local ones: {w['losses']}")
    frc, flines, flog = run_launcher(args, 1, "fail", 180)
    check(frc == 1 and len(flines) == 1 and gone(flines[0]["pid"]),
          f"control: a worker that exits 1 fails the launch with 1 and is "
          f"reaped (rc {frc}):\n{flog}")
    emit({"phase": "launch", "command": "python -m horovod_tpu_torch.runner "
          "-np 1 -H localhost:1 --cycle-time-ms 1 python chip_smoke.py "
          "--launched-worker gpt", "worker": w,
          "timer_closed_buckets": timer,
          "control_fail": {"rc": frc, "worker_reaped": True},
          "card": card})
    return w["launches"]


def phase_launch_cpu_world(args):
    """``-np 2`` through the launcher with workers on the CPU (gloo): NCCL
    refuses two ranks on one card, so this holds the per-slot env and the
    boundary protocol on this machine's Python and torch, not two GPUs."""
    rc, lines, log = run_launcher(args, 2, "cpu_world", 180)
    check(rc == 0 and len(lines) == 2, f"the 2-process CPU world exits 0 "
          f"(rc {rc}):\n{log}")
    by_rank = {w["rank"]: w for w in lines}
    check(sorted(by_rank) == [0, 1] and all(
        w["contract"] == dict(zip(CONTRACT, (str(r), "2", str(r), "2", "0",
                                             "1")))
        for r, w in by_rank.items()),
          f"each slot got its own contract: {[w['contract'] for w in lines]}")
    check(by_rank[0]["buckets"] == by_rank[1]["buckets"],
          "both ranks formed the same buckets")
    check(by_rank[0]["buckets_timer_new_signatures"][1] > 0,
          f"rank 0's timer closed buckets: {by_rank[0]['buckets']}")
    check(all(w["values_ok"] and w["backend"] == "gloo" for w in lines),
          "every value is the sum over the two ranks, over gloo")
    emit({"phase": "launch_cpu_world", "run_on": "CPU (gloo), not the card",
          "ranks": 2, "tensors": CPU_WORLD_TENSORS,
          "buckets": by_rank[0]["buckets"],
          "buckets_timer_new_signatures": by_rank[0][
              "buckets_timer_new_signatures"],
          "same_buckets_on_both_ranks": True})


def phase_cycle(torch, hvd, dev, args, card):
    """GPT-2 small and ResNet-50, in this process, at HOROVOD_CYCLE_TIME 0
    and 1 ms (the runtime's cycle set between runs, in the turns of
    CYCLE_ORDER): buckets a step, buckets the timer closed, new signatures
    a step, tokens/s or images/s as the median of CYCLE_REPEATS repeats of
    CYCLE_STEPS steps in each turn, and the device's busy ms a step and
    busy share (torch.profiler, 2 steps). Printed, not checked."""
    import torch.nn.functional as F

    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.fusion import get_runtime

    rt = get_runtime()
    cycle0 = rt._cycle_s * 1e3
    rows = []
    for name in ("gpt2_small", "resnet50"):
        gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
        if name == "gpt2_small":
            model = build_gpt(torch, dev, args.seed + 31)
            ids = torch.randint(0, model.config.vocab_size,
                                (GPT_BATCH, GPT_SEQ), generator=gen,
                                device=dev)
            opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                    weight_decay=1e-4)
            units, unit = GPT_BATCH * GPT_SEQ, "tokens_per_sec"

            def loss():
                return next_token_loss(F, model(ids), ids)
        else:
            model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(
                                 args.seed + 31)).to(dev).train()
            x = torch.randn((args.batch, 224, 224, 3), generator=gen,
                            device=dev)
            y = torch.randint(0, 1000, (args.batch,), generator=gen,
                              device=dev)
            opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
            units, unit = args.batch, "images_per_sec"

            def loss():
                return F.cross_entropy(model(x), y)
        opt = hvd.DistributedOptimizer(
            opt, named_parameters=model.named_parameters())

        def step():
            opt.zero_grad()
            loss().backward()
            opt.step()

        by_ms = {ms: {"per": [], "rates": [], "busy": []}
                 for ms in CYCLE_ORDER}
        for ms in CYCLE_ORDER:
            rt.set_cycle_time_ms(ms)
            for _ in range(args.warmup):
                step()
            got = by_ms[ms]
            for _ in range(CYCLE_REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CYCLE_STEPS):
                    m0 = rt.flush_stats()
                    step()
                    got["per"].append(buckets_since(m0)[1])
                torch.cuda.synchronize()
                got["rates"].append(units * CYCLE_STEPS
                                    / (time.perf_counter() - t0))
            got["busy"].append(device_ms(torch, step))
        for ms, got in by_ms.items():
            per = got["per"]
            rows.append({
                "model": name, "cycle_time_ms": ms,
                "buckets_per_step": statistics.mean(r[0] for r in per),
                "timer_closed_per_step": statistics.mean(r[1] for r in per),
                "new_signatures_per_step": statistics.mean(r[2] for r in per),
                "buckets_timer_new_signatures_per_step": per,
                unit: statistics.median(got["rates"]),
                f"{unit}_repeats": got["rates"],
                "device_busy_ms_per_step": [b for b, _ in got["busy"]],
                "device_busy_share": [s for _, s in got["busy"]]})
        opt._remove_hooks()
        del model, opt
        gc.collect()
    rt.set_cycle_time_ms(cycle0)
    emit({"phase": "cycle", "rows": rows, "order_ms": CYCLE_ORDER,
          "repeats_per_turn": CYCLE_REPEATS, "steps_per_repeat": CYCLE_STEPS,
          "checked": False, "card": card})
    return rows



# ---------------------------------------------------------------------------
# Elastic: ResNet-50 under hvd.elastic.run, a fault, and the membership
# changes through the launcher.
# ---------------------------------------------------------------------------

ELASTIC_STEPS, ELASTIC_FAULT = 8, 4   # the fault at step 4, after its update
ELASTIC_TURNS = (False, True, True, False)   # commit each step: off/on turns
ELASTIC_REPEATS, ELASTIC_REPEAT_STEPS = 2, 5
ELASTIC_LAUNCH_TIMEOUT = 300
ELASTIC_CPU_SCENARIOS = ("kill", "remove", "add")


def elastic_model(torch, hvd, dev, args):
    """phase train's configuration: ResNet-50 from --seed, SGD(lr=0.1,
    momentum=0.9) in hvd.DistributedOptimizer, a fixed batch."""
    from horovod_tpu_torch.models import ResNet50
    model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(args.seed))
    model = model.to(dev).train()
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9),
        named_parameters=model.named_parameters())
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
    y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)

    def step():
        import torch.nn.functional as F
        opt.zero_grad()
        loss = F.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        return loss.detach()
    return model, opt, step


def state_tensors(model_state, opt_state):
    """A model's and an optimizer's state_dict tensors, in one order."""
    per_param = [opt_state["state"][i] for i in sorted(opt_state["state"])]
    return list(model_state.values()) + [
        v for s in per_param for _, v in sorted(s.items())
        if hasattr(v, "data_ptr")]


def all_equal(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@contextlib.contextmanager
def deterministic_cudnn(torch):
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = saved


def elastic_resnet(torch, hvd, dev, args):
    """ResNet-50 under hvd.elastic.run with TorchState(model, optimizer,
    step) committed after every step; at step ELASTIC_FAULT, after the
    optimizer step and before the commit, the training function raises
    HorovodInternalError, as a failed collective does. Timed by wrapping
    basics.shutdown/init, the state's restore/sync and the wait for a new
    version. Returns the readings, the optimizer and the state."""
    import torch.distributed as dist

    from horovod_tpu_torch.elastic import worker
    from horovod_tpu_torch.common import basics
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.ops.kernels import scale_buffers as sb

    model, opt, step = elastic_model(torch, hvd, dev, args)
    state = attach_listener(hvd.TorchState(model, opt, step=0))
    spans, per_step, losses, commit_ms, seen = {}, [], {}, [], {}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                spans.setdefault(name, []).append(
                    (t0, time.perf_counter()))
        return call

    raw = (basics.shutdown, basics.init, worker.wait_for_version_change)
    basics.shutdown = timed("shutdown", raw[0])
    basics.init = timed("init", raw[1])
    worker.wait_for_version_change = timed("wait", raw[2])
    state.restore = timed("restore", state.restore)
    state.sync = timed("sync", state.sync)

    def committed():
        return state_tensors(state._saved_model_state,
                             state._saved_optimizer_state)

    @hvd.elastic.run
    def train(state):
        if seen and "resumed" not in seen:
            seen["resumed"] = time.perf_counter()
            seen["restore_bit_equal"] = all_equal(
                torch, state_tensors(model.state_dict(), opt.state_dict()),
                committed())
            seen["group_replaced"] = \
                dist.distributed_c10d._get_default_group() is not seen["pg"]
            del seen["pg"]
        while state.step < ELASTIC_STEPS:
            c0 = (sb.pack_launches, sb.unpack_launches)
            loss = step()
            torch.cuda.synchronize()
            per_step.append([state.step, "resumed" in seen,
                             sb.pack_launches - c0[0],
                             sb.unpack_launches - c0[1]])
            if state.step == ELASTIC_FAULT and not seen:
                # The control: what the step changed is not in the commit.
                seen["uncommitted_differs"] = not all_equal(
                    torch, state_tensors(model.state_dict(),
                                         opt.state_dict()), committed())
                seen["pg"] = dist.distributed_c10d._get_default_group()
                seen["fault"] = time.perf_counter()
                raise hvd.HorovodInternalError(
                    f"chip_smoke: a failed collective at step {state.step}")
            if "resumed" in seen and "first_step" not in seen:
                seen["first_step"] = time.perf_counter()
            losses[state.step] = loss.item()
            state.step += 1
            t0 = time.perf_counter()
            state.commit()
            torch.cuda.synchronize()
            commit_ms.append(1e3 * (time.perf_counter() - t0))

    version0 = os.environ.get("HOROVOD_ELASTIC_INIT_VERSION")
    sb.reset_launch_counts()                     # the elastic path starts
    try:
        train(state)
    finally:
        basics.shutdown, basics.init, worker.wait_for_version_change = raw
    launches = {"scale_pack": sb.pack_launches,
                "scale_unpack": sb.unpack_launches}   # the path ends
    check("resumed" in seen, "the training function was entered again")
    first = {k: spans[k][0] for k in ("shutdown", "restore", "wait")}
    init, sync = spans["init"][-1], spans["sync"][-1]
    devices = {str(t.device) for t in state_tensors(model.state_dict(),
                                                    opt.state_dict())}
    st = basics._get_state()

    def ms(span):
        return 1e3 * (span[1] - span[0])
    return {
        "steps": ELASTIC_STEPS, "fault_step": ELASTIC_FAULT,
        "losses": [losses[i] for i in range(ELASTIC_STEPS)],
        "launches": launches,
        "launches_per_step": per_step,
        "launches_per_step_columns": ["step", "after_reset", "pack",
                                      "unpack"],
        "restore_bit_equal": seen["restore_bit_equal"],
        "uncommitted_differs": seen["uncommitted_differs"],
        "group_replaced": seen["group_replaced"],
        "inits": len(spans["init"]), "backend": st.backend,
        "device": str(hvd.device()), "state_devices": sorted(devices),
        "version_before": version0,
        "version_after": os.environ.get("HOROVOD_ELASTIC_INIT_VERSION"),
        "commit_ms": commit_ms,
        "commit_ms_median": statistics.median(commit_ms),
        "abort_ms": ms(first["shutdown"]), "restore_ms": ms(first["restore"]),
        "wait_for_version_s": first["wait"][1] - first["wait"][0],
        "init_ms": ms(init), "sync_ms": ms(sync),
        # abort/shutdown -> init -> sync, without the restore's copy and the
        # wait for a new version
        "reset_ms": ms(first["shutdown"]) + ms(init) + ms(sync),
        "fault_to_resume_s": seen["resumed"] - seen["fault"],
        "fault_to_first_step_s": seen["first_step"] - seen["fault"],
    }, opt, state, step


def check_elastic_run(run, where):
    check(run["restore_bit_equal"], f"{where}: after the restore every "
          "parameter, buffer and momentum equals the commit bit for bit")
    check(run["uncommitted_differs"], f"{where}: control: the uncommitted "
          "state of the fault step differs from the commit")
    check(run["group_replaced"] and run["inits"] == 1
          and run["backend"] == "nccl" and run["device"] == "cuda:0"
          and run["state_devices"] == ["cuda:0"],
          f"{where}: one re-init, a new NCCL group on cuda:0 and the state "
          f"on the card: {run['inits']} inits, {run['backend']} on "
          f"{run['device']}, state on {run['state_devices']}")
    before = [s for s in run["launches_per_step"] if not s[1]]
    after = [s for s in run["launches_per_step"] if s[1]]
    check(before and after and all(s[2] > 0 and s[3] > 0
                                   for s in before + after),
          f"{where}: pack and unpack launches in every step before and after "
          f"the reset: {run['launches_per_step']}")
    check(run["losses"][-1] < run["losses"][0] and all(
        map(math.isfinite, run["losses"])), f"{where}: finite, falling "
          f"loss: {run['losses']}")


def phase_train_elastic(torch, hvd, dev, args, card):
    """Elastic ResNet-50 in this process: the fault, the reset and its
    checks; the same steps without the fault from the same weights, held
    bit-equal (deterministic cuDNN); then images/s with and without a
    commit each step, in turns. Returns the path's launches."""
    from horovod_tpu_torch.ops.fusion import get_runtime
    gc.collect()
    torch.cuda.empty_cache()
    # What earlier phases left allocated: not this phase's.
    base = torch.cuda.memory_allocated()
    with deterministic_cudnn(torch):
        model, opt, step = elastic_model(torch, hvd, dev, args)
        for _ in range(ELASTIC_STEPS):
            step()
        reference = [t.clone() for t in state_tensors(model.state_dict(),
                                                      opt.state_dict())]
        opt._remove_hooks()
        del model, opt, step
        gc.collect()
        run, opt, state, step = elastic_resnet(torch, hvd, dev, args)
        resumed = state_tensors(state.model.state_dict(), opt.state_dict())
        same = [torch.equal(a, b) for a, b in zip(resumed, reference)]
        check(len(resumed) == len(reference) and all(same),
              f"the resumed run's weights equal the run without the fault "
              f"bit for bit: {same.count(False)} of {len(same)} tensors "
              f"differ")
    check_elastic_run(run, "train_elastic")
    del reference, resumed
    rates = {False: [], True: []}
    peak = {False: 0, True: 0}
    for commit in ELASTIC_TURNS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(ELASTIC_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ELASTIC_REPEAT_STEPS):
                step()
                if commit:
                    state.commit()
            torch.cuda.synchronize()
            rates[commit].append(args.batch * ELASTIC_REPEAT_STEPS
                                 / (time.perf_counter() - t0))
        peak[commit] = max(peak[commit], torch.cuda.max_memory_allocated())
    copy_bytes = sum(t.numel() * t.element_size() for t in state_tensors(
        state._saved_model_state, state._saved_optimizer_state))
    opt._remove_hooks()
    emit({"phase": "train_elastic", "model": "ResNet-50", "batch": args.batch,
          "optimizer": "SGD(lr=0.1, momentum=0.9)",
          "fusion_threshold": get_runtime().threshold,
          "deterministic_cudnn": True, **run,
          "resumed_equals_uninterrupted_bitwise": True,
          "images_per_sec_no_commit": statistics.median(rates[False]),
          "images_per_sec_commit_each_step": statistics.median(rates[True]),
          "images_per_sec_repeats": {"no_commit": rates[False],
                                     "commit_each_step": rates[True]},
          "turns": ["commit" if c else "no_commit" for c in ELASTIC_TURNS],
          "commit_copy_gb": copy_bytes / 1e9,
          "peak_mem_gb_commit_each_step": (peak[True] - base) / 1e9,
          "peak_mem_gb_no_commit": (peak[False] - base) / 1e9,
          "peak_mem_note": "above what earlier phases left allocated "
                           f"({base / 1e9:.3f} GB); the commit copy is "
                           "held in both", "card": card})
    del opt, state, step
    gc.collect()
    return run["launches"]


def elastic_launched_worker(torch, hvd, args):
    """``--launched-worker elastic``: hvd.init() on the card under the
    elastic driver, the ResNet-50 elastic loop and its fault."""
    hvd.init()
    contract = {k: os.environ[k] for k in CONTRACT}
    dev = hvd.device()
    check(dev == torch.device("cuda", hvd.local_rank()),
          f"the launched worker runs on cuda:<local_rank>, got {dev}")
    with deterministic_cudnn(torch):
        run, opt, state, _ = elastic_resnet(torch, hvd, dev, args)
    emit({"phase": "launched_worker", "kind": "elastic", "pid": os.getpid(),
          "contract": contract, **run})
    hvd.shutdown()
    return 0


def elastic_cpu_worker(torch, hvd, args):
    """``--launched-worker elastic_cpu``: one CPU (gloo) worker of
    --elastic-scenario, tests/test_elastic_failure.py's scenarios: ``kill``
    (the second host's rank drops it from discovery and dies at step 3 of
    6), ``remove`` (a graceful removal at step 3: the survivor keeps its
    pid and an uncommitted attribute) and ``add`` (discovery grows to two
    hosts at step 3 of 8)."""
    from horovod_tpu_torch.elastic import attach_listener
    from horovod_tpu_torch.elastic.worker import (configured_version,
                                                  wait_for_version_change)
    hvd.init(device="cpu")
    scenario, script = args.elastic_scenario, args.discovery_script
    total = 8 if scenario == "add" else 6
    n = 4 if scenario == "kill" else 2
    state = attach_listener(hvd.TorchState(w=torch.zeros(n), step=0, pid0=0,
                                           uncommitted=0, worlds=[]))

    def discover(*hosts):
        with open(script, "w") as f:
            f.write("#!/bin/sh\n" + "".join(f"echo {h}\n" for h in hosts))

    @hvd.elastic.run
    def loop(state):
        while state.step < total:
            if state.step == 3 and scenario == "kill" and hvd.size() == 2 \
                    and hvd.rank() == 1:
                discover("localhost:1")
                os._exit(1)
            if state.step == 3 and scenario == "remove" and \
                    hvd.size() == 2 and state.pid0 == 0:
                state.pid0 = os.getpid()
                state.commit()
                state.uncommitted = 7        # not committed
                known = configured_version()
                if hvd.rank() == 1:
                    discover("localhost:1")
                wait_for_version_change(known, timeout=120)
                state.check_host_updates()
            if state.step == 3 and scenario == "add" and hvd.size() == 1:
                known = configured_version()
                discover("localhost:1", "127.0.0.1:1")
                check(wait_for_version_change(known, timeout=120) != known,
                      "the driver published the grown membership")
            contrib = torch.ones(n) * (hvd.rank() + 1 if scenario == "kill"
                                       else 1)
            state.w = state.w + hvd.allreduce(contrib, op=hvd.Sum)
            state.step += 1
            state.worlds.append(hvd.size())
            state.commit()
        return {"steps": state.step, "w": state.w.tolist(),
                "worlds": list(state.worlds), "pid0": state.pid0,
                "uncommitted": state.uncommitted, "size": hvd.size(),
                "rank": hvd.rank(), "backend": "gloo" if hvd.gloo_enabled()
                else "nccl"}

    emit({"phase": "launched_worker", "kind": "elastic_cpu",
          "scenario": scenario, "pid": os.getpid(), **loop(state)})
    hvd.shutdown()
    return 0


def discovery_script(name, *hosts):
    """A discovery script under build/elastic/ (ignored by git)."""
    d = ROOT / "build" / "elastic" / name
    d.mkdir(parents=True, exist_ok=True)
    path = d / "discover.sh"
    path.write_text("#!/bin/sh\n" + "".join(f"echo {h}\n" for h in hosts))
    path.chmod(0o755)
    return path


def elastic_flags(script, max_np):
    return ["--min-np", "1", "--max-np", str(max_np),
            "--host-discovery-script", str(script)]


def phase_launch_elastic(torch, args, card):
    """``hvdrun-torch -np 1 --min-np 1 --max-np 1 --host-discovery-script``
    on this script as ``--launched-worker elastic``: the ResNet-50 elastic
    loop and its fault in a worker the elastic driver started. Returns the
    worker's launches."""
    gc.collect()
    torch.cuda.empty_cache()
    script = discovery_script("launch", "localhost:1")
    t0 = time.perf_counter()
    rc, lines, log = run_launcher(
        args, 1, "elastic", ELASTIC_LAUNCH_TIMEOUT,
        launcher=["-np", "1"] + elastic_flags(script, 1))
    seconds = time.perf_counter() - t0
    check(rc == 0 and len(lines) == 1,
          f"the elastic ResNet-50 worker exits 0 (rc {rc}):\n{log}")
    w = lines[0]
    check(w["contract"] == dict(zip(CONTRACT, "010101")),
          f"the worker got the 1-slot contract: {w['contract']}")
    check_elastic_run(w, "launch_elastic")
    check(w["version_before"] == w["version_after"] == "1",
          f"the re-init was at the unchanged version 1: "
          f"{w['version_before']} -> {w['version_after']}")
    check(gone(w["pid"]), "the worker was reaped")
    emit({"phase": "launch_elastic", "command": "python -m "
          "horovod_tpu_torch.runner -np 1 --min-np 1 --max-np 1 "
          "--host-discovery-script build/elastic/launch/discover.sh python "
          "chip_smoke.py --launched-worker elastic", "seconds": seconds,
          "wait_for_version_s": w["wait_for_version_s"],
          "wait_note": "JAX's semantics: after a failure a worker waits up "
                       "to 30 s for a new membership version, then re-inits "
                       "at the unchanged one",
          "worker": w, "worker_reaped": True, "card": card})
    return w["launches"]


def phase_launch_elastic_cpu_world(args):
    """The membership changes through the elastic launcher, with CPU
    (gloo) workers: NCCL refuses two ranks on one card. The three
    scenarios run at once, each held to tests/test_elastic_failure.py's
    expected values."""
    procs = {}
    for name in ELASTIC_CPU_SCENARIOS:
        hosts = ("localhost:1",) if name == "add" \
            else ("localhost:1", "127.0.0.1:1")
        script = discovery_script(name, *hosts)
        procs[name] = start_launcher(
            args, 1, "elastic_cpu", launcher=elastic_flags(script, 2),
            worker=["--elastic-scenario", name, "--discovery-script",
                    str(script)])
    got = {name: finish_launcher(proc, ELASTIC_LAUNCH_TIMEOUT, "elastic_cpu")
           for name, proc in procs.items()}
    for name, (rc, lines, log) in got.items():
        want = 2 if name == "add" else 1
        check(rc == 0 and len(lines) == want and all(
            w["backend"] == "gloo" for w in lines),
              f"{name}: the launch exits 0 with {want} gloo worker(s) "
              f"reporting (rc {rc}):\n{log}")
    kill = got["kill"][1][0]
    check(kill["steps"] == 6 and kill["size"] == 1 and kill["w"] == [12.0] * 4
          and kill["worlds"] == [2, 2, 2, 1, 1, 1],
          f"kill: w == [12] * 4 and worlds [2, 2, 2, 1, 1, 1]: {kill}")
    rem = got["remove"][1][0]
    check(rem["steps"] == 6 and rem["size"] == 1 and rem["pid0"] == rem["pid"]
          and rem["uncommitted"] == 7 and rem["w"] == [9.0, 9.0]
          and rem["worlds"] == [2, 2, 2, 1, 1, 1],
          f"remove: the survivor keeps its pid and uncommitted state: {rem}")
    add = sorted(got["add"][1], key=lambda w: w["rank"])
    w0 = add[0]
    check([w["rank"] for w in add] == [0, 1] and all(
        w["steps"] == 8 and w["size"] == 2 and w["w"] == w0["w"]
        for w in add) and w0["worlds"][0] == 1 and w0["worlds"][-1] == 2
          and w0["worlds"].count(1) + 2 * w0["worlds"].count(2)
          == w0["w"][0], f"add: scaled up in place: {add}")
    emit({"phase": "launch_elastic_cpu_world",
          "run_on": "CPU (gloo), not the card",
          "scenarios": {name: lines for name, (_, lines, _) in got.items()}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--launched-worker",
                    choices=("gpt", "fail", "cpu_world", "elastic",
                             "elastic_cpu"),
                    help="run as a worker that hvdrun-torch started (the "
                         "launch phases)")
    ap.add_argument("--elastic-scenario", choices=ELASTIC_CPU_SCENARIOS,
                    help="--launched-worker elastic_cpu's scenario")
    ap.add_argument("--discovery-script",
                    help="--launched-worker elastic_cpu's discovery script, "
                         "which the scenario rewrites")
    args = ap.parse_args(argv)
    check(args.warmup >= 1 and args.steps >= 1, "--warmup and --steps >= 1")
    if args.launched_worker:
        return launched_worker(args)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ResNet50

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    seconds = {}

    def run(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    def resnet50():
        m = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(args.seed))
        return m.to(dev).train()

    card = run("env", phase_env, torch)
    run("build", phase_build)
    model = resnet50()
    gpt = build_gpt(torch, dev, args.seed)
    shapes = {name: [tuple(p.shape) for p in m.parameters()]
              for name, m in (("resnet50", model), ("gpt2_small", gpt))}
    shapes.update(path_shapes(torch))
    max_err = run("kernel_vs_plain", phase_kernel_vs_plain, torch, shapes,
                  dev, args.seed)
    launches, buckets = run("train", phase_train, torch, hvd, model, dev,
                            args, card)
    check(launches["scale_pack"] > 0 and launches["scale_unpack"] > 0,
          f"the main path launched both kernels: {launches}")
    total = run("timing", phase_timing, torch, buckets, dev, args.seed)
    del model
    flash_err, path_err = run("flash_vs_plain", phase_flash_vs_plain, torch,
                              dev, args.seed)
    gpt, ids, gpt_launches = run("train_gpt", phase_train_gpt, torch, hvd,
                                 gpt, dev, args, card)
    check(all(gpt_launches[k] > 0 for k in FLASH_REPLACES),
          f"the GPT path launched every flash kernel: {gpt_launches}")
    run("gpt_flash_vs_plain", phase_flash_vs_plain_model, torch, gpt, ids,
        dev)
    del gpt
    run("precision", phase_precision, torch, dev, args.seed)
    bert, batch, bert_launches = run("train_bert", phase_train_bert, torch,
                                     hvd, dev, args, card)
    run("bert_flash_vs_plain", phase_bert_flash_vs_plain, torch, bert, batch,
        dev)
    del bert, batch
    gc.collect()
    llama_state, ids, llama_launches = run("train_llama", phase_train_llama,
                                           torch, hvd, dev, args, card)
    run("llama_flash_vs_plain", phase_llama_flash_vs_plain, torch,
        llama_state, ids, dev)
    del llama_state, ids
    gc.collect()
    vit_state, vit_batch, vit_launches = run("train_vit", phase_train_vit,
                                             torch, hvd, dev, args, card)
    run("vit_flash_vs_plain", phase_vit_flash_vs_plain, torch, vit_state,
        vit_batch, dev)
    del vit_state, vit_batch
    gc.collect()
    coll_launches = run("collectives", phase_collectives, torch, hvd, dev)
    check(coll_launches["scale_pack"] > 0 and coll_launches["scale_unpack"]
          > 0, f"the collectives path launched both scale kernels: "
          f"{coll_launches}")
    launch_launches = run("launch", phase_launch, torch, args, card)
    run("launch_cpu_world", phase_launch_cpu_world, args)
    by_path = {"train_gpt": gpt_launches, "train_bert": bert_launches,
               "train_llama": llama_launches, "train_vit": vit_launches,
               "launch": launch_launches}
    check(all(n[k] > 0 for n in by_path.values() for k in STEP_COUNTS),
          f"every transformer path launched every flash and scale kernel: "
          f"{by_path}")
    flash_rows, flash_paths = run("timing_flash", phase_timing_flash, torch,
                                  dev, args.seed)
    adasum_err = run("adasum_vs_plain", phase_adasum_vs_plain, torch,
                     shapes["resnet50"], dev, args.seed)
    model = resnet50()
    ada_launches, ada_buckets = run("train_adasum", phase_train_adasum,
                                    torch, hvd, model, dev, args, card)
    check(ada_launches["scale_pack"] > 0 and ada_launches["scale_unpack"] > 0
          and ada_launches["adasum_combine"] == 0,
          f"the Adasum path launched both scale kernels and, on one rank, "
          f"no combine: {ada_launches}")
    gathered_launches, gathered_err = run(
        "adasum_gathered", phase_adasum_gathered, torch, model, ada_buckets,
        dev, args)
    check(gathered_launches > 0, "reduce_gathered launched the combine")
    ada_total = run("timing_adasum", phase_timing_adasum, torch, ada_buckets,
                    dev, args.seed)
    del model
    gc.collect()
    run("cycle", phase_cycle, torch, hvd, dev, args, card)
    elastic_launches = run("train_elastic", phase_train_elastic, torch, hvd,
                           dev, args, card)
    launch_elastic_launches = run("launch_elastic", phase_launch_elastic,
                                  torch, args, card)
    run("launch_elastic_cpu_world", phase_launch_elastic_cpu_world, args)
    hvd.shutdown()
    emit({"phase": "seconds", **seconds})
    source = "horovod_tpu_torch/ops/kernels/csrc/scale_buffers.cu"
    transformer_paths = ("train_gpt", "train_bert", "train_llama",
                         "train_vit", "launch")
    replaces = "horovod_tpu/ops/pallas/kernels.py:43"
    by_path.update(train=launches, train_adasum=ada_launches,
                   collectives=coll_launches, train_elastic=elastic_launches,
                   launch_elastic=launch_elastic_launches)
    scale_paths = ("train", "train_gpt", "train_bert", "train_llama",
                   "train_vit", "launch", "train_adasum", "collectives",
                   "train_elastic", "launch_elastic")
    kernels = [
        {"name": f"scale_{kind}", "route": "cuda", "source": source,
         "replaces": replaces,
         "launches": sum(by_path[p][f"scale_{kind}"] for p in scale_paths),
         "launches_by_path": {p: by_path[p][f"scale_{kind}"]
                              for p in scale_paths},
         "checked_vs_plain": True, "max_abs_err": max_err,
         "ms": total[f"{kind}_ms"],
         "wrapper_ms": total[f"{kind}_wrapper_ms"],
         "plain_ms": total[f"{kind}_plain_ms"],
         "bound_ms": total["bound_ms"], "bound_by": "bytes",
         "library_ms": total[f"{kind}_library_ms"]}
        for kind in ("pack", "unpack")]
    kernels += [
        {"name": name, "route": "cuda", "source": FLASH_SOURCE,
         "replaces": FLASH_REPLACES[name],
         "launches": sum(by_path[p][name] for p in transformer_paths),
         "launches_by_path": {p: by_path[p][name]
                              for p in transformer_paths},
         **({"status": REDESIGNED[name]} if name in REDESIGNED else {}),
         "checked_vs_plain": True, "max_abs_err": flash_err[name],
         "max_abs_err_by_path": {p: e[name] for p, e in path_err.items()},
         "ms": row["ms"], "plain_ms": row["plain_ms"],
         "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
         "library_ms": row["library_ms"],
         **({"plain_and_library_cover": row["plain_and_library_cover"]}
            if "plain_and_library_cover" in row else {}),
         "times_note": "ms, plain_ms, bound_ms and library_ms at the GPT "
                       "path's shape; by_path: the BERT, LLaMA and ViT "
                       "shapes",
         "by_path": {p: {k: r["kernels"][name][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
             for p, r in flash_paths.items()}}
        for name, row in flash_rows.items()]
    kernels.append(
        {"name": "adasum_combine", "route": "cuda", "source": ADASUM_SOURCE,
         "replaces": ADASUM_REPLACES, "launches": gathered_launches,
         "launches_by_path": {"train_adasum": ada_launches["adasum_combine"],
                              "adasum_gathered": gathered_launches},
         "status": "redesigned: one cooperative launch per tree level, a "
                   "and b read once; a streaming route (two launches) for "
                   "a tensor past a round",
         "checked_vs_plain": True,
         "max_abs_err": max(adasum_err, gathered_err),
         "ms": ada_total["ms"], "wrapper_ms": ada_total["wrapper_ms"],
         "plain_ms": ada_total["plain_ms"], "bound_ms": ada_total["bound_ms"],
         "bound_share": ada_total["bound_share"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no single PyTorch call computes this combine",
         "note": "train_adasum runs one rank, a tree of one leaf: no "
                 "combine; adasum_gathered drives reduce_gathered, the "
                 "route's post-gather function, on the path's buckets"})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
