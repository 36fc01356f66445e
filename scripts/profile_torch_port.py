#!/usr/bin/env python3
"""Profile one of the PyTorch port's data-parallel training steps, or one
of its decodes, on one GPU.

    python3 scripts/profile_torch_port.py
        [--model resnet50|gpt|bert|llama|vit] [--remat]
        [--op average|adasum] [--decode cached|reforward]
        [--seed 0] [--batch N] [--seq L] [--steps 10] [--repeats 5]
        [--profile-steps 3] [--root DIR]

The steps are chip_smoke.py's, on cuda:0 after hvd.init():

- ``resnet50`` (default batch 64): ResNet-50, bf16 activations, fp32
  parameters, a fixed synthetic batch, SGD(lr=0.1, momentum=0.9) in
  hvd.DistributedOptimizer; ``--op adasum`` reduces with op=hvd.Adasum
  (chip_smoke.py's train_adasum: each bucket is packed, all-gathered,
  combined by the Adasum tree, which on one rank has one leaf and runs no
  combine, and unpacked);
- ``gpt`` (default batch 8): GPT-2 small at full width, sequence 1024, bf16
  activations, fp32 parameters, the flash-attention kernels, next-token
  loss, AdamW(lr=1e-4, weight_decay=1e-4) in hvd.DistributedOptimizer;
- ``bert`` (default batch 32, sequence 128): BERT-Large MLM + NSP, bf16,
  flash (non-causal), no padding mask, dropout off, random MLM and NSP
  labels, AdamW(lr=1e-5, weight_decay=1e-4);
- ``llama`` (default batch 8, sequence 1024): LLaMA-400M (bench.py's
  config), bf16, flash with 16 query heads over 8 kv heads, next-token
  loss, AdamW(lr=1e-4, weight_decay=1e-4);
- ``vit`` (default batch 128): ViT-B/16 on 224 x 224 x 3 bf16 images, bf16
  activations, flash (non-causal, 196 patches), cross-entropy over 1000
  classes, AdamW(lr=1e-4, weight_decay=1e-4).

``--remat`` checkpoints every transformer block (gpt, bert, llama, vit).

``--decode`` (gpt or llama, eval mode, no optimizer) makes a "step" one
whole greedy decode at chip_smoke.py's generate settings (batch 8, a
32-token prompt, max_len 128): ``generate(use_cache=True)`` (cached) or
the loop that re-runs the buffer every token (reforward). ``--seq`` is
then the model's capacity (1024 for gpt, 4096 for llama), and the rate is
generated tokens per second; the profile's JSON line also gives
``decode_steps`` (96 a decode: divide a per-step figure by it for one
token of each row).

``--root`` profiles the package of another checkout (say, a parent commit
unpacked into build/), so two trees can be compared in one session.

Prints JSON lines:

- one per repeat of ``--steps`` timed steps (host clock around work that
  ends in torch.cuda.synchronize()), then their median and quartiles, in
  images or tokens per second, and the peak of allocated device memory
  over the warm-up and the repeats (``torch.cuda.max_memory_allocated``);
- a torch.profiler window of ``--profile-steps`` steps: the share of the
  window in which the device runs any kernel or copy (union of the device
  intervals over the window's span), the kernels that take the most device
  time, and device time by kind of kernel (``chip_smoke.KINDS``, the
  table its phases use too: the port's flash, scale and Adasum kernels,
  NCCL, norms, cross-entropy, the optimizer, convolutions, TF32, fp32 SIMT
  and other GEMMs, BatchNorm, pools), the PyTorch operators whose own
  kernels take the most device time, the device's kernels and copies a
  step, and the operators that take the most host time (self CPU ms and
  calls a step);
- the card's name, power limit, SM clock and power draw after the run.

Needs one CUDA device; exits 1 without one. Fails if the profiler records
no device time.
"""

import argparse
import collections
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402
from chip_smoke import busy_us, emit, kind_of  # noqa: E402


def top_ops(prof, steps, count=16):
    """The PyTorch operators whose kernels take the most device time (each
    operator's own, not its children's), per step: what the kernels
    classed "elementwise_and_other" belong to."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append([e.key[:60], us / 1e3 / steps])
    return sorted(rows, key=lambda r: -r[1])[:count]


def top_host_ops(prof, steps, count=14):
    """The PyTorch operators that take the most host time (each one's own,
    not its children's): [name, self CPU ms, calls] a step."""
    ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return [[a.key[:60], a.self_cpu_time_total / 1e3 / steps,
             a.count / steps] for a in ops[:count]]


def build_decode(args, torch, dev):
    """(decode function, generated tokens a decode, unit) for ``--decode``:
    GPT-2 small or LLaMA-400M, bf16, flash, eval mode, capacity ``--seq``;
    a prompt of chip_smoke's GEN_PROMPT tokens from ``--seed``."""
    from horovod_tpu_torch.models import (GPT, GPTConfig, Llama,
                                          LlamaConfig, generate)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    with torch.device(dev):
        if args.model == "gpt":
            model = GPT(GPTConfig(vocab_size=50304, hidden_size=768,
                                  num_layers=12, num_heads=12,
                                  intermediate_size=3072,
                                  max_position_embeddings=args.seq,
                                  dtype=torch.bfloat16, tp_axis=None,
                                  ep_axis=None, use_flash=True), generator=g)
        else:
            model = Llama(LlamaConfig.bench(max_position_embeddings=args.seq,
                                            dtype=torch.bfloat16,
                                            use_flash=True), generator=g)
    model.eval()
    P, L = cs.GEN_PROMPT, cs.GEN_LEN
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    prompt = torch.randint(0, model.config.vocab_size, (args.batch, P),
                           generator=gen, device=dev)
    cached = args.decode == "cached"

    def step():
        with torch.no_grad():
            generate(model, prompt, L, use_cache=cached)
    return step, args.batch * (L - P), "generated_tokens_per_sec"


def build_step(args, hvd, torch, dev):
    """(step function, items per step, unit) for ``args.model``."""
    import torch.nn.functional as F
    if args.model == "resnet50":
        from horovod_tpu_torch.models import ResNet50
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(args.seed))
        model = model.to(dev).train()
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        x = torch.randn((args.batch, 224, 224, 3), generator=gen, device=dev)
        y = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)

        def loss():
            return F.cross_entropy(model(x), y)
        items, unit = args.batch, "images_per_sec"
    elif args.model == "bert":
        from horovod_tpu_torch.models import BertConfig, BertForPreTraining
        cfg = BertConfig.large(dtype=torch.bfloat16, use_flash=True,
                               remat=args.remat)
        with torch.device(dev):
            model = BertForPreTraining(cfg, generator=torch.Generator(
                device=dev).manual_seed(args.seed))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-5,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 6)
        ids, labels = (torch.randint(0, cfg.vocab_size, (args.batch,
                                                         args.seq),
                                     generator=gen, device=dev)
                       for _ in range(2))
        nsp = torch.randint(0, 2, (args.batch,), generator=gen, device=dev)

        def loss():
            mlm, ns = model(ids)
            return F.cross_entropy(mlm.flatten(0, 1), labels.flatten()) \
                + F.cross_entropy(ns, nsp)
        items, unit = args.batch, "sequences_per_sec"
    elif args.model == "vit":
        from horovod_tpu_torch.models import ViT, ViTConfig
        cfg = ViTConfig.base(dtype=torch.bfloat16, use_flash=True,
                             remat=args.remat)
        with torch.device(dev):
            model = ViT(cfg, generator=torch.Generator(
                device=dev).manual_seed(args.seed))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 8)
        x = torch.randn((args.batch, 224, 224, 3), generator=gen,
                        device=dev).to(torch.bfloat16)
        y = torch.randint(0, cfg.num_classes, (args.batch,), generator=gen,
                          device=dev)

        def loss():
            return F.cross_entropy(model(x), y)
        items, unit = args.batch, "images_per_sec"
    else:
        if args.model == "gpt":
            from horovod_tpu_torch.models import GPT, GPTConfig
            cfg = GPTConfig(vocab_size=50304, hidden_size=768, num_layers=12,
                            num_heads=12, intermediate_size=3072,
                            max_position_embeddings=args.seq,
                            dtype=torch.bfloat16, tp_axis=None, ep_axis=None,
                            use_flash=True, remat=args.remat)
            model = GPT(cfg,
                        generator=torch.Generator().manual_seed(args.seed))
            model = model.to(dev).train()
        else:
            from horovod_tpu_torch.models import Llama, LlamaConfig
            cfg = LlamaConfig.bench(max_position_embeddings=args.seq,
                                    dtype=torch.bfloat16, use_flash=True,
                                    remat=args.remat)
            with torch.device(dev):
                model = Llama(cfg, generator=torch.Generator(
                    device=dev).manual_seed(args.seed))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
        ids = torch.randint(0, cfg.vocab_size, (args.batch, args.seq),
                            generator=gen, device=dev)

        def loss():
            logits = model(ids)
            return F.cross_entropy(logits[:, :-1].float().flatten(0, 1),
                                   ids[:, 1:].flatten())
        items, unit = args.batch * args.seq, "tokens_per_sec"
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters(),
                                   op=hvd.Adasum if args.op == "adasum"
                                   else hvd.Average)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    def step():
        opt.zero_grad()
        loss().backward()
        opt.step()
    return step, items, unit


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model",
                    choices=("resnet50", "gpt", "bert", "llama", "vit"),
                    default="resnet50")
    ap.add_argument("--remat", action="store_true",
                    help="checkpoint every transformer block")
    ap.add_argument("--op", choices=("average", "adasum"),
                    default="average",
                    help="the optimizer's reduction (adasum: resnet50 only)")
    ap.add_argument("--decode", choices=("cached", "reforward"),
                    default=None,
                    help="profile a greedy decode (gpt or llama)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=None,
                    help="64 images for resnet50, 128 for vit, 32 "
                         "sequences for bert, 8 for gpt and llama")
    ap.add_argument("--seq", type=int, default=None,
                    help="128 tokens for bert, 1024 for gpt and llama; "
                         "with --decode the capacity, 4096 for llama")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose horovod_tpu_torch is profiled")
    args = ap.parse_args(argv)
    if args.batch is None:
        args.batch = {"resnet50": 64, "vit": 128,
                      "bert": 32}.get(args.model, 8)
    if args.seq is None:
        args.seq = 128 if args.model == "bert" else \
            cs.LLAMA_GEN_CAPACITY if args.decode and args.model == "llama" \
            else 1024
    if args.remat and args.model == "resnet50":
        ap.error("--remat checkpoints transformer blocks")
    if args.op == "adasum" and args.model != "resnet50":
        ap.error("--op adasum profiles the resnet50 step")
    if args.decode and (args.model not in ("gpt", "llama") or args.remat
                        or args.op != "average"):
        ap.error("--decode profiles a gpt or llama decode, without --remat "
                 "or --op")

    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import horovod_tpu_torch as hvd

    torch.backends.cudnn.benchmark = True
    hvd.init()
    dev = hvd.device()
    step, items, unit = build_decode(args, torch, dev) if args.decode \
        else build_step(args, hvd, torch, dev)

    for _ in range(3):                       # cuDNN autotuning, buffers
        step()
    rates = []
    for r in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(items * args.steps / dt)
        emit({"repeat": r, unit: rates[-1],
              "step_ms": 1e3 * dt / args.steps})
    q1, med, q3 = statistics.quantiles(rates, n=4) if len(rates) > 1 \
        else (rates[0],) * 3
    emit({"summary": unit, "model": args.model, "op": args.op,
          "decode": args.decode,
          "remat": args.remat, "batch": args.batch, "seq": args.seq,
          "repeats": len(rates),
          "steps_each": args.steps, "median": statistics.median(rates),
          "q1": q1, "q3": q3, "min": min(rates), "max": max(rates),
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "root": os.path.abspath(args.root),
          "package": os.path.dirname(hvd.__file__)})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.profile_steps):
            step()
        torch.cuda.synchronize()
    events = list(prof.events())
    # Kernels and copies only: a record_function range (such as the
    # optimizer's step) also shows on the device's timeline, as an
    # annotation spanning the kernels it launched.
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("torch.profiler recorded no device time")
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    busy = busy_us((e.time_range.start, e.time_range.end) for e in device)
    by_name = collections.defaultdict(float)
    for e in device:
        by_name[e.name] += e.time_range.elapsed_us()
    by_kind = collections.defaultdict(float)
    for name, us in by_name.items():
        by_kind[kind_of(name)] += us
    n = args.profile_steps
    emit({"profile_steps": n, "window_ms": span / 1e3,
          "device_ms_by_kind_per_step": {
              k: v / 1e3 / n for k, v in sorted(by_kind.items(),
                                                key=lambda kv: -kv[1])},
          "device_busy_ms": busy / 1e3, "device_busy_share": busy / span,
          "device_idle_share": 1.0 - busy / span,
          "device_ms_per_step": busy / 1e3 / n,
          "scale_kernels_ms_per_step": sum(
              v for k, v in by_name.items() if "scale_copy_kernel" in k)
          / 1e3 / n,
          "nccl_ms_per_step": sum(
              v for k, v in by_name.items() if "nccl" in k.lower()) / 1e3 / n,
          "adasum_kernels_ms_per_step": by_kind.get("adasum_combine", 0.0)
          / 1e3 / n,
          "top_kernels_ms_per_step": [
              [k[:90], v / 1e3 / n] for k, v in sorted(
                  by_name.items(), key=lambda kv: -kv[1])[:12]],
          "top_ops_self_device_ms_per_step": top_ops(prof, n),
          "device_events_per_step": len(device) / n,
          "top_ops_self_cpu_ms_per_step": top_host_ops(prof, n),
          **({"decode_steps": cs.GEN_LEN - cs.GEN_PROMPT}
             if args.decode else {})})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    emit({"card": smi.stdout.strip().splitlines()[0],
          "torch": torch.__version__})
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
