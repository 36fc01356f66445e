#!/usr/bin/env python3
"""Time the Adasum path's combine as the runtime calls it, on one GPU.

    python3 scripts/time_adasum_path.py [--root DIR] [--ranks 2 3 4]
        [--reps 30] [--seed 0]

For each K of ``--ranks``: ResNet-50's two fp32 Adasum buckets (gradients
in the order their hooks fire, cut at the 64 MiB fusion threshold), K rows
of random values each, as the all-gather leaves them, through
``horovod_tpu_torch.ops.adasum.reduce_gathered``, the whole Adasum tree of
a bucket in place. Each call starts on an idle card from a fresh copy of
the rows, and is timed by CUDA events around the call alone, so host work
in the wrapper counts; median of ``--reps``, summed over the buckets.
The kernels' launches a call are counted, and one call's result is held
against ``reduce_gathered_reference`` per tensor within 1e-5 of its
largest plain value (exit 1 beyond it).

``--root`` times the package of another checkout (say, a parent commit
unpacked into build/), so two trees can be compared in one session: run
parent, change, change, parent. Prints one JSON line with the card's name
and power limit. Needs one CUDA device; exits 1 without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5          # fp32, as chip_smoke.py's ADASUM_TOL


def resnet50_buckets(ResNet50):
    numels = [p.numel() for p in ResNet50(num_classes=1000).parameters()]
    buckets, cur = [], []
    for n in reversed(numels):
        if sum(cur) + n > 16 * 1024 * 1024:
            buckets.append(cur)
            cur = []
        cur.append(n)
    return buckets + [cur]


def max_rel(got, want, numels):
    worst, off = 0.0, 0
    for n in numels:
        g, w = got[off:off + n].double(), want[off:off + n].double()
        off += n
        worst = max(worst, ((g - w).abs().max()
                            / w.abs().max().clamp_min(1e-30)).item())
    return worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose horovod_tpu_torch is timed")
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_adasum_path: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import adasum
    from horovod_tpu_torch.ops.kernels import _build
    from horovod_tpu_torch.ops.kernels import adasum as ak
    _build.build(("adasum",))   # reduce_gathered only loads its library

    def launches():
        return ak.launches + getattr(ak, "stream_launches", 0)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    buckets = resnet50_buckets(ResNet50)
    result, ok = {}, True
    for k in args.ranks:
        rows = []
        for numels in buckets:
            src = torch.randn(k, sum(numels), generator=gen, device=dev)
            gathered = src.clone()
            before = launches()
            got = adasum.reduce_gathered(gathered, numels)   # warms
            torch.cuda.synchronize()
            calls = launches() - before
            err = max_rel(got, ak.reduce_gathered_reference(src, numels),
                          numels)
            ok = ok and err <= TOL
            times = []
            for _ in range(args.reps):
                gathered.copy_(src)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                adasum.reduce_gathered(gathered, numels)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            rows.append({"tensors": len(numels), "elements": sum(numels),
                         "launches": calls, "max_rel": err,
                         "ms": statistics.median(times),
                         "q1_q3": statistics.quantiles(times, n=4)[::2]})
            del src, gathered, got
        result[str(k)] = {"ms": sum(r["ms"] for r in rows),
                          "launches": sum(r["launches"] for r in rows),
                          "per_bucket": rows}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": os.path.abspath(args.root),
                      "package": os.path.dirname(os.path.dirname(
                          os.path.dirname(ak.__file__))),
                      "by_ranks": result, "tolerance": TOL, "ok": ok,
                      "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
