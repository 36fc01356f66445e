#!/usr/bin/env python3
"""The fusion runtime's cycle thread on one GPU: what it closes, what it costs.

    python3 scripts/probe_cycle_thread.py [--models resnet50 gpt]
        [--turns 3] [--repeats 3] [--steps 5] [--seed 31]

Builds the kernels (chip_smoke.py's build phase), calls hvd.init() on cuda:0
and, for ResNet-50 (batch 64, SGD) and GPT-2 small (8 x 1024, AdamW) as
chip_smoke.py trains them in hvd.DistributedOptimizer:

1. ``gaps``: five steps with the cycle thread off, each gradient hook's
   enqueue timed: hooks a step, the median and the largest gap between two
   enqueues, and how many gaps pass 1 ms (the cycle time the runtime
   debounces with);
2. ``variants``, in turns (each turn runs every variant once, ``--turns``
   of them, so that a drift of the shared host reaches them all):
   - ``off``: no cycle thread (``HOROVOD_CYCLE_TIME=0``);
   - ``cycle``: the runtime's cycle thread at 1 ms;
   - ``idle``: no cycle thread; a thread that enters
     ``torch.cuda.device`` and blocks on an event for the whole turn;
   - ``timer``: no cycle thread; a thread that wakes every 1 ms and does
     nothing else;
   - ``backoff32``: the cycle thread with its sleep in a dense burst
     doubling up to 32 cycles (a candidate the runtime does not use: it
     would miss gaps shorter than its current sleep);

   per variant, images/s or tokens/s of ``--repeats`` repeats of
   ``--steps`` steps after 2 warm-up steps (host clock around work that
   ends in torch.cuda.synchronize()), and the buckets, buckets the timer
   closed and new signatures a step.

Prints one JSON line per model and measurement, then the card's name and
power limit. Needs one CUDA device; exits 1 without one.
"""

import argparse
import gc
import json
import os
import statistics
import sys
import threading
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("off", "cycle", "idle", "timer", "backoff32")


def backoff_loop(cap):
    """The runtime's cycle loop, but each sleep that finds a newer enqueue
    doubles the next, up to ``cap`` cycles."""
    def loop(self):
        k = 0
        while not self._stop.is_set():
            s = self._cycle_s
            if s <= 0:
                return
            self._wake.clear()
            if not self._pending:
                k = 0
                self._wake.wait()
                continue
            left = self._last_enqueue + s - time.perf_counter()
            if left > 0:
                self._stop.wait(max(left, min(s * 2 ** k, cap * s)))
                k += 1
                continue
            k = 0
            with self._lock:
                if self._pending and \
                        time.perf_counter() - self._last_enqueue >= s:
                    self._flush_locked("cycle")
    return loop


class Variant:
    """Switches the runtime ``rt`` between the variants."""

    def __init__(self, torch, rt, dev):
        self.torch, self.rt, self.dev = torch, rt, dev
        self.cycle_loop = type(rt)._cycle_loop
        self.stop, self.thread = None, None

    def clear(self):
        self.rt.set_cycle_time_ms(0)
        for t in self.rt.threads():
            if t.name == "hvd-fusion-cycle":
                t.join(timeout=5)
        if self.thread is not None:
            self.stop.set()
            self.thread.join(timeout=5)
            self.thread = None

    def set(self, kind):
        self.clear()
        if kind in ("cycle", "backoff32"):
            loop = self.cycle_loop if kind == "cycle" else backoff_loop(32)
            self.rt._cycle_loop = types.MethodType(loop, self.rt)
            self.rt.set_cycle_time_ms(1.0)
        elif kind in ("idle", "timer"):
            stop = self.stop = threading.Event()
            torch, dev = self.torch, self.dev

            def idle():
                with torch.cuda.device(dev):
                    stop.wait()

            def timer():
                while not stop.wait(0.001):
                    pass
            self.thread = threading.Thread(
                target=idle if kind == "idle" else timer, daemon=True)
            self.thread.start()


def build(C, torch, hvd, name, dev, seed):
    """(step, items a step, unit) for ``name``, as chip_smoke.py trains
    it."""
    import torch.nn.functional as F
    gen = torch.Generator(device=dev).manual_seed(seed)
    if name == "gpt":
        model = C.build_gpt(torch, dev, seed)
        ids = torch.randint(0, model.config.vocab_size,
                            (C.GPT_BATCH, C.GPT_SEQ), generator=gen,
                            device=dev)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        units, unit = C.GPT_BATCH * C.GPT_SEQ, "tokens_per_sec"

        def loss():
            return C.next_token_loss(F, model(ids), ids)
    else:
        from horovod_tpu_torch.models import ResNet50
        model = ResNet50(num_classes=1000, dtype=torch.bfloat16,
                         generator=torch.Generator().manual_seed(seed))
        model = model.to(dev).train()
        x = torch.randn((64, 224, 224, 3), generator=gen, device=dev)
        y = torch.randint(0, 1000, (64,), generator=gen, device=dev)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        units, unit = 64, "images_per_sec"

        def loss():
            return F.cross_entropy(model(x), y)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())

    def step():
        opt.zero_grad()
        loss().backward()
        opt.step()
    return step, units, unit, opt


def gaps(torch, rt, step):
    stamps = []
    raw = rt.enqueue

    def enqueue(*a, **k):
        stamps.append(time.perf_counter())
        return raw(*a, **k)
    rt.enqueue = enqueue
    rows = []
    try:
        for _ in range(5):
            del stamps[:]
            step()
            torch.cuda.synchronize()
            g = [b - a for a, b in zip(stamps, stamps[1:])]
            rows.append({"hooks": len(stamps),
                         "median_gap_ms": statistics.median(g) * 1e3,
                         "max_gap_ms": max(g) * 1e3,
                         "gaps_over_1ms": sum(x > 1e-3 for x in g)})
    finally:
        del rt.enqueue
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", nargs="+", default=["resnet50", "gpt"],
                    choices=["resnet50", "gpt"])
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=31)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("probe_cycle_thread: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime

    C.phase_build()
    hvd.init()
    dev = hvd.device()
    rt = get_runtime()
    variant = Variant(torch, rt, dev)
    for name in args.models:
        step, units, unit, opt = build(C, torch, hvd, name, dev, args.seed)
        variant.set("off")
        step()
        C.emit({"model": name, "gaps": gaps(torch, rt, step)})
        rates, per = {}, {}
        for _ in range(args.turns):
            for kind in VARIANTS:
                variant.set(kind)
                for _ in range(2):
                    step()
                for _ in range(args.repeats):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m0 = rt.flush_stats()
                    for _ in range(args.steps):
                        step()
                    torch.cuda.synchronize()
                    rates.setdefault(kind, []).append(
                        units * args.steps / (time.perf_counter() - t0))
                    row = C.buckets_since(m0)[1]
                    per.setdefault(kind, []).append(
                        [v / args.steps for v in row])
        C.emit({"model": name, "variants": {
            k: {unit: statistics.median(rates[k]), f"{unit}_repeats":
                rates[k], "buckets_timer_new_signatures_per_step":
                [statistics.mean(r[i] for r in per[k]) for i in range(3)]}
            for k in VARIANTS}})
        variant.clear()
        opt._remove_hooks()
        del step, opt
        gc.collect()
    hvd.shutdown()
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
