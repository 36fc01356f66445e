#!/usr/bin/env python3
"""Time GPT-2 small's training step on one GPU with and without a mesh.

    python3 scripts/probe_mesh_overhead.py [--rounds 3] [--steps 6]
        [--seed 0]

The three paths of chip_smoke.py's train_gpt_tp_sp phase (GPT-2 small,
8 x 1024 tokens, bf16, the flash kernels, AdamW in hvd.DistributedOptimizer
on the dp axis's process set): ``none``, the model with no axis in a plain
loop; ``ring`` and ``ulysses``, the model built with ``tp_axis="tp"`` and
``sp_axis="sp"`` on a (dp, sp, tp) = (1, 1, 1) mesh and stepped by
``parallel/dp.py::make_train_step``. All three are built first and timed in
interleaved rounds (none, ring, ulysses, none, ...), so that drift of the
shared host falls on each. Then, per path, the host functions with the most
own time over 3 steps (cProfile) and the device's busy time over 2 steps
(torch.profiler: the union of kernel and copy intervals).

Prints one JSON line per round, a summary line (median tokens/s, host and
device ms a step), then the card's name and power limit. Needs one CUDA
device; exits 1 without one.
"""

import argparse
import contextlib
import cProfile
import dataclasses
import io
import json
import os
import pstats
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def busy_ms(torch, step, steps):
    """Device busy ms a step over ``steps`` steps (union of intervals)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3 / steps


def host_top(step, steps, n=12):
    """The ``n`` functions with the most own host time over ``steps``."""
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(steps):
        step()
    prof.disable()
    stats = pstats.Stats(prof, stream=io.StringIO())
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"fn": f"{os.path.basename(k[0])}:{k[1]}({k[2]})",
             "calls": v[1], "own_ms": v[2] * 1e3 / steps,
             "cum_ms": v[3] * 1e3 / steps} for k, v in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("probe_mesh_overhead: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    import chip_smoke as cs
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT
    from horovod_tpu_torch.ops import in_step
    from horovod_tpu_torch.parallel import dp

    cs.phase_build()
    hvd.init()
    dev = torch.device("cuda", 0)
    mesh = in_step.make_mesh(cs.TP_SP_MESH)
    steps = {}
    ids = None
    for impl in ("none", "ring", "ulysses"):
        cfg = cs.gpt_config(torch, use_flash=True)
        bound = impl != "none"
        if bound:
            cfg = dataclasses.replace(cfg, tp_axis="tp", sp_axis="sp",
                                      sp_impl=impl)
        with (in_step.axes(mesh) if bound else contextlib.nullcontext()):
            model = GPT(cfg, generator=torch.Generator().manual_seed(
                args.seed)).to(dev).train()
        if ids is None:
            ids = cs.gpt_batch(torch, model, dev, args.seed)

        def loss_fn(m, batch):
            return cs.next_token_loss(F, m(batch), batch)
        opt = hvd.DistributedOptimizer(
            torch.optim.AdamW(model.parameters(), lr=1e-4,
                              weight_decay=1e-4),
            named_parameters=model.named_parameters(),
            process_set=dp.axis_process_set(mesh, "dp"))
        if bound:
            state = dp.TrainState.create(model, opt)
            train = dp.make_train_step(loss_fn, opt, mesh, axis_name="dp",
                                       sum_axes=("sp",))

            def step(train=train, state=state):
                return train(state, ids)[1]
        else:
            def step(opt=opt, model=model, loss_fn=loss_fn):
                opt.zero_grad()
                value = loss_fn(model, ids)
                value.backward()
                opt.step()
                return value.detach()
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        steps[impl] = step
    tokens = {impl: [] for impl in steps}
    for r in range(args.rounds):
        row = {"round": r}
        for impl, step in steps.items():
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            rate = cs.GPT_BATCH * cs.GPT_SEQ * args.steps / (
                time.perf_counter() - t0)
            tokens[impl].append(rate)
            row[impl] = rate
        print(json.dumps(row), flush=True)
    summary = {"rounds": args.rounds, "steps": args.steps}
    for impl, step in steps.items():
        summary[impl] = {
            "tokens_per_sec_median": statistics.median(tokens[impl]),
            "tokens_per_sec": tokens[impl],
            "device_busy_ms_per_step": busy_ms(torch, step, 2),
            "host_top": host_top(step, 3)}
    print(json.dumps(summary), flush=True)
    hvd.shutdown()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
