#!/usr/bin/env python3
"""What the per-rank observability planes cost GPT-2 small training, on
one GPU.

    python3 scripts/ab_planes.py --parent DIR [--pairs 4] [--rounds 5]
        [--steps 8] [--seed 0] [--skip-ab]

The step is chip_smoke.py's ``train_gpt``: GPT-2 small at full width,
8 x 1024 tokens, bf16 activations, fp32 parameters, the flash kernels,
AdamW in ``hvd.DistributedOptimizer`` over fused buckets. Three readings,
in one run of the card:

1. **Parent against change.** ``scripts/profile_torch_port.py --model gpt
   --root R`` (3 repeats of 10 steps) in a process of its own for each R,
   in the order parent, change, change, parent, ... for ``--pairs`` pairs.
   ``DIR`` holds another checkout of the repo, say the parent commit
   unpacked there with ``git archive HEAD | tar -x -C DIR``; the change is
   this checkout. Each tree runs with its defaults (in this one the flight
   recorder, the step profiler and goodput are on). Printed: each run's
   median tokens/s, each pair's change/parent ratio, and the medians.
2. **Each plane alone.** In one process of this checkout: blocks of
   ``--steps`` steps with every plane off, each of flight, profile (the
   step profiler with its watchdog), goodput, metrics and timeline on
   alone, the defaults (all but the timeline) and all on, in turn for
   ``--rounds`` rounds, each round starting one setting later than the
   last. Printed: the median tokens/s of each setting and its ratio to
   all off.
3. **Where the armed step's host time goes.** ``cProfile`` over one block
   with every plane on and one with every plane off: each plane
   function's cumulative host ms a step, the largest first, and both
   blocks' ms a step under the profiler.

``--skip-ab`` runs 2 and 3 alone. Prints JSON lines, then the card's name
and power limit. Needs one CUDA device; exits 1 without one. About 2
minutes of the card a pair, and 1 more for 2 and 3.
"""

import argparse
import cProfile
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import chip_smoke as cs  # noqa: E402

PLANES = ("flight", "profile", "goodput", "metrics", "timeline")
# The modules whose functions part 3 reads, and the two hooks in the ops
# layer that call them.
PLANE_FILES = tuple(os.path.join("horovod_tpu_torch", p) for p in (
    "flight", "profile", "goodput", "metrics", "timeline.py", "trace"))
HOOKS = ("_dispatch_op", "_dispatch_failed", "_flush_observed")


def ab(opts):
    """Part 1: parent and change in turns, each run a process of its own."""
    runs = {"parent": [], "change": []}
    order = []
    for i in range(opts.pairs):
        order += [("parent", opts.parent), ("change", ROOT)][::1 if i % 2
                                                             == 0 else -1]
    for which, root in order:
        cmd = [sys.executable, os.path.join(ROOT, "scripts",
                                            "profile_torch_port.py"),
               "--model", "gpt", "--root", root, "--repeats", "3",
               "--steps", "10", "--profile-steps", "1"]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=600)
        summary = [line for line in res.stdout.splitlines()
                   if '"summary"' in line]
        cs.check(res.returncode == 0 and summary,
                 f"{which} run failed (rc {res.returncode}):\n"
                 f"{res.stdout[-2000:]}{res.stderr[-3000:]}")
        med = json.loads(summary[0])["median"]
        runs[which].append(med)
        cs.emit({"ab_run": which, "tokens_per_sec_median": med,
                 "package": json.loads(summary[0])["package"]})
    ratios = [c / p for p, c in zip(runs["parent"], runs["change"])]
    cs.emit({"ab": "gpt2_small_train", "order": [w for w, _ in order],
             "parent": runs["parent"], "change": runs["change"],
             "pair_ratios_change_over_parent": ratios,
             "parent_median": statistics.median(runs["parent"]),
             "change_median": statistics.median(runs["change"]),
             "median_ratio": statistics.median(runs["change"])
             / statistics.median(runs["parent"])})


def arm(hvd, on, path=None):
    """The planes in ``on`` armed, the others disarmed; the timeline goes
    to ``path`` while armed."""
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.flight import recorder
    from horovod_tpu_torch.goodput import ledger as goodput
    from horovod_tpu_torch.profile import ledger
    recorder.set_enabled("flight" in on)
    ledger.set_enabled("profile" in on)
    goodput.armed = "goodput" in on
    metrics.set_enabled("metrics" in on)
    if "profile" in on:
        ledger.reset_window()
    if "timeline" in on:
        hvd.start_timeline(path)
    else:
        hvd.stop_timeline()


def per_plane(opts, torch, hvd, step, tokens, work):
    """Part 2: each plane alone against all off, in turns."""
    settings = [("off", ())] + [(p, (p,)) for p in PLANES] \
        + [("defaults", PLANES[:-1]), ("all", PLANES)]
    rates = {name: [] for name, _ in settings}
    for r in range(opts.rounds):
        k = r % len(settings)
        for name, on in settings[k:] + settings[:k]:
            arm(hvd, on, os.path.join(work, f"timeline_{name}.json"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(opts.steps):
                step()
            torch.cuda.synchronize()
            rates[name].append(tokens * opts.steps
                               / (time.perf_counter() - t0))
    arm(hvd, ())
    off = statistics.median(rates["off"])
    cs.emit({"per_plane": "gpt2_small_train", "steps_a_block": opts.steps,
             "rounds": opts.rounds, "tokens_per_sec": rates,
             "median": {k: statistics.median(v) for k, v in rates.items()},
             "ratio_to_off": {k: statistics.median(v) / off
                              for k, v in rates.items()}})


def plane_rows(stats, steps):
    """[function, cumulative host ms a step, calls a step] of the planes'
    functions and hooks, the largest first."""
    rows = []
    for (path, line, fn), (_, ncalls, _, cum, _) in stats.stats.items():
        if any(p in path for p in PLANE_FILES) or fn in HOOKS:
            rel = path.split("horovod_tpu_torch", 1)[-1]
            rows.append([f"horovod_tpu_torch{rel}:{line}({fn})",
                         1e3 * cum / steps, ncalls / steps])
    return sorted(rows, key=lambda r: -r[1])


def where(opts, torch, hvd, step, work):
    """Part 3: cProfile over an all-on block and an all-off block."""
    out = {}
    for name, on in (("all", PLANES), ("off", ())):
        arm(hvd, on, os.path.join(work, "timeline_cprofile.json"))
        torch.cuda.synchronize()
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        for _ in range(opts.steps):
            step()
        torch.cuda.synchronize()
        prof.disable()
        out[name] = {"ms_a_step_under_cprofile":
                     1e3 * (time.perf_counter() - t0) / opts.steps,
                     "plane_functions": plane_rows(pstats.Stats(prof),
                                                   opts.steps)[:25]}
    arm(hvd, ())
    cs.emit({"where": "gpt2_small_train", "steps": opts.steps, **out})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another checkout (part 1)")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-ab", action="store_true")
    opts = ap.parse_args(argv)
    if not opts.skip_ab and not opts.parent:
        ap.error("--parent DIR, or --skip-ab")
    import torch
    if not torch.cuda.is_available():
        print("ab_planes: no CUDA device is visible", file=sys.stderr)
        return 1
    card = cs.card_line()
    if not opts.skip_ab:
        ab(opts)

    import tempfile

    import horovod_tpu_torch as hvd
    import profile_torch_port as ptp
    torch.backends.cudnn.benchmark = True
    hvd.init()
    args = argparse.Namespace(model="gpt", seq=cs.GPT_SEQ,
                              batch=cs.GPT_BATCH, seed=opts.seed,
                              remat=False, op="average")
    step, tokens, _ = ptp.build_step(args, hvd, torch, hvd.device())
    for _ in range(3):
        step()
    work = tempfile.mkdtemp(prefix="hvd_ab_planes_")
    per_plane(opts, torch, hvd, step, tokens, work)
    where(opts, torch, hvd, step, work)
    hvd.shutdown()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
