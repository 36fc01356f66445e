#!/usr/bin/env python3
"""chip_smoke.py's observability phases alone, on one GPU.

    python3 scripts/probe_observe.py [--phases observe,cluster,launch,hier_cpu_world] [--root DIR]

Builds the kernels and runs the chosen ones of ``observe`` (A16's per-rank
planes on GPT-2 small at full width: interleaved disarmed and armed
blocks, the timeline, the flight recorder, the step profiler with its
roofline and watchdog, goodput and metrics, with every check of the
phase), ``cluster`` (the cluster telemetry plane and the control plane on
GPT-2 small: a JSON chaos plan's delay and hang on the fusion flush, the
stall inspector, chaos armed but idle against disarmed, a fleet of
telemetry agents on the run's real digest, the /cluster routes),
``launch`` (``hvdrun-torch -np 1`` with the timeline, goodput,
run-history, flight and chaos flags: the files each plane left, the
chaos ledger, and ``python -m horovod_tpu_torch.goodput`` reading the
run) and ``hier_cpu_world`` (4 CPU ranks, 2 x 2, with the hierarchical
control plane, two KV shards, the order check and telemetry), through
chip_smoke.py's ``PhaseRunner``. A phase that fails ends the probe with its exception and
a nonzero exit. ``--root`` runs another checkout's package (a parent
commit unpacked into build/), for an A/B within one run of the card.

About two and a half minutes on an H100, the kernels' build included."""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

PHASES = ("observe", "cluster", "launch", "hier_cpu_world")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated, of {', '.join(PHASES)}")
    ap.add_argument("--root", default=ROOT,
                    help="the checkout whose horovod_tpu_torch is run")
    ap.add_argument("--seed", type=int, default=0)
    opts = ap.parse_args(argv)
    phases = opts.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}")
    import torch
    if not torch.cuda.is_available():
        print("probe_observe: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(opts.root))
    import horovod_tpu_torch as hvd
    args = argparse.Namespace(seed=opts.seed, warmup=2, steps=10, batch=64)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    card = cs.card_line()
    cs.emit({"probe": "observe", "phases": phases, "card": card,
             "package": os.path.dirname(hvd.__file__)})
    run = cs.PhaseRunner(torch)
    run("build", cs.phase_build)
    hvd.init()
    calls = {"observe": (cs.phase_observe, torch, hvd, dev, args, card),
             "cluster": (cs.phase_cluster, torch, hvd, dev, args, card),
             "launch": (cs.phase_launch, torch, args, card),
             "hier_cpu_world": (cs.phase_hier_cpu_world, args)}
    for name in (p for p in PHASES if p in phases):
        run(name, *calls[name])
    hvd.shutdown()
    cs.emit({"phase": "seconds", **run.seconds})
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
