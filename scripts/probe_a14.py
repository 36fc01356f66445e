#!/usr/bin/env python3
"""chip_smoke.py's A14 and A15 phases alone, on one GPU.

    python3 scripts/probe_a14.py [--phases p1,p2,...] [--root DIR]

Builds the kernels and runs, in this order, the chosen ones of
``flash_vs_plain`` (which holds the flash kernels against their plain
versions at every path's shape, the decodes' included), ``train_gpt``
(GPT-2 small, dropped after it), ``train_t5``, ``train_vgg16``,
``train_inception3``, ``train_lora``, ``generate``, ``generate_cached``
(the decode cache's routes, which print their tokens/s beside
``generate``'s when both run), ``serve`` (the serving engine on GPT-2
small and LLaMA-400M) and ``launch_serving`` (``hvdrun-torch --serving``
on the card); all of them by default. Each phase goes through chip_smoke.py's ``PhaseRunner``: a
collection and a peak reset first, its JSON lines, then its seconds and the
memory still allocated when it started (what a dropped model left behind).
A phase that fails ends the probe with its exception and a nonzero exit.

``--root`` runs the phases on the package of another checkout (say, a
parent commit unpacked into build/), so two trees' models can be compared
in one run of the card, alternating.

About three minutes on an H100 for every phase, the kernels' build
included; ``generate_cached`` about a minute and a half more, ``serve``
and ``launch_serving`` about two minutes together."""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

PHASES = ("flash_vs_plain", "train_gpt", "train_t5", "train_vgg16",
          "train_inception3", "train_lora", "generate", "generate_cached",
          "serve", "launch_serving")


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
        print("probe_a14: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(opts.root))
    import horovod_tpu_torch as hvd
    args = argparse.Namespace(seed=opts.seed, warmup=2, steps=10, batch=64)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = True
    card = cs.card_line()
    cs.emit({"probe": "a14", "phases": phases, "card": card,
             "package": os.path.dirname(hvd.__file__)})
    run = cs.PhaseRunner(torch)
    run("build", cs.phase_build)
    hvd.init()
    calls = {
        "flash_vs_plain": (cs.phase_flash_vs_plain, torch, dev, args.seed),
        "train_t5": (cs.phase_train_t5, torch, hvd, dev, args, card),
        "train_vgg16": (cs.phase_train_image, torch, hvd, dev, args, card,
                        "vgg16"),
        "train_inception3": (cs.phase_train_image, torch, hvd, dev, args,
                             card, "inception3"),
        "train_lora": (cs.phase_train_lora, torch, hvd, dev, args, card),
        "generate": (cs.phase_generate, torch, dev, args, card),
        "generate_cached": (cs.phase_generate_cached, torch, dev, args,
                            card),
        "serve": (cs.phase_serve, torch, dev, args, card),
        "launch_serving": (cs.phase_launch_serving, torch, args, card)}
    for name in (p for p in PHASES if p in phases):
        if name == "train_gpt":
            gpt = cs.build_gpt(torch, dev, args.seed)
            out = run(name, cs.phase_train_gpt, torch, hvd, gpt, dev, args,
                      card)
            del gpt, out
        else:
            run(name, *calls[name])
    cs.emit({"phase": "seconds", **run.seconds})
    cs.emit({"phase": "allocated_gb_at_phase_start", **run.start_gb})
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
