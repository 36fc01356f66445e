"""``python -m horovod_tpu_torch.sim`` — the twin's scale-guard battery.

Port of the JAX package's ``sim/__main__.py``. Lint-style exit codes (0 =
every check passed, 1 = a check failed, 2 = usage error): twin-vs-thread-
dryrun parity at a thread-feasible world,
the n=16384 / n=65536 ``exchange_plan`` guards, flat-vs-hier payload
identity, and a double-run determinism check over a chaos plan.

``--pretrain PATH`` instead runs the twin autopilot to convergence and
writes the ``HOROVOD_AUTOPILOT_PRIOR`` artifact, priced at this machine's
row of ``profile/roofline.py`` (``--chip h100`` names one).
"""

import argparse
import json
import sys


def _checks():
    from horovod_tpu_torch.common.control_plane import (exchange_plan,
                                                  simulate_exchange)
    from horovod_tpu_torch.chaos.plan import ChaosPlan, FaultSpec
    from horovod_tpu_torch.sim.control import (TwinJob, flat_reference,
                                         twin_exchange)

    # 1. twin-vs-thread parity: the real exchange code under threads is
    # the ground truth the twin's generators must reproduce.
    thread = simulate_exchange(128, 8, rounds=2)
    twin = twin_exchange(128, 8, rounds=2)
    mismatch = [k for k in ("identical", "gets_total", "payload_bytes",
                            "member_gets_per_round",
                            "leader_gets_per_round")
                if thread[k] != twin[k]]
    if thread["result"] != twin["result"]:
        mismatch.append("result")
    yield ("twin-vs-thread parity n=128 s=8", not mismatch,
           f"diverging fields: {mismatch}" if mismatch else "12 fields")

    # 2/3. scale guards: per-role gets match exchange_plan, payload
    # identical to the analytic flat reference, at thread-infeasible n.
    for world, slices in ((16384, 64), (65536, 256)):
        plan = exchange_plan(world, slices)
        r = twin_exchange(world, slices)
        ok = (r["identical"]
              and r["member_gets_per_round"] == plan["member_gets"]
              and r["leader_gets_per_round"] == plan["leader_gets"]
              and r["gets_total"] == plan["round_gets_total"]
              and r["result"] == flat_reference(world, 0))
        yield (f"scale guard n={world} s={slices}", ok,
               f"member={r['member_gets_per_round']} "
               f"leader={r['leader_gets_per_round']} "
               f"events={r['events']} virtual_s={r['virtual_s']:.4f}")

    # 4. determinism: same (seed, world, slices, plan) twice -> byte-
    # identical trail and report.
    plan = ChaosPlan([
        FaultSpec(site="http_kv.request", kind="delay", p=0.02,
                  delay_ms=25),
        FaultSpec(site="negotiation.exchange", kind="crash", rank=37,
                  at=[1], max_fires=1),
    ], seed=7)
    runs = [TwinJob(256, 8, rounds=4,
                    plan=ChaosPlan.from_dict(plan.to_dict()),
                    record_trail=True).run() for _ in range(2)]
    blobs = [json.dumps(r, sort_keys=True) for r in runs]
    yield ("determinism (2 runs, chaos seed=7)", blobs[0] == blobs[1],
           f"{len(runs[0]['trail'])} trail events, "
           f"final_world={runs[0]['final_world']}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.sim", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pretrain", metavar="PATH",
                   help="write a twin-pretrained autopilot prior "
                        "artifact to PATH and exit")
    p.add_argument("--world", type=int, default=8,
                   help="pretrain layout world size (default 8)")
    p.add_argument("--slices", type=int, default=2,
                   help="pretrain layout slice count (default 2)")
    p.add_argument("--strategy", default="flat",
                   help="pretrain configured/incumbent strategy")
    p.add_argument("--bo-samples", type=int, default=4,
                   dest="bo_samples",
                   help="numeric BO samples before freeze (default 4, "
                        "matching the CPU-tier guard)")
    p.add_argument("--chip", default=None,
                   help="price the pretrain at this row of "
                        "profile/roofline.py (default: the detected "
                        "device's)")
    try:
        args = p.parse_args(argv)
    except SystemExit as e:
        return 0 if not e.code else 2

    if args.pretrain:
        from horovod_tpu_torch.sim import autopilot as sim_autopilot
        from horovod_tpu_torch.profile import roofline
        res = sim_autopilot.pretrain(
            args.world, args.slices, strategy=args.strategy,
            bayes_opt_max_samples=args.bo_samples,
            peaks=roofline.chip_peaks(args.chip))
        sim_autopilot.write_prior(args.pretrain, res)
        print(f"twin pretrain: {res['epochs']} epochs at "
              f"{res['layout']['chip']}, "
              f"winner {res['winner']['categoricals']}, "
              f"prior -> {args.pretrain}")
        return 0 if res["frozen"] else 1

    failed = 0
    for name, ok, detail in _checks():
        tag = "ok" if ok else "FAIL"
        print(f"{tag}: {name} ({detail})")
        failed += 0 if ok else 1
    if failed:
        print(f"{failed} twin check(s) failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
