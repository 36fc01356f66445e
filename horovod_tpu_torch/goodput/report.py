"""``python -m horovod_tpu_torch.goodput.report`` — render and regress runs.

Port of the JAX package's ``goodput/report.py``: the same text, tables
and regression gate, over the journals either package writes.

Reads the journals :mod:`horovod_tpu_torch.goodput.history` leaves behind and
answers, from the launch box with nothing else running: *was that job
actually training, and is this run worse than the ones before it?*

- default / ``--run ID``: render one run — wall, goodput ratio, the full
  badput decomposition, conservation check, and the victim rank when the
  cluster view carries one (max ``straggler_wait`` / watchdog naming).
- ``--diff OLD NEW``: compare two runs; the regression gate combines an
  absolute goodput-ratio drop with a cross-run robust-z (the same
  median/MAD score the step watchdog names stragglers with) of the new
  run against ALL journaled runs. Exit code 1 when a regression is
  flagged — wire it straight into CI.
"""

import argparse
import json
import os
import sys

from horovod_tpu_torch.goodput.ledger import BADPUT_CATEGORIES, PRODUCTIVE
from horovod_tpu_torch.goodput.history import read_runs
from horovod_tpu_torch.profile.ledger import robust_z

# Cross-run robust-z beyond which a per-category badput share (or a
# goodput-ratio deficit) counts as a regression, and the absolute
# goodput-ratio drop that flags regardless of history depth (robust-z
# needs >= 4 runs to mean anything; two journaled runs still gate).
Z_THRESHOLD = 3.0
DROP_THRESHOLD = 0.05


def _goodput_of(summary):
    rec = summary.get("goodput") or {}
    return rec.get("summary") or {}


def _category_shares(snap):
    """Badput categories as fractions of wall (comparable across runs of
    different lengths)."""
    wall = float(snap.get("wall_s") or 0.0)
    cats = snap.get("categories") or {}
    if wall <= 0:
        return {}
    return {k: float(cats.get(k, 0.0)) / wall for k in BADPUT_CATEGORIES}


def find_victim(summary):
    """-> (rank, reason) or None: the rank the decomposition blames.
    The step watchdog's cross-rank straggler naming wins when present —
    under a synchronous collective EVERY rank books self-relative
    ``straggler_wait``, but the comparative verdict (robust-z on the
    dispatch-path attribution across ranks) names only the one stalling
    the others. Falls back to the max per-rank ``straggler_wait`` and
    then ``rendezvous_recovery`` from the journaled cluster view."""
    view = summary.get("cluster") or {}
    ranks = (view.get("goodput") or {}).get("ranks") or {}
    snap = _goodput_of(summary)
    named = snap.get("straggler_named")
    if named is not None:
        wait = float((ranks.get(str(named)) or {})
                     .get("straggler_wait_s") or 0.0)
        detail = f", straggler_wait {wait:.2f}s" if wait else ""
        return named, f"watchdog straggler naming{detail}"
    best = None
    for cat in ("straggler_wait_s", "rendezvous_recovery_s"):
        for rank, d in ranks.items():
            v = float((d or {}).get(cat) or 0.0)
            if v > 0.0 and (best is None or v > best[1]):
                best = (rank, v, cat[:-2])
        if best is not None:
            break
    if best is None:
        return None
    rank, seconds, why = best
    return rank, f"{why} {seconds:.2f}s"


def render_run(summary):
    snap = _goodput_of(summary)
    run = summary.get("run", "?")
    start = summary.get("start") or {}
    lines = []
    ended = "ended cleanly" if summary.get("ended") else \
        "NO run_end marker (killed run)"
    lines.append(f"run {run}  fingerprint={start.get('fingerprint', '?')}"
                 f"  world={start.get('world', '?')}  [{ended}]")
    if not snap:
        lines.append("  no goodput records in journal")
        return lines
    wall = float(snap.get("wall_s") or 0.0)
    ratio = float(snap.get("goodput_ratio") or 0.0)
    err = float(snap.get("conservation_error") or 0.0)
    lines.append(f"  wall {wall:.1f}s  goodput {ratio:.1%}  "
                 f"steps {snap.get('steps', 0)}  "
                 f"resets {snap.get('resets', 0)}  "
                 f"conservation_error {err:.4%}")
    cats = snap.get("categories") or {}
    for cat in (PRODUCTIVE,) + BADPUT_CATEGORIES:
        v = float(cats.get(cat, 0.0))
        if cat != PRODUCTIVE and v <= 0.0:
            continue
        pct = v / wall if wall > 0 else 0.0
        lines.append(f"    {cat:<20s} {v:10.2f}s  {pct:6.1%}")
    victim = find_victim(summary)
    if victim is not None:
        lines.append(f"  victim: rank {victim[0]} ({victim[1]})")
    if summary.get("bench"):
        lines.append(f"  bench records: {len(summary['bench'])}")
    return lines


def diff_runs(old, new, runs, z_threshold=Z_THRESHOLD,
              drop_threshold=DROP_THRESHOLD):
    """-> (lines, regressed). ``runs`` is the full history for the
    robust-z baseline (the two runs under comparison included)."""
    lines = []
    regressed = False
    old_snap, new_snap = _goodput_of(old), _goodput_of(new)
    if not old_snap or not new_snap:
        return ["diff: missing goodput records"], False
    o_ratio = float(old_snap.get("goodput_ratio") or 0.0)
    n_ratio = float(new_snap.get("goodput_ratio") or 0.0)
    hist_ratios = [float(_goodput_of(r).get("goodput_ratio") or 0.0)
                   for r in runs.values() if _goodput_of(r)]
    z, med = robust_z(n_ratio, hist_ratios)
    lines.append(f"goodput_ratio  {o_ratio:.4f} -> {n_ratio:.4f}  "
                 f"(delta {n_ratio - o_ratio:+.4f}, z {z:+.2f} "
                 f"vs history median {med:.4f}, n={len(hist_ratios)})")
    if n_ratio < o_ratio - drop_threshold or \
            (len(hist_ratios) >= 4 and z <= -z_threshold
             and n_ratio < med):
        lines[-1] += "  REGRESSION"
        regressed = True
    o_sh, n_sh = _category_shares(old_snap), _category_shares(new_snap)
    hist_sh = [_category_shares(_goodput_of(r)) for r in runs.values()
               if _goodput_of(r)]
    for cat in BADPUT_CATEGORIES:
        o_v, n_v = o_sh.get(cat, 0.0), n_sh.get(cat, 0.0)
        if o_v == 0.0 and n_v == 0.0:
            continue
        zs = [s.get(cat, 0.0) for s in hist_sh]
        z, med = robust_z(n_v, zs)
        line = (f"badput/{cat:<20s} {o_v:6.2%} -> {n_v:6.2%}  "
                f"(z {z:+.2f})")
        if n_v > o_v + drop_threshold or \
                (len(zs) >= 4 and z >= z_threshold and n_v > med):
            line += "  REGRESSION"
            regressed = True
        lines.append(line)
    return lines, regressed


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.goodput.report",
        description="Render goodput run history and flag regressions.")
    p.add_argument("--dir", default=os.environ.get(
        "HOROVOD_RUN_HISTORY_DIR", "run_history"),
        help="run-history directory (default: $HOROVOD_RUN_HISTORY_DIR)")
    p.add_argument("--run", default=None,
                   help="render this run id (default: latest)")
    p.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"), default=None,
                   help="compare two run ids; exit 1 on regression")
    p.add_argument("--list", action="store_true", help="list runs")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--z-threshold", type=float, default=Z_THRESHOLD)
    p.add_argument("--drop-threshold", type=float, default=DROP_THRESHOLD)
    args = p.parse_args(argv)

    runs = read_runs(args.dir)
    if not runs:
        print(f"no run journals under {args.dir}", file=sys.stderr)
        return 2
    order = sorted(runs, key=lambda r: runs[r].get("t0") or 0)

    if args.list:
        for rid in order:
            s = runs[rid]
            snap = _goodput_of(s)
            ratio = snap.get("goodput_ratio")
            ratio = f"{float(ratio):.1%}" if ratio is not None else "?"
            mark = "" if s.get("ended") else "  [killed]"
            print(f"{rid}  goodput={ratio}  records={s['records']}{mark}")
        return 0

    if args.diff:
        old_id, new_id = args.diff
        if old_id not in runs or new_id not in runs:
            missing = [r for r in (old_id, new_id) if r not in runs]
            print(f"unknown run id(s): {', '.join(missing)}",
                  file=sys.stderr)
            return 2
        lines, regressed = diff_runs(
            runs[old_id], runs[new_id], runs,
            z_threshold=args.z_threshold,
            drop_threshold=args.drop_threshold)
        if args.json:
            print(json.dumps({"regressed": regressed, "lines": lines}))
        else:
            print(f"diff {old_id} -> {new_id}")
            for line in lines:
                print(f"  {line}")
        return 1 if regressed else 0

    rid = args.run or order[-1]
    if rid not in runs:
        print(f"unknown run id: {rid}", file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(runs[rid], default=str))
        return 0
    for line in render_run(runs[rid]):
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
