#!/usr/bin/env python3
"""Time the Adasum level kernel (csrc/adasum.cu) on one GPU, as built from
the checkout or with a part of it cut out, at ResNet-50's two fp32 Adasum
buckets: one tree level at K = 2 (rows 0 and 1 of a gathered bucket, in
place), CUDA events, median of 30 runs of 10 launches.

    python3 scripts/probe_adasum_level.py
        [--cut none|nosync|nostore|nosync_nostore] [--yardsticks]

``--cut`` takes parts of the kernel out, to see what each costs: the
units' completion (no arrival, no finishing, coefficients 1), the stores,
or both. Such a variant is compiled from a copy of the source under
build/probe/; its results are wrong by design, so only its times count.
The kernel as built is held against the tile-order plain version, and the
script exits 1 if a bucket's max |kernel - plain| / max |plain| passes
ADASUM_TOL. ``--yardsticks`` also times ``torch.add`` of the two rows (the
same 3 N x 4 bytes) and a copy of one. Prints one JSON line with the
card's name and power limit. Needs one CUDA device; exits 1 without one.
"""

import argparse
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "horovod_tpu_torch/ops/kernels/csrc/adasum.cu"
ADASUM_TOL = 1e-5        # fp32, as chip_smoke.py holds the kernel
CUTS = {
    "nosync": [
        ("    AtomicU64(counts[st.tile.unit]).fetch_add(1ull, "
         "cuda::memory_order_release);", ""),
        ("  if (t != static_cast<int64_t>(st.tile.first) + st.tile.ntiles - 1)"
         " return;", "  return;"),
        ("  if (threadIdx.x == 0) *shared_coef = await_coef(st.tile, words, "
         "epoch);", "  if (threadIdx.x == 0) *shared_coef = "
         "make_float2(1.f, 1.f);")],
    "nostore": [
        ("  store_tile(out + st.tile.a_off, sa, st.ma, sb, st.mb, "
         "st.tile.len, c.x, c.y);", "")],
}
CUTS["nosync_nostore"] = CUTS["nosync"] + CUTS["nostore"]


def event_ms(torch, fn):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(30):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 10)
    return statistics.median(times)


def variant(cut):
    """The csrc directory to build: the checkout's, or a copy with the
    source lines of ``cut`` replaced."""
    if cut == "none":
        return SRC.parent
    new = SRC.read_text()
    for old, repl in CUTS[cut]:
        if old not in new:
            raise SystemExit(f"cut {cut}: source line not found: {old}")
        new = new.replace(old, repl)
    d = ROOT / "build" / "probe" / cut / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    (d / "adasum.cu").write_text(new)
    shutil.copy(SRC.with_name("cvt.cuh"), d)
    return d


def resnet50_buckets(ResNet50):
    """The fp32 Adasum buckets of the path: gradients in the order their
    hooks fire, cut at the 64 MiB fusion threshold."""
    numels = [p.numel() for p in ResNet50(num_classes=1000).parameters()]
    buckets, cur = [], []
    for n in reversed(numels):
        if sum(cur) + n > 16 * 1024 * 1024:
            buckets.append(cur)
            cur = []
        cur.append(n)
    return buckets + [cur]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cut", choices=("none",) + tuple(CUTS), default="none")
    ap.add_argument("--yardsticks", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("probe_adasum_level: no CUDA device is visible",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops.kernels import _build
    from horovod_tpu_torch.ops.kernels import adasum as ak

    csrc = variant(args.cut)
    if csrc != SRC.parent:
        _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent / "lib"
    _build.build(("adasum",))
    ptxas = [v for k, v in _build.ptxas_report("adasum").items()
             if "level" in k and "IfE" in k]
    dev = torch.device("cuda", 0)
    rows = []
    for bucket in resnet50_buckets(ResNet50):
        total = sum(bucket)
        g = torch.randn(2, total, device=dev)
        flat = g.view(-1)
        sched = ak.schedule(bucket, ak.level_pairs(2, 1), total,
                            torch.float32, dev)
        want = flat.clone()
        ak.combine_level_reference(want, want, want, sched)
        got = flat.clone()
        ak.launch_level(got, got, got, sched)
        torch.cuda.synchronize()
        got, want = got[:total], want[:total]   # row 0
        rows.append({
            "elements": total, "steps": sched.steps, "grid": sched.grid,
            "tile": sched.tile, "empty": sched.tiles.count(None),
            "late": sum(r[3] < 0 for r in ak.tile_rows(
                sched.units, sched.tiles, sched.grid)),
            "max_rel": ((got - want).abs().max()
                        / want.abs().max()).item(),
            "ms": event_ms(torch, lambda: ak.launch_level(flat, flat, flat,
                                                          sched))})
        if args.yardsticks:
            out = torch.empty(total, device=dev)
            rows[-1]["add_ms"] = event_ms(
                torch, lambda: torch.add(g[0], g[1], out=out))
            rows[-1]["copy_ms"] = event_ms(torch, lambda: out.copy_(g[0]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ms = sum(r["ms"] for r in rows)
    bound = 3 * sum(r["elements"] for r in rows) * 4 / 3.35e12 * 1e3
    checked = args.cut == "none"
    ok = not checked or all(r["max_rel"] <= ADASUM_TOL for r in rows)
    print(json.dumps({**vars(args), "ptxas": ptxas, "ms": ms,
                      "bound_ms": bound, "bound_share": bound / ms,
                      "checked_against_plain": checked,
                      "tolerance": ADASUM_TOL, "ok": ok,
                      "buckets": rows, "card": card}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
