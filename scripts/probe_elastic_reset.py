#!/usr/bin/env python3
"""Where an elastic reset's time goes on one GPU.

    python3 scripts/probe_elastic_reset.py [--cycles 5]

One fresh process per variant (so that no earlier group's threads are
left), each on cuda:0 in a world of one: bring the group up, run one
all_reduce (which creates the NCCL communicator), then ``--cycles`` times
take the group down, bring a new one up and run its first all_reduce,
each part timed on the host clock around work that ends in
``torch.cuda.synchronize()``. The variants:

- ``abort``: ``torch.distributed``'s ``_abort_process_group()``, which
  ``hvd.shutdown(abort=True)`` calls; ``destroy``:
  ``destroy_process_group()``, the orderly shutdown's;
- each under the default NCCL environment, ``no_monitor``
  (TORCH_NCCL_ENABLE_MONITORING=0: no heartbeat monitor thread) and
  ``async2`` (TORCH_NCCL_ASYNC_ERROR_HANDLING=2, which ``hvd.init`` sets
  under an elastic launch);
- ``hvd``: the port's own cycle, ``hvd.init()``, a fused allreduce (the
  scale kernels) and ``hvd.shutdown(abort=True)``, with the group's abort
  timed apart from the rest of the shutdown.

Prints one JSON line per variant (the median ms of each part and every
cycle's), then the card's name and power limit. Needs one CUDA device;
exits 1 without one.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS = {"default": {}, "no_monitor": {"TORCH_NCCL_ENABLE_MONITORING": "0"},
        "async2": {"TORCH_NCCL_ASYNC_ERROR_HANDLING": "2"}}


def _ms(t0):
    import torch
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def raw_cycle(mode, cycles):
    """The group alone: up, first all_reduce, down; ``cycles`` times."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def up():
        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        init = _ms(t0)
        t0 = time.perf_counter()
        dist.all_reduce(torch.ones(1 << 20, device=dev))
        return init, _ms(t0)

    up()
    rows = []
    for _ in range(cycles):
        t0 = time.perf_counter()
        if mode == "abort":
            dist.distributed_c10d._abort_process_group()
        else:
            dist.destroy_process_group()
        down = _ms(t0)
        rows.append((down,) + up())
    dist.destroy_process_group()
    return ["down_ms", "init_ms", "first_allreduce_ms"], rows


def hvd_cycle(cycles):
    """hvd.init(), a fused allreduce, hvd.shutdown(abort=True); the
    group's abort timed inside the shutdown."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.kernels import _build
    _build.build(("scale_buffers",))
    c10d = dist.distributed_c10d
    raw, spent = c10d._abort_process_group, []

    def timed_abort(*a, **kw):
        t0 = time.perf_counter()
        try:
            return raw(*a, **kw)
        finally:
            spent.append(_ms(t0))
    c10d._abort_process_group = timed_abort

    def up():
        t0 = time.perf_counter()
        hvd.init()
        init = _ms(t0)
        t0 = time.perf_counter()
        hvd.allreduce(torch.ones(1 << 20, device=hvd.device()))
        return init, _ms(t0)

    up()
    rows = []
    for _ in range(cycles):
        t0 = time.perf_counter()
        hvd.shutdown(abort=True)
        down = _ms(t0)
        rows.append((down, spent[-1]) + up())
    hvd.shutdown()
    return ["shutdown_abort_ms", "of_it_group_abort_ms", "init_ms",
            "first_allreduce_ms"], rows


def child(variant, cycles):
    cols, rows = hvd_cycle(cycles) if variant == "hvd" \
        else raw_cycle(variant.split("/")[0], cycles)
    print(json.dumps({
        "variant": variant,
        "median_ms": {c: statistics.median(r[i] for r in rows)
                      for i, c in enumerate(cols)},
        "columns": cols, "cycles": rows}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=5)
    ap.add_argument("--child")
    args = ap.parse_args(argv)
    if args.child:
        child(args.child, args.cycles)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("probe_elastic_reset: no CUDA device is visible",
              file=sys.stderr)
        return 1
    variants = [f"{m}/{e}" for e in ENVS for m in ("abort", "destroy")]
    for variant in variants + ["hvd"]:
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT, os.environ.get("PYTHONPATH", "")]))
        env.update(ENVS.get(variant.split("/")[-1], {}))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", variant,
             "--cycles", str(args.cycles)], env=env, cwd=ROOT, text=True,
            capture_output=True, timeout=600)
        lines = [line for line in out.stdout.splitlines()
                 if line.startswith('{"variant"')]
        if out.returncode != 0 or not lines:
            print(out.stdout[-2000:] + out.stderr[-4000:], file=sys.stderr)
            return 1
        print(lines[-1], flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as C
    print(C.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
