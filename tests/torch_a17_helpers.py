"""The scenario of the port's control-plane tests.

``control_plane_world`` runs in every process of a 4-rank gloo world (2
slices of 2) that ``torch_port_helpers.run_world`` starts, and returns plain
values for the parent to hold against the JAX package's functions. This
module imports torch and the port only, never JAX.
"""

import json
import os

import torch

# Bucket sizes a rank (elements), fp32 and bf16 among them.
BUCKET = ((700, "float32"), (1500, "float32"), (333, "bfloat16"),
          (2048, "float32"))


def payload(rank, rnd):
    """Rank ``rank``'s negotiation payload of round ``rnd``."""
    return {"r": rank, "round": rnd, "sizes": [rank * 7 + rnd, rnd % 3]}


def _fused(seed, rank, tag):
    """One grouped async allreduce of BUCKET (Sum) and one of single
    tensors, on the runtime the knobs build: values and bucket
    signatures."""
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.fusion import get_runtime
    rt = get_runtime()
    gen = torch.Generator().manual_seed(seed + rank)
    ts = [torch.randn(n, generator=gen).to(getattr(torch, dt))
          for n, dt in BUCKET]
    mark = len(rt.recent_buckets(4096))
    hs = hvd.grouped_allreduce_async(ts, op=hvd.Sum, name=f"{tag}.grouped")
    hs += [hvd.allreduce_async(t, op=hvd.Sum, name=f"{tag}.{i}")
           for i, t in enumerate(ts)]
    vals = [h.synchronize().float().numpy().copy() for h in hs]
    buckets = rt.recent_buckets(4096)[mark:]
    return vals, [(why, sig[4], [n for _, n in sig[-1]])
                  for why, sig in buckets], rt._cp_role


def _chaos_schedule(rank, kv_port, ledger_dir, plan):
    """The KV calls of one scripted stretch under ``plan``: the ledger's
    schedule, the retries the drops cost, and whether every call came
    through."""
    from horovod_tpu_torch.chaos import injector
    from horovod_tpu_torch.metrics import instruments
    from horovod_tpu_torch.runner.http_kv import KVStoreClient
    os.environ["HOROVOD_CHAOS_PLAN"] = json.dumps(plan)
    os.environ["HOROVOD_CHAOS_LEDGER"] = ledger_dir
    injector.install_from_env()
    retries0 = instruments.KV_CLIENT_RETRIES.labels().get()
    client = KVStoreClient("127.0.0.1", kv_port, secret="",
                           backoff_ms=1.0, backoff_max_ms=4.0)
    ok = True
    for i in range(6):
        client.put(f"chaos{rank}", str(i), str(i * rank).encode())
        ok &= client.get(f"chaos{rank}", str(i)) == str(i * rank).encode()
    retries = instruments.KV_CLIENT_RETRIES.labels().get() - retries0
    sched = injector.ledger_schedule(injector.read_ledger(ledger_dir))
    injector.uninstall()
    for k in ("HOROVOD_CHAOS_PLAN", "HOROVOD_CHAOS_LEDGER"):
        os.environ.pop(k, None)
    return sched, retries, ok


def control_plane_world(rank, size, seed, rounds, kv_port, ledger_root):
    from horovod_tpu_torch import metrics
    from horovod_tpu_torch.common import basics, negotiation
    from horovod_tpu_torch.common.exceptions import TensorShapeMismatchError
    from horovod_tpu_torch.ops import fusion
    import horovod_tpu_torch as hvd
    metrics.set_enabled(True)
    out = {"rank": rank}
    # Negotiation: the same rounds flat, then hierarchical.
    for mode in ("flat", "hier"):
        os.environ["HOROVOD_CONTROL_PLANE"] = mode
        s0 = negotiation.stats_snapshot()
        got = [negotiation.exchange("cp_test", payload(rank, r))
               for r in range(rounds)]
        s1 = negotiation.stats_snapshot()
        out[f"exchange_{mode}"] = got
        out[f"stats_{mode}"] = {k: s1[k] - s0[k] for k in s1}
    # Fused buckets on a flat boundary stream, then on the hierarchical one
    # (a new runtime in a namespace of its own).
    os.environ["HOROVOD_CONTROL_PLANE"] = "flat"
    for mode in ("flat", "hier"):
        os.environ["HOROVOD_CONTROL_PLANE"] = mode
        s0 = negotiation.stats_snapshot()
        vals, buckets, role = _fused(seed, rank, "cp")
        hvd.barrier()
        s1 = negotiation.stats_snapshot()
        out[f"fused_{mode}"] = {"vals": vals, "buckets": buckets,
                                "role": role,
                                "stats": {k: s1[k] - s0[k] for k in s1}}
        fusion.reset_runtime()
    # The order check: rank 0 broadcasts where the others allgather.
    cfg = basics._get_state().config
    cfg.order_check = True
    x = torch.ones(3, 2)
    try:
        if rank == 0:
            hvd.broadcast(x, 0)
        else:
            hvd.allgather(x)
        out["order_mismatch"] = None
    except TensorShapeMismatchError as e:
        out["order_mismatch"] = str(e)
    same = hvd.allgather(x)         # matching calls pass the check
    out["order_match_rows"] = int(same.shape[0])
    cfg.order_check = False
    # Chaos: drops on the KV client's first two attempts, then a seeded
    # probabilistic delay; the same plan twice gives the same schedule.
    plan = {"seed": seed, "faults": [
        {"site": "http_kv.request", "kind": "drop", "at": [0, 1]},
        {"site": "http_kv.request", "kind": "delay", "p": 0.5,
         "delay_ms": 1.0}]}
    runs = [_chaos_schedule(rank, kv_port,
                            os.path.join(ledger_root, f"r{rank}_{i}"), plan)
            for i in range(2)]
    out["chaos"] = [{"schedule": s, "retries": r, "ok": ok}
                    for s, r, ok in runs]
    os.environ.pop("HOROVOD_CONTROL_PLANE", None)
    return out

