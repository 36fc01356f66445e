#!/usr/bin/env python3
"""Where the MoE GPT's training step goes, on one GPU.

Dense GPT-2 small and the MoE GPT (``chip_smoke.py``'s ``train_gpt_moe``
config) in turns (dense, moe, moe, dense): tokens/s, device busy ms and
share (torch.profiler), the top device kernels, the top host ops by self
CPU time, and the host-device syncs (cudaStreamSynchronize, item, DtoH).
Compare the modes only within one call. Run from the repository's root:

    python3 scripts/probe_moe_step.py

(about a minute on an H100, the kernels' build included); one JSON
line."""
import json, os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs


def main():
    import torch
    import torch.nn.functional as F
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import GPT
    from torch.profiler import ProfilerActivity, profile
    dev = torch.device("cuda", 0)
    card = cs.phase_env(torch)
    cs.phase_build()
    hvd.init()

    def build(moe):
        cfg = cs.moe_config(torch, None) if moe else cs.gpt_config(torch, True)
        m = GPT(cfg, generator=torch.Generator().manual_seed(0)).to(dev).train()
        opt = torch.optim.AdamW(m.parameters(), lr=1e-4, weight_decay=1e-4)
        opt = hvd.DistributedOptimizer(opt, named_parameters=m.named_parameters())
        ids = cs.gpt_batch(torch, m, dev, 0)
        loss = (lambda: cs.moe_loss(F, m, ids)) if moe else \
            (lambda: cs.next_token_loss(F, m(ids), ids))

        def step():
            opt.zero_grad()
            v = loss()
            v.backward()
            opt.step()
            return v.detach()
        return m, opt, step

    out = {}
    for name in ("dense", "moe", "moe", "dense"):
        m, opt, step = build(name != "dense")
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        tps = 5 * cs.GPT_BATCH * cs.GPT_SEQ / (time.perf_counter() - t0)
        busy, share = cs.device_ms(torch, step, steps=2)
        r = out.setdefault(name, {"tokens_per_sec": [], "device_ms": [],
                                  "busy_share": []})
        r["tokens_per_sec"].append(tps)
        r["device_ms"].append(busy)
        r["busy_share"].append(share)
        if "top" not in r:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                step()
                torch.cuda.synchronize()
            ka = prof.key_averages()
            r["top_self_cpu_ms"] = [
                (e.key, round(e.self_cpu_time_total / 1e3, 3), e.count)
                for e in sorted(ka, key=lambda e: -e.self_cpu_time_total)[:25]]
            dev_t = lambda e: getattr(e, "self_device_time_total",
                                      getattr(e, "self_cuda_time_total", 0))
            r["top_device_ms"] = [
                (e.key[:90], round(dev_t(e) / 1e3, 3), e.count)
                for e in sorted(ka, key=lambda e: -dev_t(e))[:20]]
            r["syncs"] = {e.key: e.count for e in ka if any(
                s in e.key for s in ("Synchronize", "_local_scalar_dense",
                                     "aten::item", "cudaMemcpy",
                                     "nonzero"))}
            r["top"] = True
            r["cpu_ops"] = sum(e.count for e in ka if e.key.startswith("aten::"))
        opt._remove_hooks()
        del m, opt, step
        torch.cuda.empty_cache()
    print(json.dumps({"probe": "moe_step", **out, "card": card}), flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
