#!/usr/bin/env python3
"""Show how the JAX package's composite trainer updates its experts.

One SGD step (lr 1, no aux loss) of ``horovod_tpu.parallel.composite``'s
``CompositeGPT`` (GPT tiny with a shared 4-expert MoE FFN, no-drop
capacity) at (dp 2, pp 1, tp 1), and the same step from the same weights at
(1, 1, 1) on the whole batch, on the virtual CPU mesh. Prints, for the
experts' ``w_in`` and ``w_out``: how far the dp = 2 update is from the
single-device one, and from each dp block taking the sum of both blocks'
single-device updates (what averaging the two ranks' expert gradients over
dp, each the block's gradient times dp, gives); and how far the
replicated token embedding's update is. Run from anywhere:

    python3 scripts/check_jax_composite_experts.py
"""

import os
import pathlib
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_enable_concurrency_optimized_scheduler"
                           "=false")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    jax.config.update("jax_platforms", "cpu")
    from horovod_tpu.models.gpt import GPTConfig
    from horovod_tpu.parallel.composite import CompositeGPT, build_mesh3d

    cfg = GPTConfig.tiny(vocab_size=64, hidden_size=32, num_layers=2,
                         num_heads=4, intermediate_size=64,
                         max_position_embeddings=16, num_experts=4,
                         capacity_factor=4.0)
    ids = jnp.asarray(np.random.default_rng(0).integers(0, 64, (8, 16)),
                      jnp.int32)
    updates, p0 = {}, None
    for dp in (2, 1):
        mesh = build_mesh3d(dp=dp, pp=1, tp=1, devices=jax.devices()[:dp])
        comp = CompositeGPT(cfg, mesh, optax.sgd(1.0), n_micro=2,
                            aux_weight=0.0)
        params, opt, specs = comp.init(jax.random.PRNGKey(0), ids)
        if p0 is None:
            p0 = jax.tree_util.tree_map(np.asarray, params)
        else:                                  # the same weights
            params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(jnp.asarray(x), s.sharding),
                p0, params)
            opt = comp.optimizer.init(params)
        step = comp.make_train_step(specs, donate=False)
        new, _, _ = step(params, opt, ids)
        updates[dp] = jax.tree_util.tree_map(
            lambda a, b: np.asarray(a) - np.asarray(b), p0, new)

    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    for leaf in ("w_in", "w_out"):
        two, one = updates[2]["moe"][leaf], updates[1]["moe"][leaf]
        half = one.shape[0] // 2
        summed = np.concatenate([one[:half] + one[half:]] * 2)
        print(f"{leaf}: dp=2 vs single-device {rel(two, one):.3g}; vs each "
              f"block the sum of both blocks {rel(two, summed):.3g}")
    emb = ("embed", "tok_emb", "embedding")
    two, one = updates[2], updates[1]
    for k in emb:
        two, one = two[k], one[k]
    print(f"tok_emb: dp=2 vs single-device {rel(two, one):.3g}")


if __name__ == "__main__":
    main()
