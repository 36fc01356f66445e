#!/usr/bin/env python3
"""Train the JAX package's VGG-16 and the port's side by side at SGD 0.1.

Both models start from the JAX model's own init (``VGG16.init``, carried
into the port through ``load_flax_vgg``), run in fp32 on the CPU with
dropout 0, and take the same seeded batch of 224 x 224 x 3 images and 1000
class labels at SGD(lr 0.1, momentum 0.9), bench.py's image recipe
(bench.py:727), for 8 steps. Printed: each step's two losses and their
relative distance, and after each step the parameter leaf the two trees
differ most in. A step where one loss is finite and the other is not, or
where they differ by more than ``--loss-rtol``, is where they part; the
script then names the leaf with the largest relative distance. A loss past
10 ln(1000) (ten times a uniform guess's) or not finite has diverged; the
last line says at which step each did.

The chip phase trains on 64 images; a CPU box holds fewer of them at fp32
with two models' activations (``--batch``, 16 by default: 7.5-7.8 GB
resident at its peak, 10-15 s a step on 8 cores). Run from anywhere, on
the CPU (about two minutes):

    python3 scripts/check_vgg_lr.py [--batch 16] [--steps 8] [--lr 0.1]
"""

import argparse
import os
import pathlib
import resource
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loss-rtol", type=float, default=1e-3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import torch
    import torch.nn.functional as F
    jax.config.update("jax_platforms", "cpu")
    from horovod_tpu.models import vgg as jvgg
    from horovod_tpu_torch.models import vgg as tvgg
    from horovod_tpu_torch.parallel.tp import FlaxKernel

    rng = np.random.default_rng(args.seed)
    x = rng.standard_normal((args.batch, 224, 224, 3)).astype(np.float32)
    y = rng.integers(0, 1000, (args.batch,)).astype(np.int32)
    jm = jvgg.VGG16(num_classes=1000, dtype=jnp.float32, dropout_rate=0.0,
                    train=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(args.seed),
                              jnp.asarray(x[:1]))["params"]
    tm = tvgg.load_flax_vgg(tvgg.VGG16(num_classes=1000, dtype=torch.float32,
                                       dropout_rate=0.0), params)
    tm.train()
    topt = torch.optim.SGD(tm.parameters(), lr=args.lr, momentum=0.9)
    jopt = optax.sgd(args.lr, momentum=0.9)
    jstate = jopt.init(params)

    @jax.jit
    def jstep(p, s, xb, yb):
        def loss_fn(p):
            logits = jm.apply({"params": p}, xb)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, yb).mean()
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = jopt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    named = dict(tm.named_parameters())
    parted, diverged = None, {}
    print(f"VGG-16, fp32, batch {args.batch} x 224 x 224 x 3, SGD(lr "
          f"{args.lr}, momentum 0.9), {args.steps} steps, seed {args.seed}",
          flush=True)
    for step in range(1, args.steps + 1):
        t0 = time.perf_counter()
        params, jstate, jloss = jstep(params, jstate, xj, yj)
        jloss = float(jloss)
        topt.zero_grad()
        tloss = F.cross_entropy(tm(xt), yt)
        tloss.backward()
        topt.step()
        tloss = float(tloss.detach())
        for name, v in (("jax", jloss), ("port", tloss)):
            if name not in diverged and not (np.isfinite(v)
                                             and v < 10 * np.log(1000)):
                diverged[name] = step
        worst, worst_rel = None, -1.0
        for path, leaf in leaves(params):
            name = path.replace("/", ".").replace("kernel", "weight")
            p = named[name].detach()
            if isinstance(named[name], FlaxKernel):
                p = FlaxKernel.to_flax(p)
            a, b = np.asarray(leaf), p.numpy()
            rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
            if not np.isfinite(rel):
                rel = float("inf")
            if rel > worst_rel:
                worst, worst_rel = path, rel
        rel_loss = abs(jloss - tloss) / max(abs(jloss), 1e-30)
        finite = (np.isfinite(jloss), np.isfinite(tloss))
        print(f"step {step}: jax {jloss!r} port {tloss!r} rel "
              f"{rel_loss:.3e}; most apart leaf {worst} ({worst_rel:.3e}); "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if parted is None and (finite[0] != finite[1] or (
                all(finite) and rel_loss > args.loss_rtol)):
            parted = (step, worst)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    print(f"peak resident {peak:.1f} GB")
    # diverged: the loss past 10 x ln(1000), ten times a uniform guess's
    print("; ".join(f"{name} diverged at step {diverged[name]}"
                    if name in diverged else f"{name} did not diverge"
                    for name in ("jax", "port")) + "; "
          + ("the losses part first at step %d (leaf %s)" % parted
             if parted else "the losses stay within "
             f"{args.loss_rtol} of each other while both are finite"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
