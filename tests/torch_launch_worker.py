"""A worker for ``python -m horovod_tpu_torch.runner`` in the port's CPU
tests: ``python torch_launch_worker.py OUT_DIR SEED [FAIL_RANK]``.

On gloo (``hvd.init(device="cpu")``) it allreduces (Sum and Average, fused)
and broadcasts (root 1) this rank's rows of inputs drawn from SEED, and
writes its HOROVOD_* contract, pid and results to OUT_DIR/rank<r>.json. A
rank equal to FAIL_RANK exits 1 after writing; the others then wait in a
collective that never completes, for the launcher to reap them.
"""

import json
import os
import sys

import numpy as np
import torch


def inputs(seed, size):
    gen = np.random.default_rng(seed)
    return gen.standard_normal((2, size, 6)).astype(np.float32)


def main():
    out_dir, seed = sys.argv[1], int(sys.argv[2])
    fail = int(sys.argv[3]) if len(sys.argv) > 3 else -1
    import horovod_tpu_torch as hvd
    hvd.init(device="cpu")
    rank, size = hvd.rank(), hvd.size()
    x = torch.from_numpy(inputs(seed, size)[:, rank])
    out = {"env": {k: os.environ[k] for k in sorted(os.environ)
                   if k.startswith("HOROVOD_") and "SECRET" not in k},
           "rank": rank, "size": size, "local_rank": hvd.local_rank(),
           "pid": os.getpid(),
           "sum": hvd.allreduce(x[0], op=hvd.Sum).tolist(),
           "average": hvd.allreduce(x[1], op=hvd.Average).tolist(),
           "broadcast": hvd.broadcast(x[0], root_rank=1).tolist()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if rank == fail:
        sys.exit(1)
    if fail >= 0:
        hvd.allreduce(x[0], op=hvd.Sum)     # never completes: rank `fail`
    hvd.shutdown()


if __name__ == "__main__":
    main()
