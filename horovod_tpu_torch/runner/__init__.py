"""hvdrun-torch: the launcher of the PyTorch/CUDA port.

Reference: horovod/runner/ (CLI launch.py, gloo_run, HTTP rendezvous), through
the JAX package's ``runner/``. One process per slot (GPU) joins one
``torch.distributed`` process group; the launcher's job is host bookkeeping,
the per-slot env contract, ssh/mpirun/jsrun fan-out and reaping. Elastic
launches (``--min-np``/``--max-np``/``--host-discovery-script``) run
``elastic/driver.py``, one worker per slot of each membership version.

    python -m horovod_tpu_torch.runner -np 4 -H localhost:4 python train.py
"""

from horovod_tpu_torch.runner.api import run, run_elastic  # noqa: F401
