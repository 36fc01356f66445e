"""Optimizer-side pieces of the port (the JAX package's ``optim/``): the
chunked next-token loss and PowerSGD's functional core. The
``torch.optim`` wrapper is ``horovod_tpu_torch.torch.DistributedOptimizer``."""

from horovod_tpu_torch.optim.losses import next_token_xent_chunked  # noqa: F401
