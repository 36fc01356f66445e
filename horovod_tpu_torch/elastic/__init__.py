"""Elastic training for the PyTorch/CUDA port: ``State``/``ObjectState``,
the ``run`` retry loop, and the worker side of the elastic driver's
membership protocol. ``TorchState`` and ``ElasticSampler`` are in
``horovod_tpu_torch.torch.elastic``. The JAX package's ``elastic/sharded.py``
(ZeRO, FSDP and KV-cache resharding) comes with ROADMAP A12 and A15."""

from horovod_tpu_torch.elastic.state import ObjectState, State, run  # noqa: F401
from horovod_tpu_torch.elastic.worker import (  # noqa: F401
    HostUpdateListener, attach_listener, mark_new_rank_ready,
    read_new_rank_ready,
)
