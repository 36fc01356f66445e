"""Elastic training for the PyTorch/CUDA port: ``State``/``ObjectState``,
the ``run`` retry loop, and the worker side of the elastic driver's
membership protocol. ``TorchState`` and ``ElasticSampler`` are in
``horovod_tpu_torch.torch.elastic``. ``sharded`` re-partitions ZeRO-1 and
FSDP state across a membership change (the JAX package's
``elastic/sharded.py``; its KV-cache resharding comes with ROADMAP A15)."""

from horovod_tpu_torch.elastic.state import ObjectState, State, run  # noqa: F401
from horovod_tpu_torch.elastic.worker import (  # noqa: F401
    HostUpdateListener, attach_listener, mark_new_rank_ready,
    read_new_rank_ready,
)
from horovod_tpu_torch.elastic.sharded import (  # noqa: F401
    fsdp_reshard, fsdp_restore, gather_to_host, zero_reshard, zero_restore,
)
