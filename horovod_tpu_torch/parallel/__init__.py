"""Parallel strategies over in-step mesh axes (``ops/in_step.py``): data
(``dp``), tensor (``tp``), sequence (``sequence``), sharded (``fsdp``),
pipeline (``pp``), expert (``moe``) and their composite."""

from horovod_tpu_torch.parallel.pp import (  # noqa: F401
    pipeline, pipeline_1f1b, split_microbatches, stack_stage_params,
)
from horovod_tpu_torch.parallel.moe import MoEMlp  # noqa: F401
from horovod_tpu_torch.parallel.composite import (  # noqa: F401
    CompositeGPT, CompositeLlama, build_mesh3d, build_mesh4d,
)
