"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Sources live in ``csrc/`` and are compiled with nvcc on first use
(``_build``)."""

from horovod_tpu_torch.ops.kernels import adasum, flash_attention, scale_buffers
from horovod_tpu_torch.ops.kernels.adasum import (
    adasum_combine_reference, combine_level, combine_level_reference,
    combine_pairs, combine_segments, combine_segments_reference,
    reduce_gathered_reference, schedule, segment_table)
from horovod_tpu_torch.ops.kernels.flash_attention import (fa_backward,
                                                            fa_forward)
from horovod_tpu_torch.ops.kernels.scale_buffers import (
    pack_scale, pack_scale_reference, unpack_scale, unpack_scale_reference)

__all__ = ["adasum", "flash_attention", "scale_buffers",
           "adasum_combine_reference", "combine_level",
           "combine_level_reference", "combine_pairs", "combine_segments",
           "combine_segments_reference", "reduce_gathered_reference",
           "schedule", "segment_table", "fa_forward", "fa_backward",
           "pack_scale", "pack_scale_reference", "unpack_scale",
           "unpack_scale_reference"]
