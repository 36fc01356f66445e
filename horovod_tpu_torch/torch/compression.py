"""Gradient compression for the ``horovod.torch`` surface (reference:
horovod/torch/compression.py). The port's collectives take torch tensors
directly, so the frontend's compressors are the ops layer's, with
``Compression.powersgd``'s marker (``optim/powersgd.py``)."""

from horovod_tpu_torch.ops.compression import (BF16Compressor, Compression,
                                               Compressor, FP16Compressor,
                                               Int8Compressor, NoneCompressor)
from horovod_tpu_torch.optim.powersgd import PowerSGDCompressor

__all__ = ["Compression", "Compressor", "NoneCompressor", "FP16Compressor",
           "BF16Compressor", "Int8Compressor", "PowerSGDCompressor"]
