"""Gradient compression for the wire.

Port of the JAX package's ``ops/compression.py`` on torch tensors
(reference: horovod/torch/compression.py): ``Compression.none``,
``Compression.fp16`` — cast floating tensors to fp16 before the allreduce and
back after — ``Compression.bf16``, the same with bfloat16, and
``Compression.int8``, a routing marker into the quantized wire
(``ops/wire.py``), and ``Compression.powersgd(rank)``, the stateful
low-rank marker that only ``DistributedOptimizer`` honors
(``optim/powersgd.py``): its ``compress`` raises, so an allreduce handed it
raises, as JAX's ``fused_allreduce_tree`` does.
"""

import torch


class Compressor:
    """Interface: compress returns (compressed, ctx); decompress restores."""

    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    """reference: compression.py NoneCompressor."""

    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class _CastCompressor(Compressor):
    wire_dtype = None

    @classmethod
    def compress(cls, tensor):
        if tensor.is_floating_point() and tensor.dtype != cls.wire_dtype:
            return tensor.to(cls.wire_dtype), tensor.dtype
        return tensor, None

    @classmethod
    def decompress(cls, tensor, ctx):
        return tensor if ctx is None else tensor.to(ctx)


class FP16Compressor(_CastCompressor):
    """reference: compression.py FP16Compressor."""
    wire_dtype = torch.float16


class BF16Compressor(_CastCompressor):
    wire_dtype = torch.bfloat16


class Int8Compressor(Compressor):
    """int8 on the wire. An int8 tensor cannot ride an ordinary allreduce
    (n int8s overflow and the ranks' scales differ), so compress and
    decompress are routing markers: ``compress()`` arms a one-shot request
    that the allreduce it precedes consumes, and the block-scaled exchange
    quantizes inside the collective (``wire.block_scaled_allreduce``: int8
    on both legs, fp32 accumulation, one scale per 1024 elements, error
    feedback). Lossy: each leg adds at most its block's max/254 per
    element. Payloads the exchange cannot take (non-Sum/Average ops,
    fewer than n×1024 elements, float64 or integer tensors) stay exact."""

    @staticmethod
    def compress(tensor):
        from horovod_tpu_torch.ops import wire
        wire.request_wire_once("int8")
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


def _powersgd(rank=4, min_compression_rate=2.0, ef_dtype=None):
    """The stateful PowerSGD marker (low-rank factor exchange with error
    feedback; honored by DistributedOptimizer only). ``ef_dtype`` keeps the
    residual in a wider dtype than the gradients (torch.float32 under bf16
    training)."""
    from horovod_tpu_torch.optim.powersgd import PowerSGDCompressor
    return PowerSGDCompressor(rank=rank,
                              min_compression_rate=min_compression_rate,
                              ef_dtype=ef_dtype)


class Compression:
    """reference: compression.py Compression namespace."""
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BF16Compressor
    int8 = Int8Compressor
    powersgd = staticmethod(_powersgd)
