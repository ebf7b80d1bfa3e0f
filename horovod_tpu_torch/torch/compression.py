"""Gradient compression (torch flavor).

The port's own copy of ``horovod_tpu/torch/compression.py``.
"""

import torch


class Compressor:
    @staticmethod
    def compress(tensor):
        raise NotImplementedError

    @staticmethod
    def decompress(tensor, ctx):
        raise NotImplementedError


class NoneCompressor(Compressor):
    @staticmethod
    def compress(tensor):
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor


class FP16Compressor(Compressor):
    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != torch.float16:
            return tensor.to(torch.float16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class BFloat16Compressor(Compressor):
    """2x compression with f32's exponent range (no overflow
    handling needed)."""

    @staticmethod
    def compress(tensor):
        if tensor.dtype.is_floating_point and tensor.dtype != torch.bfloat16:
            return tensor.to(torch.bfloat16), tensor.dtype
        return tensor, None

    @staticmethod
    def decompress(tensor, ctx):
        return tensor.to(ctx) if ctx is not None else tensor


class Compression:
    none = NoneCompressor
    fp16 = FP16Compressor
    bf16 = BFloat16Compressor
