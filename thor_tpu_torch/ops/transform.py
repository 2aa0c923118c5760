"""Batched integer inverse transform (torch port of thor_tpu/ops/transform.py).

Bit-exact with spec.transform_quant.transform_inv.  CUDA has no integer
GEMM in torch, and a bf16 product rounds, so each stage is a float64
matrix product: every input is an int16 value, every |T| <= 90 and a
stage sums at most 32 terms, so each partial sum is an integer below
2^27, exact in float64 in any summation order and on any device.
"""
from __future__ import annotations

import torch

from .._host import tables as T
from ..tables import to_device


def _i16(x):
    """Wrap to int16 like a C (int16_t) cast, staying in the input dtype."""
    return ((x + 32768) & 0xFFFF) - 32768


def _dot(a, b):
    """Exact a @ b for integer a (int16 range) and float64 table b."""
    return torch.matmul(a.to(torch.float64), b).to(torch.int64)


def inv_transform_batch(coeff: torch.Tensor, size: int, bitdepth: int = 8):
    """Inverse transform a batch of blocks.

    coeff: [B, size, size] integer (int16-range values; only the top-left
    min(16,size)^2 nonzero).  Returns [B, size, size] int32 residuals.
    Mirrors spec.transform_quant.transform_inv."""
    if size >= 64:
        scale = size // 32
        blk = inv_transform_batch(coeff[:, :32, :32], 32, bitdepth)
        return blk.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
    qsize = min(size, T.MAX_QUANT_SIZE)
    Tm = to_device(coeff.device)["transform"][size][:qsize]  # [qsize, size]
    c = coeff[:, :qsize, :qsize]
    shift_2 = 20 - bitdepth
    add_2 = 1 << (shift_2 - 1)
    # stage 1: tmp[b,i,j] = clip((sum_k T[k,j] * c[b,k,i] + 64) >> 7)
    tmp = ((_dot(c.transpose(1, 2), Tm) + 64) >> 7).clamp(-32768, 32767)
    # stage 2: out[b,i,j] = clip((sum_k T[k,j] * tmp[b,k,i] + a2) >> s2)
    out = ((_dot(tmp.transpose(1, 2), Tm) + add_2) >> shift_2).clamp(
        -32768, 32767)
    return out.to(torch.int32)
