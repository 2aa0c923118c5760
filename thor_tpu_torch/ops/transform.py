"""Batched integer forward and inverse transforms, static-qp
dequantization and reconstruction (torch port of
thor_tpu/ops/transform.py).

Bit-exact with thor_tpu/spec/transform_quant.py:transform_fwd and
transform_inv.  CUDA has no integer
GEMM in torch, and a bf16 product rounds, so each stage is a float64
matrix product: every input is an int16 value, every |T| <= 90 and a
stage sums at most 32 terms, so each partial sum is an integer below
2^27, exact in float64 in any summation order and on any device.
"""
from __future__ import annotations

import torch

from .. import tables as T
from ..tables import to_device


def _i16(x):
    """Wrap to int16 like a C (int16_t) cast, staying in the input dtype."""
    return ((x + 32768) & 0xFFFF) - 32768


def _i32(x):
    """An int64 tensor wrapped to int32 as int32 arithmetic wraps (a JAX
    sum of int32 values stays int32; torch sums them into int64)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _dot(a, b):
    """Exact a @ b for integer a (int16 range) and float64 table b."""
    return torch.matmul(a.to(torch.float64), b).to(torch.int64)


def inv_transform_batch(coeff: torch.Tensor, size: int, bitdepth: int = 8):
    """Inverse transform a batch of blocks.

    coeff: [B, size, size] integer (int16-range values; only the top-left
    min(16,size)^2 nonzero).  Returns [B, size, size] int32 residuals.
    Mirrors thor_tpu/spec/transform_quant.py:transform_inv."""
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


def fwd_transform_batch(block: torch.Tensor, size: int, fast: bool = False,
                        bitdepth: int = 8):
    """Forward transform a batch of residual blocks.

    block: [B, size, size] integer (int16-range values).  Returns
    [B, qsize, qsize] int32 coefficients (qsize = min(16, size)).  Mirrors
    thor_tpu/ops/transform.py:fwd_transform_batch: sizes above 32 (16
    when `fast`) first sum scale x scale sample groups with a saturating
    int16 add, and both stages saturate to int16.  Each stage is a float64
    product like the inverse's (inputs within int16, |T| <= 90, at most 32
    terms: exact)."""
    qsize = min(size, T.MAX_QUANT_SIZE)
    size1 = size
    scale = 1
    inb = block.to(torch.int64)
    lim = 32 >> int(fast)
    if size > lim:
        size1 = lim
        scale = size // size1
        s = inb.reshape(-1, size1, scale, size1, scale)
        acc = torch.zeros((inb.shape[0], size1, size1), dtype=torch.int64,
                          device=block.device)
        for m in range(scale):
            for n in range(scale):
                acc = (acc + s[:, :, m, :, n]).clamp(-16384, 16383)
        inb = acc
    Tm = to_device(block.device)["transform"][size1]
    shift_1 = T.log2i(size) + T.log2i(scale) + bitdepth - 8
    add_1 = 1 << (shift_1 - 1)
    shift_2 = T.log2i(size1) + 5
    add_2 = 1 << (shift_2 - 1)
    TqT = Tm[:qsize].T
    # stage 1: tmp[b,i,j] = sum_k T[i,k]*in[b,j,k]; computed as [b,j,i]
    tmpT = ((_dot(inb, TqT) + add_1) >> shift_1).clamp(-32768, 32767)
    tmp = tmpT.transpose(1, 2)
    # stage 2: coeff[b,i,j] = sum_k T[i,k]*tmp[b,j,k]; via [b,j,i] + T
    coeffT = ((_dot(tmp, TqT) + add_2) >> shift_2).clamp(-32768, 32767)
    return coeffT.transpose(1, 2).to(torch.int32)


def dequantize_batch(coeff, qp: int, size: int, iwmatrix=None,
                     weighted: bool = False):
    """Dequantize a batch at one static qp: [B,>=qsize,>=qsize] integer ->
    [B,size,size] int32.  The product runs in int64 and is then wrapped to
    int16, as thor_tpu/ops/transform.py:dequantize_batch does; with
    `weighted`, each coefficient is first multiplied by `iwmatrix`
    ([>=qsize,>=qsize] inverse weights, INV_WEIGHT_SHIFT-scaled)."""
    lshift = qp // 6
    qsize = min(size, T.MAX_QUANT_SIZE)
    rshift = T.log2i(size) - 1 + (T.INV_WEIGHT_SHIFT if weighted else 0)
    scale = int(T.GDEQUANT[qp % 6])
    c = coeff[:, :qsize, :qsize].to(torch.int64)
    if weighted:
        c = c * iwmatrix[None, :qsize, :qsize].to(torch.int64)
    if lshift >= rshift:
        r = (c * scale) << (lshift - rshift)
    else:
        add = 1 << (rshift - lshift - 1)
        r = (c * scale + add) >> (rshift - lshift)
    r = _i16(r).to(torch.int32)     # the low 16 bits, sign-extended
    out = torch.zeros((coeff.shape[0], size, size), dtype=torch.int32,
                      device=coeff.device)
    out[:, :qsize, :qsize] = r
    return out


def reconstruct_batch(res, pred, bitdepth: int = 8):
    """saturate(res + (int16)pred) over any matching shapes."""
    return (res + _i16(pred)).clamp(0, (1 << bitdepth) - 1)
