"""Forward/inverse integer transforms + quantization.

Mirrors reference common/transform.c:245-530, enc/encode_block.c:84 (quantize),
common/common_block.c:45-83 (dequantize, reconstruct).
"""
from __future__ import annotations

import numpy as np

from ..tables import (TRANSFORM_TABLES, ZIGZAG, GQUANT, GDEQUANT,
                      MAX_QUANT_SIZE, INV_WEIGHT_SHIFT, WEIGHT_SHIFT, log2i)


def _i16(x):
    return x.astype(np.int16)


def transform_fwd(block: np.ndarray, size: int, fast: bool, bitdepth: int) -> np.ndarray:
    """Forward transform (common/transform.c:245).

    Input: residual block (size x size).  Returns (qsize,qsize) int16 coeffs
    (only the top-left min(16,size)^2 coefficients are kept).
    """
    qsize = min(size, MAX_QUANT_SIZE)
    size1 = size
    scale = 1
    inb = block.astype(np.int32)
    lim = 32 >> int(fast)
    if size > lim:
        size1 = lim
        scale = size // size1
        # scale x scale pixel aggregation with running int16-range saturation
        # (common/transform.c:262-270; saturation matches the SIMD path)
        s = inb.reshape(size1, scale, size1, scale)
        acc = np.zeros((size1, size1), np.int32)
        for m in range(scale):
            for n in range(scale):
                acc = np.clip(acc + s[:, m, :, n], -16384, 16383)
        inb = acc
    T = TRANSFORM_TABLES[size1].astype(np.int32)
    shift_1 = log2i(size) + log2i(scale) + bitdepth - 8
    add_1 = 1 << (shift_1 - 1)
    shift_2 = log2i(size1) + 5
    add_2 = 1 << (shift_2 - 1)
    # Stage stores SATURATE to int16 (the SIMD pack, common_kernels.c
    # transform4/8/16/32 v64_pack_s32_s16), unlike the plain-C path which
    # wraps; the reference binary always runs the SIMD path on x86, so the
    # saturating variant is normative.
    # stage 1 (horizontal): tmp[i][j] = sum_k T[i,k]*in[j,k]
    tmp = np.clip((T[:qsize] @ inb.T + add_1) >> shift_1, -32768, 32767)
    # stage 2 (vertical): coeff[i][j] = sum_k T[i,k]*tmp[j,k]
    coeff = np.clip((T[:qsize] @ tmp.T + add_2) >> shift_2,
                    -32768, 32767).astype(np.int16)
    return coeff


def transform_inv_core(coeff: np.ndarray, size: int, bitdepth: int) -> np.ndarray:
    """Inverse transform core, size in {4,8,16,32}
    (common/transform.c:411-464 inverse_transform_non_simd)."""
    qsize = min(size, MAX_QUANT_SIZE)
    T = TRANSFORM_TABLES[size].astype(np.int32)
    c = coeff.astype(np.int32)
    shift_2 = 20 - bitdepth
    add_2 = 1 << (shift_2 - 1)
    # stage 1: tmp[i][j] = clip((sum_{k<qsize} T[k,j]*coeff[k,i] + 64)>>7)
    tmp = np.clip((c[:qsize, :qsize].T @ T[:qsize] + 64) >> 7, -32768, 32767)
    # stage 2: block[i][j] = clip((sum_{k<qsize} T[k,j]*tmp[k,i] + add2)>>s2)
    blk = np.clip((tmp.T[:, :qsize] @ T[:qsize] + add_2) >> shift_2,
                  -32768, 32767)
    return blk.astype(np.int16)


def transform_inv(coeff: np.ndarray, size: int, bitdepth: int) -> np.ndarray:
    """Inverse transform, any size 4..128 (common/transform.c:467-500).

    coeff: (size,size) int16 layout (only top-left qsize x qsize non-zero).
    """
    if size < 64:
        return transform_inv_core(coeff, size, bitdepth)
    # >=64: 32x32 kernel + scale x scale duplication
    scale = size // 32
    blk32 = transform_inv_core(coeff[:32, :32], 32, bitdepth)
    return np.repeat(np.repeat(blk32, scale, axis=0), scale, axis=1)


def dequantize(coeff: np.ndarray, qp: int, size: int,
               iwmatrix: np.ndarray | None = None) -> np.ndarray:
    """Dequantize (common/common_block.c:45-73).

    coeff: (qsize,qsize) int16.  Returns (size,size) int16 rcoeff with the
    dequantized values in the top-left qsize x qsize corner.
    """
    tr_log2size = log2i(size)
    lshift = qp // 6
    qsize = min(size, MAX_QUANT_SIZE)
    rshift = tr_log2size - 1 + (INV_WEIGHT_SHIFT if iwmatrix is not None else 0)
    scale = int(GDEQUANT[qp % 6])
    c = coeff[:qsize, :qsize].astype(np.int64)
    if iwmatrix is not None:
        c = c * iwmatrix[:qsize, :qsize].astype(np.int64)
    if lshift >= rshift:
        r = (c * scale) << (lshift - rshift)
    else:
        add = 1 << (rshift - lshift - 1)
        r = (c * scale + add) >> (rshift - lshift)
    out = np.zeros((size, size), np.int16)
    out[:qsize, :qsize] = r.astype(np.int16)  # wrap like the C int16 cast
    return out


def reconstruct_block(rblock: np.ndarray, pblock: np.ndarray,
                      bitdepth: int) -> np.ndarray:
    """rec = saturate(residual + pred) (common/common_block.c:75-83).

    The C code routes pred through int16 before the add.
    """
    s = rblock.astype(np.int32) + pblock.astype(np.int16).astype(np.int32)
    return np.clip(s, 0, (1 << bitdepth) - 1)


def quantize(coeff: np.ndarray, qp: int, size: int, coeff_block_type: int,
             wmatrix: np.ndarray | None = None) -> tuple[np.ndarray, int]:
    """Scalar quantizer with adaptive deadzone (enc/encode_block.c:84-160).

    coeff: (qsize,qsize) int16 transform output.
    Returns (coeffq (qsize,qsize) int16, cbp flag).
    """
    intra_block = (coeff_block_type >> 1) & 1
    tr_log2size = log2i(size)
    qsize = min(MAX_QUANT_SIZE, size)
    scale = int(GQUANT[qp % 6])
    zz = ZIGZAG[qsize]
    shift2 = 21 - tr_log2size + qp // 6 + (WEIGHT_SHIFT if wmatrix is not None else 0)

    c2 = coeff[:qsize, :qsize].astype(np.int64)
    if wmatrix is not None:
        c2 = c2 * wmatrix[:qsize, :qsize].astype(np.int64)
    scoeff = np.zeros(qsize * qsize, np.int64)
    scoeff[zz] = c2.reshape(-1)

    # Find last_pos (reverse scan with small deadzone offset)
    offset = (38 if intra_block else -26) << (shift2 - 8)
    level = 0
    pos = qsize * qsize - 1
    while level == 0 and pos >= 0:
        level64 = abs(int(scoeff[pos])) * scale + offset
        level = abs(level64) >> shift2
        pos -= 1
    last_pos = pos + 1 if level else pos

    # Forward scan with level-mode adaptive deadzone
    scoeffq = np.zeros(qsize * qsize, np.int32)
    cbp = 0
    offset0 = 102 if intra_block else 51
    offset1 = 115 if intra_block else 90
    level_mode = 1
    for pos in range(last_pos + 1):
        c = int(scoeff[pos])
        sign = -1 if c < 0 else 1
        abs_coeff = scale * abs(c)
        level0 = (abs_coeff + 0) >> shift2
        off = (offset1 if level0 > (1 - level_mode) else offset0) << (shift2 - 8)
        level = (abs_coeff + off) >> shift2
        scoeffq[pos] = sign * level
        cbp = cbp or (level != 0)
        if level_mode:
            if level == 0:
                level_mode = 0
        else:
            if level > 1:
                level_mode = 1

    coeffq = scoeffq[zz].reshape(qsize, qsize).astype(np.int16)
    return coeffq, int(cbp != 0)
