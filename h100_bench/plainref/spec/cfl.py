"""Chroma-from-luma prediction improvement.

Mirrors reference common/common_block.c:347-428 (improve_uv_prediction):
linear regression of predicted chroma on predicted luma, remapped through
reconstructed luma when the luma prediction is poor.
"""
from __future__ import annotations

import numpy as np

from ..tables import log2i


def improve_uv_prediction(pred_y: np.ndarray, pred_u: np.ndarray,
                          pred_v: np.ndarray, rec_y: np.ndarray,
                          n: int, sub: int, bitdepth: int):
    """Updates pred_u/pred_v in place.

    pred_y: (n,n) luma prediction; rec_y: (n,n) reconstructed luma;
    pred_u/pred_v: (n>>sub, n>>sub) chroma predictions.
    """
    nc = n >> sub
    lognc = log2i(nc)
    py = pred_y.astype(np.int64)
    ry = rec_y.astype(np.int64)

    sqres = int(((ry - py) ** 2).sum())
    if (sqres >> (log2i(n) + log2i(n))) <= (64 << 2 * (bitdepth - 8)):
        return

    if sub:
        ys = ((py[0::2, 0::2] + py[0::2, 1::2] +
               py[1::2, 0::2] + py[1::2, 1::2] + 2) >> 2)
    else:
        ys = py
    us = pred_u.astype(np.int64)
    vs = pred_v.astype(np.int64)

    ysum = int(ys.sum()); usum = int(us.sum()); vsum = int(vs.sum())
    yysum = int((ys * ys).sum()); yusum = int((ys * us).sum())
    yvsum = int((ys * vs).sum()); uusum = int((us * us).sum())
    vvsum = int((vs * vs).sum())

    ssyy = yysum - ((ysum * ysum) >> (lognc * 2))
    ssuu = uusum - ((usum * usum) >> (lognc * 2))
    ssvv = vvsum - ((vsum * vsum) >> (lognc * 2))
    ssyu = yusum - ((ysum * usum) >> (lognc * 2))
    ssyv = yvsum - ((ysum * vsum) >> (lognc * 2))

    if not ssyy:
        return

    hi = (1 << bitdepth) - 1

    def remap(ssyx, xsum, dst):
        # C int64 division truncates toward zero; ssyy > 0 here
        num = ssyx << 16
        a64 = -((-num) // ssyy) if num < 0 else num // ssyy
        b64 = ((xsum << 16) - a64 * ysum) >> (lognc * 2)
        a = int(np.clip(a64, -(1 << (31 - bitdepth)), 1 << (31 - bitdepth)))
        b = int(np.clip(b64 + (1 << 15), -(1 << 31), (1 << 31) - 1))
        # (a*ry + b) >> 16 in C int32 arithmetic (wraps mod 2^32)
        ry32 = rec_y.astype(np.int32)
        av = np.int32(a)
        bv = np.int32(b)
        m = np.clip((av * ry32 + bv) >> 16, 0, hi)
        if sub:
            dst[:, :] = ((m[0::2, 0::2] + m[0::2, 1::2] +
                          m[1::2, 0::2] + m[1::2, 1::2] + 2) >> 2)
        else:
            dst[:, :] = m

    if ssyu * ssyu * 2 > ssyy * ssuu:
        remap(ssyu, usum, pred_u)
    if ssyv * ssyv * 2 > ssyy * ssvv:
        remap(ssyv, vsum, pred_v)
