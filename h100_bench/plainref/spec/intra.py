"""Intra prediction: reference-sample builder + 10 modes.

Mirrors reference common/intra_prediction.c:39-428.
"""
from __future__ import annotations

import numpy as np

# intra_mode_t (common/types.h:189-201)
MODE_DC = 0
MODE_PLANAR = 1
MODE_HOR = 2
MODE_VER = 3
MODE_UPLEFT = 4
MODE_UPRIGHT = 5
MODE_UPUPRIGHT = 6
MODE_UPUPLEFT = 7
MODE_UPLEFTLEFT = 8
MODE_DOWNLEFTLEFT = 9


def _cdiv8(v):
    """C-style truncation toward zero of v/8 for possibly-negative ints."""
    return np.sign(v) * (np.abs(v) // 8)


def filter_121(arr: np.ndarray) -> np.ndarray:
    """(1,2,1)/4 smoothing with edge replication (intra_prediction.c:39)."""
    a = arr.astype(np.int32)
    prev = np.concatenate(([a[0]], a[:-1]))
    nxt = np.concatenate((a[1:], [a[-1]]))
    return ((prev + 2 * a + nxt + 2) >> 2)


def make_top_and_left(plane: np.ndarray, cb_y: int, cb_x: int, i: int, j: int,
                      size: int, cb_upright: int, cb_downleft: int,
                      tb_split: int, bitdepth: int,
                      rb: np.ndarray | None = None, rb_y: int = 0,
                      rb_x: int = 0):
    """Build left[2*size], top[2*size], top_left reference samples
    (intra_prediction.c:57-183).

    plane: full reconstructed plane (visible area, 2D); (cb_y,cb_x) is the
    coding-block origin; (i,j) the TU offset inside it (0,0 unless tb_split).
    rb: the partially-reconstructed block the C `rblock` pointer addresses
    (the CB-local compact recon in the encoder, the frame itself in the
    decoder), with the current TU at (rb_y, rb_x); defaults to the frame.
    """
    if rb is None:
        rb = plane
        rb_y = cb_y + i
        rb_x = cb_x + j
    ypos, xpos = cb_y, cb_x
    length = 2 * size
    half = 128 << (bitdepth - 8)
    top = np.empty(length, np.int32)
    left = np.empty(length, np.int32)
    top_left = 0

    if not tb_split:
        downleft = cb_downleft
        leftlen = size + 1 if downleft else size
        upright = cb_upright
        toplen = size + 1 if upright else size

        if ypos == 0:
            top[:] = half
            top_left = half
        else:
            top[:toplen] = plane[cb_y - 1, cb_x:cb_x + toplen]
            top[toplen:] = top[toplen - 1]
            top_left = plane[cb_y - 1, cb_x - 1] if xpos > 0 else top[0]

        if xpos == 0:
            left[:] = half
        else:
            left[:leftlen] = plane[cb_y:cb_y + leftlen, cb_x - 1]
            left[leftlen:] = left[leftlen - 1]

        if ypos == 0:
            top_left = left[0]
    else:
        downleft = 1 if (j == 0 and (i == 0 or cb_downleft)) else 0
        leftlen = size + 1 if downleft else size
        upright = 1 if (j == 0 or (i == 0 and cb_upright)) else 0
        toplen = size + 1 if upright else size

        if ypos + i == 0:
            top[:] = half
            top_left = half
        elif i == 0:
            top[:toplen] = plane[cb_y - 1, cb_x + j:cb_x + j + toplen]
            top[toplen:] = top[toplen - 1]
            top_left = plane[cb_y - 1, cb_x + j - 1] if xpos > 0 else top[0]
        else:
            # reads through the C rblock pointer (partial CB recon)
            top[:toplen] = rb[rb_y - 1, rb_x:rb_x + toplen]
            top[toplen:] = top[toplen - 1]
            if xpos > 0:
                top_left = (rb[rb_y - 1, rb_x - 1] if j > 0
                            else plane[cb_y + i - 1, cb_x - 1])
            else:
                top_left = top[0]

        if xpos + j == 0:
            left[:] = half
        elif j == 0:
            left[:leftlen] = plane[cb_y + i:cb_y + i + leftlen, cb_x - 1]
            left[leftlen:] = left[leftlen - 1]
        else:
            left[:leftlen] = rb[rb_y:rb_y + leftlen, rb_x - 1]
            left[leftlen:] = left[leftlen - 1]

        if ypos + i == 0:
            top_left = left[0]

    return left, top, int(top_left)


def get_intra_prediction(left: np.ndarray, top: np.ndarray, top_left: int,
                         ypos: int, xpos: int, size: int, mode: int,
                         bitdepth: int) -> np.ndarray:
    """Dispatch to mode predictors (intra_prediction.c:403-428).
    Returns a (size,size) int array."""
    n = size
    idx = np.arange(n)
    ii = idx[:, None]
    jj = idx[None, :]

    if mode in (MODE_DC,) or mode >= 10:
        l = left if xpos != 0 else top
        t = top if ypos != 0 else left
        s = int(t[:n].sum() + l[:n].sum())
        dc = (s + n) // (2 * n)
        return np.full((n, n), dc, np.int32)

    if mode == MODE_HOR:
        return np.broadcast_to(left[:n, None], (n, n)).astype(np.int32)

    if mode == MODE_VER:
        return np.broadcast_to(top[None, :n], (n, n)).astype(np.int32)

    if mode == MODE_PLANAR:
        t = top.astype(np.int32)
        l = left.astype(np.int32)
        topF = np.empty(n, np.int32)
        leftF = np.empty(n, np.int32)
        # 5-tap (1,2,2,2,1) with edge handling (intra_prediction.c:229-247)
        topF[0] = t[0] + 2 * t[0] + 2 * t[0] + 2 * t[1] + t[2]
        topF[1] = t[0] + 2 * t[0] + 2 * t[1] + 2 * t[2] + t[3]
        for k in range(2, n - 2):
            topF[k] = t[k - 2] + 2 * t[k - 1] + 2 * t[k] + 2 * t[k + 1] + t[k + 2]
        topF[n - 2] = t[n - 4] + 2 * t[n - 3] + 2 * t[n - 2] + 2 * t[n - 1] + t[n - 1]
        topF[n - 1] = t[n - 3] + 2 * t[n - 2] + 2 * t[n - 1] + 2 * t[n - 1] + t[n - 1]
        leftF[0] = l[0] + 2 * l[0] + 2 * l[0] + 2 * l[1] + l[2]
        leftF[1] = l[0] + 2 * l[0] + 2 * l[1] + 2 * l[2] + l[3]
        for k in range(2, n - 2):
            leftF[k] = l[k - 2] + 2 * l[k - 1] + 2 * l[k] + 2 * l[k + 1] + l[k + 2]
        leftF[n - 2] = l[n - 4] + 2 * l[n - 3] + 2 * l[n - 2] + 2 * l[n - 1] + l[n - 1]
        leftF[n - 1] = l[n - 3] + 2 * l[n - 2] + 2 * l[n - 1] + 2 * l[n - 1] + l[n - 1]
        tlF = l[1] + 2 * l[0] + 2 * top_left + 2 * t[0] + t[1]
        val = leftF[:, None] + topF[None, :] - tlF + 4
        return np.clip(_cdiv8(val), 0, (1 << bitdepth) - 1).astype(np.int32)

    if mode == MODE_UPLEFT:
        lF, tF = filter_121(left[:n]), filter_121(top[:n])
        tlF = (2 * top_left + left[0] + top[0] + 2) >> 2
        diag = ii - jj
        out = np.where(diag > 0, lF[np.clip(diag - 1, 0, n - 1)],
                       np.where(diag == 0, tlF, tF[np.clip(-diag - 1, 0, n - 1)]))
        return out.astype(np.int32)

    if mode == MODE_UPRIGHT:
        tF = filter_121(top[:2 * n])
        return tF[ii + jj + 1].astype(np.int32)

    if mode == MODE_UPUPRIGHT:
        tF = filter_121(top[:2 * n])
        diag = ii + 2 * jj
        odd = (diag & 1) == 1
        out = np.where(odd, tF[np.clip((diag + 1) // 2, 0, 2 * n - 1)],
                       (tF[np.clip(diag // 2, 0, 2 * n - 1)] +
                        tF[np.clip(diag // 2 + 1, 0, 2 * n - 1)]) >> 1)
        return out.astype(np.int32)

    if mode == MODE_UPUPLEFT:
        lF, tF = filter_121(left[:n]), filter_121(top[:n])
        tlF = (2 * top_left + left[0] + top[0] + 2) >> 2
        diag = ii - 2 * jj
        # diag>1: leftF[diag-2]; ==1: tlF; ==0: (tlF+topF[0])>>1;
        # <0: odd -> topF[-diag/2] (trunc), even -> avg
        nd = -diag
        t_odd = tF[np.clip(nd // 2, 0, n - 1)]
        t_even = (tF[np.clip(nd // 2, 0, n - 1)] +
                  tF[np.clip(nd // 2 - 1, 0, n - 1)]) >> 1
        neg = np.where((diag & 1) == 1, t_odd, t_even)
        out = np.where(diag > 1, lF[np.clip(diag - 2, 0, n - 1)],
                       np.where(diag == 1, tlF,
                                np.where(diag == 0, (tlF + tF[0]) >> 1, neg)))
        return out.astype(np.int32)

    if mode == MODE_UPLEFTLEFT:
        lF, tF = filter_121(left[:n]), filter_121(top[:n])
        tlF = (2 * top_left + left[0] + top[0] + 2) >> 2
        diag = 2 * ii - jj
        l_odd = lF[np.clip(diag // 2, 0, n - 1)]
        l_even = (lF[np.clip(diag // 2, 0, n - 1)] +
                  lF[np.clip(diag // 2 - 1, 0, n - 1)]) >> 1
        pos = np.where((diag & 1) == 1, l_odd, l_even)
        out = np.where(diag < -1, tF[np.clip(-diag - 2, 0, n - 1)],
                       np.where(diag == -1, tlF,
                                np.where(diag == 0, (tlF + lF[0]) >> 1, pos)))
        return out.astype(np.int32)

    if mode == MODE_DOWNLEFTLEFT:
        lF = filter_121(left[:2 * n])
        diag = 2 * ii + jj
        odd = (diag & 1) == 1
        out = np.where(odd, lF[np.clip((diag + 1) // 2, 0, 2 * n - 1)],
                       (lF[np.clip(diag // 2, 0, 2 * n - 1)] +
                        lF[np.clip(diag // 2 + 1, 0, 2 * n - 1)]) >> 1)
        return out.astype(np.int32)

    raise ValueError(mode)
