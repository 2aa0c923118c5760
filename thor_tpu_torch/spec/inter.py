"""Inter prediction: MV clipping, quarter-pel luma MC, eighth-pel chroma MC,
MV prediction (median) and skip/merge candidate derivation.

Mirrors reference common/inter_prediction.c (clip_mv:51, luma MC:117,
chroma MC:65, yuv dispatch:185, average:228, mvp:413, merge:528, skip:682).
"""
from __future__ import annotations

import numpy as np

from ..tables import (COEFFS_STANDARD, COEFFS_BIPRED, COEFFS_CHROMA,
                      PADDING_Y, MIN_PB_SIZE)

MAX_MV_EXT = PADDING_Y - 16  # 144 integer pixels


def clip_mv(mvy: int, mvx: int, ypos: int, xpos: int, fwidth: int,
            fheight: int, bwidth: int, bheight: int, sign: int):
    """inter_prediction.c:51-63."""
    if sign:
        mvy, mvx = -mvy, -mvx
    # C integer division truncates toward zero
    if ypos + int(mvy / 4) < -MAX_MV_EXT:
        mvy = 4 * (-MAX_MV_EXT - ypos)
    if ypos + int(mvy / 4) + bheight > fheight + MAX_MV_EXT:
        mvy = 4 * (fheight + MAX_MV_EXT - ypos - bheight)
    if xpos + int(mvx / 4) < -MAX_MV_EXT:
        mvx = 4 * (-MAX_MV_EXT - xpos)
    if xpos + int(mvx / 4) + bwidth > fwidth + MAX_MV_EXT:
        mvx = 4 * (fwidth + MAX_MV_EXT - xpos - bwidth)
    if sign:
        mvy, mvx = -mvy, -mvx
    return mvy, mvx


def _ref_read(ref_full: np.ndarray, pad: int, y0: int, x0: int,
              h: int, w: int) -> np.ndarray:
    """Read an (h,w) window at visible coords (y0,x0), may dip into padding."""
    return ref_full[pad + y0:pad + y0 + h, pad + x0:pad + x0 + w].astype(np.int32)


def mc_luma(ref_full: np.ndarray, pad: int, ypos: int, xpos: int,
            bwidth: int, bheight: int, mvy: int, mvx: int, sign: int,
            bipred: int, pic_width: int, pic_height: int,
            bitdepth: int, clamp_ypos: int | None = None,
            clamp_xpos: int | None = None) -> np.ndarray:
    """Quarter-pel luma MC (inter_prediction.c:117-181).

    ref_full: padded reference plane; (ypos,xpos) block pos in visible
    coords (the C ref pointer).  clamp_ypos/clamp_xpos: the xpos/ypos args
    the C code clamps ver_int/hor_int with - for split sub-PBs the caller
    passes the *parent block* origin there (inter_prediction.c:214).
    """
    if clamp_ypos is None:
        clamp_ypos = ypos
    if clamp_xpos is None:
        clamp_xpos = xpos
    if sign:
        mvy, mvx = -mvy, -mvx
    ver_frac = mvy & 3
    hor_frac = mvx & 3
    ver_int = mvy >> 2
    hor_int = mvx >> 2
    ver_int = min(ver_int, pic_height - clamp_ypos)
    ver_int = max(ver_int, -clamp_xpos - bheight)  # (sic - quirk kept)
    hor_int = min(hor_int, pic_width - clamp_xpos)
    hor_int = max(hor_int, -clamp_xpos - bwidth)

    y0 = ypos + ver_int
    x0 = xpos + hor_int

    if ver_frac == 0 and hor_frac == 0:
        return _ref_read(ref_full, pad, y0, x0, bheight, bwidth)

    if ver_frac == 2 and hor_frac == 2 and bipred < 2:
        # special 4-tap lowpass at centre position
        w = _ref_read(ref_full, pad, y0 - 1, x0 - 1, bheight + 3, bwidth + 3)
        k = np.array([[0, 1, 1, 0], [1, 2, 2, 1], [1, 2, 2, 1], [0, 1, 1, 0]],
                     np.int32)
        out = np.zeros((bheight, bwidth), np.int32)
        for dy in range(4):
            for dx in range(4):
                if k[dy, dx]:
                    out += k[dy, dx] * w[dy:dy + bheight, dx:dx + bwidth]
        return np.clip((out + 8) >> 4, 0, (1 << bitdepth) - 1)

    coeffs = COEFFS_BIPRED if bipred else COEFFS_STANDARD
    fv = coeffs[ver_frac]
    fh = coeffs[hor_frac]
    # vertical then horizontal, 6 taps spanning [-2..+3]
    w = _ref_read(ref_full, pad, y0 - 2, x0 - 2, bheight + 5, bwidth + 5)
    tmp = np.zeros((bheight, bwidth + 5), np.int32)
    for m in range(6):
        tmp += fv[m] * w[m:m + bheight, :]
    out = np.zeros((bheight, bwidth), np.int32)
    for m in range(6):
        out += fh[m] * tmp[:, m:m + bwidth]
    return np.clip((out + 2048) >> 12, 0, (1 << bitdepth) - 1)


def mc_chroma(ref_full: np.ndarray, pad: int, ypos: int, xpos: int,
              bwidth: int, bheight: int, mvy: int, mvx: int, sign: int,
              pic_width2: int, pic_height2: int, bitdepth: int,
              clamp_ypos: int | None = None,
              clamp_xpos: int | None = None) -> np.ndarray:
    """Eighth-pel 4-tap chroma MC (inter_prediction.c:65-115).
    All coords/sizes in chroma units; mv still in luma quarter-pel units."""
    if clamp_ypos is None:
        clamp_ypos = ypos
    if clamp_xpos is None:
        clamp_xpos = xpos
    if sign:
        mvy, mvx = -mvy, -mvx
    ver_frac = mvy & 7
    hor_frac = mvx & 7
    ver_int = mvy >> 3
    hor_int = mvx >> 3
    ver_int = min(ver_int, pic_height2 - clamp_ypos)
    ver_int = max(ver_int, -clamp_xpos - bheight)
    hor_int = min(hor_int, pic_width2 - clamp_xpos)
    hor_int = max(hor_int, -clamp_xpos - bwidth)
    y0 = ypos + ver_int
    x0 = xpos + hor_int
    if ver_frac == 0 and hor_frac == 0:
        return _ref_read(ref_full, pad, y0, x0, bheight, bwidth)
    fh = COEFFS_CHROMA[hor_frac]
    fv = COEFFS_CHROMA[ver_frac]
    # horizontal first (rows -1..height+1), 4 taps spanning [-1..+2]
    w = _ref_read(ref_full, pad, y0 - 1, x0 - 1, bheight + 3, bwidth + 3)
    tmp = np.zeros((bheight + 3, bwidth), np.int32)
    for m in range(4):
        tmp += fh[m] * w[:, m:m + bwidth]
    out = np.zeros((bheight, bwidth), np.int32)
    for m in range(4):
        out += fv[m] * tmp[m:m + bheight, :]
    return np.clip((out + 2048) >> 12, 0, (1 << bitdepth) - 1)


def get_inter_prediction_yuv(ref, mv_arr, ypos, xpos, size, bwidth, bheight,
                             sign, width, height, enable_bipred, split,
                             bitdepth):
    """Full-block YUV MC with optional PB split (inter_prediction.c:185-226).

    ref: YuvFrame (padded).  mv_arr: list of 4 (mvy,mvx).
    Returns (py, pu, pv) int32 arrays sized (size,size)/(sizeC,sizeC),
    with only bwidth/bheight area valid.
    """
    div = split + 1
    bw, bh = bwidth // div, bheight // div
    sub = ref.sub
    sizeC = size >> sub
    py = np.zeros((size, size), np.int32)
    pu = np.zeros((sizeC, sizeC), np.int32)
    pv = np.zeros((sizeC, sizeC), np.int32)
    for index in range(div * div):
        idx = index & 1
        idy = (index >> 1) & 1
        oy, ox = idy * bh, idx * bw
        mvy, mvx = mv_arr[index]
        mvy, mvx = clip_mv(mvy, mvx, ypos, xpos, width, height, bw, bh, sign)
        # The C code points ref at the sub-PB but passes the parent block
        # origin as the clamp coords (inter_prediction.c:205-224).
        py[oy:oy + bh, ox:ox + bw] = mc_luma(
            ref.y_full, ref.pad, ypos + oy, xpos + ox, bw, bh, mvy, mvx,
            sign, enable_bipred, width, height, bitdepth, ypos, xpos)
        if ref.mono:
            continue
        if sub:
            pu[oy >> 1:(oy + bh) >> 1, ox >> 1:(ox + bw) >> 1] = mc_chroma(
                ref.u_full, ref.pad_c, (ypos + oy) >> 1, (xpos + ox) >> 1,
                bw >> 1, bh >> 1, mvy, mvx, sign, width >> 1, height >> 1,
                bitdepth, ypos >> 1, xpos >> 1)
            pv[oy >> 1:(oy + bh) >> 1, ox >> 1:(ox + bw) >> 1] = mc_chroma(
                ref.v_full, ref.pad_c, (ypos + oy) >> 1, (xpos + ox) >> 1,
                bw >> 1, bh >> 1, mvy, mvx, sign, width >> 1, height >> 1,
                bitdepth, ypos >> 1, xpos >> 1)
        else:
            # 4:4:4 uses luma filters for chroma with bipred forced 0
            pu[oy:oy + bh, ox:ox + bw] = mc_luma(
                ref.u_full, ref.pad_c, ypos + oy, xpos + ox, bw, bh, mvy, mvx,
                sign, 0, width, height, bitdepth, ypos, xpos)
            pv[oy:oy + bh, ox:ox + bw] = mc_luma(
                ref.v_full, ref.pad_c, ypos + oy, xpos + ox, bw, bh, mvy, mvx,
                sign, 0, width, height, bitdepth, ypos, xpos)
    return py, pu, pv


def average_blocks(p0, p1):
    """(p0+p1)>>1 (inter_prediction.c:228-248)."""
    return (p0 + p1) >> 1


# ---- MV prediction / candidate derivation over the deblock-data grid ----

class DeblockData:
    """Per-4x4 grid of block state (C deblock_data_t as structured arrays)."""

    def __init__(self, width, height, gop_size=1):
        self.bs = width // MIN_PB_SIZE
        self.rows = height // MIN_PB_SIZE
        n = self.rows * self.bs
        self.mode = np.zeros(n, np.int32)
        self.size = np.zeros(n, np.int32)
        self.tb_split = np.zeros(n, np.int32)
        self.pb_part = np.zeros(n, np.int32)
        self.cbp_y = np.zeros(n, np.int32)
        self.cbp_u = np.zeros(n, np.int32)
        self.cbp_v = np.zeros(n, np.int32)
        self.mv0 = np.zeros((n, 2), np.int32)   # (y,x)
        self.mv1 = np.zeros((n, 2), np.int32)
        self.ref_idx0 = np.zeros(n, np.int32)
        self.ref_idx1 = np.zeros(n, np.int32)
        self.bipred_flag = np.zeros(n, np.int32)
        # inter_pred_arr[phase].mv0 for interp_ref=2 temporal prediction
        self.arr_mv0 = np.zeros((n, 16, 2), np.int32)

    def clear(self):
        for a in (self.mode, self.size, self.tb_split, self.pb_part,
                  self.cbp_y, self.cbp_u, self.cbp_v, self.mv0, self.mv1,
                  self.ref_idx0, self.ref_idx1, self.bipred_flag):
            a.fill(0)

    def inter_pred(self, idx):
        return (int(self.mv0[idx, 0]), int(self.mv0[idx, 1]),
                int(self.mv1[idx, 0]), int(self.mv1[idx, 1]),
                int(self.ref_idx0[idx]), int(self.ref_idx1[idx]),
                int(self.bipred_flag[idx]))


ZERO_PRED = (0, 0, 0, 0, 0, 0, 0)


def get_left_available(ypos, xpos):
    return xpos > 0


def get_up_available(ypos, xpos):
    return ypos > 0


def get_upright_available(ypos, xpos, bwidth, bheight, fwidth, fheight, sb_size):
    """common/common_block.h:60-74."""
    avail = (ypos > 0) and (xpos + bwidth < fwidth)
    size = max(bwidth, bheight)
    size2 = size
    while size2 < sb_size:
        if (ypos % (size2 << 1)) == size2 and (xpos % size2) == (size2 - size):
            avail = 0
        size2 *= 2
    return int(avail)


def get_downleft_available(ypos, xpos, bwidth, bheight, fwidth, fheight, sb_size):
    """common/common_block.h:76-95."""
    avail = (xpos > 0) and (ypos + bheight < fheight)
    size = max(bwidth, bheight)
    if (ypos % sb_size) == (sb_size - size) and (xpos % sb_size) == 0:
        avail = 0
    size2 = 2 * size
    while size2 <= sb_size:
        if (ypos % size2) == (size2 - size) and (xpos % size2) > 0:
            avail = 0
        size2 *= 2
    return int(avail)


def get_mv_pred(ypos, xpos, width, height, bwidth, bheight, sb_size,
                dd: DeblockData):
    """Median MVP from A/B/C neighbours (inter_prediction.c:413-526)."""
    size = max(bwidth, bheight)
    bsz = size // MIN_PB_SIZE
    bstr = dd.bs
    bi = (ypos // MIN_PB_SIZE) * bstr + (xpos // MIN_PB_SIZE)

    up0 = bi - bstr
    up1 = bi - bstr + (bsz - 1) // 2
    up2 = bi - bstr + bsz - 1
    left0 = bi - 1
    left1 = bi + bstr * ((bsz - 1) // 2) - 1
    left2 = bi + bstr * (bsz - 1) - 1
    downleft = bi + bstr * bsz - 1
    upright = bi - bstr + bsz
    upleft = bi - bstr - 1

    U = get_up_available(ypos, xpos)
    UR = get_upright_available(ypos, xpos, bwidth, bheight, width, height, sb_size)
    L = get_left_available(ypos, xpos)
    DL = get_downleft_available(ypos, xpos, bwidth, bheight, width, height, sb_size)

    def mv0(idx):
        return (int(dd.mv0[idx, 0]), int(dd.mv0[idx, 1]))

    key = (U, UR, L, DL)
    table = {
        (0, 0, 0, 0): None,
        (1, 0, 0, 0): (up0, up1, up2),
        (1, 1, 0, 0): (up0, up2, upright),
        (0, 0, 1, 0): (left0, left1, left2),
        (1, 0, 1, 0): (upleft, up2, left2),
        (1, 1, 1, 0): (up0, upright, left2),
        (0, 0, 1, 1): (left0, left2, downleft),
        (1, 0, 1, 1): (up2, left0, downleft),
        (1, 1, 1, 1): (up0, upright, left0),
    }
    sel = table.get(key)
    if sel is None:
        mva = mvb = mvc = (0, 0)
    else:
        mva, mvb, mvc = mv0(sel[0]), mv0(sel[1]), mv0(sel[2])

    def median(a, b, c):
        if a < b:
            return min(b, max(a, c))
        return min(a, max(b, c))

    return (median(mva[0], mvb[0], mvc[0]), median(mva[1], mvb[1], mvc[1]))


def _gather_two_candidates(ypos, xpos, width, height, bwidth, bheight,
                           sb_size, dd: DeblockData):
    """Shared LIMITED_SKIP candidate gathering for skip and merge
    (inter_prediction.c:565-582 / 719-736)."""
    size = max(bwidth, bheight)
    bsz = size // MIN_PB_SIZE
    bstr = dd.bs
    bi = (ypos // MIN_PB_SIZE) * bstr + (xpos // MIN_PB_SIZE)
    up0 = bi - bstr
    up2 = bi - bstr + bsz - 1
    left0 = bi - 1
    left2 = bi + bstr * (bsz - 1) - 1
    upright = bi - bstr + bsz

    up = get_up_available(ypos, xpos)
    left = get_left_available(ypos, xpos)
    ur = get_upright_available(ypos, xpos, bwidth, bheight, width, height, sb_size)

    if ypos + size > height:
        left2 = left0
    if xpos + size > width:
        up2 = up0

    c0 = dd.inter_pred(left2) if left else ZERO_PRED
    if ur:
        c1 = dd.inter_pred(upright)
    elif up:
        c1 = dd.inter_pred(up2)
    else:
        c1 = ZERO_PRED
    return [c0, c1]


def _dedup(cands):
    """Duplicate removal (inter_prediction.c:661-679). Candidate tuple:
    (mv0y,mv0x,mv1y,mv1x,ref0,ref1,bipred)."""
    out = [cands[0]]
    for c in cands[1:]:
        dup = False
        for o in out:
            if (c[0] == o[0] and c[1] == o[1] and c[2] == o[2] and
                    c[3] == o[3] and c[4] == o[4] and c[5] == o[5] and
                    (c[6] == o[6] or c[6] == -1)):
                dup = True
        if not dup:
            out.append(c)
    return out


def get_mv_skip(ypos, xpos, width, height, bwidth, bheight, sb_size, dd):
    return _dedup(_gather_two_candidates(ypos, xpos, width, height,
                                         bwidth, bheight, sb_size, dd))


def get_mv_merge(ypos, xpos, width, height, bwidth, bheight, sb_size, dd):
    return _dedup(_gather_two_candidates(ypos, xpos, width, height,
                                         bwidth, bheight, sb_size, dd))
