"""Temporal frame interpolation (interp_ref): hierarchical bi-directional ME
+ motion-compensated averaging.  Must be bit-identical in encoder and
decoder.

Mirrors reference common/temporal_interp.c (interpolate_frames:909,
motion_estimate_bi:786, adaptive_search_v2:584, skip_test:458,
merge_candidate_search:661, interpolate_frame:880, scale_frame_down2x2:143)
and common/inter_prediction.c:250-350 (scale_mv/store_mv).

Notes on the reference's effective behaviour (SIMD build):
- the pyramid downscale (scale_frame_down2x2_simd) is luma-only; chroma of
  pyramid levels is never read (TEMP_INTERP_USE_CHROMA=0)
- all SAD/average kernels are integer-exact equal between SIMD and C paths
"""
from __future__ import annotations

import math

import numpy as np

from ..frame import YuvFrame
from ..tables import MIN_PB_SIZE, log2i

BLOCK_STEP = 16
MAX_CANDS = 20
COST_MAX = 0x3FFFFFFF
MAX_LEVELS = 4
LAMBDA = (3000 * BLOCK_STEP) // 16
LAMBDA_SHIFT = 4
ACC_BITS = 3
ACC_ROUND = 1 << (ACC_BITS - 1)
SKIP_THRESHOLD = 8


def scale_val(v: int, numer: int, denom: int) -> int:
    if denom == 0:
        return 0
    prod = v * numer
    if denom < 0:
        denom = -denom
        prod = -prod
    return ((prod + denom // 2) // denom if prod >= 0
            else -((-prod + denom // 2) // denom))


def scale_mv(mv, numer, denom):
    if numer == denom:
        return mv
    if numer == -denom:
        return (-mv[0], -mv[1])
    return (scale_val(mv[0], numer, denom), scale_val(mv[1], numer, denom))


class MvData:
    def __init__(self, w, h, bs, bbs, ratio, k):
        self.step = bbs // bs
        self.bw = self.step * ((w + bbs - 1) // bbs)
        self.bh = self.step * ((h + bbs - 1) // bbs)
        self.pw, self.ph = w, h
        self.bbs, self.bs = bbs, bs
        self.skip_thr = SKIP_THRESHOLD
        self.skip_mv = (0, 0)
        self.scaled_skip_mv = (0, 0)
        n = self.bw * self.bh
        # mv[i] as list of (x,y) tuples (uninitialized in C; zeros here -
        # never read before written, see motion_estimate_bi)
        self.mv = [[(0, 0)] * n, [(0, 0)] * n]
        self.bgmap = [0] * n
        self.ratio = ratio
        self.reversed = int(k > ratio // 2)
        self.wt = [k if self.reversed else ratio - k, 0]
        self.wt[1] = ratio - self.wt[0]
        self.pos = k


def _downscale_luma(src: YuvFrame, dst: YuvFrame):
    """scale_frame_down2x2 (luma only, SIMD build behaviour), then pad."""
    si = src.y.astype(np.int32)
    h, w = dst.height, dst.width
    a = si[0:2 * h:2, 0:2 * w:2]
    b = si[1:2 * h:2, 0:2 * w:2]
    c = si[0:2 * h:2, 1:2 * w:2]
    d = si[1:2 * h:2, 1:2 * w:2]
    dst.y[:] = ((((a + b + 1) >> 1) + ((c + d + 1) >> 1)) >> 1).astype(dst.dtype)
    dst.pad_frame()


def _plane_at(frame: YuvFrame):
    """(full_array_int32, pad) for luma."""
    return frame.y_full.astype(np.int32), frame.pad


class _Pics:
    """Pair of frames with cached int32 luma fulls."""

    def __init__(self, f0: YuvFrame, f1: YuvFrame):
        self.f = (f0, f1)
        self.y = (f0.y_full.astype(np.int32), f1.y_full.astype(np.int32))
        self.pad = f0.pad
        self.w = f0.width
        self.h = f0.height


def _sad_cost(pics: _Pics, xstart, ystart, mv0, mv1, size, cost_start):
    pady = pics.pad
    wP = pics.w + pady
    hP = pics.h + pady
    xs0 = xstart + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
    xs1 = xstart + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
    ys0 = ystart + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
    ys1 = ystart + ((mv1[1] + ACC_ROUND) >> ACC_BITS)
    p = pady
    y0, y1 = pics.y
    if (xs0 >= -pady and xs0 + size <= wP and ys0 >= -pady and ys0 + size <= hP
            and xs1 >= -pady and xs1 + size <= wP and ys1 >= -pady
            and ys1 + size <= hP):
        a = y0[p + ys0:p + ys0 + size, p + xs0:p + xs0 + size]
        b = y1[p + ys1:p + ys1 + size, p + xs1:p + xs1 + size]
        return cost_start + int(np.abs(a - b).sum())
    # clipped version
    jj = np.arange(size)
    x0 = np.clip(jj + xs0, -pady, wP - 1)
    x1 = np.clip(jj + xs1, -pady, wP - 1)
    yy0 = np.clip(jj + ys0, -pady, hP - 1)
    yy1 = np.clip(jj + ys1, -pady, hP - 1)
    a = y0[p + yy0[:, None], p + x0[None, :]]
    b = y1[p + yy1[:, None], p + x1[None, :]]
    return cost_start + int(np.abs(a - b).sum())


def _mv_absdist_filter(mlist):
    best_idx, best_cost = 0, COST_MAX
    for j, mj in enumerate(mlist):
        cost = 0
        for mi in mlist:
            cost += abs(mi[0] - mj[0]) + abs(mi[1] - mj[1])
        if cost <= best_cost:
            best_idx, best_cost = j, cost
    return mlist[best_idx]


def _add_cand(cands, cand):
    if len(cands) < MAX_CANDS:
        for c in cands:
            if c == cand:
                return
        cands.append(cand)


def _get_mv_cost(mv, mvd: MvData, xp, yp, xs, ys, lam):
    bw = mvd.bw
    arr = mvd.mv[1]
    if xp == 0 and yp == 0:
        diff = 0
    elif yp > 0 and xp > 0 and xp < bw - xs:
        a = arr[(yp - ys) * bw + xp + xs]
        b = arr[(yp - ys) * bw + xp]
        c = arr[(yp - ys) * bw + xp - xs]
        d = arr[yp * bw + xp - xs]
        diff = (abs(mv[0] - a[0]) + abs(mv[1] - a[1]) +
                abs(mv[0] - b[0]) + abs(mv[1] - b[1]) +
                abs(mv[0] - c[0]) + abs(mv[1] - c[1]) +
                abs(mv[0] - d[0]) + abs(mv[1] - d[1]))
    elif yp == 0:
        a = arr[xp - xs]
        diff = abs(mv[0] - a[0]) + abs(mv[1] - a[1])
    elif xp == 0:
        a = arr[(yp - ys) * bw + xp + xs]
        b = arr[(yp - ys) * bw + xp]
        diff = (abs(mv[0] - a[0]) + abs(mv[1] - a[1]) +
                abs(mv[0] - b[0]) + abs(mv[1] - b[1]))
    else:
        # right-edge interior blocks (xp >= bw-xs): no branch matches in the
        # reference -> zero cost (temporal_interp.c:302-314)
        diff = 0
    return (diff * lam) >> (LAMBDA_SHIFT + ACC_BITS)


def _skip_test(mvd: MvData, pics: _Pics, xp, yp):
    xstart = xp * mvd.bs
    ystart = yp * mvd.bs
    mv1 = mvd.skip_mv
    mv0 = mvd.scaled_skip_mv
    pos = yp * mvd.bw + xp
    size = mvd.bbs
    thr = mvd.skip_thr * 8 * 8
    skip = 1
    pady = pics.pad
    padx = pics.pad
    hP = pics.h + pady
    wP = pics.w + padx
    y0, y1 = pics.y
    pd = pady
    for p in range(ystart, ystart + size, 8):
        if not skip:
            break
        for q in range(xstart, xstart + size, 8):
            xs0 = q + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
            xs1 = q + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
            ys0 = p + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
            ys1 = p + ((mv1[1] + ACC_ROUND) >> ACC_BITS)
            if (xs0 >= -padx and xs0 + 8 <= wP and ys0 >= -pady
                    and ys0 + 8 <= hP and xs1 >= -padx and xs1 + 8 <= wP
                    and ys1 >= -pady and ys1 + 8 <= hP):
                a = y0[pd + ys0:pd + ys0 + 8, pd + xs0:pd + xs0 + 8]
                b = y1[pd + ys1:pd + ys1 + 8, pd + xs1:pd + xs1 + 8]
                if int(np.abs(a - b).sum()) > thr:
                    skip = 0
                    break
            else:
                skip = 0
                break
    if skip:
        mvd.bgmap[pos] = 1
        mvd.mv[1][pos] = mvd.skip_mv
        mvd.mv[0][pos] = mvd.scaled_skip_mv
    bw = mvd.bw
    for off in (1, bw, bw + 1):
        mvd.mv[0][pos + off] = mvd.mv[0][pos]
        mvd.mv[1][pos + off] = mvd.mv[1][pos]
        mvd.bgmap[pos + off] = mvd.bgmap[pos]


def _adaptive_search_v2(mvd: MvData, guided, cand_list, pics: _Pics, xp, yp,
                        xstep, ystep):
    xstart = xp * mvd.bs
    ystart = yp * mvd.bs
    size = mvd.bbs
    best_mv = cand_list[0]
    best_scaled = scale_mv(best_mv, -mvd.wt[1], mvd.wt[0])
    best_cost = COST_MAX
    lam = LAMBDA // 4 if guided else LAMBDA

    for c, cand in enumerate(cand_list):
        mv1 = cand
        mv0 = scale_mv(cand, -mvd.wt[1], mvd.wt[0])
        cost = _get_mv_cost(cand, mvd, xp, yp, xstep, ystep, lam)
        cost = _sad_cost(pics, xstart, ystart, mv0, mv1, size, cost)
        ref_mv, ref_scaled = mv1, mv0
        if ((4 + c) * cost) // 8 < best_cost:
            shift = (0 if guided else 3) + ACC_BITS
            count = 8 if guided else 64
            while shift >= ACC_BITS and count > 0:
                cx, cy = ref_mv
                cross = ((cx - (1 << shift), cy), (cx + (1 << shift), cy),
                         (cx, cy - (1 << shift)), (cx, cy + (1 << shift)))
                better = 0
                for rmv in cross:
                    m0 = scale_mv(rmv, -mvd.wt[1], mvd.wt[0])
                    bcost = _get_mv_cost(rmv, mvd, xp, yp, xstep, ystep, lam)
                    bcost = _sad_cost(pics, xstart, ystart, m0, rmv, size,
                                      bcost)
                    if bcost < cost:
                        cost = bcost
                        ref_mv = rmv
                        ref_scaled = m0
                        better = 1
                if not better:
                    shift -= 1
                count -= 4
        if cost < best_cost:
            best_mv, best_scaled, best_cost = ref_mv, ref_scaled, cost

    pos = yp * mvd.bw + xp
    mvd.mv[1][pos] = best_mv
    mvd.mv[0][pos] = best_scaled


def _get_cands(mvd: MvData, guides, xp, yp, xstep, ystep):
    cands = []
    _add_cand(cands, (0, 0))
    pos = yp * mvd.bw + xp
    for g in guides:
        numer = mvd.wt[0] if mvd.reversed == g.reversed else -mvd.wt[0]
        denom = g.wt[0]
        _add_cand(cands, scale_mv(g.mv[1][pos], numer, denom))
    if yp > 0 and xp < mvd.bw - xstep:
        _add_cand(cands, mvd.mv[1][(yp - ystep) * mvd.bw + xp + xstep])
    if xp > 0:
        _add_cand(cands, mvd.mv[1][yp * mvd.bw + xp - xstep])
    if yp > 0:
        _add_cand(cands, mvd.mv[1][(yp - ystep) * mvd.bw + xp])
    return cands


def _get_merge_cands(mvd: MvData, xp, yp):
    cands = []
    yoff = 2 if (yp & 1) else 1
    xoff = 2 if (yp & 1) else 1
    bw = mvd.bw
    _add_cand(cands, mvd.mv[1][yp * bw + xp])
    if yp - yoff >= 0:
        _add_cand(cands, mvd.mv[1][(yp - yoff) * bw + xp])
    if yp + yoff < mvd.bh:
        _add_cand(cands, mvd.mv[1][(yp + yoff) * bw + xp])
    if xp - xoff >= 0:
        _add_cand(cands, mvd.mv[1][yp * bw + xp - xoff])
    if xp + xoff < bw:
        _add_cand(cands, mvd.mv[1][yp * bw + xp + xoff])
    return cands


def _make_skip_vector(mvd: MvData, xp, yp, xstep, ystep):
    bw = mvd.bw
    vlist = []
    if yp > 0 and xp < bw - xstep:
        vlist.append(mvd.mv[1][(yp - ystep) * bw + xp + xstep])
    if xp > 0:
        vlist.append(mvd.mv[1][yp * bw + xp - xstep])
    if yp > 0:
        vlist.append(mvd.mv[1][(yp - ystep) * bw + xp])
    mvd.skip_mv = _mv_absdist_filter(vlist) if vlist else (0, 0)
    mvd.scaled_skip_mv = scale_mv(mvd.skip_mv, -mvd.wt[1], mvd.wt[0])


def _merge_candidate_search(cands, mvd: MvData, pics: _Pics, xp, yp):
    xstart = xp * mvd.bs
    ystart = yp * mvd.bs
    size = mvd.bs
    best_cost = COST_MAX
    best_mv = (0, 0)
    best_scaled = (0, 0)
    for rmv in cands:
        m0 = scale_mv(rmv, -mvd.wt[1], mvd.wt[0])
        bcost = _sad_cost(pics, xstart, ystart, m0, rmv, size, 0)
        if bcost < best_cost:
            best_cost, best_mv, best_scaled = bcost, rmv, m0
    return best_mv, best_scaled


def motion_estimate_bi(mvd: MvData, guides, in0: YuvFrame, in1: YuvFrame):
    bw, bh = mvd.bw, mvd.bh
    if not guides:
        mvd.mv[0] = [(0, 0)] * (bw * bh)
        mvd.mv[1] = [(0, 0)] * (bw * bh)
    mvd.bgmap = [0] * (bw * bh)
    step = mvd.step
    pics = _Pics(in1, in0) if mvd.reversed else _Pics(in0, in1)

    for i in range(0, bh, step):
        for j in range(0, bw, step):
            _make_skip_vector(mvd, j, i, step, step)
            _skip_test(mvd, pics, j, i)
            pos = i * bw + j
            if mvd.bgmap[pos] == 0:
                cands = _get_cands(mvd, guides, j, i, step, step)
                _adaptive_search_v2(mvd, len(guides) != 0, cands, pics, j, i,
                                    step, step)
            mv0 = mvd.mv[0][pos]
            mv1 = mvd.mv[1][pos]
            bg = mvd.bgmap[pos]
            for q in range(step):
                for p in range(step):
                    mvd.mv[0][pos + q * bw + p] = mv0
                    mvd.mv[1][pos + q * bw + p] = mv1
                    mvd.bgmap[pos + q * bw + p] = bg

    new0 = [None] * (bw * bh)
    new1 = [None] * (bw * bh)
    for i in range(bh):
        for j in range(bw):
            cands = _get_merge_cands(mvd, j, i)
            if len(cands) > 1:
                best_mv, best_scaled = _merge_candidate_search(cands, mvd,
                                                               pics, j, i)
                new1[i * bw + j] = best_mv
                new0[i * bw + j] = best_scaled
            else:
                new0[i * bw + j] = mvd.mv[0][i * bw + j]
                new1[i * bw + j] = mvd.mv[1][i * bw + j]
    mvd.mv[0] = new0
    mvd.mv[1] = new1


def _upscale_mv_data(src: MvData, dst: MvData):
    bwo, bho, bwi = dst.bw, dst.bh, src.bw
    for i in range(bho):
        for j in range(bwo):
            po = i * bwo + j
            pi = (i // 2) * bwi + (j // 2)
            m1 = (src.mv[1][pi][0] * 2, src.mv[1][pi][1] * 2)
            dst.mv[1][po] = m1
            dst.mv[0][po] = scale_mv(m1, -dst.wt[1], dst.wt[0])


def _mot_comp_avg(xstart, ystart, r0full, r1full, outfull, rpad, opad,
                  mv0, mv1, wP, hP, pad, size, dtype):
    xs0 = xstart + ((mv0[0] + ACC_ROUND) >> ACC_BITS)
    xs1 = xstart + ((mv1[0] + ACC_ROUND) >> ACC_BITS)
    ys0 = ystart + ((mv0[1] + ACC_ROUND) >> ACC_BITS)
    ys1 = ystart + ((mv1[1] + ACC_ROUND) >> ACC_BITS)
    dst = outfull[opad + ystart:opad + ystart + size,
                  opad + xstart:opad + xstart + size]
    in0 = (xs0 >= -pad and xs0 + size <= wP and ys0 >= -pad
           and ys0 + size <= hP)
    in1 = (xs1 >= -pad and xs1 + size <= wP and ys1 >= -pad
           and ys1 + size <= hP)
    if in0 and in1:
        a = r0full[rpad + ys0:rpad + ys0 + size, rpad + xs0:rpad + xs0 + size]
        b = r1full[rpad + ys1:rpad + ys1 + size, rpad + xs1:rpad + xs1 + size]
        dst[:] = ((a.astype(np.int32) + b + 1) // 2).astype(dtype)
    elif in1:
        dst[:] = r1full[rpad + ys1:rpad + ys1 + size,
                        rpad + xs1:rpad + xs1 + size]
    elif in0:
        dst[:] = r0full[rpad + ys0:rpad + ys0 + size,
                        rpad + xs0:rpad + xs0 + size]
    else:
        jj = np.arange(size)
        x0 = np.clip(jj + xs0, -pad, wP - 1)
        x1 = np.clip(jj + xs1, -pad, wP - 1)
        y0 = np.clip(jj + ys0, -pad, hP - 1)
        y1 = np.clip(jj + ys1, -pad, hP - 1)
        a = r0full[rpad + y0[:, None], rpad + x0[None, :]].astype(np.int32)
        b = r1full[rpad + y1[:, None], rpad + x1[None, :]]
        dst[:] = ((a + b + 1) // 2).astype(dtype)


def _interpolate_frame(mvd: MvData, in0: YuvFrame, in1: YuvFrame,
                       out: YuvFrame, w, h):
    pic0, pic1 = (in1, in0) if mvd.reversed else (in0, in1)
    pad = mvd.bs // 2
    wP, hP = w + pad, h + pad
    sub = in0.sub
    wPc, hPc, padc = wP >> sub, hP >> sub, pad >> sub
    bw, bh = mvd.bw, mvd.bh

    for yp in range(bh):
        for xp in range(bw):
            bs = mvd.bs
            mv0 = mvd.mv[0][yp * bw + xp]
            mv1 = mvd.mv[1][yp * bw + xp]
            _mot_comp_avg(xp * bs, yp * bs, pic0.y_full, pic1.y_full,
                          out.y_full, pic0.pad, out.pad, mv0, mv1, wP, hP,
                          pad, bs, out.dtype)
            if in0.mono:
                continue
            bsc = bs // 2
            m1 = (mv1[0] >> 1, mv1[1] >> 1)
            m0 = scale_mv(m1, -mvd.wt[1], mvd.wt[0])
            _mot_comp_avg(xp * bsc, yp * bsc, pic0.u_full, pic1.u_full,
                          out.u_full, pic0.pad_c, out.pad_c, m0, m1, wPc,
                          hPc, padc, bsc, out.dtype)
            _mot_comp_avg(xp * bsc, yp * bsc, pic0.v_full, pic1.v_full,
                          out.v_full, pic0.pad_c, out.pad_c, m0, m1, wPc,
                          hPc, padc, bsc, out.dtype)


def interpolate_frames(new_frame: YuvFrame, ref0: YuvFrame, ref1: YuvFrame,
                       ratio: int, pos: int):
    """common/temporal_interp.c:909-992."""
    w, h = ref0.width, ref0.height
    max_levels = min(MAX_LEVELS,
                     int(math.log10(min(w, h)) / math.log10(2.0) - 4.0))
    bs = BLOCK_STEP // 2

    mv_data = [MvData(w >> j, h >> j, bs, BLOCK_STEP, ratio, pos)
               for j in range(max_levels)]
    spatial = [MvData(w >> j, h >> j, bs, BLOCK_STEP, ratio, pos)
               for j in range(max_levels)]

    in_down = [[ref0, ref1]]
    for i in range(1, max_levels):
        f0 = YuvFrame(w >> i, h >> i, ref0.subsample, 32, ref0.bitdepth,
                      ref0.input_bitdepth)
        f1 = YuvFrame(w >> i, h >> i, ref0.subsample, 32, ref0.bitdepth,
                      ref0.input_bitdepth)
        in_down.append([f0, f1])
    for lvl in range(max_levels - 1):
        _downscale_luma(in_down[lvl][0], in_down[lvl + 1][0])
        _downscale_luma(in_down[lvl][1], in_down[lvl + 1][1])

    for lvl in range(max_levels - 1, -1, -1):
        guides = [] if lvl == max_levels - 1 else [spatial[lvl]]
        motion_estimate_bi(mv_data[lvl], guides, in_down[lvl][0],
                           in_down[lvl][1])
        if lvl == 0:
            _interpolate_frame(mv_data[lvl], in_down[lvl][0],
                               in_down[lvl][1], new_frame, w, h)
        if lvl > 0:
            _upscale_mv_data(mv_data[lvl], spatial[lvl - 1])


# ---- MV store for interp_ref=2 (common/inter_prediction.c:250-350) ----

def _scale_mv_store(mv, scale, offset=0.125):
    scalef = 1.0 / scale
    absx, absy = abs(mv[1]), abs(mv[0])
    signx = 1 if mv[1] >= 0 else -1
    signy = 1 if mv[0] >= 0 else -1
    return (signy * int(math.floor(scalef * absy + offset)),
            signx * int(math.floor(scalef * absx + offset)))


def store_mv(dd, width, height, b_level, frame_type, frame_num, gop_size):
    """common/inter_prediction.c:259-350 store_mv (P_FRAME=1, B_FRAME=2)."""
    P_FRAME, B_FRAME = 1, 2
    MODE_INTRA = 1
    phase = frame_num % gop_size
    scale_array = [8.0 / 4.0, 16.0 / 4.0, 9.0 / 4.0, 11.0 / 4.0]
    num_lev = log2i(gop_size)

    if gop_size == 3:
        scale_array2 = [3.0 / 3.0, 6.0 / 3.0, 5.0 / 3.0]
        for bi in range((height // MIN_PB_SIZE) * (width // MIN_PB_SIZE)):
            ref_idx0 = int(dd.ref_idx0[bi])
            bipred = int(dd.bipred_flag[bi])
            if frame_type == P_FRAME:
                mvin = (int(dd.mv0[bi, 0]), int(dd.mv0[bi, 1]))
                mvout = _scale_mv_store(mvin, 3.0 * scale_array2[ref_idx0])
                dd.arr_mv0[bi, 1] = mvout
                dd.arr_mv0[bi, 2] = mvout
            elif (frame_type == B_FRAME and phase == 1 and
                  int(dd.mode[bi]) != MODE_INTRA):
                if bipred or ref_idx0 == 1:
                    mvin = ((int(dd.mv1[bi, 0]), int(dd.mv1[bi, 1])) if bipred
                            else (int(dd.mv0[bi, 0]), int(dd.mv0[bi, 1])))
                    dd.arr_mv0[bi, 2] = _scale_mv_store(mvin, 2.0)
        return

    for bi in range((height // MIN_PB_SIZE) * (width // MIN_PB_SIZE)):
        ref_idx0 = int(dd.ref_idx0[bi])
        bipred = int(dd.bipred_flag[bi])
        if frame_type == P_FRAME:
            mvin = (int(dd.mv0[bi, 0]), int(dd.mv0[bi, 1]))
            for lev in range(num_lev):
                scale = 1 << lev
                mvout = _scale_mv_store(mvin, scale * scale_array[ref_idx0])
                inc = gop_size >> lev
                for p in range(inc >> 1, gop_size, inc):
                    dd.arr_mv0[bi, p] = mvout
        elif (frame_type == B_FRAME and b_level < num_lev - 1 and
              int(dd.mode[bi]) != MODE_INTRA):
            if bipred or ref_idx0 == 0:
                mvin = (int(dd.mv0[bi, 0]), int(dd.mv0[bi, 1]))
                for lev in range(b_level + 1, num_lev):
                    scale = 1 << (lev - b_level)
                    mvout = _scale_mv_store(mvin, float(scale))
                    inc = gop_size >> lev
                    delta = (scale - 1) * (inc >> 1)
                    for p in range(phase - delta, phase, inc):
                        dd.arr_mv0[bi, p] = mvout
            if bipred or ref_idx0 == 1:
                mvin = ((int(dd.mv1[bi, 0]), int(dd.mv1[bi, 1])) if bipred
                        else (int(dd.mv0[bi, 0]), int(dd.mv0[bi, 1])))
                for lev in range(b_level + 1, num_lev):
                    scale = 1 << (lev - b_level)
                    mvout = _scale_mv_store(mvin, float(scale))
                    inc = gop_size >> lev
                    delta = (scale - 1) * (inc >> 1)
                    for p in range(phase + delta, phase, -inc):
                        dd.arr_mv0[bi, p] = mvout
