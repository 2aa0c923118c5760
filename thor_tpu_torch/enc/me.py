"""Motion estimation (mirrors enc/encode_block.c:174-913).

All SAD/search arithmetic is integer-exact; the fast half/quarter-pel
approximations use the same averaging trees as the reference SIMD kernels
(enc/enc_kernels.c), which the scalar C code replicates.
"""
from __future__ import annotations

import numpy as np

from ..spec.inter import clip_mv, mc_luma

MAX_UINT32 = 1 << 31


def quote_mv_bits(mv_diff_y: int, mv_diff_x: int) -> int:
    """enc/encode_block.c:467-515."""
    bits = 0
    for mvabs in (abs(mv_diff_x), abs(mv_diff_y)):
        if mvabs < 1:
            ln = 2
        elif mvabs < 2:
            ln = 4
        elif mvabs < 4:
            ln = 5
        elif mvabs < 36:
            ln = 5 + ((mvabs - 4) >> 3) + 1
        else:
            ln = 10 + ((mvabs - 36) >> 4) + 1
        bits += ln
    return bits


def sad_calc(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def widesad_calc(a: np.ndarray, bfull: np.ndarray, by: int, bx: int,
                 width: int, height: int):
    """SAD at five positions x.xXx.x returning (best_sad, best_xoff)
    (enc/encode_block.c:430-453)."""
    best_sad = 1 << 31
    best_x = 0
    a32 = a.astype(np.int32)
    for off in (-3, -1, 0, 1, 3):
        b = bfull[by:by + height, bx + off:bx + off + width].astype(np.int32)
        sad = int(np.abs(a32 - b).sum())
        if sad < best_sad:
            best_sad = sad
            best_x = off
    return best_sad, best_x


def ssd_calc(a: np.ndarray, b: np.ndarray) -> int:
    d = a.astype(np.int64) - b.astype(np.int64)
    return int((d * d).sum())


def _avg(a, b):
    return (a + b + 1) >> 1


def sad_calc_fasthalf(a: np.ndarray, bfull: np.ndarray, by: int, bx: int,
                      width: int, height: int):
    """8 half-pel positions via avg trees (enc/encode_block.c:174-282).
    a: (h,w) original; bfull int32 padded ref; (by,bx) centre position.
    Returns (best_sad, best_x, best_y) with x/y in {-2,0,2}."""
    o = a.astype(np.int32)

    def b(dy, dx):
        return bfull[by + dy:by + dy + height, bx + dx:bx + dx + width]

    t2 = _avg(b(0, -1), b(0, 0))
    left = int(np.abs(o - t2).sum())
    t8 = _avg(b(0, 0), b(0, 1))
    right = int(np.abs(o - t8).sum())
    down = int(np.abs(o - _avg(b(0, 0), b(1, 0))).sum())
    top = int(np.abs(o - _avg(b(0, 0), b(-1, 0))).sum())

    # corners via the exact averaging trees
    t1 = _avg(b(-1, -1), b(-1, 0))
    t1 = (t1 + t2) >> 1
    t3 = _avg(b(-2, -1), b(1, -1))
    t4 = _avg(b(-2, 0), b(1, 0))
    t3 = (t3 + t4) >> 1
    t5 = _avg(b(-1, -2), b(-1, 1))
    t6 = _avg(b(0, -2), b(0, 1))
    t5a = (t5 + t6) >> 1
    t5a = (t3 + t5a) >> 1
    ptl = (t5a + t1) >> 1
    tl = int(np.abs(o - ptl).sum())

    t1 = _avg(b(-1, 0), b(-1, 1))
    t1 = (t1 + t8) >> 1
    t5b = _avg(b(-2, 1), b(1, 1))
    t3 = (t4 + t5b) >> 1
    t4b = _avg(b(-1, -1), b(-1, 2))
    t7 = _avg(b(0, -1), b(0, 2))
    t5c = (t7 + t4b) >> 1
    t5c = (t3 + t5c) >> 1
    ptr = (t5c + t1) >> 1
    tr = int(np.abs(o - ptr).sum())

    t1 = _avg(b(1, -1), b(1, 0))
    t3 = (t1 + t2) >> 1
    t2b = _avg(b(-1, -1), b(2, -1))
    t4c = _avg(b(-1, 0), b(2, 0))
    t5d = (t4c + t2b) >> 1
    t1b = _avg(b(1, -2), b(1, 1))
    t2c = (t6 + t1b) >> 1
    t2c = (t5d + t2c) >> 1
    pbl = (t2c + t3) >> 1
    bl = int(np.abs(o - pbl).sum())

    t2d = _avg(b(1, 0), b(1, 1))
    t3 = (t8 + t2d) >> 1
    t5e = _avg(b(-1, 1), b(2, 1))
    t6b = (t4c + t5e) >> 1
    t8b = _avg(b(1, -1), b(1, 2))
    t1c = (t7 + t8b) >> 1
    t2e = (t6b + t1c) >> 1
    pbr = (t2e + t3) >> 1
    br = int(np.abs(o - pbr).sum())

    bestx, besty, best = 0, -2, top
    if down < best:
        besty, best = 2, down
    if right < best:
        bestx, besty, best = 2, 0, right
    if left < best:
        bestx, besty, best = -2, 0, left
    if tl < best:
        bestx, besty, best = -2, -2, tl
    if tr < best:
        bestx, besty, best = 2, -2, tr
    if br < best:
        bestx, besty, best = 2, 2, br
    if bl < best:
        bestx, besty, best = -2, 2, bl
    return best, bestx, besty


def sad_calc_fastquarter(o: np.ndarray, bfull: np.ndarray, by: int, bx: int,
                         width: int, height: int, inx: int, iny: int):
    """8 quarter-pel positions around a half-pel centre
    (enc/encode_block.c:286-415).  inx/iny: the half-pel phase (nonzero if
    centre is at a half-pel offset in that dimension)."""
    og = o.astype(np.int32)

    def r(dy, dx):
        return bfull[by + dy:by + dy + height, bx + dx:bx + dx + width]

    a = r(0, 0)
    d = r(0, 1)
    e = r(1, 1)
    f = r(1, 0)
    if inx and iny:
        ad = _avg(a, d)
        de = _avg(d, e)
        af = _avg(a, f)
        fe = _avg(f, e)
        preds = {
            (-1, -1): (ad + af) >> 1, (0, -1): (de + a) >> 1,
            (1, -1): (ad + de) >> 1, (-1, 0): (ad + f) >> 1,
            (1, 0): (ad + e) >> 1, (-1, 1): (af + fe) >> 1,
            (0, 1): (de + f) >> 1, (1, 1): (de + fe) >> 1}
    elif inx:
        b_ = r(-1, 0)
        c = r(-1, 1)
        ad = _avg(a, d)
        de = _avg(d, e)
        dc = _avg(d, c)
        af = _avg(a, f)
        ab = _avg(a, b_)
        preds = {
            (-1, -1): (ad + ab) >> 1, (0, -1): (dc + a) >> 1,
            (1, -1): (ad + dc) >> 1, (-1, 0): (ad + a) >> 1,
            (1, 0): (ad + d) >> 1, (-1, 1): (ad + af) >> 1,
            (0, 1): (af + d) >> 1, (1, 1): (ad + de) >> 1}
    elif iny:
        g = r(1, -1)
        h = r(0, -1)
        ad = _avg(a, d)
        af = _avg(a, f)
        fe = _avg(f, e)
        ah = _avg(a, h)
        gf = _avg(g, f)
        preds = {
            (-1, -1): (ah + af) >> 1, (0, -1): (af + a) >> 1,
            (1, -1): (ad + af) >> 1, (-1, 0): (gf + a) >> 1,
            (1, 0): (ad + f) >> 1, (-1, 1): (af + gf) >> 1,
            (0, 1): (af + f) >> 1, (1, 1): (af + fe) >> 1}
    else:
        b_ = r(-1, 0)
        h = r(0, -1)
        ad = _avg(a, d)
        af = _avg(a, f)
        ah = _avg(a, h)
        ab = _avg(a, b_)
        preds = {
            (-1, -1): (ah + ab) >> 1, (0, -1): (ab + a) >> 1,
            (1, -1): (ad + ab) >> 1, (-1, 0): (ah + a) >> 1,
            (1, 0): (ad + a) >> 1, (-1, 1): (ah + af) >> 1,
            (0, 1): (af + a) >> 1, (1, 1): (af + ad) >> 1}

    sad = {k: int(np.abs(og - v).sum()) for k, v in preds.items()}
    tl, top_, tr = sad[(-1, -1)], sad[(0, -1)], sad[(1, -1)]
    left, right = sad[(-1, 0)], sad[(1, 0)]
    bl, down, br = sad[(-1, 1)], sad[(0, 1)], sad[(1, 1)]

    bestx, besty, best = 0, -1, top_
    if tl < best:
        bestx, best = -1, tl
    if tr < best:
        bestx, best = 1, tr
    if left < best:
        bestx, besty, best = -1, 0, left
    if right < best:
        bestx, besty, best = 1, 0, right
    if bl < best:
        bestx, besty, best = -1, 1, bl
    if down < best:
        bestx, besty, best = 0, 1, down
    if br < best:
        bestx, besty, best = 1, 1, br
    return best, bestx, besty


class RefView:
    """Reference plane accessor anchored at a block position."""

    def __init__(self, ref_frame, ypos, xpos):
        self.full = ref_frame.y_full.astype(np.int32)
        self.pad = ref_frame.pad
        self.y0 = self.pad + ypos
        self.x0 = self.pad + xpos

    def block(self, dy, dx, h, w):
        return self.full[self.y0 + dy:self.y0 + dy + h,
                         self.x0 + dx:self.x0 + dx + w]


def motion_estimate(org: np.ndarray, ref_frame, ypos, xpos, size,
                    width, height, mvc, mvp, lam, params, sign,
                    fwidth, fheight, mvcand, mvcand_num, enable_bipred,
                    bitdepth, base_off=(0, 0), sync=0):
    """Full ME for one PU (enc/encode_block.c:517-711).

    org: (height,width) block of original pixels; ref_frame: padded
    YuvFrame; mvc/mvp: (y,x).  (ypos,xpos) is the parent block position
    (used for MV clipping and MC clamps); base_off offsets the reference
    read base to the sub-PU (C passes ref_y+offset_r with block coords).
    Returns (sad, mv)."""
    if sync:
        return motion_estimate_sync(org, ref_frame, ypos, xpos, size, width,
                                    height, mvc, mvp, lam, params, sign,
                                    fwidth, fheight, mvcand, mvcand_num,
                                    enable_bipred, bitdepth, base_off)
    s = -1 if sign else 1
    rv = RefView(ref_frame, ypos + base_off[0], xpos + base_off[1])
    min_sad = MAX_UINT32
    mv_opt = (0, 0)
    mv_ref = ((((mvc[0]) + 2) >> 2) << 2, (((mvc[1]) + 2) >> 2) << 2)

    def cand_sad_plain(mv_cand):
        return sad_calc(org, rv.block(s * (mv_cand[0] >> 2),
                                      s * (mv_cand[1] >> 2), height, width))

    if (size == 16 and enable_bipred) or params.encoder_speed == 0:
        step = 32
        while step >= 4:
            rng = 2 * step
            best = None
            for k in range(-rng, rng + 1, step):
                for l in range(-rng, rng + 1, step):
                    if step < 32 and k == 0 and l == 0:
                        continue
                    mv_cand = (mv_ref[0] + k, mv_ref[1] + l)
                    mv_cand = clip_mv(mv_cand[0], mv_cand[1], ypos, xpos,
                                      fwidth, fheight, size, size, sign)
                    if (step == 32 and size == 16 and
                            0 < params.encoder_speed < 2):
                        sad, x = widesad_calc(
                            org, rv.full,
                            rv.y0 + s * (mv_cand[0] >> 2),
                            rv.x0 + s * (mv_cand[1] >> 2), width, height)
                        mv_cand = (mv_cand[0], mv_cand[1] + ((s * x) << 2))
                    else:
                        sad = cand_sad_plain(mv_cand)
                    sad >>= bitdepth - 8
                    sad += int(lam * quote_mv_bits(mv_cand[0] - mvp[0],
                                                   mv_cand[1] - mvp[1]) + 0.5)
                    if sad < min_sad:
                        min_sad = sad
                        mv_opt = mv_cand
            mv_ref = mv_opt
            step >>= 1

    # Candidate search
    for idx in range(mvcand_num[0]):
        x = 0
        mv_cand = (int(mvcand[idx][0]) << 2, int(mvcand[idx][1]) << 2)
        mv_cand = clip_mv(mv_cand[0], mv_cand[1], ypos, xpos, fwidth,
                          fheight, size, size, sign)
        if size == 16:
            sad, x = widesad_calc(org, rv.full,
                                  rv.y0 + s * (mv_cand[0] >> 2),
                                  rv.x0 + s * (mv_cand[1] >> 2),
                                  width, height)
        else:
            sad = cand_sad_plain(mv_cand)
        sad >>= bitdepth - 8
        mv_cand = (mv_cand[0], mv_cand[1] + ((s * x) << 2))
        sad += int(lam * quote_mv_bits(mv_cand[0] - mvp[0],
                                       mv_cand[1] - mvp[1]) + 0.5)
        if sad < min_sad:
            min_sad = sad
            mv_opt = mv_cand
    mv_ref = mv_opt

    # Hexagon full-pel refinement
    maxsteps = 6 if (size <= 16 or params.encoder_speed == 0) else 0
    start, end = 0, 5
    diy = [1, 2, 1, -1, -2, -1]
    dix = [-1, 0, 1, 1, 0, -1]
    for step in range(1, maxsteps):
        direc = start - 1
        best_dir = -1
        while True:
            direc += 1
            if direc == 6:
                direc = 0
            mv_cand = (mv_ref[0] + dix[direc] * 4, mv_ref[1] + diy[direc] * 4)
            mv_cand = clip_mv(mv_cand[0], mv_cand[1], ypos, xpos, fwidth,
                              fheight, size, size, sign)
            sad = cand_sad_plain(mv_cand) >> (bitdepth - 8)
            sad += int(lam * quote_mv_bits(mv_cand[0] - mvp[0],
                                           mv_cand[1] - mvp[1]) + 0.5)
            if sad < min_sad:
                min_sad = sad
                mv_opt = mv_cand
                best_dir = direc
            if direc == end:
                break
        mv_ref = mv_opt
        start = best_dir - 1 if best_dir else 5
        end = start + 2
        if end >= 6:
            end -= 6
        if best_dir < 0:
            break

    ydelta_hp = xdelta_hp = ydelta_qp = xdelta_qp = 0
    cmin = min_sad

    if params.encoder_speed == 0:
        hmpos = [0, 0, -2, 2, 0, -2, -2, 2, 2]
        hnpos = [0, -2, 0, 0, 2, -2, 2, -2, 2]
        for i in range(1, 9):
            mv_cand = (mv_ref[0] + hmpos[i], mv_ref[1] + hnpos[i])
            pred = mc_luma(ref_frame.y_full, ref_frame.pad,
                           ypos + base_off[0], xpos + base_off[1],
                           width, height, mv_cand[0], mv_cand[1], sign,
                           enable_bipred, fwidth, fheight, bitdepth,
                           ypos, xpos)
            sad = sad_calc(org, pred) >> (bitdepth - 8)
            sad += int(lam * quote_mv_bits(mv_cand[0] - mvp[0],
                                           mv_cand[1] - mvp[1]) + 0.5)
            if sad < cmin:
                cmin = sad
                ydelta_hp, xdelta_hp = hmpos[i], hnpos[i]
        mv_opt = (mv_opt[0] + ydelta_hp, mv_opt[1] + xdelta_hp)
        qmpos = [0, 0, -1, 1, 0, -1, -1, 1, 1]
        qnpos = [0, -1, 0, 0, 1, -1, 1, -1, 1]
        for i in range(1, 9):
            mv_cand = (mv_opt[0] + qmpos[i], mv_opt[1] + qnpos[i])
            pred = mc_luma(ref_frame.y_full, ref_frame.pad,
                           ypos + base_off[0], xpos + base_off[1],
                           width, height, mv_cand[0], mv_cand[1], sign,
                           enable_bipred, fwidth, fheight, bitdepth,
                           ypos, xpos)
            sad = sad_calc(org, pred) >> (bitdepth - 8)
            sad += int(lam * quote_mv_bits(mv_cand[0] - mvp[0],
                                           mv_cand[1] - mvp[1]) + 0.5)
            if sad < cmin:
                cmin = sad
                ydelta_qp, xdelta_qp = qmpos[i], qnpos[i]
    else:
        # fast bilinear approximation
        mr = (mv_ref[0] * s, mv_ref[1] * s)
        sad, spx, spy = sad_calc_fasthalf(
            org, rv.full, rv.y0 + (mr[0] >> 2), rv.x0 + (mr[1] >> 2),
            width, height)
        sad >>= bitdepth - 8
        sad += int(lam * quote_mv_bits(mr[0] + s * spy - mvp[0],
                                       mr[1] + s * spx - mvp[1]) + 0.5)
        if sad < cmin:
            cmin = sad
            xdelta_hp, ydelta_hp = s * spx, s * spy
        spx, spy = xdelta_hp, ydelta_hp
        mr = (mv_opt[0] + s * spy, mv_opt[1] + s * spx)
        mv_opt = (mv_opt[0] + ydelta_hp, mv_opt[1] + xdelta_hp)

        # quarter-pel search around the half-pel-refined centre; the phase
        # flags are the half-pel deltas (C reuses spx/spy in-out)
        qy = rv.y0 + s * (mr[0] >> 2)
        qx = rv.x0 + s * (mr[1] >> 2)
        inx_flag = spx
        iny_flag = spy
        sad, spx2, spy2 = sad_calc_fastquarter(org, rv.full, qy, qx,
                                               width, height, inx_flag,
                                               iny_flag)
        sad >>= bitdepth - 8
        sad += int(lam * quote_mv_bits(mr[0] + s * spy2 - mvp[0],
                                       mr[1] + s * spx2 - mvp[1]) + 0.5)
        if sad < cmin:
            cmin = sad
            xdelta_qp, ydelta_qp = s * spx2, s * spy2

    mv_opt = (mv_opt[0] + ydelta_qp, mv_opt[1] + xdelta_qp)
    return min(cmin, min_sad), mv_opt


def motion_estimate_bi(org, ref0, ref1, ypos, xpos, size, width, height,
                       mvc, mvp, lam, params, sign, fwidth, fheight,
                       mvcand, mvcand_num, enable_bipred, bitdepth):
    """Simultaneous bipred ME with mv0=-mv1 (enc/encode_block.c:798-913)."""
    rv0 = RefView(ref0, ypos, xpos)
    rv1 = RefView(ref1, ypos, xpos)
    min_sad = MAX_UINT32
    mv_opt = (0, 0)
    mv_ref = ((((mvc[0]) + 2) >> 2) << 2, (((mvc[1]) + 2) >> 2) << 2)

    def bi_sad(mv_cand):
        m0 = clip_mv(mv_cand[0], mv_cand[1], ypos, xpos, fwidth, fheight,
                     size, size, sign)
        p0 = mc_luma(ref0.y_full, ref0.pad, ypos, xpos, width, height,
                     m0[0], m0[1], sign, enable_bipred, fwidth, fheight,
                     bitdepth)
        # C clips in place: the second clip operates on the first's output
        m1 = clip_mv(m0[0], m0[1], ypos, xpos, fwidth, fheight,
                     size, size, 1 - sign)
        p1 = mc_luma(ref1.y_full, ref1.pad, ypos, xpos, width, height,
                     m1[0], m1[1], 1 - sign, enable_bipred, fwidth, fheight,
                     bitdepth)
        rf = (p0 + p1) >> 1
        # NB: after the two clip_mv calls the C cost uses the second clip's
        # result (mv_cand mutated in place)
        return sad_calc(org, rf) >> (bitdepth - 8), m1

    step = 32
    while step > 0:
        rng = step
        for k in range(-rng, rng + 1, step):
            for l in range(-rng, rng + 1, step):
                if step < 32 and k == 0 and l == 0:
                    continue
                if step == 1:
                    vf, hf = mv_ref[0] & 3, mv_ref[1] & 3
                    if vf == 0 and hf == 0:
                        if abs(k) != abs(l):
                            continue
                    elif vf == 2 and hf == 2:
                        continue
                    else:
                        if abs(k) == abs(l):
                            continue
                mv_cand = (mv_ref[0] + k, mv_ref[1] + l)
                sad, mc_final = bi_sad(mv_cand)
                sad += int(lam * quote_mv_bits(mc_final[0] - mvp[0],
                                               mc_final[1] - mvp[1]) + 0.5)
                if sad < min_sad:
                    min_sad = sad
                    mv_opt = mc_final
        mv_ref = mv_opt
        step >>= 1

    # C zero-fills slots [num..3] in place, then sets [4]=mvp, [5]=0
    for idx in range(mvcand_num[0], 4):
        mvcand[idx] = (0, 0)
    mvcand[4] = mvp
    mvcand[5] = (0, 0)
    for idx in range(6):
        mv_cand = (int(mvcand[idx][0]), int(mvcand[idx][1]))
        sad, mc_final = bi_sad(mv_cand)
        sad += int(lam * quote_mv_bits(mc_final[0] - mvp[0],
                                       mc_final[1] - mvp[1]) + 0.5)
        if sad < min_sad:
            min_sad = sad
            mv_opt = mc_final
    return min_sad, mv_opt


def motion_estimate_sync(org, ref_frame, ypos, xpos, size, width, height,
                         mvc, mvp, lam, params, sign, fwidth, fheight,
                         mvcand, mvcand_num, enable_bipred, bitdepth,
                         base_off=(0, 0)):
    """Wavefront-safe ME (enc/encode_block.c:713-796): telescope search to
    quarter-pel resolution using full MC, then a 6-entry candidate pass.
    NB: the C writes mvp and zero into mvcand[4]/[5] in place."""
    min_sad = MAX_UINT32
    mv_opt = (0, 0)
    mv_ref = ((((mvc[0]) + 2) >> 2) << 2, (((mvc[1]) + 2) >> 2) << 2)

    def mc_sad(mv_cand):
        m = clip_mv(mv_cand[0], mv_cand[1], ypos, xpos, fwidth, fheight,
                    size, size, sign)
        pred = mc_luma(ref_frame.y_full, ref_frame.pad,
                       ypos + base_off[0], xpos + base_off[1], width,
                       height, m[0], m[1], sign, enable_bipred, fwidth,
                       fheight, bitdepth, ypos, xpos)
        sad = sad_calc(org, pred) >> (bitdepth - 8)
        sad += int(lam * quote_mv_bits(m[0] - mvp[0], m[1] - mvp[1]) + 0.5)
        return sad, m

    step = 32
    while step > 0:
        rng = step
        for k in range(-rng, rng + 1, step):
            for l in range(-rng, rng + 1, step):
                if step < 32 and k == 0 and l == 0:
                    continue
                if step == 1:
                    vf, hf = mv_ref[0] & 3, mv_ref[1] & 3
                    if vf == 0 and hf == 0:
                        if abs(k) != abs(l):
                            continue
                    elif vf == 2 and hf == 2:
                        continue
                    else:
                        if abs(k) == abs(l):
                            continue
                sad, m = mc_sad((mv_ref[0] + k, mv_ref[1] + l))
                if sad < min_sad:
                    min_sad = sad
                    mv_opt = m
        mv_ref = mv_opt
        step >>= 1

    # candidate pass over 6 fixed slots (C mutates mvcand[4]/[5];
    # slots [num..3] hold stale values from earlier searches)
    mvcand[4] = mvp
    mvcand[5] = (0, 0)
    for idx in range(6):
        sad, m = mc_sad((int(mvcand[idx][0]), int(mvcand[idx][1])))
        if sad < min_sad:
            min_sad = sad
            mv_opt = m
    return min_sad, mv_opt
