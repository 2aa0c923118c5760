"""In-loop filters: deblocking, CLPF, CDEF.

Mirrors reference common/common_frame.c:47-432 (deblock), 1005-1157 (CLPF
frame drive), common/common_block.c:85-345 (CDEF dir/filter, CLPF block).

All three are non-recursive per pass on TPU-relevant granularity: every
output pixel depends only on the pre-pass frame (the reference implements
this via a delayed write-back cache; see common_frame.c:851-1002), so each
maps to an embarrassingly-parallel kernel.
"""
from __future__ import annotations

import numpy as np

from ..tables import (BETA_TABLE, TC_TABLE, MIN_PB_SIZE, MIN_BLOCK_SIZE,
                      CDEF_DIRECTIONS_X, CDEF_DIRECTIONS_Y, CDEF_PRI_TAPS,
                      CDEF_SEC_TAPS, CDEF_VERY_LARGE, log2i)

MODE_SKIP = 0
MODE_INTRA = 1


def _ctrunc2(v):
    """C truncation toward zero of v/2."""
    return int(v / 2) if v >= 0 or v % 2 == 0 else -((-v) // 2)


def deblock_frame_y(rec_y: np.ndarray, dd, width, height, qp, bitdepth):
    """Luma deblock, in place (common_frame.c:47-352).
    MODIFIED_DEBLOCK_TEST=1, NEW_MV_TEST=1, NEW_DEBLOCK_FILTER=1."""
    beta = int(BETA_TABLE[qp]) << (bitdepth - 8)
    tc = (int(TC_TABLE[qp]) << (bitdepth - 12) if bitdepth > 12
          else int(TC_TABLE[qp]) >> (12 - bitdepth))
    r = rec_y
    bstr = dd.bs

    def filt_edge_v(i, j, k, d15, d26):
        d = d26 if (k & 1) else d15
        if d < beta:
            p1 = int(r[i + k, j - 2]); p0 = int(r[i + k, j - 1])
            q0 = int(r[i + k, j + 0]); q1 = int(r[i + k, j + 1])
            delta = (18 * (q0 - p0) - 6 * (q1 - p1) + 16) >> 5
            delta = max(-tc, min(tc, delta))
            hi = (1 << bitdepth) - 1
            r[i + k, j - 2] = min(hi, max(0, p1 + _ctrunc2(delta)))
            r[i + k, j - 1] = min(hi, max(0, p0 + delta))
            r[i + k, j + 0] = min(hi, max(0, q0 - delta))
            r[i + k, j + 1] = min(hi, max(0, q1 - _ctrunc2(delta)))

    def filt_edge_h(i, j, l, d15, d26):
        d = d26 if (l & 1) else d15
        if d < beta:
            p1 = int(r[i - 2, j + l]); p0 = int(r[i - 1, j + l])
            q0 = int(r[i + 0, j + l]); q1 = int(r[i + 1, j + l])
            delta = (18 * (q0 - p0) - 6 * (q1 - p1) + 16) >> 5
            delta = max(-tc, min(tc, delta))
            hi = (1 << bitdepth) - 1
            r[i - 2, j + l] = min(hi, max(0, p1 + _ctrunc2(delta)))
            r[i - 1, j + l] = min(hi, max(0, p0 + delta))
            r[i + 0, j + l] = min(hi, max(0, q0 - delta))
            r[i + 1, j + l] = min(hi, max(0, q1 - _ctrunc2(delta)))

    def mv_test(p, q):
        return (abs(int(dd.mv0[p, 0])) >= 4 or abs(int(dd.mv0[q, 0])) >= 4 or
                abs(int(dd.mv0[p, 1])) >= 4 or abs(int(dd.mv0[q, 1])) >= 4 or
                abs(int(dd.mv1[p, 0])) >= 4 or abs(int(dd.mv1[q, 0])) >= 4 or
                abs(int(dd.mv1[p, 1])) >= 4 or abs(int(dd.mv1[q, 1])) >= 4)

    # Vertical edges
    for i in range(0, height, MIN_BLOCK_SIZE):
        for j in range(MIN_BLOCK_SIZE, width, MIN_BLOCK_SIZE):
            d15 = (abs(int(r[i + 1, j - 2]) - int(r[i + 1, j - 1])) +
                   abs(int(r[i + 1, j + 1]) - int(r[i + 1, j + 0])) +
                   abs(int(r[i + 5, j - 2]) - int(r[i + 5, j - 1])) +
                   abs(int(r[i + 5, j + 1]) - int(r[i + 5, j + 0])))
            d26 = (abs(int(r[i + 2, j - 2]) - int(r[i + 2, j - 1])) +
                   abs(int(r[i + 2, j + 1]) - int(r[i + 2, j + 0])) +
                   abs(int(r[i + 6, j - 2]) - int(r[i + 6, j - 1])) +
                   abs(int(r[i + 6, j + 1]) - int(r[i + 6, j + 0])))
            for m in range(0, MIN_BLOCK_SIZE, MIN_PB_SIZE):
                q_idx = ((i + m) // MIN_PB_SIZE) * bstr + j // MIN_PB_SIZE
                p_idx = q_idx - 1
                q_size = int(dd.size[q_idx])
                if ((dd.tb_split[q_idx] or dd.pb_part[q_idx] == 2 or
                     dd.pb_part[q_idx] == 3) and q_size > MIN_BLOCK_SIZE):
                    q_size //= 2
                mv = mv_test(p_idx, q_idx)
                cbp = dd.cbp_y[p_idx] or dd.cbp_y[q_idx]
                mode = (dd.mode[p_idx] == MODE_INTRA or
                        dd.mode[q_idx] == MODE_INTRA)
                interior = (j % q_size) > 0
                if (not interior) and (mv or cbp or mode):
                    for k in range(m, m + MIN_PB_SIZE):
                        filt_edge_v(i, j, k, d15, d26)

    # Horizontal edges
    for i in range(MIN_BLOCK_SIZE, height, MIN_BLOCK_SIZE):
        for j in range(0, width, MIN_BLOCK_SIZE):
            d15 = (abs(int(r[i - 2, j + 1]) - int(r[i - 1, j + 1])) +
                   abs(int(r[i + 1, j + 1]) - int(r[i + 0, j + 1])) +
                   abs(int(r[i - 2, j + 5]) - int(r[i - 1, j + 5])) +
                   abs(int(r[i + 1, j + 5]) - int(r[i + 0, j + 5])))
            d26 = (abs(int(r[i - 2, j + 2]) - int(r[i - 1, j + 2])) +
                   abs(int(r[i + 1, j + 2]) - int(r[i + 0, j + 2])) +
                   abs(int(r[i - 2, j + 6]) - int(r[i - 1, j + 6])) +
                   abs(int(r[i + 1, j + 6]) - int(r[i + 0, j + 6])))
            for n in range(0, MIN_BLOCK_SIZE, MIN_PB_SIZE):
                q_idx = (i // MIN_PB_SIZE) * bstr + (j + n) // MIN_PB_SIZE
                p_idx = q_idx - bstr
                q_size = int(dd.size[q_idx])
                if ((dd.tb_split[q_idx] or dd.pb_part[q_idx] == 1 or
                     dd.pb_part[q_idx] == 3) and q_size > MIN_BLOCK_SIZE):
                    q_size //= 2
                mv = mv_test(p_idx, q_idx)
                cbp = dd.cbp_y[p_idx] or dd.cbp_y[q_idx]
                mode = (dd.mode[p_idx] == MODE_INTRA or
                        dd.mode[q_idx] == MODE_INTRA)
                interior = (i % q_size) > 0
                if (not interior) and (mv or cbp or mode):
                    for l in range(n, n + MIN_PB_SIZE):
                        filt_edge_h(i, j, l, d15, d26)


def deblock_frame_uv(rec_u, rec_v, dd, width, height, qpc, sub, bitdepth):
    """Chroma deblock, in place (common_frame.c:354-432).
    width/height in luma units."""
    tc = (int(TC_TABLE[qpc]) << (bitdepth - 12) if bitdepth > 12
          else int(TC_TABLE[qpc]) >> (12 - bitdepth))
    bstr = dd.bs
    hi = (1 << bitdepth) - 1
    for recC in (rec_u, rec_v):
        # vertical edges
        for i in range(0, height, MIN_BLOCK_SIZE):
            for j in range(MIN_BLOCK_SIZE, width, MIN_BLOCK_SIZE):
                i2, j2 = i >> sub, j >> sub
                q_idx = (i // MIN_PB_SIZE) * bstr + j // MIN_PB_SIZE
                p_idx = q_idx - 1
                q_size = int(dd.size[q_idx])
                mode = (dd.mode[p_idx] == MODE_INTRA or
                        dd.mode[q_idx] == MODE_INTRA)
                if (j % q_size) == 0 and mode:
                    for k in range(MIN_BLOCK_SIZE >> sub):
                        p1 = int(recC[i2 + k, j2 - 2]); p0 = int(recC[i2 + k, j2 - 1])
                        q0 = int(recC[i2 + k, j2 + 0]); q1 = int(recC[i2 + k, j2 + 1])
                        delta = (4 * (q0 - p0) + (p1 - q1) + 4) >> 3
                        delta = max(-tc, min(tc, delta))
                        recC[i2 + k, j2 - 1] = min(hi, max(0, p0 + delta))
                        recC[i2 + k, j2 + 0] = min(hi, max(0, q0 - delta))
        # horizontal edges
        for i in range(MIN_BLOCK_SIZE, height, MIN_BLOCK_SIZE):
            for j in range(0, width, MIN_BLOCK_SIZE):
                i2, j2 = i >> sub, j >> sub
                q_idx = (i // MIN_PB_SIZE) * bstr + j // MIN_PB_SIZE
                p_idx = q_idx - bstr
                q_size = int(dd.size[q_idx])
                mode = (dd.mode[p_idx] == MODE_INTRA or
                        dd.mode[q_idx] == MODE_INTRA)
                if (i % q_size) == 0 and mode:
                    for l in range(MIN_BLOCK_SIZE >> sub):
                        p1 = int(recC[i2 - 2, j2 + l]); p0 = int(recC[i2 - 1, j2 + l])
                        q0 = int(recC[i2 + 0, j2 + l]); q1 = int(recC[i2 + 1, j2 + l])
                        delta = (4 * (q0 - p0) + (p1 - q1) + 4) >> 3
                        delta = max(-tc, min(tc, delta))
                        recC[i2 - 1, j2 + l] = min(hi, max(0, p0 + delta))
                        recC[i2 + 0, j2 + l] = min(hi, max(0, q0 - delta))


# ---------------- CLPF ----------------

def _constrain(diff, threshold, damping):
    """common/common_block.c:217-221 (CDEF variant, used by CLPF too)."""
    if not threshold:
        return np.zeros_like(diff)
    shift = damping - log2i(threshold)
    ad = np.abs(diff)
    mag = np.minimum(ad, np.maximum(0, threshold - (ad >> shift)))
    return np.sign(diff) * mag


def clpf_block(src: np.ndarray, x0, y0, sizex, sizey, bt, strength, damping):
    """CLPF one block; returns the filtered block (common_block.c:315-345).
    src: full plane (pre-pass values).  bt: boundary flags."""
    TILE_LEFT, TILE_RIGHT, TILE_ABOVE, TILE_BOTTOM = 1, 2, 4, 8
    xmin = x0 - (0 if bt & TILE_LEFT else 2)
    ymin = y0 - (0 if bt & TILE_ABOVE else 2)
    xmax = x0 + sizex + (0 if bt & TILE_RIGHT else 2) - 1
    ymax = y0 + sizey + (0 if bt & TILE_BOTTOM else 2) - 1

    ys, xs = np.mgrid[y0:y0 + sizey, x0:x0 + sizex]
    s = src.astype(np.int32)

    def at(yy, xx):
        return s[np.clip(yy, ymin, ymax), np.clip(xx, xmin, xmax)]

    X = s[ys, xs]
    A = at(ys - 2, xs); B = at(ys - 1, xs)
    C = at(ys, xs - 2); D = at(ys, xs - 1)
    E = at(ys, xs + 1); F = at(ys, xs + 2)
    G = at(ys + 1, xs); H = at(ys + 2, xs)
    delta = (1 * _constrain(A - X, strength, damping) +
             3 * _constrain(B - X, strength, damping) +
             1 * _constrain(C - X, strength, damping) +
             3 * _constrain(D - X, strength, damping) +
             3 * _constrain(E - X, strength, damping) +
             1 * _constrain(F - X, strength, damping) +
             3 * _constrain(G - X, strength, damping) +
             1 * _constrain(H - X, strength, damping))
    d = (8 + delta - (delta < 0)) >> 4
    return X + d


def clpf_frame(plane_arr, dd, width_l, plane, strength, fb_size_log2,
               bitdepth, qp, sub, decision_bits=None):
    """Frame-level CLPF application (common_frame.c:1005-1131), in place.

    plane_arr: the plane to filter (visible view).  width_l: luma width.
    decision_bits: per-fb decision callback results (list consumed in order)
    or None for always-on.  Returns number of decisions consumed.
    """
    bs = 4 if (plane != 0 and sub) else 8
    height, width = plane_arr.shape
    num_fb_hor = (width + (1 << fb_size_log2) - 1) >> fb_size_log2
    num_fb_ver = (height + (1 << fb_size_log2) - 1) >> fb_size_log2
    damping = bitdepth - 4 - (plane != 0) + (qp >> 4)
    strength <<= bitdepth - 8
    src = plane_arr.copy()  # pre-pass values for all taps
    psub = sub if plane != 0 else 0
    # NB: the reference indexes deblock_data with the *plane-local* width as
    # stride (common_frame.c:1050,1074) - wrong stride for chroma, but it is
    # the normative behaviour, so we replicate it.
    bstr = width // MIN_PB_SIZE
    consumed = 0

    for k in range(num_fb_ver):
        for l in range(num_fb_hor):
            xoff = l << fb_size_log2
            yoff = k << fb_size_log2
            allskip = True
            for m in range(0, (1 << fb_size_log2) // bs):
                for n in range(0, (1 << fb_size_log2) // bs):
                    xpos = xoff + n * bs
                    ypos = yoff + m * bs
                    if xpos < width and ypos < height:
                        idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                               ((xpos << psub) // MIN_PB_SIZE))
                        if dd.mode[idx] != MODE_SKIP:
                            allskip = False
                    if not allskip:
                        break
                if not allskip:
                    break
            h = min(height, (k + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            w = min(width, (l + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            h += (not h) << fb_size_log2
            w += (not w) << fb_size_log2
            if allskip:
                continue
            if decision_bits is not None:
                bit = decision_bits[consumed]
                consumed += 1
                if not bit:
                    continue
            for m in range((h + bs - 1) // bs):
                for n in range((w + bs - 1) // bs):
                    xpos = xoff + n * bs
                    ypos = yoff + m * bs
                    sizex = min(width - xpos, bs)
                    sizey = min(height - ypos, bs)
                    idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                           ((xpos << psub) // MIN_PB_SIZE))
                    if dd.mode[idx] == MODE_SKIP:
                        continue
                    bt = ((1 if not xpos else 0) |
                          (4 if not ypos else 0) |
                          (2 if xpos == width - sizex else 0) |
                          (8 if ypos == height - sizey else 0))
                    out = clpf_block(src, xpos, ypos, sizex, sizey, bt,
                                     strength, damping)
                    plane_arr[ypos:ypos + sizey, xpos:xpos + sizex] = out
    return consumed


def count_clpf_decisions(dd, width, height, plane, fb_size_log2, sub):
    """How many per-fb decision bits clpf_frame will consume (for the
    decoder to read them from the stream lazily)."""
    bs = 4 if (plane != 0 and sub) else 8
    psub = sub if plane != 0 else 0
    width >>= psub
    height >>= psub
    num_fb_hor = (width + (1 << fb_size_log2) - 1) >> fb_size_log2
    num_fb_ver = (height + (1 << fb_size_log2) - 1) >> fb_size_log2
    bstr = width // MIN_PB_SIZE  # plane-local stride quirk, see clpf_frame
    cnt = 0
    for k in range(num_fb_ver):
        for l in range(num_fb_hor):
            xoff = l << fb_size_log2
            yoff = k << fb_size_log2
            allskip = True
            for m in range(0, (1 << fb_size_log2) // bs):
                for n in range(0, (1 << fb_size_log2) // bs):
                    xpos = xoff + n * bs
                    ypos = yoff + m * bs
                    if xpos < width and ypos < height:
                        idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                               ((xpos << psub) // MIN_PB_SIZE))
                        if dd.mode[idx] != MODE_SKIP:
                            allskip = False
            if not allskip:
                cnt += 1
    return cnt


# ---------------- CDEF ----------------

def cdef_find_dir(img: np.ndarray, coeff_shift: int):
    """Direction detector on an 8x8 block (common_block.c:94-162).
    Returns (dir, var)."""
    x = (img.astype(np.int32) >> coeff_shift) - 128
    partial = [np.zeros(15, np.int64) for _ in range(8)]
    for i in range(8):
        for j in range(8):
            v = int(x[i, j])
            partial[0][i + j] += v
            partial[1][i + j // 2] += v
            partial[2][i] += v
            partial[3][3 + i - j // 2] += v
            partial[4][7 + i - j] += v
            partial[5][3 - i // 2 + j] += v
            partial[6][j] += v
            partial[7][i // 2 + j] += v
    div_table = [0, 840, 420, 280, 210, 168, 140, 120, 105]
    cost = [0] * 8
    for i in range(8):
        cost[2] += int(partial[2][i]) ** 2
        cost[6] += int(partial[6][i]) ** 2
    cost[2] *= div_table[8]
    cost[6] *= div_table[8]
    for i in range(7):
        cost[0] += (int(partial[0][i]) ** 2 + int(partial[0][14 - i]) ** 2) * div_table[i + 1]
        cost[4] += (int(partial[4][i]) ** 2 + int(partial[4][14 - i]) ** 2) * div_table[i + 1]
    cost[0] += int(partial[0][7]) ** 2 * div_table[8]
    cost[4] += int(partial[4][7]) ** 2 * div_table[8]
    for i in range(1, 8, 2):
        for j in range(5):
            cost[i] += int(partial[i][3 + j]) ** 2
        cost[i] *= div_table[8]
        for j in range(3):
            cost[i] += (int(partial[i][j]) ** 2 + int(partial[i][10 - j]) ** 2) * div_table[2 * j + 2]
    best_cost, best_dir = 0, 0
    for i in range(8):
        if cost[i] > best_cost:
            best_cost = cost[i]
            best_dir = i
    var = (best_cost - cost[(best_dir + 4) & 7]) >> 10
    return best_dir, var


def _constrain1(diff, threshold, damping):
    if not threshold:
        return 0
    s = -1 if diff < 0 else 1
    ad = abs(diff)
    return s * min(ad, max(0, threshold - (ad >> (damping - log2i(threshold)))))


def cdef_filter_block(inp: np.ndarray, pri_strength, sec_strength, direction,
                      pri_damping, sec_damping, sizey, sizex, coeff_shift):
    """5x5 CDEF filter (common_block.c:224-279).

    inp: (sizey+4, sizex+4) int array with 2-px border; border cells beyond
    tile edges hold CDEF_VERY_LARGE.  Returns (sizey,sizex) filtered.
    (The C version loops bsize=sizex rows and discards rows >= sizey on
    copy-back; we compute exactly the kept rows.)"""
    pri_taps = CDEF_PRI_TAPS[(pri_strength >> coeff_shift) & 1]
    sec_taps = CDEF_SEC_TAPS[(pri_strength >> coeff_shift) & 1]
    out = np.zeros((sizey, sizex), np.int32)
    for i in range(sizey):
        for j in range(sizex):
            ci, cj = i + 2, j + 2
            x = int(inp[ci, cj])
            total = 0
            mx = mn = x
            for k in range(2):
                dy = int(CDEF_DIRECTIONS_Y[direction, k])
                dx = int(CDEF_DIRECTIONS_X[direction, k])
                p0 = int(inp[ci + dy, cj + dx])
                p1 = int(inp[ci - dy, cj - dx])
                total += pri_taps[k] * _constrain1(p0 - x, pri_strength, pri_damping)
                total += pri_taps[k] * _constrain1(p1 - x, pri_strength, pri_damping)
                if p0 != CDEF_VERY_LARGE:
                    mx = max(p0, mx)
                if p1 != CDEF_VERY_LARGE:
                    mx = max(p1, mx)
                mn = min(p0, mn)
                mn = min(p1, mn)
                for dirn in ((direction + 2) & 7, (direction + 6) & 7):
                    sy = int(CDEF_DIRECTIONS_Y[dirn, k])
                    sx = int(CDEF_DIRECTIONS_X[dirn, k])
                    s0 = int(inp[ci + sy, cj + sx])
                    s1 = int(inp[ci - sy, cj - sx])
                    if s0 != CDEF_VERY_LARGE:
                        mx = max(s0, mx)
                    if s1 != CDEF_VERY_LARGE:
                        mx = max(s1, mx)
                    mn = min(s0, mn)
                    mn = min(s1, mn)
                    total += sec_taps[k] * _constrain1(s0 - x, sec_strength, sec_damping)
                    total += sec_taps[k] * _constrain1(s1 - x, sec_strength, sec_damping)
            y = x + ((8 + total - (total < 0)) >> 4)
            out[i, j] = max(mn, min(mx, y))
    return out


def adjust_strength(strength, var):
    """common/common_frame.h:61-65."""
    i = min(log2i(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4 if var else 0


def cdef_allskip(xoff, yoff, width, height, dd, fb_size_log2):
    for m in range((1 << fb_size_log2) // 8):
        for n in range((1 << fb_size_log2) // 8):
            xpos = xoff + n * 8
            ypos = yoff + m * 8
            if xpos < width and ypos < height:
                idx = (ypos // MIN_PB_SIZE) * dd.bs + (xpos // MIN_PB_SIZE)
                if dd.mode[idx] != MODE_SKIP:
                    return False
    return True


def cdef_frame(plane_arr, dd, width_l, height_l, plane, sub, bitdepth,
               presets_per_fb, damping, dirs_out=None):
    """CDEF one plane, in place (common_frame.c:826-1002).

    presets_per_fb: list over fb index ci of dicts with keys
    pri_strength(level), skip_condition, sec_strength for this plane.
    dirs_out: optional {ci: 8x8->dir array} shared from luma pass.
    """
    fb_size_log2 = 6
    psub = sub if plane != 0 else 0
    bs = 4 if psub else 8
    height, width = plane_arr.shape
    num_fb_hor = (width_l + (1 << fb_size_log2) - 1) >> fb_size_log2
    num_fb_ver = (height_l + (1 << fb_size_log2) - 1) >> fb_size_log2
    src = plane_arr.copy()
    coeff_shift = bitdepth - 8
    ci = 0
    for k in range(num_fb_ver):
        for l in range(num_fb_hor):
            xoff = l << fb_size_log2
            yoff = k << fb_size_log2
            allskip = cdef_allskip(xoff, yoff, width_l, height_l, dd, fb_size_log2)
            hl = min(height_l, (k + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            wl = min(width_l, (l + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            hl += (not hl) << fb_size_log2
            wl += (not wl) << fb_size_log2
            pr = presets_per_fb[ci]
            pri_strength = pr["level"]
            sec_strength = pr["sec_strength"] + (pr["sec_strength"] == 3)
            if not allskip:
                if dirs_out is not None and ci not in dirs_out:
                    dirs_out[ci] = {}
                for m in range((hl + bs - 1) >> (log2i(bs) + psub)):
                    for n in range((wl + bs - 1) >> (log2i(bs) + psub)):
                        xpos = (xoff >> psub) + n * bs
                        ypos = (yoff >> psub) + m * bs
                        sizex = min((width_l >> psub) - xpos, bs)
                        sizey = min((height_l >> psub) - ypos, bs)
                        idx = (((yoff + m * 8) // MIN_PB_SIZE) * dd.bs +
                               ((xoff + n * 8) // MIN_PB_SIZE))
                        if plane == 0:
                            d, var = cdef_find_dir(
                                src[ypos:ypos + 8, xpos:xpos + 8], coeff_shift)
                            dirs_out[ci][(m, n)] = (d, var)
                        if dd.mode[idx] == MODE_SKIP:
                            continue
                        d, var = dirs_out[ci][(m, n)]
                        # build input with border handling
                        inp = np.full((sizey + 4, sizex + 4), CDEF_VERY_LARGE,
                                      np.int32)
                        y0, y1 = ypos - 2, ypos + sizey + 2
                        x0, x1 = xpos - 2, xpos + sizex + 2
                        ry0, ry1 = max(y0, 0), min(y1, height)
                        rx0, rx1 = max(x0, 0), min(x1, width)
                        inp[ry0 - y0:ry1 - y0, rx0 - x0:rx1 - x0] = \
                            src[ry0:ry1, rx0:rx1]
                        if plane:
                            adj = pri_strength
                        else:
                            adj = adjust_strength(pri_strength, var)
                        pd = (max(log2i(adj), damping[0] - (plane != 0))
                              if adj else damping[0] - (plane != 0))
                        sd = damping[1] - (plane != 0)
                        out = cdef_filter_block(
                            inp, adj << coeff_shift, sec_strength << coeff_shift,
                            d if pri_strength else 0,
                            pd + coeff_shift, sd + coeff_shift, sizey, sizex,
                            coeff_shift)
                        plane_arr[ypos:ypos + sizey, xpos:xpos + sizex] = out
            ci += 1
