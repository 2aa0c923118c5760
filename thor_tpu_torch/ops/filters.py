"""In-loop filters: deblock, CLPF and CDEF (torch port of
thor_tpu/ops/filters.py; reference common_frame.c:47-432,
common_block.c:224-345).

The host mask functions `_mv_ge4`, `deblock_masks_y`,
`deblock_masks_uv` (thor_tpu/ops/filters.py:32-93), `clpf_pixel_mask`
(:223-275) and `cdef_block_maps` (:529-574) are verbatim copies, except
that `cdef_block_maps` imports `cdef_allskip` at module level: the
original module imports JAX at the top, and the port's decoder imports
this module in its place.
The device functions are torch, with integer arithmetic throughout;
every pass is a dense masked stencil over the whole plane, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tables as T
from ..spec.filters import cdef_allskip
from ..tables import to_device

MODE_SKIP = 0
MODE_INTRA = 1
MIN_PB_SIZE = T.MIN_PB_SIZE
MIN_BLOCK_SIZE = T.MIN_BLOCK_SIZE
log2i = T.log2i


def edge_pad(x, pad: int):
    """Edge-replicate padding of a 2-D integer plane (jnp.pad
    mode="edge") by a clamped-index gather: F.pad's replicate mode does
    not take integer tensors."""
    H, W = x.shape
    ri = torch.arange(-pad, H + pad, device=x.device).clamp(0, H - 1)
    ci = torch.arange(-pad, W + pad, device=x.device).clamp(0, W - 1)
    return x[ri[:, None], ci[None, :]]


# ---------------------------------------------------------------- deblock

def _mv_ge4(dd):
    """Per-PB 'any MV component >= 4' (common_frame.c NEW_MV_TEST)."""
    return ((np.abs(dd.mv0) >= 4).any(axis=1) |
            (np.abs(dd.mv1) >= 4).any(axis=1))


def deblock_masks_y(dd, width, height):
    """Host: fold deblock_data into per-edge luma filter masks.

    Returns (maskv [H//4, Ev], maskh [Hh, W//4]) bool, where Ev/Hh count
    interior vertical/horizontal 8-px edges; rows/cols are in 4-px PB
    units (each mask row covers the 4 pixel rows of one PB).
    """
    bs = dd.bs
    gh, gw = height // MIN_PB_SIZE, width // MIN_PB_SIZE
    size = dd.size[:gh * bs].reshape(gh, bs)[:, :gw]
    tb = dd.tb_split[:gh * bs].reshape(gh, bs)[:, :gw]
    pb = dd.pb_part[:gh * bs].reshape(gh, bs)[:, :gw]
    cbp = dd.cbp_y[:gh * bs].reshape(gh, bs)[:, :gw].astype(bool)
    intra = (dd.mode[:gh * bs].reshape(gh, bs)[:, :gw] == MODE_INTRA)
    mv = _mv_ge4(dd)[:gh * bs].reshape(gh, bs)[:, :gw]

    # vertical edges: q blocks at even grid cols >= 2
    qc = np.arange(2, gw, 2)
    q_size = size[:, qc].astype(np.int64)
    halve = ((tb[:, qc] != 0) | (pb[:, qc] == 2) | (pb[:, qc] == 3))
    q_size = np.where(halve & (q_size > MIN_BLOCK_SIZE), q_size // 2, q_size)
    j = (qc * MIN_PB_SIZE)[None, :]
    interior = (j % q_size) > 0
    act = (mv[:, qc] | mv[:, qc - 1] | cbp[:, qc] | cbp[:, qc - 1] |
           intra[:, qc] | intra[:, qc - 1])
    maskv = (~interior) & act                                # [gh, Ev]

    # horizontal edges: q blocks at even grid rows >= 2
    qr = np.arange(2, gh, 2)
    q_size = size[qr, :].astype(np.int64)
    halve = ((tb[qr, :] != 0) | (pb[qr, :] == 1) | (pb[qr, :] == 3))
    q_size = np.where(halve & (q_size > MIN_BLOCK_SIZE), q_size // 2, q_size)
    i = (qr * MIN_PB_SIZE)[:, None]
    interior = (i % q_size) > 0
    act = (mv[qr, :] | mv[qr - 1, :] | cbp[qr, :] | cbp[qr - 1, :] |
           intra[qr, :] | intra[qr - 1, :])
    maskh = (~interior) & act                                # [Eh, gw]
    return maskv, maskh


def deblock_masks_uv(dd, width, height):
    """Host: chroma deblock masks (intra-only, whole-block edges)."""
    bs = dd.bs
    gh, gw = height // MIN_PB_SIZE, width // MIN_PB_SIZE
    size = dd.size[:gh * bs].reshape(gh, bs)[:, :gw].astype(np.int64)
    intra = (dd.mode[:gh * bs].reshape(gh, bs)[:, :gw] == MODE_INTRA)

    qc = np.arange(2, gw, 2)
    j = (qc * MIN_PB_SIZE)[None, :]
    maskv = ((j % size[::2, qc]) == 0) & \
        (intra[::2, qc] | intra[::2, qc - 1])                # [gh/2, Ev]
    qr = np.arange(2, gh, 2)
    i = (qr * MIN_PB_SIZE)[:, None]
    maskh = ((i % size[qr, ::2]) == 0) & \
        (intra[qr, ::2] | intra[qr - 1, ::2])                # [Eh, gw/2]
    return maskv, maskh

def _delta_luma(p1, p0, q0, q1, tc):
    delta = (18 * (q0 - p0) - 6 * (q1 - p1) + 16) >> 5
    return delta.clamp(-tc, tc)


def _half_trunc(delta):
    """C (delta/2): truncation toward zero."""
    return torch.where(delta >= 0, delta >> 1, -((-delta) >> 1))


def _tc(qp: int, bitdepth: int) -> int:
    return (int(T.TC_TABLE[qp]) << (bitdepth - 12) if bitdepth > 12
            else int(T.TC_TABLE[qp]) >> (12 - bitdepth))


def _luma_edges(p1, p0, q0, q1, band_d, mask, beta, tc, hi):
    """New (p1, p0, q0, q1) of one edge pass; band_d [..] the per-band
    activity broadcast to the edge samples."""
    cond = mask & (band_d < beta)
    delta = _delta_luma(p1, p0, q0, q1, tc)
    half = _half_trunc(delta)
    return (torch.where(cond, (p1 + half).clamp(0, hi), p1),
            torch.where(cond, (p0 + delta).clamp(0, hi), p0),
            torch.where(cond, (q0 - delta).clamp(0, hi), q0),
            torch.where(cond, (q1 - half).clamp(0, hi), q1))


def deblock_plane_y(r, maskv, maskh, qp: int, bitdepth: int = 8):
    """Luma deblock: vertical-edge pass then horizontal-edge pass, each a
    dense masked stencil (common_frame.c:47-352).  Returns int32."""
    beta = int(T.BETA_TABLE[qp]) << (bitdepth - 8)
    tc = _tc(qp, bitdepth)
    hi = (1 << bitdepth) - 1
    H, W = r.shape
    r = r.to(torch.int32).clone()

    # ---- vertical edges (cols 8, 16, ..., W-8) ----
    ev = W // 8 - 1
    if ev > 0:
        cols = [slice(6, W - 8, 8), slice(7, W - 8, 8), slice(8, W - 7, 8),
                slice(9, W - 6, 8)]
        p1, p0, q0, q1 = (r[:, c] for c in cols)
        # d15 from band rows 1,5; d26 from rows 2,6 (per 8-row band)
        band = ((p1 - p0).abs() + (q1 - q0).abs()).reshape(H // 8, 8, ev)
        d15 = band[:, 1] + band[:, 5]
        d26 = band[:, 2] + band[:, 6]
        d = torch.stack([d15, d26] * 4, 1).reshape(H, ev)
        new = _luma_edges(p1, p0, q0, q1, d,
                          maskv.repeat_interleave(4, 0), beta, tc, hi)
        for c, v in zip(cols, new):
            r[:, c] = v

    # ---- horizontal edges (rows 8, 16, ..., H-8) ----
    eh = H // 8 - 1
    if eh > 0:
        rows = [slice(6, H - 8, 8), slice(7, H - 8, 8), slice(8, H - 7, 8),
                slice(9, H - 6, 8)]
        p1, p0, q0, q1 = (r[s, :] for s in rows)
        band = ((p1 - p0).abs() + (q1 - q0).abs()).reshape(eh, W // 8, 8)
        d15 = band[:, :, 1] + band[:, :, 5]
        d26 = band[:, :, 2] + band[:, :, 6]
        d = torch.stack([d15, d26] * 4, 2).reshape(eh, W)
        new = _luma_edges(p1, p0, q0, q1, d,
                          maskh.repeat_interleave(4, 1), beta, tc, hi)
        for s, v in zip(rows, new):
            r[s, :] = v
    return r


def deblock_plane_uv(c, maskv, maskh, qpc: int, sub: int = 1,
                     bitdepth: int = 8):
    """Chroma deblock of one plane (common_frame.c:354-432).  Edges every
    8 luma px = (8>>sub) chroma px; the 2-tap filter writes only p0/q0, so
    adjacent edges stay independent.  Returns int32."""
    tc = _tc(qpc, bitdepth)
    hi = (1 << bitdepth) - 1
    H, W = c.shape
    c = c.to(torch.int32).clone()
    step = MIN_BLOCK_SIZE >> sub

    def edge(p1, p0, q0, q1, cond):
        delta = ((4 * (q0 - p0) + (p1 - q1) + 4) >> 3).clamp(-tc, tc)
        return (torch.where(cond, (p0 + delta).clamp(0, hi), p0),
                torch.where(cond, (q0 - delta).clamp(0, hi), q0))

    ev = W // step - 1
    if ev > 0:
        cols = [slice(step - 2, W - step - 1, step),
                slice(step - 1, W - step, step),
                slice(step, W - step + 1, step),
                slice(step + 1, W - step + 2, step)]
        p1, p0, q0, q1 = (c[:, s] for s in cols)
        n0, n1 = edge(p1, p0, q0, q1, maskv.repeat_interleave(step, 0))
        c[:, cols[1]] = n0
        c[:, cols[2]] = n1

    eh = H // step - 1
    if eh > 0:
        rows = [slice(step - 2, H - step - 1, step),
                slice(step - 1, H - step, step),
                slice(step, H - step + 1, step),
                slice(step + 1, H - step + 2, step)]
        p1, p0, q0, q1 = (c[s, :] for s in rows)
        n0, n1 = edge(p1, p0, q0, q1, maskh.repeat_interleave(step, 1))
        c[rows[1], :] = n0
        c[rows[2], :] = n1
    return c


# ----------------------------------------------------------------- CLPF

def _constrain(diff, strength, shift):
    ad = diff.abs()
    mag = torch.minimum(ad, (strength - (ad >> shift)).clamp(min=0))
    return torch.sign(diff) * mag


def clpf_pixel_mask(dd, width, height, plane, fb_size_log2, sub,
                    decision_bits=None):
    """Host: per-pixel CLPF application mask for one plane.

    Folds the per-fb allskip/decision logic and the per-block (8x8 luma /
    4x4 420-chroma) skip test, including the reference's plane-local
    deblock_data stride quirk (common_frame.c:1050,1074).  Returns a bool
    [ph, pw] array in plane resolution and the number of decision bits
    consumed.
    """
    psub = sub if plane != 0 else 0
    bs = 4 if (plane != 0 and sub) else 8
    ph, pw = height >> psub, width >> psub
    bstr = pw // MIN_PB_SIZE          # normative stride quirk
    nfh = (pw + (1 << fb_size_log2) - 1) >> fb_size_log2
    nfv = (ph + (1 << fb_size_log2) - 1) >> fb_size_log2

    mask = np.zeros((ph, pw), bool)
    consumed = 0
    for k in range(nfv):
        for l in range(nfh):
            xoff, yoff = l << fb_size_log2, k << fb_size_log2
            allskip = True
            for m in range((1 << fb_size_log2) // bs):
                for n in range((1 << fb_size_log2) // bs):
                    xpos, ypos = xoff + n * bs, yoff + m * bs
                    if xpos < pw and ypos < ph:
                        idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                               ((xpos << psub) // MIN_PB_SIZE))
                        if dd.mode[idx] != MODE_SKIP:
                            allskip = False
            if allskip:
                continue
            if decision_bits is not None:
                bit = decision_bits[consumed]
                consumed += 1
                if not bit:
                    continue
            h = min(ph, (k + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            w = min(pw, (l + 1) << fb_size_log2) & ((1 << fb_size_log2) - 1)
            h += (not h) << fb_size_log2
            w += (not w) << fb_size_log2
            for m in range((h + bs - 1) // bs):
                for n in range((w + bs - 1) // bs):
                    xpos, ypos = xoff + n * bs, yoff + m * bs
                    sizex = min(pw - xpos, bs)
                    sizey = min(ph - ypos, bs)
                    idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                           ((xpos << psub) // MIN_PB_SIZE))
                    if dd.mode[idx] == MODE_SKIP:
                        continue
                    mask[ypos:ypos + sizey, xpos:xpos + sizex] = True
    return mask, consumed

def clpf_plane(src, mask, strength: int, damping: int):
    """CLPF one plane (common_block.c:315-345): one edge-replicated 8-tap
    stencil over the whole plane, masked per pixel."""
    s = src.to(torch.int32)
    p = edge_pad(s, 2)
    H, W = s.shape
    shift = damping - log2i(strength) if strength else 0

    def tap(dy, dx):
        return p[2 + dy:2 + dy + H, 2 + dx:2 + dx + W]

    X = s
    delta = sum(w * _constrain(tap(dy, dx) - X, strength, shift)
                for w, dy, dx in ((1, -2, 0), (3, -1, 0), (1, 0, -2),
                                  (3, 0, -1), (3, 0, 1), (1, 0, 2),
                                  (3, 1, 0), (1, 2, 0)))
    d = (8 + delta - (delta < 0).to(torch.int32)) >> 4
    return torch.where(mask, X + d, X)


# ----------------------------------------------------------------- CDEF

def _log2i_j(v):
    """floor(log2(v)) as JAX's 31 - clz(int32 v): -1 for 0 and 31 for a
    negative v.  frexp of the float64 value is exact for every int32."""
    v = v.to(torch.int32)
    _, e = torch.frexp(v.to(torch.float64))
    lg = e.to(torch.int32) - 1
    return torch.where(v > 0, lg, torch.where(v == 0, -1, 31))


def cdef_dirs(src, coeff_shift: int = 0):
    """Per-8x8-block direction + variance (common_block.c:94-162).

    src: [ph, pw] (multiple-of-8 dims).  Returns (dirs [ph//8, pw//8]
    int32, var same shape int64)."""
    ph, pw = src.shape
    nby, nbx = ph // 8, pw // 8
    tb = to_device(src.device)
    x = ((src.to(torch.int32) >> coeff_shift) - 128).reshape(nby, 8, nbx, 8)
    x = x.permute(0, 2, 1, 3).reshape(nby * nbx, 64)
    # partial sums of at most 8 samples in [-128, 127]: an exact float64
    # product with the one-hot bin maps (CUDA has no integer einsum)
    partial = torch.matmul(x.to(torch.float64), tb["dir_proj"]).to(
        torch.int64).reshape(nby * nbx, 8, 15)
    sq = partial * partial
    div = tb["div_table"]
    costs = [None] * 8
    for k in (2, 6):
        costs[k] = sq[:, k, :8].sum(dim=1) * div[8]
    for k in (0, 4):
        c = sq[:, k, 7] * div[8]
        for i in range(7):
            c = c + (sq[:, k, i] + sq[:, k, 14 - i]) * div[i + 1]
        costs[k] = c
    for k in (1, 3, 5, 7):
        c = sq[:, k, 3:8].sum(dim=1) * div[8]
        for j in range(3):
            c = c + (sq[:, k, j] + sq[:, k, 10 - j]) * div[2 * j + 2]
        costs[k] = c
    call = torch.stack(costs, dim=1)                    # [n, 8]
    bc = call.max(dim=1).values
    # the first maximum wins ties, as jnp.argmax
    ks = torch.arange(8, device=src.device)
    best = torch.where(call == bc[:, None], ks, 8).min(dim=1).values
    opp = call.gather(1, ((best + 4) & 7)[:, None])[:, 0]
    var = (bc - opp) >> 10
    return (best.to(torch.int32).reshape(nby, nbx), var.reshape(nby, nbx))


def cdef_plane(src, dirs, var, level, sec_strength, mask, bs: int,
               plane: int, pri_damping: int, sec_damping: int,
               coeff_shift: int = 0):
    """CDEF one plane (common_block.c:224-279 per block; frame drive
    common_frame.c:826-1002 with VERY_LARGE only at frame borders).

    src: [ph, pw]; dirs/var: per-luma-8x8-block maps [nby, nbx] (chroma
    reuses luma's); level/sec_strength: per-block maps; mask: [ph, pw]
    bool where the filter applies; bs: block size in this plane.  All 8
    direction variants are computed and selected per block."""
    ph, pw = src.shape
    s = src.to(torch.int32)
    big = int(T.CDEF_VERY_LARGE)
    p = torch.full((ph + 4, pw + 4), big, dtype=torch.int32,
                   device=s.device)
    p[2:2 + ph, 2:2 + pw] = s

    def expand(m):
        return m.repeat_interleave(bs, 0).repeat_interleave(bs, 1)[:ph, :pw]

    lvl = expand(level).to(torch.int32)
    varx = expand(var).to(torch.int32)
    # adjust_strength (common_frame.h:61-65), luma only
    if plane == 0:
        v6 = varx >> 6
        i = torch.where(v6 > 0, _log2i_j(v6.clamp(min=1)), 0).clamp(max=12)
        adj = torch.where(varx != 0, (lvl * (4 + i) + 8) >> 4, 0)
    else:
        adj = lvl
    sec = expand(sec_strength).to(torch.int32)
    dir_eff = torch.where(lvl > 0, expand(dirs), 0)

    # strengths at coeff_shift scale; per-pixel constrain shifts
    pri_t = adj << coeff_shift
    sec_t = sec << coeff_shift
    pd = torch.where(adj > 0, torch.clamp(_log2i_j(adj.clamp(min=1)),
                                          min=pri_damping),
                     pri_damping) + coeff_shift
    pri_shift = pd - _log2i_j(pri_t.clamp(min=1))
    sec_shift = (sec_damping + coeff_shift) - _log2i_j(sec_t.clamp(min=1))

    def constrain(diff, threshold, shift):
        ad = diff.abs()
        mag = torch.minimum(ad, (threshold - (ad >> shift)).clamp(min=0))
        return torch.where(threshold > 0, torch.sign(diff) * mag, 0)

    odd = (pri_t >> coeff_shift) & 1
    pri_taps = [int(T.CDEF_PRI_TAPS[0][k]) +
                (int(T.CDEF_PRI_TAPS[1][k]) - int(T.CDEF_PRI_TAPS[0][k])) * odd
                for k in range(2)]
    sec_taps = (int(T.CDEF_SEC_TAPS[0][0]), int(T.CDEF_SEC_TAPS[0][1]))

    def tap(dy, dx):
        return p[2 + dy:2 + dy + ph, 2 + dx:2 + dx + pw]

    total = torch.zeros_like(s)
    mx = s
    mn = s
    for d in range(8):
        t = torch.zeros_like(s)
        dmx = s
        dmn = s
        for k in range(2):
            dy = int(T.CDEF_DIRECTIONS_Y[d, k])
            dx = int(T.CDEF_DIRECTIONS_X[d, k])
            pairs = [(pri_taps[k], pri_t, pri_shift, dy, dx)]
            for dirn in ((d + 2) & 7, (d + 6) & 7):
                pairs.append((sec_taps[k], sec_t, sec_shift,
                              int(T.CDEF_DIRECTIONS_Y[dirn, k]),
                              int(T.CDEF_DIRECTIONS_X[dirn, k])))
            for w, thr, sh, ty, tx in pairs:
                a, b = tap(ty, tx), tap(-ty, -tx)
                t = t + w * (constrain(a - s, thr, sh) +
                             constrain(b - s, thr, sh))
                dmx = torch.maximum(dmx, torch.where(a == big, dmx, a))
                dmx = torch.maximum(dmx, torch.where(b == big, dmx, b))
                dmn = torch.minimum(dmn, torch.minimum(a, b))
        sel = dir_eff == d
        total = torch.where(sel, t, total)
        mx = torch.where(sel, dmx, mx)
        mn = torch.where(sel, dmn, mn)

    y = s + ((8 + total - (total < 0).to(torch.int32)) >> 4)
    out = torch.maximum(mn, torch.minimum(mx, y))
    return torch.where(mask, out, s)


def cdef_block_maps(dd, presets_per_fb, width_l, height_l, plane, sub):
    """Host: per-block level/sec_strength maps + application mask for one
    plane (frame drive common_frame.c:826-1002).  Block grid is the luma
    8x8 grid (chroma blocks are co-located).  Returns (level [nby,nbx],
    sec [nby,nbx], mask [ph,pw] bool)."""
    fb_size_log2 = 6
    psub = sub if plane != 0 else 0
    bs = 4 if psub else 8
    ph, pw = height_l >> psub, width_l >> psub
    nby, nbx = (height_l + 7) // 8, (width_l + 7) // 8
    level = np.zeros((nby, nbx), np.int32)
    sec = np.zeros((nby, nbx), np.int32)
    mask = np.zeros((ph, pw), bool)
    nfh = (width_l + (1 << fb_size_log2) - 1) >> fb_size_log2
    nfv = (height_l + (1 << fb_size_log2) - 1) >> fb_size_log2
    ci = 0
    for k in range(nfv):
        for l in range(nfh):
            xoff, yoff = l << fb_size_log2, k << fb_size_log2
            pr = presets_per_fb[ci]
            allskip = cdef_allskip(xoff, yoff, width_l, height_l, dd,
                                   fb_size_log2)
            hl = min(height_l, (k + 1) << fb_size_log2) & 63
            wl = min(width_l, (l + 1) << fb_size_log2) & 63
            hl += (not hl) << 6
            wl += (not wl) << 6
            if not allskip:
                for m in range((hl + bs - 1) >> (log2i(bs) + psub)):
                    for n in range((wl + bs - 1) >> (log2i(bs) + psub)):
                        by = yoff // 8 + m
                        bx = xoff // 8 + n
                        level[by, bx] = pr["level"]
                        sec[by, bx] = (pr["sec_strength"] +
                                       (pr["sec_strength"] == 3))
                        idx = (((yoff + m * 8) // MIN_PB_SIZE) * dd.bs +
                               ((xoff + n * 8) // MIN_PB_SIZE))
                        if dd.mode[idx] == MODE_SKIP:
                            continue
                        xpos = (xoff >> psub) + n * bs
                        ypos = (yoff >> psub) + m * bs
                        sizex = min(pw - xpos, bs)
                        sizey = min(ph - ypos, bs)
                        mask[ypos:ypos + sizey, xpos:xpos + sizex] = True
            ci += 1
    return level, sec, mask


# ------------------------------------------------- unfused frame passes

def _pack16(y, u, v, sub: int, mono: bool):
    """One int16 buffer for one pull: luma alone (mono), else luma over
    u|v side by side (4:2:0) or over u over v (4:4:4)."""
    i16 = torch.int16
    if mono:
        return y.to(i16)
    return torch.cat([y.to(i16), torch.cat([u, v], dim=1 if sub else 0)
                      .to(i16)], dim=0)


def filters_exec(y, u, v, mv_, mh_, cmv, cmh, lv0, sec0, m0, lv1, sec1,
                 m1, m2, clpf_my, clpf_mu, clpf_mv, qp: int, qpc: int,
                 bd: int, sub: int, mono: bool, deblocking: bool,
                 cdef_damping: int, cs: int, s_y: int, s_u: int, s_v: int,
                 qpclpf: int):
    """Whole in-loop chain (deblock -> CDEF -> CLPF) of a frame that did
    not take the fused route (thor_tpu/ops/filters.py:filters_exec).

    The planes and every mask are tensors on one device; the stream-read
    parameters are host integers.  Planes and masks that a stream has
    not (mono's chroma, masks of a filter that is off) are placeholders
    that nothing reads.  Returns one packed int16 buffer (`_pack16`) so
    that the frame costs a single device->host pull."""
    if deblocking:
        y = deblock_plane_y(y, mv_, mh_, qp, bd)
        if not mono:
            u = deblock_plane_uv(u, cmv, cmh, qpc, sub, bd)
            v = deblock_plane_uv(v, cmv, cmh, qpc, sub, bd)

    dirs, var = cdef_dirs(y, cs)
    y = cdef_plane(y, dirs, var, lv0, sec0, m0, 8, 0, cdef_damping,
                   cdef_damping, cs)
    if not mono:
        bsc = 4 if sub else 8
        u = cdef_plane(u, dirs, var, lv1, sec1, m1, bsc, 1,
                       cdef_damping - 1, cdef_damping - 1, cs)
        v = cdef_plane(v, dirs, var, lv1, sec1, m2, bsc, 2,
                       cdef_damping - 1, cdef_damping - 1, cs)

    if s_y:
        y = clpf_plane(y, clpf_my, (s_y + (s_y == 3)) << cs,
                       bd - 4 + qpclpf)
    if not mono:
        if s_u:
            u = clpf_plane(u, clpf_mu, (s_u + (s_u == 3)) << cs,
                           bd - 5 + qpclpf)
        if s_v:
            v = clpf_plane(v, clpf_mv, (s_v + (s_v == 3)) << cs,
                           bd - 5 + qpclpf)
    return _pack16(y, u, v, sub, mono)


def deblock_exec(y, u, v, mv_, mh_, cmv, cmh, qp: int, qpc: int, bd: int,
                 sub: int, mono: bool):
    """Deblock all three planes; packed int16 return (the encoder's tail
    uses this; the decoder's full chain is filters_exec)."""
    y = deblock_plane_y(y, mv_, mh_, qp, bd)
    if not mono:
        u = deblock_plane_uv(u, cmv, cmh, qpc, sub, bd)
        v = deblock_plane_uv(v, cmv, cmh, qpc, sub, bd)
    return _pack16(y, u, v, sub, mono)
