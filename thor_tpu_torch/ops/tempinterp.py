"""Temporal frame interpolation (interp_ref) on the device (torch port of
thor_tpu/ops/tempinterp.py).

Replicates spec/tempinterp.py (reference common/temporal_interp.c:
interpolate_frames:909, motion_estimate_bi:786, adaptive_search_v2:584,
skip_test:458, merge_candidate_search:661, interpolate_frame:880)
bit-exactly with batched device passes:

  - block pass: the per-16x16-block skip test + candidate search has a
    left/top-left/top/top-right dependency through the MV grid, so it
    runs as a 2:1-skewed wavefront (s = 2*bi + bj) with all blocks of a
    diagonal evaluated in lockstep over a fixed number of lanes (masked
    candidate slots, a cross refinement that mirrors the C trajectory
    decision for decision).  The loops over diagonals and refinement
    steps run on the host; a refinement ends early once no lane is
    active, which changes no lane's result
  - merge pass: reads only the pre-merge grid -> one batched call
  - motion-compensated averaging: per-cell, one batched call

The C in-range SAD fast path and its clipped fallback compute identical
values, so the device uses the clipped gather everywhere; the skip test
(which rejects out-of-range windows instead of clipping) keeps explicit
bounds masks.  All arithmetic is int32 (matches the reference's int);
indices are widened to int64 only where torch indexes with them.

There is one route: the port decodes 4:2:0 only, so `interpolate_frames`
has no fallback to the numpy spec.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..frame import YuvFrame
from ..spec.tempinterp import _downscale_luma

I32 = torch.int32
ACC_BITS = 3
ACC_ROUND = 4
LAMBDA = 3000            # (3000 * BLOCK_STEP) // 16
LAMBDA_SHIFT = 4
COST_MAX = 0x3FFFFFFF
SKIP_THR = 8 * 8 * 8     # skip_thr * 8 * 8


def _ar(n, device):
    return torch.arange(n, dtype=I32, device=device)


def _scale1(v, numer: int, denom: int):
    """scale_val (temporal_interp.c helper): round half away from zero.
    The floor division only ever sees non-negative values."""
    prod = v * numer
    q = torch.div(prod.abs() + denom // 2, denom, rounding_mode="floor")
    return torch.where(prod >= 0, q, -q).to(I32)


def _scale(mx, my, numer: int, denom: int):
    return _scale1(mx, numer, denom), _scale1(my, numer, denom)


def _win(plane, pad: int, ys, xs, size: int, lo: int, hi_x: int, hi_y: int):
    """Clipped [N,size,size] window gather at visible coords (ys,xs)."""
    d = _ar(size, plane.device)
    rr = ((ys[:, None] + d[None, :]).clamp(lo, hi_y) + pad).long()
    cc = ((xs[:, None] + d[None, :]).clamp(lo, hi_x) + pad).long()
    return plane[rr[:, :, None], cc[:, None, :]]


def _sad(y0, y1, pad: int, w: int, h: int, size: int, m0x, m0y, m1x, m1y,
         py0, px0):
    """SAD of size x size windows of y0 displaced by (m0x,m0y) against y1
    displaced by (m1x,m1y), eighth-pel vectors rounded to whole samples;
    the operands are broadcast against each other (any leading shape)."""
    xs0 = px0 + ((m0x + ACC_ROUND) >> ACC_BITS)
    ys0 = py0 + ((m0y + ACC_ROUND) >> ACC_BITS)
    xs1 = px0 + ((m1x + ACC_ROUND) >> ACC_BITS)
    ys1 = py0 + ((m1y + ACC_ROUND) >> ACC_BITS)
    shape = xs0.shape
    a = _win(y0, pad, ys0.reshape(-1), xs0.reshape(-1), size, -pad,
             w + pad - 1, h + pad - 1)
    b = _win(y1, pad, ys1.reshape(-1), xs1.reshape(-1), size, -pad,
             w + pad - 1, h + pad - 1)
    return (a - b).abs().sum(dim=(1, 2)).to(I32).reshape(shape)


# ---------------------------------------------------------------------------
# block pass (wavefront)
# ---------------------------------------------------------------------------

def me_bi_level(y0, y1, guide, wt0: int, wt1: int, *, w: int, h: int,
                pad: int, bw: int, bh: int, guided: bool):
    """motion_estimate_bi block pass for one pyramid level.

    y0/y1: padded int32 luma planes in pics order (already swapped when
    reversed).  guide: [bh,bw,2] (x,y) spatial guide grid (ignored when
    not guided).  Returns (mv1 [bh,bw,2], mv0, bgmap [bh,bw])."""
    dev = y0.device
    step = 2
    nbx, nby = bw // step, bh // step
    L = 0
    for s in range(2 * (nby - 1) + nbx):
        lo = max(0, (s - nbx + 2) // 2)
        hi = min(nby - 1, s // 2)
        L = max(L, hi - lo + 1)
    S = 2 * (nby - 1) + nbx - 1 + 1

    lam = LAMBDA // 4 if guided else LAMBDA
    shift0 = (0 if guided else 3) + ACC_BITS
    count0 = 8 if guided else 64
    niter = count0 // 4

    lane = _ar(L, dev)
    zeros = torch.zeros((L,), dtype=I32, device=dev)
    true = torch.ones((L,), dtype=torch.bool, device=dev)
    false = torch.zeros((L,), dtype=torch.bool, device=dev)
    # the four cross positions of one refinement step, in the reference's
    # order of decisions: left, right, up, down
    cross_x = torch.tensor([-1, 1, 0, 0], dtype=I32, device=dev)[:, None]
    cross_y = torch.tensor([0, 0, -1, 1], dtype=I32, device=dev)[:, None]

    def rd(g, ci, cj):
        return g[ci.clamp(0, bh - 1).long(), cj.clamp(0, bw - 1).long()]

    def sad16(m0x, m0y, m1x, m1y, py0, px0):
        return _sad(y0, y1, pad, w, h, 16, m0x, m0y, m1x, m1y, py0, px0)

    mv1g = torch.zeros((bh, bw, 2), dtype=I32, device=dev)
    mv0g = torch.zeros((bh, bw, 2), dtype=I32, device=dev)
    bgg = torch.zeros((bh, bw), dtype=I32, device=dev)

    for s in range(S):
        lo = max(0, (s - nbx + 2) // 2)
        bi = lo + lane
        bj = s - 2 * bi
        valid = (bi <= min(nby - 1, s // 2)) & (bj >= 0)
        # the valid lanes are the first nv (bi rises, bj falls along them)
        nv = min(nby - 1, s // 2) - lo + 1
        i = bi * step
        j = bj * step
        py0, px0 = i * 8, j * 8

        condA = (i > 0) & (j < bw - step)      # top-right
        condB = j > 0                          # left
        condC = i > 0                          # top
        vA = rd(mv1g, i - step, j + step)
        vB = rd(mv1g, i, j - step)
        vC = rd(mv1g, i - step, j)

        # ---- skip vector: absdist filter over present [A,B,C] --------
        pres = (condA, condB, condC)
        vs = (vA, vB, vC)
        f_cost = torch.full((L,), COST_MAX, dtype=I32, device=dev)
        skx = zeros
        sky = zeros
        for k in range(3):
            ck = zeros
            for m in range(3):
                d = ((vs[m][:, 0] - vs[k][:, 0]).abs() +
                     (vs[m][:, 1] - vs[k][:, 1]).abs())
                ck = ck + torch.where(pres[m], d, 0)
            upd = pres[k] & (ck <= f_cost)
            f_cost = torch.where(upd, ck, f_cost)
            skx = torch.where(upd, vs[k][:, 0], skx)
            sky = torch.where(upd, vs[k][:, 1], sky)
        ssx, ssy = _scale(skx, sky, -wt1, wt0)

        # ---- skip test (8x8 quadrants; OOB window -> no skip) --------
        skipf = true
        for dy in (0, 8):
            for dx in (0, 8):
                qx, qy = px0 + dx, py0 + dy
                xs0 = qx + ((ssx + ACC_ROUND) >> ACC_BITS)
                ys0 = qy + ((ssy + ACC_ROUND) >> ACC_BITS)
                xs1 = qx + ((skx + ACC_ROUND) >> ACC_BITS)
                ys1 = qy + ((sky + ACC_ROUND) >> ACC_BITS)
                inb = ((xs0 >= -pad) & (xs0 + 8 <= w + pad) &
                       (ys0 >= -pad) & (ys0 + 8 <= h + pad) &
                       (xs1 >= -pad) & (xs1 + 8 <= w + pad) &
                       (ys1 >= -pad) & (ys1 + 8 <= h + pad))
                sad = _sad(y0, y1, pad, w, h, 8, ssx, ssy, skx, sky, qy, qx)
                skipf = skipf & inb & (sad <= SKIP_THR)

        # ---- mv-cost neighbour context (temporal_interp.c:302-314) ---
        case4 = (i > 0) & (j > 0) & (j < bw - step)
        case_y0 = (i == 0) & (j > 0)
        case_x0 = (j == 0) & (i > 0)
        nTL = rd(mv1g, i - step, j - step)
        nbrs = (vA, vC, nTL, vB)               # TR, T, TL, L
        nbw = (case4 | case_x0, case4 | case_x0, case4, case4 | case_y0)

        def mv_cost(rmx, rmy):
            """rmx/rmy [..., L]: the weighted distance to the neighbours."""
            diff = torch.zeros_like(rmx)
            for nb, wgt in zip(nbrs, nbw):
                d = (rmx - nb[:, 0]).abs() + (rmy - nb[:, 1]).abs()
                diff = diff + torch.where(wgt, d, 0)
            return (diff * lam) >> (LAMBDA_SHIFT + ACC_BITS)

        def cost_of(rmx, rmy):
            r0x, r0y = _scale(rmx, rmy, -wt1, wt0)
            return mv_cost(rmx, rmy) + sad16(r0x, r0y, rmx, rmy, py0, px0)

        # ---- candidate slots (zero, guide, TR, L, T) with dedup ------
        slots = [(zeros, zeros, true)]
        if guided:
            gmv = rd(guide, i, j)
            slots.append((gmv[:, 0], gmv[:, 1], true))
        slots.append((vA[:, 0], vA[:, 1], condA))
        slots.append((vB[:, 0], vB[:, 1], condB))
        slots.append((vC[:, 0], vC[:, 1], condC))
        kept = []
        for k, (mx, my, av) in enumerate(slots):
            dup = false
            for m in range(k):
                pmx, pmy, _ = slots[m]
                dup = dup | (kept[m] & (pmx == mx) & (pmy == my))
            kept.append(av & ~dup)
        # every slot's own cost in one pass: they do not depend on the
        # decisions, only the gates below do
        slot_cost = cost_of(torch.stack([sl[0] for sl in slots]),
                            torch.stack([sl[1] for sl in slots]))

        best_cost = torch.full((L,), COST_MAX, dtype=I32, device=dev)
        best_x = zeros
        best_y = zeros
        cidx = zeros
        for k, (mx, my, _) in enumerate(slots):
            kc = kept[k]
            cost = slot_cost[k]
            gate = kc & (torch.div((4 + cidx) * cost, 8,
                                   rounding_mode="floor") < best_cost)
            rx, ry = mx, my
            shift = torch.full((L,), shift0, dtype=I32, device=dev)
            # the reference also counts evaluations down from count0 by 4
            # a step; that count runs out exactly after step niter
            # a lane outside the diagonal is never written: it need not
            # keep the refinement going
            act = gate & valid
            for _t in range(niter):
                if not bool(act.any()):
                    break           # no lane can change any more
                bx, by = rx, ry
                better = false
                off = torch.ones_like(shift) << shift
                # the four positions depend on (bx,by) alone: one pass for
                # their costs, then the decisions in the reference's order
                rmx4 = bx[None, :] + cross_x * off[None, :]
                rmy4 = by[None, :] + cross_y * off[None, :]
                bc4 = cost_of(rmx4, rmy4)
                for c in range(4):
                    upd = act & (bc4[c] < cost)
                    cost = torch.where(upd, bc4[c], cost)
                    rx = torch.where(upd, rmx4[c], rx)
                    ry = torch.where(upd, rmy4[c], ry)
                    better = better | upd
                shift = torch.where(act & ~better, shift - 1, shift)
                act = act & (shift >= ACC_BITS)
            upd = kc & (cost < best_cost)
            best_cost = torch.where(upd, cost, best_cost)
            best_x = torch.where(upd, rx, best_x)
            best_y = torch.where(upd, ry, best_y)
            cidx = cidx + kc.to(I32)

        selx = torch.where(skipf, skx, best_x)
        sely = torch.where(skipf, sky, best_y)
        s0x, s0y = _scale(selx, sely, -wt1, wt0)

        # write the valid lanes' step x step cells (torch has no scatter
        # that drops out-of-range rows, so the valid lanes are selected)
        d = torch.arange(step, device=dev)
        ri = (i[:nv, None, None] + d[None, :, None]).long()
        cj = (j[:nv, None, None] + d[None, None, :]).long()
        mv1g[ri, cj] = torch.stack([selx, sely], -1)[:nv, None, None, :]
        mv0g[ri, cj] = torch.stack([s0x, s0y], -1)[:nv, None, None, :]
        bgg[ri, cj] = skipf.to(I32)[:nv, None, None]
    return mv1g, mv0g, bgg


# ---------------------------------------------------------------------------
# merge pass (parallel)
# ---------------------------------------------------------------------------

def _grid(bh: int, bw: int, device):
    ii, jj = torch.meshgrid(_ar(bh, device), _ar(bw, device), indexing="ij")
    return ii.reshape(-1), jj.reshape(-1)


def merge_level(y0, y1, mv1g, mv0g, wt0: int, wt1: int, *, w: int, h: int,
                pad: int, bw: int, bh: int):
    """merge_candidate_search over the whole grid (reads pre-merge mvs)."""
    dev = y0.device
    ii, jj = _grid(bh, bw, dev)
    N = bh * bw
    off = 1 + (ii & 1)

    def rd(ci, cj):
        return mv1g[ci.clamp(0, bh - 1).long(), cj.clamp(0, bw - 1).long()]

    slots = [(rd(ii, jj), torch.ones((N,), dtype=torch.bool, device=dev)),
             (rd(ii - off, jj), ii - off >= 0),
             (rd(ii + off, jj), ii + off < bh),
             (rd(ii, jj - off), jj - off >= 0),
             (rd(ii, jj + off), jj + off < bw)]
    kept = []
    for k, (mv, av) in enumerate(slots):
        dup = torch.zeros((N,), dtype=torch.bool, device=dev)
        for m in range(k):
            pmv, _ = slots[m]
            dup = dup | (kept[m] & (pmv[:, 0] == mv[:, 0]) &
                         (pmv[:, 1] == mv[:, 1]))
        kept.append(av & ~dup)
    nkept = sum(k.to(I32) for k in kept)

    px0, py0 = jj * 8, ii * 8
    best_cost = torch.full((N,), COST_MAX, dtype=I32, device=dev)
    best_x = torch.zeros((N,), dtype=I32, device=dev)
    best_y = torch.zeros((N,), dtype=I32, device=dev)
    for k, (mv, _) in enumerate(slots):
        m1x, m1y = mv[:, 0], mv[:, 1]
        m0x, m0y = _scale(m1x, m1y, -wt1, wt0)
        cost = _sad(y0, y1, pad, w, h, 8, m0x, m0y, m1x, m1y, py0, px0)
        upd = kept[k] & (cost < best_cost)
        best_cost = torch.where(upd, cost, best_cost)
        best_x = torch.where(upd, m1x, best_x)
        best_y = torch.where(upd, m1y, best_y)

    b0x, b0y = _scale(best_x, best_y, -wt1, wt0)
    mg = (nkept > 1).reshape(bh, bw)
    new1 = torch.where(mg[..., None],
                       torch.stack([best_x, best_y], -1).reshape(bh, bw, 2),
                       mv1g)
    new0 = torch.where(mg[..., None],
                       torch.stack([b0x, b0y], -1).reshape(bh, bw, 2),
                       mv0g)
    return new1, new0


# ---------------------------------------------------------------------------
# motion-compensated averaging (parallel)
# ---------------------------------------------------------------------------

def interp_exec(p0y, p1y, p0u, p1u, p0v, p1v, mv0g, mv1g, wt0: int,
                wt1: int, *, w: int, h: int, pad: int, pad_c: int, bw: int,
                bh: int, mono: bool):
    """interpolate_frame: per-cell MC averaging.  Bounds pad is bs//2=4
    (2 chroma) regardless of the storage pad (temporal_interp.c:880)."""
    ii, jj = _grid(bh, bw, p0y.device)
    m0 = mv0g.reshape(-1, 2)
    m1 = mv1g.reshape(-1, 2)

    def plane_mc(f0, f1, spad, m0x, m0y, m1x, m1y, bs, bpad, wp, hp):
        xs0 = jj * bs + ((m0x + ACC_ROUND) >> ACC_BITS)
        ys0 = ii * bs + ((m0y + ACC_ROUND) >> ACC_BITS)
        xs1 = jj * bs + ((m1x + ACC_ROUND) >> ACC_BITS)
        ys1 = ii * bs + ((m1y + ACC_ROUND) >> ACC_BITS)
        in0 = ((xs0 >= -bpad) & (xs0 + bs <= wp) &
               (ys0 >= -bpad) & (ys0 + bs <= hp))
        in1 = ((xs1 >= -bpad) & (xs1 + bs <= wp) &
               (ys1 >= -bpad) & (ys1 + bs <= hp))
        a = _win(f0, spad, ys0, xs0, bs, -bpad, wp - 1, hp - 1)
        b = _win(f1, spad, ys1, xs1, bs, -bpad, wp - 1, hp - 1)
        avg = (a + b + 1) >> 1
        out = torch.where((in0 & ~in1)[:, None, None], a,
                          torch.where((in1 & ~in0)[:, None, None], b, avg))
        return (out.reshape(bh, bw, bs, bs).permute(0, 2, 1, 3)
                .reshape(bh * bs, bw * bs))

    bpad = 4
    lum = plane_mc(p0y, p1y, pad, m0[:, 0], m0[:, 1], m1[:, 0], m1[:, 1],
                   8, bpad, w + bpad, h + bpad)
    if mono:
        return lum, None, None
    c1x, c1y = m1[:, 0] >> 1, m1[:, 1] >> 1
    c0x, c0y = _scale(c1x, c1y, -wt1, wt0)
    wpc, hpc = (w + bpad) >> 1, (h + bpad) >> 1
    u = plane_mc(p0u, p1u, pad_c, c0x, c0y, c1x, c1y, 4, bpad >> 1,
                 wpc, hpc)
    v = plane_mc(p0v, p1v, pad_c, c0x, c0y, c1x, c1y, 4, bpad >> 1,
                 wpc, hpc)
    return lum, u, v


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _upscale_mv1(src1, bh_d: int, bw_d: int, bw_s: int, bh_s: int):
    """_upscale_mv_data (mv[1] only; flat-index semantics preserved)."""
    ii, jj = torch.meshgrid(_ar(bh_d, src1.device), _ar(bw_d, src1.device),
                            indexing="ij")
    flat = (torch.div(ii, 2, rounding_mode="floor") * bw_s +
            torch.div(jj, 2, rounding_mode="floor")).clamp(
                0, bh_s * bw_s - 1)
    return 2 * src1.reshape(-1, 2)[flat.long()]


def interpolate_frames(new_frame: YuvFrame, ref0: YuvFrame, ref1: YuvFrame,
                       ratio: int, pos: int, device=None):
    """Device twin of spec.tempinterp.interpolate_frames: fills
    new_frame's planes (host numpy) from the two references' host planes,
    computing on `device` (the CUDA card when none is given)."""
    from ..dec.decoder import resolve_device
    device = resolve_device(device)
    w, h = ref0.width, ref0.height
    max_levels = min(4, int(math.log10(min(w, h)) / math.log10(2.0) - 4.0))
    reversed_ = int(pos > ratio // 2)
    wt0 = pos if reversed_ else ratio - pos
    wt1 = ratio - wt0

    levels = []
    for j in range(max_levels):
        wj, hj = w >> j, h >> j
        levels.append((wj, hj, 2 * ((wj + 15) // 16),
                       2 * ((hj + 15) // 16)))

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

    def up(plane):
        return torch.from_numpy(plane.astype(np.int32)).to(device)

    guide = None
    for lvl in range(max_levels - 1, -1, -1):
        wj, hj, bw, bh = levels[lvl]
        f0, f1 = in_down[lvl]
        pic0, pic1 = (f1, f0) if reversed_ else (f0, f1)
        y0 = up(pic0.y_full)
        y1 = up(pic1.y_full)
        pad = f0.pad
        guided = lvl != max_levels - 1
        mv1g, mv0g, _bg = me_bi_level(y0, y1, guide, wt0, wt1, w=wj, h=hj,
                                      pad=pad, bw=bw, bh=bh, guided=guided)
        mv1g, mv0g = merge_level(y0, y1, mv1g, mv0g, wt0, wt1, w=wj,
                                 h=hj, pad=pad, bw=bw, bh=bh)
        if lvl > 0:
            bw_d, bh_d = levels[lvl - 1][2], levels[lvl - 1][3]
            guide = _upscale_mv1(mv1g, bh_d, bw_d, bw, bh)
        else:
            mono = ref0.mono
            pu0 = up(pic0.u_full) if not mono else y0
            pu1 = up(pic1.u_full) if not mono else y1
            pv0 = up(pic0.v_full) if not mono else y0
            pv1 = up(pic1.v_full) if not mono else y1
            lum, u, v = interp_exec(y0, y1, pu0, pu1, pv0, pv1, mv0g,
                                    mv1g, wt0, wt1, w=wj, h=hj, pad=pad,
                                    pad_c=pic0.pad_c, bw=bw, bh=bh,
                                    mono=mono)
            op = new_frame.pad
            new_frame.y_full[op:op + bh * 8, op:op + bw * 8] = \
                lum.cpu().numpy().astype(new_frame.dtype)
            if not mono:
                oc = new_frame.pad_c
                new_frame.u_full[oc:oc + bh * 4, oc:oc + bw * 4] = \
                    u.cpu().numpy().astype(new_frame.dtype)
                new_frame.v_full[oc:oc + bh * 4, oc:oc + bw * 4] = \
                    v.cpu().numpy().astype(new_frame.dtype)
