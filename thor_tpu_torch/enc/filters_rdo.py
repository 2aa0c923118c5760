"""Encoder-side in-loop filter decisions: CDEF joint strength search and
CLPF RDO (mirrors enc/encode_frame.c:44-635).  Torch port of
thor_tpu/enc/filters_rdo.py.

The host functions are copies of thor_tpu's, body for body, except that
the device passes take the encoder's torch device.  The device passes
(`_cdef_mse_device`, `_apply_cdef_device`, `_clpf_tables_plane_dev`,
`clpf_ssd_tables`) are torch over ops/filters.py.  thor_tpu gates them
on a JAX backend probe (`_device_ok`); the port always has its device,
so only the reference's shape conditions pick the host loops (CDEF
search on frames whose sides are not multiples of 16; CDEF application
on mono, non-4:2:0 or non-multiple-of-8 frames).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..tables import MIN_PB_SIZE, CDEF_VERY_LARGE, log2i
from ..ops.transform import _i32
from ..spec import filters
from ..spec.filters import (cdef_find_dir, cdef_filter_block, adjust_strength,
                            cdef_allskip, _constrain1)

CDEF_PRI_STRENGTHS = 16
CDEF_SEC_STRENGTHS = 4
TOTAL_STRENGTHS = CDEF_PRI_STRENGTHS * CDEF_SEC_STRENGTHS
CDEF_STRENGTH_BITS = 6

PRICONV = [list(range(16)), [0, 1, 2, 3, 5, 7, 10, 13], [0, 1, 3, 6]]
PRISTRENGTHS = [64, 32, 16]


def dist_8x8(dst, src, coeff_shift):
    """enc/encode_frame.c:194-221 (weighted 8x8 distortion)."""
    s = src.astype(np.int64)
    d = dst.astype(np.int64)
    sum_s = int(s.sum()); sum_d = int(d.sum())
    sum_s2 = int((s * s).sum()); sum_d2 = int((d * d).sum())
    sum_sd = int((s * d).sum())
    svar = sum_s2 - ((sum_s * sum_s + 32) >> 6)
    dvar = sum_d2 - ((sum_d * sum_d + 32) >> 6)
    return int(math.floor(
        .5 + (sum_d2 + sum_s2 - 2 * sum_sd) * .5 *
        (svar + dvar + (400 << 2 * coeff_shift)) /
        (math.sqrt((20000 << 4 * coeff_shift) + svar * float(dvar)))))


def _search_one(lev, nb, mse, sb_count, speed):
    total = PRISTRENGTHS[speed]
    tot = [0] * total
    for i in range(sb_count):
        best_mse = 1 << 63
        for gi in range(nb):
            if mse[i][lev[gi]] < best_mse:
                best_mse = mse[i][lev[gi]]
        for j in range(total):
            tot[j] += min(best_mse, mse[i][j])
    best_tot, best_id = 1 << 63, 0
    for j in range(total):
        if tot[j] < best_tot:
            best_tot, best_id = tot[j], j
    lev[nb] = best_id
    return best_tot


def _search_one_dual(lev0, lev1, nb, mse0, mse1, sb_count, speed):
    total = PRISTRENGTHS[speed]
    tot = np.zeros((total, total), np.int64)
    # zero eligible SBs (all-skip frame): empty python lists come in 1-D
    m0 = np.asarray(mse0, np.int64).reshape(-1, TOTAL_STRENGTHS)[
        :sb_count, :total]
    m1 = np.asarray(mse1, np.int64).reshape(-1, TOTAL_STRENGTHS)[
        :sb_count, :total]
    if nb:
        cur = np.stack([m0[:, lev0[g]] + m1[:, lev1[g]] for g in range(nb)])
        best = cur.min(axis=0)
    else:
        best = np.full(sb_count, 1 << 62, np.int64)
    comb = m0[:, :, None] + m1[:, None, :]        # [sb, j, k]
    tot = np.minimum(comb, best[:, None, None]).sum(axis=0)
    idx = int(np.argmin(tot.reshape(-1)))
    best_id0, best_id1 = idx // total, idx % total
    # C scans j outer, k inner, strict '<' keeps first -> argmin matches
    lev0[nb] = best_id0
    lev1[nb] = best_id1
    return int(tot[best_id0, best_id1])


def joint_strength_search_dual(lev0, lev1, nb_strengths, mse0, mse1,
                               sb_count, speed):
    best_tot = 1 << 63
    for i in range(nb_strengths):
        best_tot = _search_one_dual(lev0, lev1, i, mse0, mse1, sb_count,
                                    speed)
    for _ in range(4 * nb_strengths):
        for j in range(nb_strengths - 1):
            lev0[j] = lev0[j + 1]
            lev1[j] = lev1[j + 1]
        best_tot = _search_one_dual(lev0, lev1, nb_strengths - 1, mse0, mse1,
                                    sb_count, speed)
    return best_tot


def cdef_search(enc, rec, org, dd):
    """enc/encode_frame.c:228-489.  Emits per-fb preset indices to the
    stream; fills enc.cdef_strengths/uv and enc.cdef_presets_per_fb.
    Returns nb_strength_bits."""
    p = enc.params
    speed = p.cdef - 1
    width, height = rec.width, rec.height
    fb = 6
    nfh = (width + 63) >> fb
    nfv = (height + 63) >> fb
    bitdepth = p.bitdepth
    coeff_shift = bitdepth - 8
    pri_damping = enc.cdef_damping
    sec_damping = pri_damping
    total = PRISTRENGTHS[speed]
    w = enc.w

    enc.cdef_dirs = {}
    enc.cdef_sel = {}

    if speed == 3:
        enc.cdef_bits = 0
    if enc.cdef_bits == 0:
        qp = enc.fi.qp
        primary = max(0, (qp - 24) // 3)
        secondary = int(16 < qp < 32)
        enc.cdef_strengths[0] = enc.cdef_uv_strengths[0] = \
            (primary << 2) + secondary
        sel = {}
        for ci in range(nfh * nfv):
            sel[ci] = 0
        enc.cdef_sel = sel
        return 0

    if (width % 16 == 0 and height % 16 == 0 and
            p.subsample in (420, 444)):
        mse0, mse1, ci_index = _cdef_mse_device(
            enc, rec, org, dd, speed, total, pri_damping, sec_damping,
            coeff_shift, nfh, nfv)
        return _cdef_pick_and_emit(enc, mse0, mse1, ci_index, speed,
                                   nfh, nfv)

    planes = [(rec.y, org.y, 0, 0), (rec.u, org.u, 1, rec.sub),
              (rec.v, org.v, 2, rec.sub)]

    mse0 = []
    mse1 = []
    ci_index = []
    ci = -1
    for k in range(nfv):
        for l in range(nfh):
            xoff, yoff = l << fb, k << fb
            ci += 1
            if cdef_allskip(xoff, yoff, width, height, dd, fb):
                continue
            hl = min(height, (k + 1) << fb) & 63
            wl = min(width, (l + 1) << fb) & 63
            hl += (not hl) << fb
            wl += (not wl) << fb
            row0 = [0] * TOTAL_STRENGTHS
            row1 = [0] * TOTAL_STRENGTHS
            dirs = {}
            for (rp, op, plane, sub) in planes:
                bs = 8
                for gi in range(total):
                    level = PRICONV[speed][gi // CDEF_SEC_STRENGTHS]
                    pri_strength = level
                    sec_strength = gi % CDEF_SEC_STRENGTHS
                    acc = 0
                    for m in range((hl + bs - 1) >> (3 + sub)):
                        for n in range((wl + bs - 1) >> (3 + sub)):
                            xpos = (xoff >> sub) + n * bs
                            ypos = (yoff >> sub) + m * bs
                            sizex = min((width >> sub) - xpos, bs)
                            sizey = min((height >> sub) - ypos, bs)
                            idx = (((yoff + m * 8) // MIN_PB_SIZE) * w +
                                   ((xoff + n * 8) // MIN_PB_SIZE))
                            if plane == 0 and gi == 0:
                                dirs[(m, n)] = cdef_find_dir(
                                    rp[ypos:ypos + 8, xpos:xpos + 8],
                                    coeff_shift)
                            if dd.mode[idx] == 0:  # MODE_SKIP
                                continue
                            d, var = dirs[(m, n)]
                            adj = (pri_strength if plane else
                                   adjust_strength(pri_strength, var))
                            pd = (max(log2i(adj), pri_damping - (plane != 0))
                                  if adj else pri_damping - (plane != 0))
                            sd = sec_damping - (plane != 0)
                            # input window with frame-edge handling per fb
                            inp = np.full((sizey + 4, sizex + 4),
                                          CDEF_VERY_LARGE, np.int32)
                            ph, pw = rp.shape
                            # the fb-level prepared buffer marks pixels
                            # outside the fb's boundary-type as VERY_LARGE
                            fx0 = xoff >> sub
                            fy0 = yoff >> sub
                            fx1 = fx0 + (min(width - xoff, 64) >> sub)
                            fy1 = fy0 + (min(height - yoff, 64) >> sub)
                            bt_l = fx0 == 0
                            bt_t = fy0 == 0
                            bt_r = fx1 == (width >> sub)
                            bt_b = fy1 == (height >> sub)
                            lo_y = fy0 if bt_t else fy0 - 2
                            hi_y = fy1 if bt_b else fy1 + 2
                            lo_x = fx0 if bt_l else fx0 - 2
                            hi_x = fx1 if bt_r else fx1 + 2
                            y0c, y1c = ypos - 2, ypos + sizey + 2
                            x0c, x1c = xpos - 2, xpos + sizex + 2
                            ry0, ry1 = max(y0c, lo_y), min(y1c, hi_y)
                            rx0, rx1 = max(x0c, lo_x), min(x1c, hi_x)
                            if ry1 > ry0 and rx1 > rx0:
                                inp[ry0 - y0c:ry1 - y0c,
                                    rx0 - x0c:rx1 - x0c] = rp[ry0:ry1,
                                                              rx0:rx1]
                            out = cdef_filter_block(
                                inp, adj << coeff_shift,
                                sec_strength << coeff_shift,
                                d if pri_strength else 0,
                                pd + coeff_shift, sd + coeff_shift,
                                sizey, sizex, coeff_shift)
                            ob = op[ypos:ypos + sizey, xpos:xpos + sizex]
                            if plane or sizex != 8 or sizey != 8:
                                dd2 = (out.astype(np.int64) -
                                       ob.astype(np.int64))
                                acc += int((dd2 * dd2).sum())
                            else:
                                acc += dist_8x8(out, ob, coeff_shift)
                    # C accumulates planes 1 and 2 into the same mse[1] row
                    if plane < 2:
                        (row0 if plane == 0 else row1)[gi] = acc
                    else:
                        row1[gi] += acc
            enc.cdef_dirs[ci] = dirs
            mse0.append(row0)
            mse1.append(row1)
            ci_index.append(ci)
    return _cdef_pick_and_emit(enc, mse0, mse1, ci_index, speed, nfh, nfv)


def _cdef_mse_device(enc, rec, org, dd, speed, total, pri_damping,
                     sec_damping, coeff_shift, nfh, nfv):
    """Device mse tables for the CDEF strength search.

    All candidate strengths are trial-filtered on the device
    (ops/filters.py:cdef_search_sums - whole-plane passes over the
    candidate list) and reduced to per-8x8-block sums; the host only
    assembles the per-fb tables and evaluates the float dist_8x8 formula
    vectorised.  Bit-exact with the per-block host loop
    (enc/encode_frame.c:228-419): the frame-interior fb windows admit
    every in-frame tap, so padding the frame once with CDEF_VERY_LARGE
    reproduces the reference's per-fb prepared buffers."""
    from ..ops import filters as OF

    dev = enc.device
    width, height = rec.width, rec.height
    sub = rec.sub
    nby, nbx = height // 8, width // 8
    levels = [PRICONV[speed][gi // CDEF_SEC_STRENGTHS]
              for gi in range(total)]
    secs = [gi % CDEF_SEC_STRENGTHS for gi in range(total)]

    def up32(p):
        return torch.from_numpy(np.ascontiguousarray(p).astype(
            np.int32)).to(dev)

    ry = up32(rec.y)
    dirs_j, var_j = OF.cdef_dirs(ry, coeff_shift)
    ls = OF.cdef_search_sums(ry, up32(org.y),
                             dirs_j, var_j, levels, secs, 0, 8,
                             pri_damping, sec_damping, coeff_shift)
    # chroma 8x8 blocks use the luma dir computed at the SAME (m,n)
    # block index within the fb (the reference's indexing quirk,
    # enc/encode_frame.c:312)
    hc, wc = height >> sub, width >> sub
    nbyc, nbxc = hc // 8, wc // 8
    npb = 8 >> sub
    iy = (np.arange(nbyc) // npb) * 8 + np.arange(nbyc) % npb
    ix = (np.arange(nbxc) // npb) * 8 + np.arange(nbxc) % npb
    iyt = torch.as_tensor(iy, device=dev)[:, None]
    ixt = torch.as_tensor(ix, device=dev)[None, :]
    dirc = dirs_j[iyt, ixt]
    varc = var_j[iyt, ixt]
    cs_u = OF.cdef_search_sums(
        up32(rec.u), up32(org.u), dirc, varc, levels, secs,
        1, 8, pri_damping - 1, sec_damping - 1, coeff_shift)
    cs_v = OF.cdef_search_sums(
        up32(rec.v), up32(org.v), dirc, varc, levels, secs,
        1, 8, pri_damping - 1, sec_damping - 1, coeff_shift)

    # per-8x8 sums are pulled as int32 (the reference's narrowing; they
    # fit up to 12-bit) and widened back to int64 for the exact math
    def pull32(t):
        return _i32(t).cpu().numpy().astype(np.int64)

    lsums = pull32(ls)
    ssd_c = pull32(cs_u) + pull32(cs_v)
    dirs_np = dirs_j.cpu().numpy()
    var_np = var_j.cpu().numpy()

    # vectorised dist_8x8 (enc/encode_frame.c:194-221); all luma blocks
    # are full 8x8 under the width/height%16==0 gate
    oy = org.y.astype(np.int64).reshape(nby, 8, nbx, 8)
    sum_s = oy.sum(axis=(1, 3))
    sum_s2 = (oy * oy).sum(axis=(1, 3))
    sum_d, sum_d2, sum_sd = lsums[:, 0], lsums[:, 1], lsums[:, 2]
    svar = sum_s2 - ((sum_s * sum_s + 32) >> 6)
    dvar = sum_d2 - ((sum_d * sum_d + 32) >> 6)
    num = sum_d2 + sum_s2[None] - 2 * sum_sd
    dist = np.floor(
        .5 + num * .5 * (svar[None] + dvar + (400 << 2 * coeff_shift)) /
        np.sqrt((20000 << 4 * coeff_shift) +
                svar[None].astype(np.float64) * dvar.astype(np.float64))
    ).astype(np.int64)

    mode_grid = np.asarray(dd.mode).reshape(height // 4, width // 4)
    skipb = mode_grid[::2, ::2] == 0             # [nby,nbx] MODE_SKIP
    selb = ~skipb
    selc = selb[iy][:, ix]

    mse0, mse1, ci_index = [], [], []
    ci = -1
    for k in range(nfv):
        for l in range(nfh):
            ci += 1
            r0, r1 = k * 8, min((k + 1) * 8, nby)
            c0, c1 = l * 8, min((l + 1) * 8, nbx)
            sel = selb[r0:r1, c0:c1]
            if not sel.any():
                continue
            row0 = [0] * TOTAL_STRENGTHS
            row1 = [0] * TOTAL_STRENGTHS
            blk0 = (dist[:, r0:r1, c0:c1] * sel).sum(axis=(1, 2))
            rc0, rc1 = k * npb, min((k + 1) * npb, nbyc)
            cc0, cc1 = l * npb, min((l + 1) * npb, nbxc)
            blk1 = (ssd_c[:, rc0:rc1, cc0:cc1] *
                    selc[rc0:rc1, cc0:cc1]).sum(axis=(1, 2))
            for gi in range(total):
                row0[gi] = int(blk0[gi])
                row1[gi] = int(blk1[gi])
            mse0.append(row0)
            mse1.append(row1)
            ci_index.append(ci)
            enc.cdef_dirs[ci] = {
                (m, n): (int(dirs_np[r0 + m, c0 + n]),
                         int(var_np[r0 + m, c0 + n]))
                for m in range(r1 - r0) for n in range(c1 - c0)}
    return mse0, mse1, ci_index


def _cdef_pick_and_emit(enc, mse0, mse1, ci_index, speed, nfh, nfv):
    """Joint strength search + per-fb preset assignment/emission
    (enc/encode_frame.c:398-489) from the mse tables."""
    p = enc.params
    sb_count = len(ci_index)

    strengths = [0] * 8
    uv_strengths = [0] * 8
    nb_strength_bits = 0
    best_tot_mse = 1 << 63
    lam = enc.fi.lambda_
    i = enc.cdef_bits
    lev0 = [0] * 8
    lev1 = [0] * 8
    tot = joint_strength_search_dual(lev0, lev1, 1 << i, mse0, mse1,
                                     sb_count, speed)
    tot += int(sb_count * lam * i)
    tot += int((1 << i) * lam * CDEF_STRENGTH_BITS)
    if tot < best_tot_mse:
        best_tot_mse = tot
        nb_strength_bits = i
        for j in range(1 << i):
            strengths[j] = lev0[j]
            uv_strengths[j] = lev1[j]

    # sort + dedup (enc/encode_frame.c:420-436)
    n = 1 << nb_strength_bits
    lst = sorted(((strengths[i2] << 16) + (uv_strengths[i2] << 8) + i2)
                 for i2 in range(n))
    gi_trans = [0] * 8
    j = 0
    for i2 in range(n):
        gi_trans[lst[i2] & 255] = j
        if not i2 or (lst[i2] & ~255) != (lst[i2 - 1] & ~255):
            strengths[j] = lst[i2] >> 16
            uv_strengths[j] = (lst[i2] >> 8) & 255
            j += 1
    nb_strength_bits = log2i(j)
    if getattr(enc, "_turbo_frame", False) and nb_strength_bits < i:
        # The reference's dedup reduction (enc/encode_frame.c:434-438)
        # shrinks the patched cdef header below the placeholder written
        # at frame-header time (enc/encode_frame.c:686), leaving stale
        # placeholder bits between the cdef field and the block data -
        # an undecodable stream (the reference's own latent bug; its
        # random-content check.sh never dedups).  The exact host path
        # keeps the behaviour for byte-parity with Thorenc; turbo
        # streams must always DECODE, so pad the strength list back to
        # the placeholder count with duplicates (compliant syntax, the
        # padded entries are simply never selected).
        while j < (1 << i):
            strengths[j] = strengths[j - 1]
            uv_strengths[j] = uv_strengths[j - 1]
            j += 1
        nb_strength_bits = i
    nb_strengths = 1 << nb_strength_bits

    # assign best preset per fb + emit bits
    sel = {}
    for i2 in range(sb_count):
        best_gi, best_mse = 0, 1 << 63
        for gi in range(1 << nb_strength_bits):
            curr = mse0[i2][strengths[gi_trans[gi]]]
            if p.subsample != 400:
                curr += mse1[i2][uv_strengths[gi_trans[gi]]]
            if curr < best_mse:
                best_gi = min(nb_strengths - 1, gi_trans[gi])
                best_mse = curr
        sel[ci_index[i2]] = best_gi
        if nb_strength_bits:
            enc.writer.put_flc(nb_strength_bits, best_gi)

    for j2 in range(nb_strengths):
        strengths[j2] = (PRICONV[speed][strengths[j2] // CDEF_SEC_STRENGTHS] *
                         CDEF_SEC_STRENGTHS +
                         strengths[j2] % CDEF_SEC_STRENGTHS)
        uv_strengths[j2] = (
            PRICONV[speed][uv_strengths[j2] // CDEF_SEC_STRENGTHS] *
            CDEF_SEC_STRENGTHS + uv_strengths[j2] % CDEF_SEC_STRENGTHS)

    enc.cdef_strengths = strengths
    enc.cdef_uv_strengths = uv_strengths
    enc.cdef_sel = sel
    return nb_strength_bits


def apply_cdef_enc(enc, rec, dd):
    """Apply CDEF with the selected strengths (decoder-identical math)."""
    p = enc.params
    nfh = (rec.width + 63) >> 6
    nfv = (rec.height + 63) >> 6
    presets_y, presets_uv = [], []
    for ci in range(nfh * nfv):
        gi = enc.cdef_sel.get(ci, 0)
        sy = enc.cdef_strengths[gi]
        su = enc.cdef_uv_strengths[gi]
        presets_y.append({"level": sy >> 2, "sec_strength": sy & 3})
        presets_uv.append({"level": su >> 2, "sec_strength": su & 3})
    if (not rec.mono and rec.sub == 1 and
            rec.width % 8 == 0 and rec.height % 8 == 0):
        # one device dispatch (same kernels/maps as the decoder's fused
        # chain, ops/filters.py:filters_exec CDEF stage - bit-exact with
        # the host spec path); the host per-block walk costs ~20 s/frame
        # at 1080p
        _apply_cdef_device(enc, rec, dd, presets_y, presets_uv)
        return
    damping = (enc.cdef_damping, enc.cdef_damping)
    dirs = {}
    filters.cdef_frame(rec.y, dd, rec.width, rec.height, 0, rec.sub,
                       p.bitdepth, presets_y, damping, dirs)
    if not rec.mono:
        filters.cdef_frame(rec.u, dd, rec.width, rec.height, 1, rec.sub,
                           p.bitdepth, presets_uv, damping, dirs)
        filters.cdef_frame(rec.v, dd, rec.width, rec.height, 2, rec.sub,
                           p.bitdepth, presets_uv, damping, dirs)


def _apply_cdef_device(enc, rec, dd, presets_y, presets_uv):
    """CDEF with the chosen presets on the device (the kernels and maps
    of the decoder's filter chain, ops/filters.py); one packed pull."""
    from ..ops import filters as OF

    dev = enc.device
    W, H = rec.width, rec.height
    cs = enc.params.bitdepth - 8
    damping = enc.cdef_damping
    lv0, sec0, m0 = OF.cdef_block_maps(dd, presets_y, W, H, 0, rec.sub)
    lv1, sec1, m1 = OF.cdef_block_maps(dd, presets_uv, W, H, 1, rec.sub)
    _, _, m2 = OF.cdef_block_maps(dd, presets_uv, W, H, 2, rec.sub)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    y, u, v = (up(p.astype(np.int32)) for p in (rec.y, rec.u, rec.v))
    dirs, var = OF.cdef_dirs(y, cs)
    y = OF.cdef_plane(y, dirs, var, up(lv0), up(sec0), up(m0), 8, 0,
                      damping, damping, cs)
    u = OF.cdef_plane(u, dirs, var, up(lv1), up(sec1), up(m1), 4, 1,
                      damping - 1, damping - 1, cs)
    v = OF.cdef_plane(v, dirs, var, up(lv1), up(sec1), up(m2), 4, 2,
                      damping - 1, damping - 1, cs)
    packed = OF._pack16(y, u, v, 1, False).cpu().numpy()
    Hc, Wc = H >> 1, W >> 1
    rec.y[:] = packed[:H].astype(rec.dtype)
    rec.u[:] = packed[H:H + Hc, :Wc].astype(rec.dtype)
    rec.v[:] = packed[H:H + Hc, Wc:].astype(rec.dtype)


# ---------------- CLPF RDO ----------------

def _clpf_sample(X, A, B, C, D, E, F, G, H, s, dmp):
    delta = (1 * _constrain1(A - X, s, dmp) + 3 * _constrain1(B - X, s, dmp) +
             1 * _constrain1(C - X, s, dmp) + 3 * _constrain1(D - X, s, dmp) +
             3 * _constrain1(E - X, s, dmp) + 1 * _constrain1(F - X, s, dmp) +
             3 * _constrain1(G - X, s, dmp) + 1 * _constrain1(H - X, s, dmp))
    return (8 + delta - (delta < 0)) >> 4


def _gather_clpf(rec_p, x0, y0, width, height, size):
    """Vectorized A..H taps with frame-edge clamping
    (detect_clpf/detect_multi_clpf addressing)."""
    s = rec_p.astype(np.int32)
    ys, xs = np.mgrid[y0:y0 + size, x0:x0 + size]
    X = s[ys, xs]
    A = s[np.maximum(0, ys - 2), xs]
    B = s[np.maximum(0, ys - 1), xs]
    C = s[ys, np.maximum(0, xs - 2)]
    D = s[ys, np.maximum(0, xs - 1)]
    E = s[ys, np.minimum(width - 1, xs + 1)]
    F = s[ys, np.minimum(width - 1, xs + 2)]
    G = s[np.minimum(height - 1, ys + 1), xs]
    H = s[np.minimum(height - 1, ys + 2), xs]
    return X, A, B, C, D, E, F, G, H


def _constrain_v(diff, threshold, damping):
    if not threshold:
        return np.zeros_like(diff)
    shift = damping - log2i(threshold)
    ad = np.abs(diff)
    return np.sign(diff) * np.minimum(ad, np.maximum(0, threshold -
                                                     (ad >> shift)))


def _clpf_delta_v(X, A, B, C, D, E, F, G, H, s, dmp):
    delta = (1 * _constrain_v(A - X, s, dmp) + 3 * _constrain_v(B - X, s, dmp)
             + 1 * _constrain_v(C - X, s, dmp)
             + 3 * _constrain_v(D - X, s, dmp)
             + 3 * _constrain_v(E - X, s, dmp)
             + 1 * _constrain_v(F - X, s, dmp)
             + 3 * _constrain_v(G - X, s, dmp)
             + 1 * _constrain_v(H - X, s, dmp))
    return (8 + delta - (delta < 0)) >> 4


def detect_clpf(rec_p, org_p, x0, y0, width, height, strength, shift, size,
                dmp):
    """enc/encode_block.c:2568-2591. Returns (sum0, sum1) as uint32 sums."""
    X, A, B, C, D, E, F, G, H = _gather_clpf(rec_p, x0, y0, width, height,
                                             size)
    O = org_p[y0:y0 + size, x0:x0 + size].astype(np.int32)
    Y = X + _clpf_delta_v(X, A, B, C, D, E, F, G, H, strength, dmp)
    s0 = np.uint32(((O - X) ** 2).astype(np.int64).sum() & 0xFFFFFFFF)
    s1 = np.uint32(((O - Y) ** 2).astype(np.int64).sum() & 0xFFFFFFFF)
    return int(s0) >> (shift * 2), int(s1) >> (shift * 2)


def detect_multi_clpf(rec_p, org_p, x0, y0, width, height, shift, size, dmp):
    """enc/encode_block.c:2593-2624. Returns [s0,s1,s2,s3] shifted."""
    X, A, B, C, D, E, F, G, H = _gather_clpf(rec_p, x0, y0, width, height,
                                             size)
    O = org_p[y0:y0 + size, x0:x0 + size].astype(np.int32)
    out = []
    F1 = X + _clpf_delta_v(X, A, B, C, D, E, F, G, H, 1 << shift, dmp)
    F2 = X + _clpf_delta_v(X, A, B, C, D, E, F, G, H, 2 << shift, dmp)
    F3 = X + _clpf_delta_v(X, A, B, C, D, E, F, G, H, 4 << shift, dmp)
    for V in (X, F1, F2, F3):
        s = int(((O - V) ** 2).astype(np.int64).sum() & 0xFFFFFFFF)
        out.append(s >> (shift * 2))
    return out


def clpf_rdo(y, x, rec, org, dd, block_size, fb_size_log2, w, h, res,
             bitdepth, plane, qp, tables=None):
    """enc/encode_frame.c:523-586 (recursive)."""
    filtered = 0
    bslog = log2i(block_size)
    damping = bitdepth - 4 - (plane != 0) + (qp >> 4)
    sums = [0, 0, 0, 0]

    if plane == 0 and fb_size_log2 > log2i(128) - 3:
        fb_size_log2 -= 1
        w1 = min(1 << (fb_size_log2 - bslog), w)
        h1 = min(1 << (fb_size_log2 - bslog), h)
        w2 = min(w - (1 << (fb_size_log2 - bslog)), w >> 1)
        h2 = min(h - (1 << (fb_size_log2 - bslog)), h >> 1)
        i = log2i(128) - fb_size_log2
        sum1, sum2, sum3 = res[i][1], res[i][2], res[i][3]
        oldfiltered = res[i][0]
        res[i][0] = 0
        filtered = clpf_rdo(y, x, rec, org, dd, block_size, fb_size_log2,
                            w1, h1, res, bitdepth, plane, qp, tables)
        if 1 << (fb_size_log2 - bslog) < w:
            filtered |= clpf_rdo(y, x + (1 << fb_size_log2), rec, org, dd,
                                 block_size, fb_size_log2, w2, h1, res,
                                 bitdepth, plane, qp, tables)
        if 1 << (fb_size_log2 - bslog) < h:
            filtered |= clpf_rdo(y + (1 << fb_size_log2), x, rec, org, dd,
                                 block_size, fb_size_log2, w1, h2, res,
                                 bitdepth, plane, qp, tables)
            filtered |= clpf_rdo(y + (1 << fb_size_log2),
                                 x + (1 << fb_size_log2), rec, org, dd,
                                 block_size, fb_size_log2, w2, h2, res,
                                 bitdepth, plane, qp, tables)
        res[i][1] = min(sum1 + res[i][0], res[i][1])
        res[i][2] = min(sum2 + res[i][0], res[i][2])
        res[i][3] = min(sum3 + res[i][0], res[i][3])
        res[i][0] = oldfiltered + filtered
        return filtered

    rec_p = rec.y if plane == 0 else (rec.u if plane == 1 else rec.v)
    org_p = org.y if plane == 0 else (org.u if plane == 1 else org.v)
    rec_width = rec.width >> rec.sub if plane else rec.width
    rec_height = rec.height >> rec.sub if plane else rec.height

    for m in range(h):
        for n in range(w):
            xpos = x + n * block_size
            ypos = y + m * block_size
            sub = rec.sub if plane else 0
            idx = (((ypos << sub) // MIN_PB_SIZE) * (rec.width //
                                                     MIN_PB_SIZE) +
                   ((xpos << sub) // MIN_PB_SIZE))
            if dd.mode[idx] != 0:
                if tables is not None:
                    s = tables[plane][ypos // 8, xpos // 8]
                else:
                    s = detect_multi_clpf(rec_p, org_p, xpos, ypos,
                                          rec_width, rec_height,
                                          bitdepth - 8, block_size,
                                          damping)
                for i2 in range(4):
                    sums[i2] += int(s[i2])
                filtered = 1
    for i2 in range(4 if plane == 0 else 1):
        for j2 in range(4):
            res[i2][j2] += sums[j2]
    return filtered


def clpf_test_frame(rec, org, dd, fi, bitdepth, plane, max_clpf_strength,
                    device):
    """enc/encode_frame.c:588-635. Returns (best_strength, best_bs|None).
    The per-block SSD tables come from `device`."""
    sums = [[0] * 4 for _ in range(4)]
    width = rec.width >> rec.sub if plane else rec.width
    height = rec.height >> rec.sub if plane else rec.height
    bs = 8
    fb_size_log2 = log2i(128)
    rec_p = rec.y if plane == 0 else (rec.u if plane == 1 else rec.v)
    org_p = org.y if plane == 0 else (org.u if plane == 1 else org.v)
    dmp = bitdepth - 4 - (plane != 0) + (fi.qp >> 4)
    tables = {plane: _clpf_tables_plane_dev(rec_p, org_p, bitdepth - 8, dmp,
                                            device)}
    if plane != 0:
        clpf_rdo(0, 0, rec, org, dd, bs, fb_size_log2, width // bs,
                 height // bs, sums, bitdepth, plane, fi.qp, tables)
    else:
        for k in range((height + (1 << fb_size_log2) - bs) >> fb_size_log2):
            for l in range((width + (1 << fb_size_log2) - bs) >>
                           fb_size_log2):
                hh = min(height, (k + 1) << fb_size_log2) & \
                    ((1 << fb_size_log2) - 1)
                ww = min(width, (l + 1) << fb_size_log2) & \
                    ((1 << fb_size_log2) - 1)
                hh += (not hh) << fb_size_log2
                ww += (not ww) << fb_size_log2
                clpf_rdo(k << fb_size_log2, l << fb_size_log2, rec, org, dd,
                         bs, fb_size_log2, ww // bs, hh // bs, sums,
                         bitdepth, plane, fi.qp, tables)
    for j in range(4):
        cost = int(fi.lambda_ * sums[j][0] + 6)
        if plane != 0:
            sums[j][2] += sums[j][2] >> 7
            sums[j][3] += sums[j][3] >> 7
        for i in range(4):
            i_max = min(max_clpf_strength, 3)
            if i > i_max:
                sums[j][i] = 1 << 30
            sums[j][i] = ((sums[j][i] + (int(bool(i)) * int(bool(j))) * cost)
                          << 4) + j * 4 + i
    best = 1 << 62
    for j in range(4 if plane == 0 else 1):
        for i in range(4):
            if (i or not j) and sums[j][i] < best:
                best = sums[j][i]
    best &= 15
    best_bs = (int(best > 3)) * (5 + int(best < 12) + int(best < 8))
    best_strength = (1 << ((best - 1) & 3)) if best else 0
    return best_strength, best_bs


def clpf_decision(k, l, rec, org, dd, block_size, w, h, writer, strength,
                  fb_size_log2, shift, size, qp, tables=None):
    """enc/encode_frame.c:492-511 (per-fb luma decision, writes 1 bit)."""
    sum0 = sum1 = 0
    damping = shift + 4 + (qp >> 4)
    for m in range(h):
        for n in range(w):
            xpos = (l << fb_size_log2) + n * block_size
            ypos = (k << fb_size_log2) + m * block_size
            idx = ((ypos // MIN_PB_SIZE) * (rec.width // MIN_PB_SIZE) +
                   (xpos // MIN_PB_SIZE))
            if dd.mode[idx] != 0:
                if tables is not None:
                    col = {1: 1, 2: 2, 4: 3}[strength >> shift]
                    t = tables[0][ypos // 8, xpos // 8]
                    s0, s1 = int(t[0]), int(t[col])
                else:
                    s0, s1 = detect_clpf(rec.y, org.y, xpos, ypos,
                                         rec.width, rec.height, strength,
                                         shift, size, damping)
                # the reference's detect_clpf_simd accumulates the scalar
                # AND the vector sums (enc_kernels.c:257-262) - every call
                # contributes twice; replicated for exactness
                sum0 += 2 * s0
                sum1 += 2 * s1
    writer.put_flc(1, int(sum1 < sum0))
    return int(sum1 < sum0)


# ------------------------------------------------ device CLPF RDO tables

def _clpf_tables_plane_dev(rec_p, org_p, shift: int, dmp: int, device):
    """One device pass: per-8x8-block SSD vs org for CLPF strengths
    {0, 1<<shift, 2<<shift, 4<<shift} at damping dmp.  The clpf_plane
    kernel is bit-exact with detect_clpf's arithmetic (same edge
    clamping), so the resulting integers equal the numpy path's."""
    from ..ops import filters as OF

    r = torch.from_numpy(np.ascontiguousarray(rec_p).astype(np.int32)).to(
        device)
    o = torch.from_numpy(np.ascontiguousarray(org_p).astype(np.int32)).to(
        device)
    H, W = r.shape
    h8, w8 = H // 8, W // 8
    Hc, Wc = h8 * 8, w8 * 8
    ones = torch.ones((H, W), dtype=torch.bool, device=device)
    outs = []
    for s in (0, 1, 2, 4):
        Y = r if s == 0 else OF.clpf_plane(r, ones, s << shift, dmp)
        d = (o - Y)[:Hc, :Wc].to(torch.int64)
        outs.append((d * d).reshape(h8, 8, w8, 8).sum(dim=(1, 3)))
    t = torch.stack(outs, -1).cpu().numpy()
    return (t.astype(np.int64) >> (shift * 2)).astype(np.int64)


def clpf_ssd_tables(rec, org, bitdepth, qp, mono, device):
    """Per-plane [h8,w8,4] CLPF SSD tables (device pre-pass)."""
    shift = bitdepth - 8
    tabs = {}
    planes = [(0, rec.y, org.y)]
    if not mono:
        planes += [(1, rec.u, org.u), (2, rec.v, org.v)]
    for plane, rp, op in planes:
        dmp = bitdepth - 4 - (plane != 0) + (qp >> 4)
        tabs[plane] = _clpf_tables_plane_dev(rp, op, shift, dmp, device)
    return tabs
