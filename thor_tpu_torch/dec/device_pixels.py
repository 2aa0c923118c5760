"""Device pixel pipeline pieces for real decoded frames (torch port of
thor_tpu/dec/device_pixels.py).

The host helpers below (`_clip_mv`, `_plan_luma`, `_plan_chroma`,
`_pad_to`, `FramePlan`, `plan_block_mc`, `_plan_temp`) and
`build_qm_operands` with `QM_SLOTS` are verbatim copies of
thor_tpu/dec/device_pixels.py:43-302 and :464-516: the original module
imports JAX at the top, and the port's decoder builds its `FramePlan`
and its qmtx operands from this module.  The device functions are torch:
dequantization with the inverse transform, motion compensation over
cells through the CUDA kernels of ops/mc.py, and the two-stage executor
(`frame_exec`, `execute`) that decodes the inter cells of a frame the
fused decoder does not take (luma through the luma kernel, chroma through
the one-plane chroma kernel once per plane and list).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tables
from ..spec import inter as spec_inter
from ..ops.mc import (OP_COPY, OP_LOWPASS, OP_NONE, OP_SIXTAP,  # noqa: F401
                      mc_cells_chroma, mc_cells_chroma_uv, mc_cells_luma)
from ..ops.transform import _i16, inv_transform_batch
from ..tables import to_device

MAX_MV_EXT = spec_inter.MAX_MV_EXT
MIN_PB_SIZE = tables.MIN_PB_SIZE
log2i = tables.log2i

# ---------------------------------------------------------------------------
# host-side MC planning (mirrors spec/inter.mc_luma / mc_chroma prologues)
# ---------------------------------------------------------------------------

def _clip_mv(mvy, mvx, ypos, xpos, fw, fh, bw, bh, sign):
    """inter_prediction.c:51-63 (C int division truncates toward zero)."""
    if sign:
        mvy, mvx = -mvy, -mvx
    if ypos + int(mvy / 4) < -MAX_MV_EXT:
        mvy = 4 * (-MAX_MV_EXT - ypos)
    if ypos + int(mvy / 4) + bh > fh + MAX_MV_EXT:
        mvy = 4 * (fh + MAX_MV_EXT - ypos - bh)
    if xpos + int(mvx / 4) < -MAX_MV_EXT:
        mvx = 4 * (-MAX_MV_EXT - xpos)
    if xpos + int(mvx / 4) + bw > fw + MAX_MV_EXT:
        mvx = 4 * (fw + MAX_MV_EXT - xpos - bw)
    if sign:
        mvy, mvx = -mvy, -mvx
    return mvy, mvx


def _plan_luma(mvy, mvx, ypos, xpos, bw, bh, sign, bipred, W, H,
               cl_y, cl_x):
    """mc_luma prologue (inter_prediction.c:117-150): returns
    (op, y0, x0, vfrac, hfrac, fset) with (y0,x0) the block origin in
    visible coords."""
    if sign:
        mvy, mvx = -mvy, -mvx
    vf = mvy & 3
    hf = mvx & 3
    vi = mvy >> 2
    hi = mvx >> 2
    vi = min(vi, H - cl_y)
    vi = max(vi, -cl_x - bh)   # (sic) reference quirk: clamps with xpos
    hi = min(hi, W - cl_x)
    hi = max(hi, -cl_x - bw)
    y0 = ypos + vi
    x0 = xpos + hi
    if vf == 0 and hf == 0:
        return OP_COPY, y0, x0, 0, 0, 0
    if vf == 2 and hf == 2 and bipred < 2:
        return OP_LOWPASS, y0, x0, 0, 0, 0
    return OP_SIXTAP, y0, x0, vf, hf, 1 if bipred else 0


def _plan_chroma(mvy, mvx, ypos, xpos, bw, bh, sign, W2, H2, cl_y, cl_x):
    """mc_chroma prologue (inter_prediction.c:65-90), chroma units."""
    if sign:
        mvy, mvx = -mvy, -mvx
    vf = mvy & 7
    hf = mvx & 7
    vi = mvy >> 3
    hi = mvx >> 3
    vi = min(vi, H2 - cl_y)
    vi = max(vi, -cl_x - bh)
    hi = min(hi, W2 - cl_x)
    hi = max(hi, -cl_x - bw)
    y0 = ypos + vi
    x0 = xpos + hi
    if vf == 0 and hf == 0:
        return OP_COPY, y0, x0, 0, 0
    return OP_SIXTAP, y0, x0, vf, hf


def _pad_to(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


class FramePlan:
    """Per-frame dense MC parameter grids + dense TB residual planes.

    Residuals are stored TPU-first: one dense coefficient plane per
    colour plane (each TB's top-left min(16,s)^2 coeffs written at its
    plane position) plus per-4x4-cell qp / log2-TB-size grids, so the
    device can inverse-transform the whole frame with static shapes
    (no per-batch recompiles, one dispatch)."""

    def __init__(self, width, height):
        self.w, self.h = width, height
        gh, gw = height // MIN_PB_SIZE, width // MIN_PB_SIZE
        z = lambda: np.zeros((gh, gw), np.int32)  # noqa: E731
        # luma cell params, lists 0/1
        self.ly = {k: z() for k in ("op0", "y0_0", "x0_0", "vf0", "hf0",
                                    "fs0", "r0", "op1", "y0_1", "x0_1",
                                    "vf1", "hf1", "fs1", "r1")}
        # chroma cell params (u and v share geometry; planes differ only
        # in source data)
        self.ch = {k: z() for k in ("op0", "y0_0", "x0_0", "vf0", "hf0",
                                    "op1", "y0_1", "x0_1", "vf1", "hf1")}
        self.avg = z()            # 1 = average lists (dir==2 / temp)
        self.inter = z()          # 1 = cell written by device pass
        # dense residual planes (padded so every TB size tiles evenly)
        hp, wp = _pad_to(height, 128), _pad_to(width, 128)
        hc, wc = _pad_to(height // 2, 64), _pad_to(width // 2, 64)
        self.coef = {"y": np.zeros((hp, wp), np.int16),
                     "u": np.zeros((hc, wc), np.int16),
                     "v": np.zeros((hc, wc), np.int16)}
        self.qp4 = {"y": np.zeros((hp // 4, wp // 4), np.int32),
                    "c": np.zeros((hc // 4, wc // 4), np.int32)}
        self.ls4 = {"y": np.zeros((hp // 4, wp // 4), np.int32),
                    "c": np.zeros((hc // 4, wc // 4), np.int32)}
        self.intra = []           # deferred intra blocks (coding order)

    def add_tb(self, plane: str, size: int, cy: int, cx: int, qp: int,
               coeff: np.ndarray):
        """One transform block: top-left (cy,cx) in plane coords."""
        qs = min(size, 16)
        self.coef[plane][cy:cy + qs, cx:cx + qs] = coeff[:qs, :qs]
        g = "y" if plane == "y" else "c"
        self.qp4[g][cy // 4:(cy + size) // 4, cx // 4:(cx + size) // 4] = qp
        self.ls4[g][cy // 4:(cy + size) // 4,
                    cx // 4:(cx + size) // 4] = log2i(size)

    # ---- per-PB fills -----------------------------------------------
    def fill_luma(self, lst: int, ypos, xpos, bw, bh, plan):
        op, y0, x0, vf, hf, fs = plan
        g = self.ly
        s = "01"[lst]
        by, bx = ypos // 4, xpos // 4
        nh, nw = bh // 4, bw // 4
        g["op" + s][by:by + nh, bx:bx + nw] = op
        # per-cell window origins advance with the cell
        oy = y0 + (np.arange(nh) * 4)[:, None]
        ox = x0 + (np.arange(nw) * 4)[None, :]
        g["y0_" + s][by:by + nh, bx:bx + nw] = oy
        g["x0_" + s][by:by + nh, bx:bx + nw] = ox
        g["vf" + s][by:by + nh, bx:bx + nw] = vf
        g["hf" + s][by:by + nh, bx:bx + nw] = hf
        g["fs" + s][by:by + nh, bx:bx + nw] = fs

    def fill_chroma(self, lst: int, ypos, xpos, bw, bh, plan):
        """(ypos,xpos,bw,bh) in LUMA units; plan origins in chroma units."""
        op, y0, x0, vf, hf = plan
        g = self.ch
        s = "01"[lst]
        by, bx = ypos // 4, xpos // 4
        nh, nw = bh // 4, bw // 4
        g["op" + s][by:by + nh, bx:bx + nw] = op
        oy = y0 + (np.arange(nh) * 2)[:, None]
        ox = x0 + (np.arange(nw) * 2)[None, :]
        g["y0_" + s][by:by + nh, bx:bx + nw] = oy
        g["x0_" + s][by:by + nh, bx:bx + nw] = ox
        g["vf" + s][by:by + nh, bx:bx + nw] = vf
        g["hf" + s][by:by + nh, bx:bx + nw] = hf


def plan_block_mc(plan: FramePlan, dec, bp, size, ypos, xpos, bwidth,
                  bheight, ref_slots):
    """Mirror Decoder._inter_pred / get_inter_prediction_yuv into the
    plan grids (all the same control flow, no pixel math)."""
    h = dec.h
    fi = dec.fi
    rec_num = dec.rec.frame_num
    mode = bp["mode"]
    W, H = dec.width, dec.height
    temp_case = (mode == 0 and bp["dir"] == 2 and
                 dec.stat_frame_type == 2 and h.interp_ref == 2 and
                 bp["skip_idx"] == 0)

    by, bx = ypos // 4, xpos // 4
    plan.inter[by:by + bheight // 4, bx:bx + bwidth // 4] = 1

    if temp_case:
        _plan_temp(plan, dec, bp, size, ypos, xpos, bwidth, bheight,
                   ref_slots)
        return

    def one_list(lst, ridx, sign, bipred_arg, split):
        ref = dec._ref_frame(fi.ref_array[ridx])
        slot = ref_slots[fi.ref_array[ridx]]
        div = split + 1
        bw, bh = bwidth // div, bheight // div
        mv_arr = bp["mv_arr0"] if lst == 0 else bp["mv_arr1"]
        for index in range(div * div):
            idx, idy = index & 1, (index >> 1) & 1
            oy, ox = idy * bh, idx * bw
            mvy, mvx = mv_arr[index]
            mvy, mvx = _clip_mv(mvy, mvx, ypos, xpos, W, H, bw, bh, sign)
            pl = _plan_luma(mvy, mvx, ypos + oy, xpos + ox, bw, bh, sign,
                            bipred_arg, W, H, ypos, xpos)
            plan.fill_luma(lst, ypos + oy, xpos + ox, bw, bh, pl)
            if lst == 0:
                plan.ly["r0"][(ypos + oy) // 4:(ypos + oy + bh) // 4,
                              (xpos + ox) // 4:(xpos + ox + bw) // 4] = slot
            else:
                plan.ly["r1"][(ypos + oy) // 4:(ypos + oy + bh) // 4,
                              (xpos + ox) // 4:(xpos + ox + bw) // 4] = slot
            pc = _plan_chroma(mvy, mvx, (ypos + oy) >> 1, (xpos + ox) >> 1,
                              bw >> 1, bh >> 1, sign, W >> 1, H >> 1,
                              ypos >> 1, xpos >> 1)
            plan.fill_chroma(lst, ypos + oy, xpos + ox, bw, bh, pc)

    if mode in (0, 4):  # SKIP / MERGE
        if bp["dir"] == 2:
            r0, r1 = bp["ref_idx0"], bp["ref_idx1"]
            s0 = int(dec._ref_frame(fi.ref_array[r0]).frame_num >= rec_num)
            s1 = int(dec._ref_frame(fi.ref_array[r1]).frame_num >= rec_num)
            one_list(0, r0, s0, h.bipred, 0)
            one_list(1, r1, s1, h.bipred, 0)
            plan.avg[by:by + bheight // 4, bx:bx + bwidth // 4] = 1
        else:
            r0 = bp["ref_idx0"]
            s0 = int(dec._ref_frame(fi.ref_array[r0]).frame_num > rec_num)
            one_list(0, r0, s0, h.bipred, 0)
    elif mode == 2:  # INTER (sequence-level pb_split flag as split arg)
        r0 = bp["ref_idx0"]
        s0 = int(dec._ref_frame(fi.ref_array[r0]).frame_num > rec_num)
        one_list(0, r0, s0, h.bipred, h.pb_split)
    elif mode == 3:  # BIPRED
        r0, r1 = bp["ref_idx0"], bp["ref_idx1"]
        s0 = int(dec._ref_frame(fi.ref_array[r0]).frame_num >= rec_num)
        s1 = int(dec._ref_frame(fi.ref_array[r1]).frame_num >= rec_num)
        one_list(0, r0, s0, h.bipred, h.pb_split)
        one_list(1, r1, s1, h.bipred, h.pb_split)
        plan.avg[by:by + bheight // 4, bx:bx + bwidth // 4] = 1
    else:
        raise ValueError(mode)


def _plan_temp(plan, dec, bp, size, ypos, xpos, bwidth, bheight,
               ref_slots):
    """get_inter_prediction_temp (inter_prediction.c:352-411): per-4x4
    MVs from the temporal MV store, bipred filter set, signs 0/1."""
    h = dec.h
    fi = dec.fi
    W, H = dec.width, dec.height
    gop = h.num_reorder_pics + 1
    phase = fi.phase
    slot0 = ref_slots[fi.ref_array[bp["ref_idx0"]]]
    slot1 = ref_slots[fi.ref_array[bp["ref_idx1"]]]
    by, bx = ypos // 4, xpos // 4
    plan.avg[by:by + bheight // 4, bx:bx + bwidth // 4] = 1
    for m in range(0, bheight, MIN_PB_SIZE):
        for n in range(0, bwidth, MIN_PB_SIZE):
            bi = ((ypos + m) // MIN_PB_SIZE) * dec.dd.bs + \
                (xpos + n) // MIN_PB_SIZE
            mv = (int(dec.dd.arr_mv0[bi, phase, 0]),
                  int(dec.dd.arr_mv0[bi, phase, 1]))
            yb, xb = ypos + m, xpos + n
            mvy, mvx = _clip_mv(mv[0], mv[1], yb, xb, W, H,
                                MIN_PB_SIZE, MIN_PB_SIZE, 0)
            pl = _plan_luma(mvy, mvx, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE,
                            0, 2, W, H, yb, xb)
            plan.fill_luma(0, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE, pl)
            plan.ly["r0"][yb // 4, xb // 4] = slot0
            pc = _plan_chroma(mvy, mvx, yb >> 1, xb >> 1, 2, 2, 0,
                              W >> 1, H >> 1, yb >> 1, xb >> 1)
            plan.fill_chroma(0, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE, pc)
            mv1 = mv
            if gop == 3 and phase == 1:
                mv1 = (2 * mv[0], 2 * mv[1])
            mvy, mvx = _clip_mv(mv1[0], mv1[1], yb, xb, W, H,
                                MIN_PB_SIZE, MIN_PB_SIZE, 1)
            pl = _plan_luma(mvy, mvx, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE,
                            1, 2, W, H, yb, xb)
            plan.fill_luma(1, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE, pl)
            plan.ly["r1"][yb // 4, xb // 4] = slot1
            pc = _plan_chroma(mvy, mvx, yb >> 1, xb >> 1, 2, 2, 1,
                              W >> 1, H >> 1, yb >> 1, xb >> 1)
            plan.fill_chroma(1, yb, xb, MIN_PB_SIZE, MIN_PB_SIZE, pc)


# ---------------------------------------------------------------------------
# device functions
# ---------------------------------------------------------------------------

def residual_batch(coeff, qp, size: int, bitdepth: int):
    """Dynamic-qp dequantize (common/common_block.c:45-73, no qmtx) +
    inverse transform.  coeff [N,qs,qs] integer, qp [N] integer.
    Returns [N,size,size] int32."""
    qs = min(size, 16)
    qp = qp.to(torch.int32)
    lshift = torch.div(qp, 6, rounding_mode="floor")
    rshift = log2i(size) - 1
    scale = to_device(coeff.device)["gdequant"][qp.long() % 6]
    c = coeff.to(torch.int32) * scale[:, None, None]
    le = (lshift >= rshift)[:, None, None]
    dl = (lshift - rshift).clamp(min=0)[:, None, None]
    dr = (rshift - lshift).clamp(min=0)[:, None, None]
    add = torch.where(dr > 0, 1 << (dr - 1).clamp(min=0),
                      torch.zeros_like(dr))
    r = _i16(torch.where(le, c << dl, (c + add) >> dr))   # int16 wrap
    full = torch.zeros((coeff.shape[0], size, size), dtype=torch.int32,
                       device=coeff.device)
    full[:, :qs, :qs] = r
    return inv_transform_batch(full, size, bitdepth)


def residual_batch_w(coeff, qp, iw, size: int, bitdepth: int):
    """Weight-matrix dequantize (common/common_block.c:45-73 with
    iwmatrix) + inverse transform.  coeff [N,qs,qs] integer, qp [N]
    integer, iw [N,qs,qs] inverse weights (INV_WEIGHT_SHIFT-scaled).
    coeff*iw*scale can pass 2^31, so the product runs in int64; the
    result wraps to int16.  Returns [N,size,size] int32."""
    qs = min(size, 16)
    qp = qp.to(torch.int64)
    lshift = torch.div(qp, 6, rounding_mode="floor")
    rshift = log2i(size) - 1 + tables.INV_WEIGHT_SHIFT
    scale = to_device(coeff.device)["gdequant"][qp % 6].to(torch.int64)
    c = (coeff.to(torch.int64) * iw.to(torch.int64) *
         scale[:, None, None])
    le = (lshift >= rshift)[:, None, None]
    dl = (lshift - rshift).clamp(min=0)[:, None, None]
    dr = (rshift - lshift).clamp(min=0)[:, None, None]
    add = torch.where(dr > 0, 1 << (dr - 1).clamp(min=0),
                      torch.zeros_like(dr))
    r = _i16(torch.where(le, c << dl, (c + add) >> dr))   # int16 wrap
    full = torch.zeros((coeff.shape[0], size, size), dtype=torch.int32,
                       device=coeff.device)
    full[:, :qs, :qs] = r.to(torch.int32)
    return inv_transform_batch(full, size, bitdepth)


def _dense_residual(coefp, qp4, ls4, bd: int, sizes, wsel4=None,
                    wbank=None):
    """Inverse-transform every TB of a plane with static shapes.

    coefp [hp,wp] int16 dense coefficient plane (hp/wp multiples of the
    largest size); qp4/ls4 [hp/4,wp/4].  As in the JAX version, each size
    transforms the whole tiled plane and the tiles whose log2-size matches
    are kept; this port keeps that form so that it equals the reference
    on every input.

    qmtx streams pass wsel4 [hp/4,wp/4] (per-4x4 weight slot) and wbank
    {size: [L,qs,qs]} inverse-weight banks (build_qm_operands); slots
    select the (qlevel, intra) matrix for each TB."""
    hp, wp = coefp.shape
    res = torch.zeros((hp, wp), dtype=torch.int32, device=coefp.device)
    for s in sizes:
        if s > hp or s > wp:
            continue
        qs = min(s, 16)
        nh, nw = hp // s, wp // s
        t = (coefp.reshape(nh, s, nw, s)[:, :qs, :, :qs]
             .permute(0, 2, 1, 3).reshape(nh * nw, qs, qs))
        qp_t = qp4[::s // 4, ::s // 4].reshape(-1)
        if wsel4 is None:
            r = residual_batch(t, qp_t, s, bd)
        else:
            iw_t = wbank[s][wsel4[::s // 4, ::s // 4].reshape(-1).long()]
            r = residual_batch_w(t, qp_t, iw_t, s, bd)
        pl = r.reshape(nh, nw, s, s).permute(0, 2, 1, 3).reshape(hp, wp)
        m = ls4[::s // 4, ::s // 4] == log2i(s)
        pm = m.repeat_interleave(s, 0).repeat_interleave(s, 1)
        res = torch.where(pm, pl, res)
    return res


QM_SLOTS = 24      # weight slots: NUM_QM_LEVELS x {intra,inter} covers
                   # every possible frame, so the bank shape is static


def build_qm_operands(dec, plan, blks):
    """Host-side qmtx operands for the dense residual path.

    Returns (wsel_y [gh,gw], wsel_c [gh/2,gw/2], banks) where banks maps
    plane -> {size: [QM_SLOTS,qs,qs] int32}.  The qlevel follows each
    BLOCK's luma qp (decode_block derives ql from qpY once for all
    planes, dec/decoder.py:731) - taken from the parsed block records,
    since the qp4 grid is only filled at coded TBs (a chroma TB under a
    cbp_y=0 luma block would otherwise read qp 0).  intra/inter selects
    the matrix flavour per cell."""
    from ..tables import qp_to_qlevel
    from . import native_parse as NP
    h = dec.h
    qp4y = plan.qp4["y"]
    gh, gw = qp4y.shape        # padded coef-plane geometry
    qpd = np.zeros((gh, gw), np.int32)
    intra4 = np.ones((gh, gw), np.int32)
    for r in blks:
        y, x = int(r[NP.B_YPOS]) // 4, int(r[NP.B_XPOS]) // 4
        s4 = int(r[NP.B_SIZE]) // 4
        qpd[y:y + s4, x:x + s4] = int(r[NP.B_QPY])
        intra4[y:y + s4, x:x + s4] = int(r[NP.B_MODE]) == 1  # MODE_INTRA
    qls = np.zeros_like(qpd)
    for q in np.unique(qpd):
        qls[qpd == q] = qp_to_qlevel(int(q), h.qmtx_offset)
    # slot = pair index over the distinct (qlevel, intra) combos present
    pairs = sorted({(int(a), int(b))
                    for a, b in zip(qls.reshape(-1), intra4.reshape(-1))})
    slot_of = {p: i for i, p in enumerate(pairs)}
    wsel_y = np.zeros((gh, gw), np.int32)
    for p, i in slot_of.items():
        wsel_y[(qls == p[0]) & (intra4 == p[1])] = i
    wsel_c = wsel_y[::2, ::2].copy()
    banks = {}
    for plane, key in ((0, "y"), (1, "u"), (2, "v")):
        per = {}
        for s in (4, 8, 16, 32, 64, 128):
            qs = min(s, 16)
            bank = np.zeros((QM_SLOTS, qs, qs), np.int32)
            for (ql, intra_f), i in slot_of.items():
                # reference quirk: intra chroma dequant uses the U-plane
                # matrix for BOTH chroma planes (dec/decode_block.c:255,
                # decoder.py:802 iwm(1,1)); inter is per-plane
                pl = 1 if (plane == 2 and intra_f) else plane
                bank[i] = dec.iwmatrix[ql][pl][intra_f][
                    log2i(s) - 2].astype(np.int32)
            per[s] = bank
        banks[key] = per
    return wsel_y, wsel_c, banks


# ---------------------------------------------------------------------------
# two-stage executor: the inter half of a frame on the device, for frames
# that the fused DeviceFrameDecoder does not take
# ---------------------------------------------------------------------------

def frame_exec(ystack, ustack, vstack, lg, cg, avg, coef_y, qp4_y, ls4_y,
               coef_u, coef_v, qp4_c, ls4_c, H: int, W: int, bd: int,
               pad: int, pad_c: int, has_avg: bool):
    """MC + dequant/itx + reconstruct for a whole 4:2:0 frame
    (thor_tpu/dec/device_pixels.py:frame_exec).

    ystack/ustack/vstack [R,Hp,Wp] int16 padded reference planes; lg/cg
    the plan's luma and chroma cell grids, flattened ({key: [gh*gw]
    int32}); avg [gh*gw]; the dense coefficient planes with their qp and
    log2-size grids.  Chroma MC runs once per plane and list, through the
    one-plane kernel.  Returns one packed int16 buffer [H + H/2, W]: luma
    on top, u|v side by side below (a single device->host pull)."""
    gh, gw = H // 4, W // 4
    H2, W2 = H // 2, W // 2

    def cells_to_plane(p, cs):
        return p.reshape(gh, gw, cs, cs).permute(0, 2, 1, 3).reshape(
            gh * cs, gw * cs)

    def luma(s):
        return mc_cells_luma(ystack, lg["r" + s], lg["y0_" + s] + pad,
                             lg["x0_" + s] + pad, lg["op" + s],
                             lg["vf" + s], lg["hf" + s], lg["fs" + s], 4, bd)

    def chroma(stack, s):
        return mc_cells_chroma(stack, lg["r" + s], cg["y0_" + s] + pad_c,
                               cg["x0_" + s] + pad_c, cg["op" + s],
                               cg["vf" + s], cg["hf" + s], 2, bd)

    # ---- luma MC, then chroma MC per plane (4:2:0) ----
    p0, pu0, pv0 = luma("0"), chroma(ustack, "0"), chroma(vstack, "0")
    if has_avg:
        m = avg[:, None, None] == 1
        p0 = torch.where(m, (p0 + luma("1")) >> 1, p0)
        pu0 = torch.where(m, (pu0 + chroma(ustack, "1")) >> 1, pu0)
        pv0 = torch.where(m, (pv0 + chroma(vstack, "1")) >> 1, pv0)

    # ---- dense residuals ----
    res_y = _dense_residual(coef_y, qp4_y, ls4_y, bd,
                            (4, 8, 16, 32, 64, 128))[:H, :W]
    res_u = _dense_residual(coef_u, qp4_c, ls4_c, bd,
                            (4, 8, 16, 32, 64))[:H2, :W2]
    res_v = _dense_residual(coef_v, qp4_c, ls4_c, bd,
                            (4, 8, 16, 32, 64))[:H2, :W2]

    # ---- reconstruct (pred routed through int16 like the reference) ----
    maxv = (1 << bd) - 1

    def recon(pred, cs, res):
        return (_i16(cells_to_plane(pred, cs)) + res).clamp(0, maxv).to(
            torch.int16)

    rec_uv = torch.cat([recon(pu0, 2, res_u), recon(pv0, 2, res_v)], dim=1)
    return torch.cat([recon(p0, 4, res_y), rec_uv], dim=0)


def build_exec_inputs(dec, plan: FramePlan, ref_frames):
    """(host arrays, static kwargs) for frame_exec.  The references are
    stacked from the host frames, so any deferred pull of a fused frame
    must be resolved first (Decoder.flush_pixels)."""
    for r in ref_frames:
        if not getattr(r, "host_pixels_valid", True):
            raise RuntimeError(
                "reading host pixels of a reference whose deferred device "
                "copy has not been resolved (frame_num=%s)" % r.frame_num)
    arrs = {
        "ystack": np.stack([r.y_full for r in ref_frames]).astype(np.int16),
        "ustack": np.stack([r.u_full for r in ref_frames]).astype(np.int16),
        "vstack": np.stack([r.v_full for r in ref_frames]).astype(np.int16),
        "lg": {k: v.reshape(-1) for k, v in plan.ly.items()},
        "cg": {k: v.reshape(-1) for k, v in plan.ch.items()},
        "avg": plan.avg.reshape(-1),
        "coef_y": plan.coef["y"], "qp4_y": plan.qp4["y"],
        "ls4_y": plan.ls4["y"], "coef_u": plan.coef["u"],
        "coef_v": plan.coef["v"], "qp4_c": plan.qp4["c"],
        "ls4_c": plan.ls4["c"],
    }
    static = dict(H=dec.height, W=dec.width, bd=dec.h.bitdepth,
                  pad=ref_frames[0].pad, pad_c=ref_frames[0].pad_c,
                  has_avg=bool(plan.avg.any()))
    return arrs, static


def merge_exec_output(dec, plan: FramePlan, packed: np.ndarray):
    """Merge a pulled frame_exec buffer into dec.rec (inter cells)."""
    H, W = dec.height, dec.width
    H2 = H // 2
    rec_y = packed[:H]
    rec_u = packed[H:, :W // 2]
    rec_v = packed[H:, W // 2:]
    m4 = plan.inter.astype(bool)
    my = np.repeat(np.repeat(m4, 4, 0), 4, 1)
    mc2 = np.repeat(np.repeat(m4, 2, 0), 2, 1)
    rec = dec.rec
    rec.y[my] = rec_y[my].astype(rec.dtype)
    rec.u[mc2] = rec_u[:H2][mc2].astype(rec.dtype)
    rec.v[mc2] = rec_v[:H2][mc2].astype(rec.dtype)


def execute(dec, plan: FramePlan, ref_slots, ref_frames):
    """Run the planned frame on the decoder's device; fills dec.rec's
    inter cells."""
    arrs, static = build_exec_inputs(dec, plan, ref_frames)

    def up(a):
        if isinstance(a, dict):
            return {k: up(v) for k, v in a.items()}
        return torch.from_numpy(np.ascontiguousarray(a)).to(dec.device)

    packed = frame_exec(**up(arrs), **static)
    merge_exec_output(dec, plan, packed.cpu().numpy())
