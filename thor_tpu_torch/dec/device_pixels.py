"""Device pixel pipeline pieces for real decoded frames (torch port of
thor_tpu/dec/device_pixels.py).

The host helpers below (`_clip_mv`, `_plan_luma`, `_plan_chroma`,
`_pad_to`, `FramePlan`) are verbatim copies of thor_tpu/dec/device_pixels.py
:43-187: the original module imports JAX at the top, and the host decoder
builds its `FramePlan` from this module (thor_tpu_torch/_host.py registers
it under the original's name).  The device functions are torch:
dequantization with the inverse transform, and motion compensation over
cells through the CUDA kernels of ops/mc.py.
"""
from __future__ import annotations

import numpy as np
import torch

from .._host import spec_inter, tables
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


def _dense_residual(coefp, qp4, ls4, bd: int, sizes):
    """Inverse-transform every TB of a plane with static shapes.

    coefp [hp,wp] int16 dense coefficient plane (hp/wp multiples of the
    largest size); qp4/ls4 [hp/4,wp/4].  As in the JAX version, each size
    transforms the whole tiled plane and the tiles whose log2-size matches
    are kept; this port keeps that form so that it equals the reference
    on every input (qmtx planes are not ported)."""
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
        r = residual_batch(t, qp_t, s, bd)
        pl = r.reshape(nh, nw, s, s).permute(0, 2, 1, 3).reshape(hp, wp)
        m = ls4[::s // 4, ::s // 4] == log2i(s)
        pm = m.repeat_interleave(s, 0).repeat_interleave(s, 1)
        res = torch.where(pm, pl, res)
    return res
