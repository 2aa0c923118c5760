"""Bridge to the native (C) block-layer syntax parser (blockparse.c).

One call parses a whole frame's SB walk into flat numpy arrays: leaf
block records, TB records + descanned coefficients, deblock-data grid
updates (in place), bit accounting, and - when the device pixel path is
active - the dense MC-plan grids and dense coefficient planes consumed
directly by dec/device_pixels.frame_exec.  Falls back to the Python walk
(dec/decoder.py) when the native library is unavailable.
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from ..tables import ZIGZAG

# leaf block record fields (blockparse.c BREC layout)
BREC_W = 32
(B_YPOS, B_XPOS, B_SIZE, B_MODE, B_TBSPLIT, B_PBPART, B_INTRA_MODE,
 B_SKIP_IDX, B_REF0, B_REF1, B_DIR, B_CBP_Y, B_CBP_U, B_CBP_V, B_QPY,
 B_QPC) = range(16)
B_MV0, B_MV1 = 16, 24

TREC_W = 8
T_PLANE, T_SIZE, T_YPOS, T_XPOS, T_QP, T_OFF, T_BLK, T_DENSE = range(8)

ST_TOTAL = 372

_ZZ = {k: np.ascontiguousarray(v, dtype=np.int32)
       for k, v in ZIGZAG.items()}

_DISABLED = os.environ.get("THOR_NATIVE_PARSE", "1") == "0"


def available():
    if _DISABLED:
        return False
    from .._native import get_lib
    return get_lib() is not None


def parse_frame(dec, s, plan=None, ref_slots=None):
    """Parse one frame's SB walk natively.

    dec: Decoder (frame header already read); s: BitReader positioned at
    the first SB; plan: optional device_pixels.FramePlan whose grids the
    parser fills; ref_slots: {ref_array_value: device slot} when plan.

    Returns (blks, tbs, coef) numpy arrays, or None when the native
    library is unavailable (caller falls back to the Python walk)."""
    if _DISABLED:
        return None
    from .._native import get_lib, ParseCtx, i32p, i16p, i64p
    lib = get_lib()
    if lib is None:
        return None
    h = dec.h
    fi = dec.fi
    dd = dec.dd

    c = ParseCtx()
    c.width, c.height = dec.width, dec.height
    c.sb_size = 1 << h.log2_sb_size
    c.pb_split = h.pb_split
    c.tb_split_enable = h.tb_split_enable
    c.max_delta_qp = h.max_delta_qp
    c.use_block_contexts = h.use_block_contexts
    c.bipred = h.bipred
    c.seq_interp_ref = h.interp_ref
    c.num_reorder_pics = h.num_reorder_pics
    c.sub = dec.sub
    c.mono = int(dec.mono)
    c.frame_type = fi.frame_type
    c.stat_frame_type = dec.stat_frame_type
    c.num_ref = fi.num_ref
    c.interp_ref = fi.interp_ref
    c.num_intra_modes = fi.num_intra_modes
    c.qp = fi.qp
    c.qpb = fi.qpb
    c.phase = fi.phase
    c.rec_frame_num = dec.rec.frame_num
    for r in range(fi.num_ref):
        c.ref_frame_num[r] = dec._ref_frame(fi.ref_array[r]).frame_num
        c.ref_slot[r] = (ref_slots[fi.ref_array[r]]
                         if ref_slots is not None else 0)

    c.bs, c.rows = dd.bs, dd.rows
    c.dd_mode = i32p(dd.mode)
    c.dd_size = i32p(dd.size)
    c.dd_tb_split = i32p(dd.tb_split)
    c.dd_pb_part = i32p(dd.pb_part)
    c.dd_cbp_y = i32p(dd.cbp_y)
    c.dd_cbp_u = i32p(dd.cbp_u)
    c.dd_cbp_v = i32p(dd.cbp_v)
    c.dd_mv0 = i32p(dd.mv0)
    c.dd_mv1 = i32p(dd.mv1)
    c.dd_ref0 = i32p(dd.ref_idx0)
    c.dd_ref1 = i32p(dd.ref_idx1)
    c.dd_bipred = i32p(dd.bipred_flag)
    c.dd_arr_mv0 = i32p(dd.arr_mv0)

    # worst case: one leaf per 8x8 (plus rect edge leaves) - 4x headroom
    max_blk = 4 * ((dec.width // 8 + 2) * (dec.height // 8 + 2))
    blks = np.zeros((max_blk, BREC_W), np.int32)
    # TBs: one luma + two chroma per 4x4 worst case
    max_tb = 3 * ((dec.width // 4 + 1) * (dec.height // 4 + 1))
    tbs = np.zeros((max_tb, TREC_W), np.int32)
    coef_cap = 4 * dec.width * dec.height
    coef = np.zeros(coef_cap, np.int16)
    c.blk = i32p(blks)
    c.blk_cap = max_blk
    c.tb = i32p(tbs)
    c.tb_cap = max_tb
    c.coef = i16p(coef)
    c.coef_cap = coef_cap

    if plan is not None:
        c.enable_plan = 1
        c.gh, c.gw = dec.height // 4, dec.width // 4
        ly_keys = ("op0", "y0_0", "x0_0", "vf0", "hf0", "fs0", "r0",
                   "op1", "y0_1", "x0_1", "vf1", "hf1", "fs1", "r1")
        for i, k in enumerate(ly_keys):
            c.ly[i] = i32p(plan.ly[k])
        ch_keys = ("op0", "y0_0", "x0_0", "vf0", "hf0",
                   "op1", "y0_1", "x0_1", "vf1", "hf1")
        for i, k in enumerate(ch_keys):
            c.ch[i] = i32p(plan.ch[k])
        c.avg = i32p(plan.avg)
        c.inter = i32p(plan.inter)
        c.dcoef_y = i16p(plan.coef["y"])
        c.dcoef_u = i16p(plan.coef["u"])
        c.dcoef_v = i16p(plan.coef["v"])
        c.dcy_stride = plan.coef["y"].shape[1]
        c.dcc_stride = plan.coef["u"].shape[1]
        c.qp4_y = i32p(plan.qp4["y"])
        c.ls4_y = i32p(plan.ls4["y"])
        c.qp4_c = i32p(plan.qp4["c"])
        c.ls4_c = i32p(plan.ls4["c"])
        c.q4y_stride = plan.qp4["y"].shape[1]
        c.q4c_stride = plan.qp4["c"].shape[1]
    else:
        c.enable_plan = 0

    c.zz4 = i32p(_ZZ[4])
    c.zz8 = i32p(_ZZ[8])
    c.zz16 = i32p(_ZZ[16])

    stats = np.zeros(ST_TOTAL, np.int64)
    c.stats = i64p(stats)

    c.data = s.data
    c.nbytes = len(s.data)
    c.bitpos = s.bitpos

    n = lib.parse_frame(ctypes.byref(c))
    if n < 0:
        return None  # capacity overflow: fall back to Python walk

    s.bitcnt += c.bitpos - s.bitpos
    s.bitpos = c.bitpos
    fi.qpb = c.qpb
    _merge_stats(dec.bc, stats)
    return blks[:c.n_blk], tbs[:c.n_tb], coef[:c.coef_len]


def _merge_stats(bc, st):
    """Add the C walk's bit accounting into the Decoder's BitCount."""
    o = 0
    for name in ("super_mode", "intra_mode", "mv", "skip_idx", "coeff_y",
                 "coeff_u", "coeff_v", "cbp"):
        arr = getattr(bc, name)
        for i in range(3):
            arr[i] += int(st[o + i])
        o += 3
    for i in range(3):
        for m in range(5):
            bc.mode[i][m] += int(st[24 + i * 5 + m])
            bc.size[i][m] += int(st[39 + i * 5 + m])
    for i in range(3):
        for sz in range(5):
            for m in range(5):
                bc.size_and_mode[i][sz][m] += int(
                    st[54 + (i * 5 + sz) * 5 + m])
    for i in range(3):
        for sz in range(5):
            for m in range(9):
                bc.super_mode_stat[i][sz][m] += int(
                    st[129 + (i * 5 + sz) * 9 + m])
    for i in range(3):
        for sz in range(5):
            for m in range(4):
                bc.size_and_ref_idx[i][sz][m] += int(
                    st[264 + (i * 5 + sz) * 4 + m])
    for i in range(3):
        for m in range(16):
            bc.bi_ref[i][m] += int(st[324 + i * 16 + m])


def block_params(rec):
    """Build the decoder's bp dict from a native leaf record."""
    mv0 = [(int(rec[B_MV0 + 2 * i]), int(rec[B_MV0 + 2 * i + 1]))
           for i in range(4)]
    mv1 = [(int(rec[B_MV1 + 2 * i]), int(rec[B_MV1 + 2 * i + 1]))
           for i in range(4)]
    return {"mode": int(rec[B_MODE]), "tb_split": int(rec[B_TBSPLIT]),
            "pb_part": int(rec[B_PBPART]),
            "intra_mode": int(rec[B_INTRA_MODE]),
            "skip_idx": int(rec[B_SKIP_IDX]),
            "ref_idx0": int(rec[B_REF0]), "ref_idx1": int(rec[B_REF1]),
            "dir": int(rec[B_DIR]), "mv_arr0": mv0, "mv_arr1": mv1,
            "cbp": (int(rec[B_CBP_Y]), int(rec[B_CBP_U]),
                    int(rec[B_CBP_V]))}


def block_coeffs(dec, rec, tb_rows, coef):
    """Reassemble the decoder's per-block coeffs dict from TB records.

    tb_rows: the TB record rows belonging to this block (coding order).
    Matches the shapes read_block produces: full (size,size) planes for
    tb_split=0, (4,s/2,s/2) stacks for split luma/large chroma, and
    full-size chroma when sizeC <= 4."""
    size = int(rec[B_SIZE])
    sub = dec.sub
    sizeC = 0 if dec.mono else size >> sub
    tb_split = int(rec[B_TBSPLIT])
    mode = int(rec[B_MODE])
    if mode == 0:  # SKIP
        return {"y": None, "u": None, "v": None}
    ypos, xpos = int(rec[B_YPOS]), int(rec[B_XPOS])
    yC, xC = ypos >> sub, xpos >> sub

    def unpack(row):
        s = int(row[T_SIZE])
        qs = min(s, 16)
        off = int(row[T_OFF])
        out = np.zeros((s, s), np.int16)
        out[:qs, :qs] = coef[off:off + qs * qs].reshape(qs, qs)
        return out

    coeffs = {"y": None, "u": None, "v": None}
    if not tb_split:
        coeffs["y"] = np.zeros((size, size), np.int16)
        if not dec.mono:
            coeffs["u"] = np.zeros((sizeC, sizeC), np.int16)
            coeffs["v"] = np.zeros((sizeC, sizeC), np.int16)
        for row in tb_rows:
            p = "yuv"[int(row[T_PLANE])]
            coeffs[p] = unpack(row)
        return coeffs
    s2 = size // 2
    coeffs["y"] = np.zeros((4, s2, s2), np.int16)
    if sizeC > 4:
        sc2 = sizeC // 2
        coeffs["u"] = np.zeros((4, sc2, sc2), np.int16)
        coeffs["v"] = np.zeros((4, sc2, sc2), np.int16)
        for row in tb_rows:
            pl = int(row[T_PLANE])
            if pl == 0:
                index = 2 * ((int(row[T_YPOS]) - ypos) // s2) + \
                    (int(row[T_XPOS]) - xpos) // s2
                coeffs["y"][index] = unpack(row)
            else:
                index = 2 * ((int(row[T_YPOS]) - yC) // sc2) + \
                    (int(row[T_XPOS]) - xC) // sc2
                coeffs["uv"[pl - 1]][index] = unpack(row)
        return coeffs
    if not dec.mono:
        coeffs["u"] = np.zeros((sizeC, sizeC), np.int16)
        coeffs["v"] = np.zeros((sizeC, sizeC), np.int16)
    for row in tb_rows:
        pl = int(row[T_PLANE])
        if pl == 0:
            index = 2 * ((int(row[T_YPOS]) - ypos) // s2) + \
                (int(row[T_XPOS]) - xpos) // s2
            coeffs["y"][index] = unpack(row)
        else:
            coeffs["uv"[pl - 1]] = unpack(row)
    return coeffs
