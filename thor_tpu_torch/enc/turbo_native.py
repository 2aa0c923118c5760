"""Native (C) host passes for the turbo encoder (copy of
thor_tpu/enc/turbo_native.py over the port's own C library).

Pairs with _native/blockemit.c: pass 1 (plan_frame_turbo) replaces the
Python quadtree walk + candidate/MVP derivation + plan fills of
enc/turbo_final.py:plan_frame, pass 2 (emit_frame_turbo) replaces the
Python syntax emission of emit_nodes.  Both passes update the encoder's
deblock-data arrays in place (the C side binds them by pointer), so the
filter tail and later frames see exactly the state the Python path
would produce.  Byte-exactness vs the Python emitter is enforced by
tests/test_torch_turbo.py.  The library is required: a failed build
raises (thor_tpu_torch/_native), and there is no switch that turns
these passes off (`turbo_final.NATIVE` is the tests' oracle switch).
"""
from __future__ import annotations

import ctypes

import numpy as np

from ..tables import CHROMA_QP

EREC_W = 40
(E_MVPY, E_MVPX, E_NSKIP, E_ISEG, E_ILANE, E_KIND) = range(32, 38)
B_YPOS, B_XPOS, B_SIZE, B_MODE = 0, 1, 2, 3
B_INTRA_MODE = 6

class _NativeTurbo:
    """Holds the ParseCtx + keepalive buffers across the two passes."""

    def __init__(self, ctx, keep, recs):
        self.ctx = ctx
        self.keep = keep
        self.recs = recs


def plan_frame(enc, dec, plan):
    """C pass 1.  Fills `plan` (FramePlan) + enc.dd, returns
    (_NativeTurbo, recs_view, intra_list), or None where the C walk
    cannot hold the frame (its record buffer)."""
    from .._native import get_lib, ParseCtx, TurboPlan, i32p, i16p, i64p
    from ..dec.native_parse import _ZZ, ST_TOTAL
    lib = get_lib()
    p = enc.params
    fi = enc.fi
    dd = enc.dd

    c = ParseCtx()
    c.width, c.height = p.width, p.height
    c.sb_size = 1 << p.log2_sb_size
    c.pb_split = int(p.enable_pb_split)
    c.tb_split_enable = int(p.enable_tb_split)
    c.max_delta_qp = p.max_delta_qp
    c.use_block_contexts = p.use_block_contexts
    c.bipred = p.enable_bipred
    c.seq_interp_ref = p.interp_ref
    c.num_reorder_pics = p.num_reorder_pics
    c.sub = enc.sub
    c.mono = int(enc.mono)
    c.frame_type = fi.frame_type
    c.stat_frame_type = fi.frame_type
    c.num_ref = fi.num_ref
    c.interp_ref = fi.interp_ref
    c.num_intra_modes = fi.num_intra_modes
    c.qp = fi.qp
    c.qpb = fi.qp
    c.phase = getattr(fi, "phase", 0)
    c.rec_frame_num = enc.rec.frame_num
    for r in range(fi.num_ref):
        c.ref_frame_num[r] = enc._ref_frame(fi.ref_array[r]).frame_num
        c.ref_slot[r] = r

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

    max_blk = 4 * ((p.width // 8 + 2) * (p.height // 8 + 2))
    recs = np.zeros((max_blk, EREC_W), np.int32)
    c.blk = i32p(recs)
    c.blk_cap = max_blk

    c.enable_plan = 1
    c.gh, c.gw = p.height // 4, p.width // 4
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
    c.qp4_y = i32p(plan.qp4["y"])
    c.ls4_y = i32p(plan.ls4["y"])
    c.qp4_c = i32p(plan.qp4["c"])
    c.ls4_c = i32p(plan.ls4["c"])
    c.q4y_stride = plan.qp4["y"].shape[1]
    c.q4c_stride = plan.qp4["c"].shape[1]

    c.zz4 = i32p(_ZZ[4])
    c.zz8 = i32p(_ZZ[8])
    c.zz16 = i32p(_ZZ[16])
    stats = np.zeros(ST_TOTAL, np.int64)
    c.stats = i64p(stats)
    c.data = b""
    c.nbytes = 0
    c.bitpos = 0
    c.error = 0

    qp = fi.qp
    t = TurboPlan()
    keep = [recs, stats]
    is_b = bool(dec["is_b"])
    tb_on = bool(dec.get("tb_on", False))
    for i, s in enumerate((8, 16, 32, 64, 128)):
        ch = np.ascontiguousarray(dec["choice"][s], np.int32)
        m = dec["meta"][s]
        mvs = np.ascontiguousarray(m[0], np.int32)
        mvc = np.ascontiguousarray(m[1], np.int32)
        imode = np.ascontiguousarray(m[2], np.int32)
        mvb = (np.ascontiguousarray(m[3], np.int32) if is_b else mvc)
        keep += [ch, mvs, mvc, imode, mvb]
        t.choice[i] = i32p(ch)
        t.mv_skip[i] = i32p(mvs)
        t.mv_int[i] = i32p(mvc)
        t.mv_int1[i] = i32p(mvb)
        t.imode[i] = i32p(imode)
        t.gw[i] = dec["W"] // s
        if tb_on:
            tbg = np.ascontiguousarray(m[-1], np.int32)
            keep.append(tbg)
            t.tb[i] = i32p(tbg)
    t.is_b = int(is_b)
    t.r0i = 1 if (is_b and fi.interp_ref) else 0
    t.r1i = 2 if (is_b and fi.interp_ref) else 1
    t.qp = qp
    t.qpc = int(CHROMA_QP[qp])

    n = lib.plan_frame_turbo(ctypes.byref(c), ctypes.byref(t))
    if n < 0:
        return None
    rv = recs[:n]
    leaves = rv[rv[:, E_KIND] == 1]
    intra = leaves[leaves[:, B_MODE] == 1]
    intra_list = [(int(r[B_YPOS]), int(r[B_XPOS]), int(r[B_SIZE]),
                   int(r[B_INTRA_MODE])) for r in intra]
    return _NativeTurbo(c, keep, rv), rv, intra_list


def emit_frame(enc, nt, coefq, icq, icb, ipos):
    """C pass 2: write the whole frame's block syntax into enc.writer.

    coefq: dict plane -> dense quantized-coeff plane (int16); icq
    [3,S,L,16,16] int16 intra coeff stacks; icb [S,L,3] intra cbp; ipos
    maps (ypos,xpos) -> (si,li) for intra leaves."""
    from .._native import get_lib, TurboEmit, BwStruct, i32p, i16p
    lib = get_lib()
    c = nt.ctx
    recs = nt.recs

    # fill intra segment/lane indices resolved after the wave build
    for r in recs:
        if r[E_KIND] == 1 and r[B_MODE] == 1:
            si, li = ipos[(int(r[B_YPOS]), int(r[B_XPOS]))]
            r[E_ISEG] = si
            r[E_ILANE] = li

    cy = np.ascontiguousarray(coefq["y"], np.int16)
    cu = np.ascontiguousarray(coefq["u"], np.int16)
    cv = np.ascontiguousarray(coefq["v"], np.int16)
    icq = np.ascontiguousarray(icq, np.int16)
    icb = np.ascontiguousarray(icb, np.int32)
    c.dcoef_y = i16p(cy)
    c.dcoef_u = i16p(cu)
    c.dcoef_v = i16p(cv)
    c.dcy_stride = cy.shape[1]
    c.dcc_stride = cu.shape[1]

    t = TurboEmit()
    t.icq = i16p(icq)
    t.icb = i32p(icb)
    t.S = icq.shape[1]
    t.L = icq.shape[2]

    w = enc.writer
    cap = max(1 << 20, c.width * c.height * 3)
    buf = (ctypes.c_uint8 * cap)()
    bw = BwStruct(ctypes.cast(buf, ctypes.c_void_p), cap, 0,
                  w.bitbuf, w.bitrest)
    rc = lib.emit_frame_turbo(ctypes.byref(c), ctypes.byref(bw),
                              ctypes.byref(t))
    if rc < 0:
        raise RuntimeError("native turbo emit overflow")
    nb = bw.bytepos
    if nb:
        end = w.bytepos + nb
        if len(w.buf) < end:
            w.buf.extend(b"\0" * (end - len(w.buf)))
        w.buf[w.bytepos:end] = bytes(buf[:nb])
        w.bytepos = end
    w.bitbuf = bw.bitbuf
    w.bitrest = bw.bitrest
