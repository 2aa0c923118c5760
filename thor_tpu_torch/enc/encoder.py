"""Thor encoder of the port (torch port of thor_tpu/enc/encoder.py):
bit-exact with the reference Thorenc.

Mirrors enc/mainenc.c (sequence loop, GOP, refs), enc/encode_frame.c
(frame drive, in-loop filter RDO) and enc/encode_block.c (quadtree RDO,
ME, early skip).  Three encoders share the frame loop, chosen per frame
as thor_tpu chooses:
- the exact host-RDO encoder (the default, `turbo=0`): thor_tpu's SB
  loop body for body, in numpy on the host.  Like the reference it uses
  the real bitstream as scratchpad (trial encodes write bits; losers are
  rewound), which pins bit costs and tie-breaks to the reference's
  decisions; with `max_delta_qp` it searches the SB's QP, with `bitrate`
  it runs rate control (rc.py);
- the turbo encoder (`turbo=1`, enc/turbo.py, enc/turbo_final.py) on
  the encoder's torch device, for every frame that
  `turbo.turbo_reject_reason` accepts; the others take the host RDO,
  and turbo says so once on stderr (`turbo.turbo_supported`);
- the wavefront device encoder (`device_enc=1`, enc/device_lc.py) on the
  encoder's torch device, for every frame that `device_lc.lc_supported`
  accepts, before turbo is asked (`turbo=1, device_enc=1` codes those
  frames with device_lc); the others take turbo or the host RDO.
Every way the frame tail (deblock, CDEF search and application, CLPF
RDO) runs its pixel passes on the encoder's device.

`encode_sequence` takes thor_tpu's `schedule_only` and `encoder_hook`
(the GOP lanes, enc/gop_lanes.py, run on them).  Not ported:
turbo's host emit (THOR_TURBO_FINAL=0) and the THOR_TURBO,
THOR_DEVICE_ENC and THOR_ENC_PROF environment switches (the port takes
keywords).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import trace as TR
from ..bitstream import BitWriter
from ..frame import YuvFrame, new_ref_frame
from ..tables import (CHROMA_QP, MAX_REF_FRAMES, MAX_REORDER_BUFFER,
                      MIN_PB_SIZE, EARLY_SKIP_BLOCK_SIZE, GQUANT, log2i,
                      qp_to_qlevel)
from ..spec import inter, intra, filters
from ..spec.transform_quant import (transform_fwd, transform_inv, dequantize,
                                    quantize, reconstruct_block)
from ..spec.cfl import improve_uv_prediction
from ..spec.tempinterp import store_mv
from ..ops import filters as OF
from ..dec.decoder import find_block_contexts, resolve_device
from . import me as ME
from . import writer as W
from . import filters_rdo as FR
from . import device_lc
from . import turbo
from .params import EncParams
from .rc import RateControl

I_FRAME, P_FRAME, B_FRAME = 0, 1, 2
MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED, MODE_MERGE = 0, 1, 2, 3, 4
MAX_UINT32 = 1 << 31

SQUARED_LAMBDA_QP = [
    0.0382, 0.0485, 0.0615, 0.0781, 0.0990, 0.1257, 0.1595, 0.2023, 0.2567,
    0.3257, 0.4132, 0.5243, 0.6652, 0.8440, 1.0709, 1.3588, 1.7240, 2.1874,
    2.7754, 3.5214, 4.4679, 5.6688, 7.1926, 9.1259, 11.5789, 14.6912,
    18.6402, 23.6505, 30.0076, 38.0735, 48.3075, 61.2922, 77.7672, 98.6706,
    125.1926, 158.8437, 201.5399, 255.7126, 324.4467, 411.6560, 522.3067,
    662.6996, 840.8294, 1066.8393, 1353.5994, 1717.4389, 2179.0763,
    2764.7991, 3507.9607, 4450.8797, 5647.2498, 7165.1970]

# coding order <-> display order (enc/mainenc.c:50-64)
CD = {1: [0], 2: [1, 0], 4: [3, 1, 0, 2], 8: [7, 3, 1, 5, 0, 2, 4, 6],
      16: [15, 7, 3, 11, 1, 5, 9, 13, 0, 2, 4, 6, 8, 10, 12, 14]}
DC = {1: [-1, 0], 2: [-2, 1, 0], 4: [-4, 2, 1, 3, 0],
      8: [-8, 4, 2, 5, 1, 6, 3, 7, 0],
      16: [-16, 8, 4, 9, 2, 10, 5, 11, 1, 12, 6, 13, 3, 14, 7, 15, 0]}

@dataclass
class FrameInfoEnc:
    frame_num: int = 0
    frame_type: int = I_FRAME
    qp: int = 32
    prev_qp: int = 32
    num_ref: int = 0
    ref_array: list = field(default_factory=list)
    num_intra_modes: int = 4
    b_level: int = 0
    phase: int = 0
    interp_ref: int = 0
    lambda_: float = 0.0
    lambda_coeff: float = 1.0
    best_ref: int = -1
    mvcand: list = field(default_factory=list)    # per ref: list of (y,x)
    mvcand_mask: list = field(default_factory=list)


class BlockInfo:
    __slots__ = ("size", "ypos", "xpos", "bwidth", "bheight", "sub", "qp",
                 "delta_qp", "lambda_", "max_num_tb_part", "max_num_pb_part",
                 "org_y", "org_u", "org_v", "rec", "rec_best",
                 "skip_candidates", "merge_candidates", "num_skip_vec",
                 "num_merge_vec", "mvp", "ctx_split", "ctx_cbp", "ctx_index",
                 "final_encode", "best")


def frame_lambda_coeff(p: EncParams, fi):
    """Per-frame lambda multiplier (enc/encode_frame.c:660-676)."""
    if fi.frame_type == I_FRAME:
        return p.lambda_coeffI
    if fi.frame_type == P_FRAME:
        return p.lambda_coeffP
    return ([p.lambda_coeffB0, p.lambda_coeffB1, p.lambda_coeffB2,
             p.lambda_coeffB3][fi.b_level] if fi.b_level <= 3
            else p.lambda_coeffB)


def frame_qp(p: EncParams, fi, num_encoded_frames, sub_gop):
    """QP ladder (enc/mainenc.c:281-314); float multipliers are C floats."""
    if fi.frame_type == I_FRAME:
        qp = p.qp + p.dqpI
    elif p.num_reorder_pics == 0:
        if num_encoded_frames % p.HQperiod:
            qp = int(np.float32(p.mqpP) * np.float32(p.qp)) + p.dqpP
        else:
            qp = p.qp
    else:
        if fi.frame_num % sub_gop:
            if p.dyadic_coding:
                b = fi.b_level
                mqp = [p.mqpB0, p.mqpB1, p.mqpB2, p.mqpB3]
                dqp = [p.dqpB0, p.dqpB1, p.dqpB2, p.dqpB3]
                if b <= 3:
                    qp = int(np.float32(mqp[b]) * np.float32(p.qp)) + dqp[b]
                else:
                    qp = int(np.float32(p.mqpB) * np.float32(p.qp)) + p.dqpB
            else:
                qp = int(np.float32(p.mqpB) * np.float32(p.qp)) + p.dqpB
        else:
            if fi.frame_num % p.HQperiod:
                qp = int(np.float32(p.mqpP) * np.float32(p.qp)) + p.dqpP
            else:
                qp = p.qp
    return min(51, max(0, qp))


def _stage_dev_ref(y, u, v, pad: int, pad_c: int):
    """Edge-pad a final recon (device planes) into reference geometry."""
    i16 = torch.int16
    return (OF.edge_pad(y.to(i16), pad), OF.edge_pad(u.to(i16), pad_c),
            OF.edge_pad(v.to(i16), pad_c))


class Encoder:
    def __init__(self, params: EncParams, device, megakernel=True):
        self.params = params.validate()
        p = self.params
        self.device = torch.device(device)
        self.width, self.height = p.width, p.height
        self.w = p.width // MIN_PB_SIZE
        self.sub = 1 if p.subsample == 420 else 0
        self.mono = p.subsample == 400
        self.rec_buf = [YuvFrame(p.width, p.height, p.subsample, 0,
                                 p.bitdepth, p.input_bitdepth)
                        for _ in range(MAX_REORDER_BUFFER + 1)]
        self.ref = [new_ref_frame(p.width, p.height, p.subsample, p.bitdepth,
                                  p.input_bitdepth)
                    for _ in range(MAX_REF_FRAMES)]
        self.interp_frames = ([new_ref_frame(p.width, p.height, p.subsample,
                                             p.bitdepth, p.input_bitdepth)]
                              if p.interp_ref else [])
        self.orig = YuvFrame(p.width, p.height, p.subsample, 0, p.bitdepth,
                             p.input_bitdepth)
        self.dd = inter.DeblockData(p.width, p.height)
        self.fi = FrameInfoEnc()
        self.writer = BitWriter()
        self.rec: YuvFrame | None = None
        self.turbo = p.turbo == 1
        # the wavefront device encoder (enc/device_lc.py) for the frames
        # device_lc.lc_supported accepts; the others take the host RDO
        self.device_sb_loop = p.device_enc == 1
        # its route: device_lc.frame_megakernel, or the host loop over
        # device_lc.run_diagonal with megakernel=False
        self.megakernel = megakernel
        # set while turbo codes the frame: the CDEF anti-shrink guard of
        # filters_rdo._cdef_pick_and_emit applies to turbo frames only
        # (turbo streams must always decode; see the comment there)
        self._turbo_frame = False
        self.cdef_damping = 5
        self.cdef_bits = 0
        self.cdef_strengths = [127] * 8
        self.cdef_uv_strengths = [127] * 8
        self.cdef_header_pos = None
        self.cdef_sel = {}
        self.cdef_dirs = {}
        # persistent MV candidate arrays (the C frame_info.mvcand arrays
        # keep stale entries across SBs/frames; sync/bi ME read fixed slots)
        self.mvcand = [[(0, 0)] * 64 for _ in range(4)]
        self.rc = None
        if p.bitrate > 0:
            sb = 1 << p.log2_sb_size
            num_sb = (((p.width + sb - 1) // sb) *
                      ((p.height + sb - 1) // sb))
            self.rc = RateControl(int(p.bitrate / p.frame_rate), num_sb)
        self.wmatrix = self.iwmatrix = None
        if p.qmtx:
            from ..qmtx import get_wmatrices, get_iwmatrices
            self.wmatrix = get_wmatrices()
            self.iwmatrix = get_iwmatrices()
        # device-resident reference ring: frame_num -> padded int16
        # (y, u, v) device planes
        self._dev_refs = OrderedDict()

    # ---------- low-level helpers ----------

    def _wm(self, ql, plane, intra_f, size):
        if not self.params.qmtx:
            return None
        return self.wmatrix[ql][plane][intra_f][log2i(size // 4)]

    def _iwm(self, ql, plane, intra_f, size):
        if not self.params.qmtx:
            return None
        return self.iwmatrix[ql][plane][intra_f][log2i(size // 4)]

    def _transform_fast_flag(self, size, tb_split):
        p = self.params
        if tb_split:
            return size == 64 or p.encoder_speed > 1
        return (size == 64 and p.encoder_speed > 0) or p.encoder_speed > 1

    def _enc_recon_inter(self, org, size, qp, pred, ctype, tb_split, ql,
                         plane):
        """encode_and_reconstruct_block_inter (enc/encode_block.c:1275).
        Returns (cbp, coeffq-or-list, rec_block)."""
        p = self.params
        bd = p.bitdepth
        res = org.astype(np.int16) - pred.astype(np.int16)
        if tb_split:
            s2 = size // 2
            cbp = 0
            coeffs = []
            rblock = np.zeros((size, size), np.int16)
            for index in range(4):
                i, j = (index >> 1) * s2, (index & 1) * s2
                blk = res[i:i + s2, j:j + s2]
                co = transform_fwd(blk, s2, size == 64 or p.encoder_speed > 1,
                                   bd)
                cq, cbpbit = quantize(co, qp, s2, ctype,
                                      self._wm(ql, plane, 0, s2))
                coeffs.append(cq)
                if cbpbit:
                    rco = dequantize(cq, qp, s2, self._iwm(ql, plane, 0, s2))
                    rb = transform_inv(rco, s2, bd)
                else:
                    rb = np.zeros((s2, s2), np.int16)
                rblock[i:i + s2, j:j + s2] = rb
                cbp = (cbp << 1) + cbpbit
            rec = reconstruct_block(rblock, pred, bd)
            return cbp, coeffs, rec
        co = transform_fwd(res, size,
                           (size == 64 and p.encoder_speed > 0) or
                           p.encoder_speed > 1, bd)
        cq, cbp = quantize(co, qp, size, ctype, self._wm(ql, plane, 0, size))
        if cbp:
            rco = dequantize(cq, qp, size, self._iwm(ql, plane, 0, size))
            rb = transform_inv(rco, size, bd)
            rec = reconstruct_block(rb, pred, bd)
        else:
            rec = pred.astype(np.int32).copy()
        return cbp, cq, rec

    def _enc_recon_intra(self, org, plane_arr, rec_block, ypos, xpos, size,
                         qp, ctype, tb_split, im, ur, dl, ql, plane):
        """encode_and_reconstruct_block_intra (enc/encode_block.c:1100).
        plane_arr: frame rec plane; rec_block (size,size) int32 written.
        Returns (cbp, coeffs, pred_full)."""
        p = self.params
        bd = p.bitdepth
        pred_full = np.zeros((size, size), np.int32)
        if tb_split:
            s2 = size // 2
            cbp = 0
            coeffs = []
            for index in range(4):
                i, j = (index >> 1) * s2, (index & 1) * s2
                left, top, tl = intra.make_top_and_left(
                    plane_arr, ypos, xpos, i, j, s2, ur, dl, 1, bd,
                    rb=rec_block, rb_y=i, rb_x=j)
                pr = intra.get_intra_prediction(left, top, tl, ypos + i,
                                                xpos + j, s2, im, bd)
                pred_full[i:i + s2, j:j + s2] = pr
                res = (org[i:i + s2, j:j + s2].astype(np.int16) -
                       pr.astype(np.int16))
                co = transform_fwd(res, s2, p.encoder_speed > 1, bd)
                cq, cbpbit = quantize(co, qp, s2, ctype,
                                      self._wm(ql, plane, 1, s2))
                coeffs.append(cq)
                if cbpbit:
                    rco = dequantize(cq, qp, s2, self._iwm(ql, plane, 1, s2))
                    rb = transform_inv(rco, s2, bd)
                else:
                    rb = np.zeros((s2, s2), np.int16)
                cbp = (cbp << 1) + cbpbit
                rec_block[i:i + s2, j:j + s2] = reconstruct_block(rb, pr, bd)
            return cbp, coeffs, pred_full
        left, top, tl = intra.make_top_and_left(plane_arr, ypos, xpos, 0, 0,
                                                size, ur, dl, 0, bd)
        pr = intra.get_intra_prediction(left, top, tl, ypos, xpos, size, im,
                                        bd)
        pred_full[:, :] = pr
        res = org.astype(np.int16) - pr.astype(np.int16)
        co = transform_fwd(res, size, p.encoder_speed > 1, bd)
        cq, cbp = quantize(co, qp, size, ctype, self._wm(ql, plane, 1, size))
        if cbp:
            rco = dequantize(cq, qp, size, self._iwm(ql, plane, 1, size))
            rb = transform_inv(rco, size, bd)
            rec_block[:, :] = reconstruct_block(rb, pr, bd)
        else:
            rec_block[:, :] = pr
        return cbp, cq, pred_full

    def _ref_frame(self, r):
        return self.ref[r] if r >= 0 else self.interp_frames[0]

    # --- device-resident reference ring ------------------------------------
    # The decide and finalize passes read reference PIXELS on the device
    # every frame.  After each frame's filter chain completes, the final
    # recon is uploaded ONCE (visible area) and edge-padded on the device;
    # decide/finalize stage refs from this ring and upload from the host
    # only on a miss (the interpolated frame).  Values equal ref.y_full by
    # construction (same edge-replicate rule as YuvFrame.pad_frame).
    DEV_REF_CAP = 12

    def _note_dev_ref(self, frame_num):
        rec = self.rec
        ref0 = self.ref[0]

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a).astype(
                np.int16)).to(self.device)

        self._dev_refs[frame_num] = _stage_dev_ref(
            up(rec.y), up(rec.u), up(rec.v), pad=ref0.pad, pad_c=ref0.pad_c)
        while len(self._dev_refs) > self.DEV_REF_CAP:
            self._dev_refs.popitem(last=False)

    def _dev_ref_planes(self, ref):
        """Resident (y,u,v) padded int16 device planes for `ref`, or
        None when the frame is not in the ring."""
        return self._dev_refs.get(ref.frame_num)

    def _inter_pred_block(self, bp, bi: BlockInfo):
        """Prediction for non-intra modes (enc/encode_block.c:1433-1460)."""
        p = self.params
        fi = self.fi
        mode = bp["mode"]
        split = p.enable_pb_split if mode in (MODE_INTER, MODE_BIPRED) else 0
        size = bi.size
        if bp["dir"] == 2 or mode == MODE_BIPRED:
            ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
            ref1 = self._ref_frame(fi.ref_array[bp["ref_idx1"]])
            if (fi.frame_type == B_FRAME and p.interp_ref == 2 and
                    mode == MODE_SKIP and bp["skip_idx"] == 0):
                return self._inter_pred_temp(bi)
            sign0 = int(ref0.frame_num > self.rec.frame_num)
            p0 = inter.get_inter_prediction_yuv(
                ref0, bp["mv_arr0"], bi.ypos, bi.xpos, size, bi.bwidth,
                bi.bheight, sign0, self.width, self.height, p.enable_bipred,
                split, p.bitdepth)
            sign1 = int(ref1.frame_num > self.rec.frame_num)
            p1 = inter.get_inter_prediction_yuv(
                ref1, bp["mv_arr1"], bi.ypos, bi.xpos, size, bi.bwidth,
                bi.bheight, sign1, self.width, self.height, p.enable_bipred,
                split, p.bitdepth)
            return tuple(inter.average_blocks(a, b) for a, b in zip(p0, p1))
        ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
        sign = int(ref0.frame_num > self.rec.frame_num)
        return inter.get_inter_prediction_yuv(
            ref0, bp["mv_arr0"], bi.ypos, bi.xpos, size, bi.bwidth,
            bi.bheight, sign, self.width, self.height, p.enable_bipred,
            split, p.bitdepth)

    def _inter_pred_temp(self, bi):
        """get_inter_prediction_temp for the encoder (same math as the
        decoder's; inter_prediction.c:352-411)."""
        p = self.params
        fi = self.fi
        gop = p.num_reorder_pics + 1
        phase = fi.phase
        ref0 = self._ref_frame(fi.ref_array[0])
        ref1 = self._ref_frame(fi.ref_array[1])
        sub = self.sub
        size = bi.size
        py = np.zeros((size, size), np.int32)
        pu = np.zeros((size >> sub, size >> sub), np.int32)
        pv = np.zeros((size >> sub, size >> sub), np.int32)
        for m in range(0, bi.bheight, MIN_PB_SIZE):
            for n in range(0, bi.bwidth, MIN_PB_SIZE):
                k = (((bi.ypos + m) // MIN_PB_SIZE) * self.dd.bs +
                     (bi.xpos + n) // MIN_PB_SIZE)
                mv = (int(self.dd.arr_mv0[k, phase, 0]),
                      int(self.dd.arr_mv0[k, phase, 1]))
                p0 = inter.get_inter_prediction_yuv(
                    ref0, [mv] * 4, bi.ypos + m, bi.xpos + n, MIN_PB_SIZE,
                    MIN_PB_SIZE, MIN_PB_SIZE, 0, self.width, self.height,
                    2, 0, p.bitdepth)
                mv1 = mv
                if gop == 3 and phase == 1:
                    mv1 = (2 * mv[0], 2 * mv[1])
                p1 = inter.get_inter_prediction_yuv(
                    ref1, [mv1] * 4, bi.ypos + m, bi.xpos + n, MIN_PB_SIZE,
                    MIN_PB_SIZE, MIN_PB_SIZE, 1, self.width, self.height,
                    2, 0, p.bitdepth)
                avg = tuple(inter.average_blocks(a, b)
                            for a, b in zip(p0, p1))
                py[m:m + 4, n:n + 4] = avg[0]
                if not self.mono:
                    pu[m >> sub:(m >> sub) + (4 >> sub),
                       n >> sub:(n >> sub) + (4 >> sub)] = avg[1]
                    pv[m >> sub:(m >> sub) + (4 >> sub),
                       n >> sub:(n >> sub) + (4 >> sub)] = avg[2]
        return py, pu, pv

    def _get_mv_skip_temp(self, bi, cands):
        """inter_prediction.c:836-881 for the encoder."""
        gop = self.params.num_reorder_pics + 1
        phase = self.fi.phase
        dd = self.dd
        c0 = cands[0]
        duplicate = True
        for m in range(bi.bheight // MIN_PB_SIZE):
            for n in range(bi.bwidth // MIN_PB_SIZE):
                k = ((bi.ypos // MIN_PB_SIZE + m) * dd.bs +
                     bi.xpos // MIN_PB_SIZE + n)
                mv0 = (int(dd.arr_mv0[k, phase, 0]),
                       int(dd.arr_mv0[k, phase, 1]))
                mv1 = mv0
                if gop == 3 and phase == 1:
                    mv1 = (mv1[0] * 2, mv1[1] * 2)
                if (mv0[0] != c0[0] or mv0[1] != c0[1] or
                        mv1[0] != c0[2] or mv1[1] != c0[3] or
                        c0[4] != 0 or c0[5] != 1 or c0[6] != 2):
                    duplicate = False
        new0 = (c0[0], c0[1], c0[2], c0[3], 0, 1, 2)
        if not duplicate:
            return [new0, c0]
        return [new0]

    # ---------- encode_block ----------

    def encode_block(self, bi: BlockInfo, bp):
        """enc/encode_block.c:1340-1514. Returns nbits; fills bp[cbp/coeff]
        and bi.rec (trial recon)."""
        p = self.params
        fi = self.fi
        size = bi.size
        sub = bi.sub
        sizeC = size >> sub
        qpY = bi.qp
        qpC = int(CHROMA_QP[qpY]) if sub else qpY
        mode = bp["mode"]

        re_use = (bi.final_encode & 1) and not p.enable_tb_split
        if re_use:
            bi.rec = bi.rec_best
            return W.write_block(self.writer, self, bi, bp)

        tb_split = max(0, bp.get("tb_param", 0))
        zero_block = 1 if bp.get("tb_param", 0) == -1 else 0
        bp["tb_split"] = tb_split

        rec_y = np.zeros((size, size), np.int32)
        rec_u = np.zeros((sizeC, sizeC), np.int32)
        rec_v = np.zeros((sizeC, sizeC), np.int32)
        ql = qp_to_qlevel(qpY, p.qmtx_offset) if p.qmtx else 0

        if mode == MODE_INTRA:
            im = bp["intra_mode"]
            sb = 1 << p.log2_sb_size
            ur = inter.get_upright_available(bi.ypos, bi.xpos, size, size,
                                             self.width, self.height, sb)
            dl = inter.get_downleft_available(bi.ypos, bi.xpos, size, size,
                                              self.width, self.height, sb)
            ctype = ((fi.frame_type == I_FRAME) << 1) | 0
            cbp_y, coeff_y, pred_y = self._enc_recon_intra(
                bi.org_y, self.rec.y, rec_y, bi.ypos, bi.xpos, size, qpY,
                ctype, tb_split, im, ur, dl, ql, 0)
            if not self.mono:
                cbp_u, cbp_v, coeff_u, coeff_v = self._enc_recon_intra_uv(
                    bi, rec_u, rec_v, sizeC, qpC,
                    ((fi.frame_type == I_FRAME) << 1) | 1,
                    tb_split and sizeC > 4, im, ur, dl, ql,
                    pred_y if p.cfl_intra else None, rec_y)
            else:
                cbp_u = cbp_v = 0
                coeff_u = coeff_v = None
        else:
            pred_y, pred_u, pred_v = self._inter_pred_block(bp, bi)
            if mode == MODE_SKIP or zero_block:
                rec_y = pred_y.astype(np.int32)
                rec_u = pred_u.astype(np.int32)
                rec_v = pred_v.astype(np.int32)
                cbp_y = cbp_u = cbp_v = 0
                coeff_y = coeff_u = coeff_v = None
            else:
                ctype = ((fi.frame_type == I_FRAME) << 1) | 0
                cbp_y, coeff_y, rec_y = self._enc_recon_inter(
                    bi.org_y, size, qpY, pred_y, ctype, tb_split, ql, 0)
                if p.cfl_inter and not self.mono:
                    improve_uv_prediction(pred_y, pred_u, pred_v, rec_y,
                                          size, sub, p.bitdepth)
                if not self.mono:
                    ctype_c = ((fi.frame_type == I_FRAME) << 1) | 1
                    cbp_u, coeff_u, rec_u = self._enc_recon_inter(
                        bi.org_u, sizeC, qpC, pred_u, ctype_c,
                        tb_split and sizeC > 4, ql, 1)
                    cbp_v, coeff_v, rec_v = self._enc_recon_inter(
                        bi.org_v, sizeC, qpC, pred_v, ctype_c,
                        tb_split and sizeC > 4, ql, 2)
                else:
                    cbp_u = cbp_v = 0
                    coeff_u = coeff_v = None

        bp["cbp"] = (cbp_y, cbp_u, cbp_v)
        if tb_split:
            bp["coeff_y4"] = coeff_y if isinstance(coeff_y, list) else None
            if isinstance(coeff_u, list):
                bp["coeff_u4"] = coeff_u
                bp["coeff_v4"] = coeff_v
            else:
                bp["coeff_u"] = coeff_u
                bp["coeff_v"] = coeff_v
        else:
            bp["coeff_y"] = coeff_y
            bp["coeff_u"] = coeff_u
            bp["coeff_v"] = coeff_v
        bi.rec = (rec_y, rec_u, rec_v)
        nbits = W.write_block(self.writer, self, bi, bp)
        if tb_split:
            bp["cbp"] = (1, 1, 1)  # for deblock data only
        return nbits

    def _enc_recon_intra_uv(self, bi, rec_u, rec_v, sizeC, qpC, ctype,
                            tb_split, im, ur, dl, ql, pred_y, rec_y):
        """encode_and_reconstruct_block_intra_uv (enc/encode_block.c:1170)."""
        p = self.params
        bd = p.bitdepth
        sub = bi.sub
        yC, xC = bi.ypos >> sub, bi.xpos >> sub
        if tb_split:
            s2 = sizeC // 2
            cbp_u = cbp_v = 0
            cu_l, cv_l = [], []
            for index in range(4):
                i, j = (index >> 1) * s2, (index & 1) * s2
                lu, tu, tlu = intra.make_top_and_left(
                    self.rec.u, yC, xC, i, j, s2, ur, dl, 1, bd,
                    rb=rec_u, rb_y=i, rb_x=j)
                pu = intra.get_intra_prediction(lu, tu, tlu, yC + i, xC + j,
                                                s2, im, bd)
                lv, tv, tlv = intra.make_top_and_left(
                    self.rec.v, yC, xC, i, j, s2, ur, dl, 1, bd,
                    rb=rec_v, rb_y=i, rb_x=j)
                pv = intra.get_intra_prediction(lv, tv, tlv, yC + i, xC + j,
                                                s2, im, bd)
                if pred_y is not None:
                    n2 = s2 << sub
                    flat = pred_y.reshape(-1)
                    start = i * sizeC + j
                    ys_sk = flat[start:start + n2 * n2].reshape(n2, n2)
                    ry = rec_y.reshape(-1)[
                        (i << sub) * (sizeC << sub) + (j << sub):]
                    # C: &rec_y[(i<<sub)*rec_stride2+(j<<sub)] with
                    # rec_stride2 = sizeY; build the strided window
                    sizeY = sizeC << sub
                    base = (i << sub) * sizeY + (j << sub)
                    idxr = (base + np.arange(n2)[:, None] * sizeY +
                            np.arange(n2)[None, :])
                    ryw = rec_y.reshape(-1)[idxr]
                    improve_uv_prediction(ys_sk, pu, pv,
                                          ryw.astype(np.int32), n2, sub, bd)
                res = (bi.org_u[i:i + s2, j:j + s2].astype(np.int16) -
                       pu.astype(np.int16))
                co = transform_fwd(res, s2, p.encoder_speed > 1, bd)
                cq, cbpbit = quantize(co, qpC, s2, ctype,
                                      self._wm(ql, 1, 1, s2))
                cu_l.append(cq)
                if cbpbit:
                    rco = dequantize(cq, qpC, s2, self._iwm(ql, 1, 1, s2))
                    rb = transform_inv(rco, s2, bd)
                else:
                    rb = np.zeros((s2, s2), np.int16)
                cbp_u = (cbp_u << 1) + cbpbit
                rec_u[i:i + s2, j:j + s2] = reconstruct_block(rb, pu, bd)

                res = (bi.org_v[i:i + s2, j:j + s2].astype(np.int16) -
                       pv.astype(np.int16))
                co = transform_fwd(res, s2, p.encoder_speed > 1, bd)
                cq, cbpbit = quantize(co, qpC, s2, ctype,
                                      self._wm(ql, 1, 1, s2))
                cv_l.append(cq)
                if cbpbit:
                    rco = dequantize(cq, qpC, s2, self._iwm(ql, 1, 1, s2))
                    rb = transform_inv(rco, s2, bd)
                else:
                    rb = np.zeros((s2, s2), np.int16)
                cbp_v = (cbp_v << 1) + cbpbit
                rec_v[i:i + s2, j:j + s2] = reconstruct_block(rb, pv, bd)
            return cbp_u, cbp_v, cu_l, cv_l
        lu, tu, tlu = intra.make_top_and_left(self.rec.u, yC, xC, 0, 0,
                                              sizeC, ur, dl, 0, bd)
        pu = intra.get_intra_prediction(lu, tu, tlu, yC, xC, sizeC, im, bd)
        lv, tv, tlv = intra.make_top_and_left(self.rec.v, yC, xC, 0, 0,
                                              sizeC, ur, dl, 0, bd)
        pv = intra.get_intra_prediction(lv, tv, tlv, yC, xC, sizeC, im, bd)
        if pred_y is not None:
            n = sizeC << sub
            improve_uv_prediction(pred_y, pu, pv, rec_y.astype(np.int32), n,
                                  sub, bd)
        res = bi.org_u.astype(np.int16) - pu.astype(np.int16)
        co = transform_fwd(res, sizeC, p.encoder_speed > 1, bd)
        cu, cbp_u = quantize(co, qpC, sizeC, ctype, self._wm(ql, 1, 1, sizeC))
        if cbp_u:
            rco = dequantize(cu, qpC, sizeC, self._iwm(ql, 1, 1, sizeC))
            rb = transform_inv(rco, sizeC, bd)
            rec_u[:, :] = reconstruct_block(rb, pu, bd)
        else:
            rec_u[:, :] = pu
        res = bi.org_v.astype(np.int16) - pv.astype(np.int16)
        co = transform_fwd(res, sizeC, p.encoder_speed > 1, bd)
        cv, cbp_v = quantize(co, qpC, sizeC, ctype, self._wm(ql, 1, 1, sizeC))
        if cbp_v:
            rco = dequantize(cv, qpC, sizeC, self._iwm(ql, 1, 1, sizeC))
            rb = transform_inv(rco, sizeC, bd)
            rec_v[:, :] = reconstruct_block(rb, pv, bd)
        else:
            rec_v[:, :] = pv
        return cbp_u, cbp_v, cu, cv

    # ---------- RDO ----------

    def cost_calc(self, bi: BlockInfo, nbits):
        """enc/encode_block.c:916-926."""
        rec_y, rec_u, rec_v = bi.rec
        bw, bh = bi.bwidth, bi.bheight
        sub = bi.sub
        ssd = ME.ssd_calc(bi.org_y[:bh, :bw], rec_y[:bh, :bw])
        if not self.mono:
            ssd += ME.ssd_calc(bi.org_u[:bh >> sub, :bw >> sub],
                               rec_u[:bh >> sub, :bw >> sub])
            ssd += ME.ssd_calc(bi.org_v[:bh >> sub, :bw >> sub],
                               rec_v[:bh >> sub, :bw >> sub])
        bd = self.params.bitdepth
        cost = (ssd >> (bd * 2 - 16)) + int(bi.lambda_ * nbits + 0.5)
        return min(cost, 1 << 30)

    def _copy_best(self, bi: BlockInfo, bp):
        """copy_best_parameters (enc/encode_block.c:1615-1677)."""
        bi.rec_best = bi.rec
        best = dict(bp)
        mode = bp["mode"]
        idx = bp.get("skip_idx", 0)
        if mode == MODE_SKIP:
            c = bi.skip_candidates[idx]
            best["ref_idx0"], best["ref_idx1"] = c[4], c[5]
            best["mv_arr0"] = [(c[0], c[1])] * 4
            best["mv_arr1"] = [(c[2], c[3])] * 4
            best["dir"] = c[6]
        elif mode == MODE_MERGE:
            c = bi.merge_candidates[idx]
            best["ref_idx0"], best["ref_idx1"] = c[4], c[5]
            best["mv_arr0"] = [(c[0], c[1])] * 4
            best["mv_arr1"] = [(c[2], c[3])] * 4
            best["dir"] = c[6]
        elif mode == MODE_INTRA:
            best["ref_idx0"] = best["ref_idx1"] = 0
            best["mv_arr0"] = [(0, 0)] * 4
            best["mv_arr1"] = [(0, 0)] * 4
            best["dir"] = -1
        elif mode == MODE_INTER:
            best["dir"] = 0
        else:
            best["dir"] = 2
        bi.best = best

    def search_intra_mode(self, bi: BlockInfo):
        """search_intra_prediction_params (enc/encode_block.c:928-1031)."""
        p = self.params
        bd = p.bitdepth
        size = bi.size
        sb = 1 << p.log2_sb_size
        ur = inter.get_upright_available(bi.ypos, bi.xpos, size, size,
                                         self.width, self.height, sb)
        dl = inter.get_downleft_available(bi.ypos, bi.xpos, size, size,
                                          self.width, self.height, sb)
        left, top, tl = intra.make_top_and_left(self.rec.y, bi.ypos, bi.xpos,
                                                0, 0, size, ur, dl, 0, bd)
        num_modes = self.fi.num_intra_modes
        min_sad = 1 << 30
        best_mode = intra.MODE_DC
        order4 = [intra.MODE_DC, intra.MODE_HOR, intra.MODE_VER,
                  intra.MODE_PLANAR]
        order10 = order4 + [intra.MODE_UPLEFT, intra.MODE_UPRIGHT,
                            intra.MODE_UPUPRIGHT, intra.MODE_UPUPLEFT,
                            intra.MODE_UPLEFTLEFT, intra.MODE_DOWNLEFTLEFT]
        modes = order4 if num_modes == 4 else order10
        for m in modes:
            if m == intra.MODE_DC:
                # the search passes (left, top) unconditionally
                # (enc/encode_block.c:951: `xposY >= 0 ? left : top` is
                # always left), unlike the actual predictor's != 0 rule
                s = int(top[:size].sum() + left[:size].sum())
                dc = (s + size) // (2 * size)
                pr = np.full((size, size), dc, np.int32)
            else:
                pr = intra.get_intra_prediction(left, top, tl, bi.ypos,
                                                bi.xpos, size, m, bd)
            sad = ME.sad_calc(bi.org_y, pr) >> (bd - 8)
            if sad < min_sad:
                best_mode = m
                min_sad = sad
        return best_mode, min_sad

    def mode_decision_rdo(self, bi: BlockInfo):
        """enc/encode_block.c:1835-2121."""
        p = self.params
        fi = self.fi
        size = bi.size
        lam = bi.lambda_
        w = self.writer
        min_cost = MAX_UINT32
        pos_ref = w.save_pos()
        rectangular = bi.bwidth != size or bi.bheight != size
        do_inter = do_intra = 1
        intra_inter_sad = p.encoder_speed > 0 and not p.sync
        sad_intra = MAX_UINT32
        best_intra_mode = intra.MODE_DC

        if fi.frame_type != I_FRAME:
            for skip_idx in range(bi.num_skip_vec):
                c = bi.skip_candidates[skip_idx]
                bp = {"mode": MODE_SKIP, "tb_param": 0, "pb_part": 0,
                      "skip_idx": skip_idx, "ref_idx0": c[4],
                      "ref_idx1": c[5], "mv_arr0": [(c[0], c[1])] * 4,
                      "mv_arr1": [(c[2], c[3])] * 4, "dir": c[6]}
                nbits = self.encode_block(bi, bp)
                cost = self.cost_calc(bi, nbits)
                if cost < min_cost:
                    min_cost = cost
                    self._copy_best(bi, bp)

        if ((size < 128 or p.encoder_speed == 0) and not rectangular and
                size <= 128):
            if fi.frame_type != I_FRAME:
                # merge
                for merge_idx in range(bi.num_merge_vec):
                    c = bi.merge_candidates[merge_idx]
                    for tb_param in range(0, bi.max_num_tb_part):
                        bp = {"mode": MODE_MERGE, "tb_param": tb_param,
                              "pb_part": 0, "skip_idx": merge_idx,
                              "ref_idx0": c[4], "ref_idx1": c[5],
                              "mv_arr0": [(c[0], c[1])] * 4,
                              "mv_arr1": [(c[2], c[3])] * 4, "dir": c[6]}
                        nbits = self.encode_block(bi, bp)
                        cost = self.cost_calc(bi, nbits)
                        if cost < min_cost:
                            min_cost = cost
                            self._copy_best(bi, bp)

                if intra_inter_sad:
                    best_intra_mode, sad_intra = self.search_intra_mode(bi)
                    sad_intra += int(math.sqrt(lam) * 2 + 0.5)

                # inter ME + RDO
                if (fi.best_ref < 0 or p.encoder_speed < 2 or
                        p.enable_bipred or p.sync):
                    min_idx, max_idx = 0, fi.num_ref - 1
                else:
                    min_idx = max_idx = fi.best_ref
                if fi.frame_type == B_FRAME and fi.interp_ref > 2:
                    min_idx = 1
                worst_cost, best_cost = 0, MAX_UINT32
                mv_center = {}
                for ref_idx in range(min_idx, max_idx + 1):
                    r = fi.ref_array[ref_idx]
                    ref = self._ref_frame(r)
                    mvp = inter.get_mv_pred(bi.ypos, bi.xpos, self.width,
                                            self.height, size, size,
                                            1 << p.log2_sb_size, self.dd)
                    self._add_mvcand(ref_idx, mvp)
                    bi.mvp = mvp
                    sign = int(ref.frame_num > self.rec.frame_num)
                    mv_center[ref_idx] = mvp
                    mv_all = {}
                    sad_inter = MAX_UINT32
                    for part in range(bi.max_num_pb_part):
                        sad, mvs = self._search_inter(
                            bi, ref, mv_center[ref_idx], mvp, part, lam,
                            sign, ref_idx)
                        mv_all[part] = mvs
                        for i in range(4):
                            self._add_mvcand(ref_idx, mvs[i])
                        mv_center[ref_idx] = mv_all[0][0]
                        sad_inter = min(sad_inter, sad)
                    if intra_inter_sad:
                        do_inter = int(sad_inter < sad_intra)
                        if sad_inter < sad_intra:
                            do_intra = 0
                    if do_inter:
                        for part in range(bi.max_num_pb_part):
                            min_tb = -1 if p.encoder_speed < 1 else 0
                            for tb_param in range(min_tb,
                                                  bi.max_num_tb_part):
                                bp = {"mode": MODE_INTER,
                                      "tb_param": tb_param,
                                      "pb_part": part,
                                      "ref_idx0": ref_idx,
                                      "ref_idx1": ref_idx,
                                      "mv_arr0": list(mv_all[part]),
                                      "mv_arr1": list(mv_all[part]),
                                      "dir": 0, "skip_idx": 0}
                                nbits = self.encode_block(bi, bp)
                                cost = self.cost_calc(bi, nbits)
                                worst_cost = max(worst_cost, cost)
                                best_cost = min(best_cost, cost)
                                if cost < min_cost:
                                    min_cost = cost
                                    self._copy_best(bi, bp)
                if worst_cost and worst_cost * 3 > best_cost * 4:
                    fi.best_ref = 0
                if fi.num_ref > 1 and p.enable_bipred and do_inter:
                    min_cost = self._bipred_rdo(bi, mv_center, bi.mvp, lam,
                                                min_cost)

            # intra
            if do_intra:
                if p.intra_rdo:
                    min_icost = MAX_UINT32
                    bim = intra.MODE_DC
                    for im in range(fi.num_intra_modes):
                        for tb_param in range(0, bi.max_num_tb_part):
                            bp = {"mode": MODE_INTRA, "tb_param": tb_param,
                                  "pb_part": 0, "intra_mode": im,
                                  "ref_idx0": 0, "ref_idx1": 0, "dir": -1,
                                  "skip_idx": 0,
                                  "mv_arr0": [(0, 0)] * 4,
                                  "mv_arr1": [(0, 0)] * 4}
                            nbits = self.encode_block(bi, bp)
                            cost = self.cost_calc(bi, nbits)
                            if cost < min_icost:
                                min_icost = cost
                                bim = im
                    intra_mode = bim
                elif intra_inter_sad and fi.frame_type != I_FRAME:
                    intra_mode = best_intra_mode
                else:
                    intra_mode, _ = self.search_intra_mode(bi)
                for tb_param in range(0, bi.max_num_tb_part):
                    bp = {"mode": MODE_INTRA, "tb_param": tb_param,
                          "pb_part": 0, "intra_mode": intra_mode,
                          "ref_idx0": 0, "ref_idx1": 0, "dir": -1,
                          "skip_idx": 0, "mv_arr0": [(0, 0)] * 4,
                          "mv_arr1": [(0, 0)] * 4}
                    nbits = self.encode_block(bi, bp)
                    cost = self.cost_calc(bi, nbits)
                    if cost < min_cost:
                        min_cost = cost
                        self._copy_best(bi, bp)

        self.writer.restore_pos(pos_ref)
        return min_cost

    def _add_mvcand(self, ref_idx, mv):
        """add_mvcandidate (enc/encode_block.c:69-82)."""
        fi = self.fi
        iy = (mv[0] + 2) >> 2
        ix = (mv[1] + 2) >> 2
        m = 1 << (((iy << 3) ^ ix) & 63)
        if not (m & fi.mvcand_mask[ref_idx]):
            fi.mvcand[ref_idx][fi.mvcand_num[ref_idx]] = (iy, ix)
            fi.mvcand_num[ref_idx] += 1
        fi.mvcand_mask[ref_idx] |= m

    def _search_inter(self, bi: BlockInfo, ref, mvc, mvp, part, lam, sign,
                      ref_idx):
        """search_inter_prediction_params (enc/encode_block.c:1033-1098)."""
        p = self.params
        fi = self.fi
        size = bi.size
        sqrt_lam = math.sqrt(lam)
        mvcand = fi.mvcand[ref_idx]
        ncand = [fi.mvcand_num[ref_idx]]
        mvs = [None] * 4
        sad_total = 0
        mvp2 = mvp
        if part == 0:
            sad, mv = ME.motion_estimate(
                bi.org_y, ref, bi.ypos, bi.xpos, size, size, size, mvc, mvp2,
                sqrt_lam, p, sign, self.width, self.height, mvcand, ncand,
                p.enable_bipred, p.bitdepth, sync=p.sync)
            sad_total += sad
            mvs = [mv] * 4
        elif part == 1:  # HOR
            for index in (0, 2):
                py = index >> 1
                sad, mv = ME.motion_estimate(
                    bi.org_y[py * (size // 2):py * (size // 2) + size // 2],
                    ref, bi.ypos, bi.xpos, size, size, size // 2, mvc, mvp2,
                    sqrt_lam, p, sign, self.width, self.height, mvcand,
                    ncand, p.enable_bipred, p.bitdepth,
                    base_off=(py * (size // 2), 0))
                sad_total += sad
                mvs[index] = mvs[index + 1] = mv
                mvp2 = mvs[0]
        elif part == 2:  # VER
            for index in (0, 1):
                px = index
                sad, mv = ME.motion_estimate(
                    bi.org_y[:, px * (size // 2):px * (size // 2) +
                             size // 2],
                    ref, bi.ypos, bi.xpos, size, size // 2, size, mvc, mvp2,
                    sqrt_lam, p, sign, self.width, self.height, mvcand,
                    ncand, p.enable_bipred, p.bitdepth,
                    base_off=(0, px * (size // 2)))
                sad_total += sad
                mvs[index] = mvs[index + 2] = mv
                mvp2 = mvs[0]
        else:  # QUAD
            for index in range(4):
                px, py = index & 1, (index & 2) >> 1
                sad, mv = ME.motion_estimate(
                    bi.org_y[py * (size // 2):py * (size // 2) + size // 2,
                             px * (size // 2):px * (size // 2) + size // 2],
                    ref, bi.ypos, bi.xpos, size, size // 2, size // 2,
                    mvc, mvp2, sqrt_lam, p, sign, self.width, self.height,
                    mvcand, ncand, p.enable_bipred, p.bitdepth,
                    base_off=(py * (size // 2), px * (size // 2)))
                sad_total += sad
                mvs[index] = mv
                mvp2 = mvs[0]
        return sad_total, mvs

    def _bipred_rdo(self, bi, mv_center, mvp, lam, min_cost):
        """MODE_BIPRED evaluation (enc/encode_block.c:2021-2069).
        Returns the updated min_cost."""
        p = self.params
        num_bi_part = 1  # BIPRED_PART == 0
        for part in range(num_bi_part):
            r0, r1, mv0, mv1 = self._search_bipred(bi, part, mv_center, mvp,
                                                   0)
            for tb_param in range(0, bi.max_num_tb_part):
                bp = {"mode": MODE_BIPRED, "tb_param": tb_param,
                      "pb_part": part, "ref_idx0": r0, "ref_idx1": r1,
                      "mv_arr0": list(mv0), "mv_arr1": list(mv1),
                      "dir": 2, "skip_idx": 0}
                nbits = self.encode_block(bi, bp)
                cost = self.cost_calc(bi, nbits)
                if cost < min_cost:
                    min_cost = cost
                    self._copy_best(bi, bp)
        if self.fi.frame_type == B_FRAME and p.encoder_speed == 0:
            r0, r1, mv0, mv1 = self._search_bipred(bi, num_bi_part,
                                                   mv_center, mvp, 1)
            bp = {"mode": MODE_BIPRED, "tb_param": 0, "pb_part": 0,
                  "ref_idx0": r0, "ref_idx1": r1, "mv_arr0": list(mv0),
                  "mv_arr1": list(mv1), "dir": 2, "skip_idx": 0}
            nbits = self.encode_block(bi, bp)
            cost = self.cost_calc(bi, nbits)
            if cost < min_cost:
                min_cost = cost
                self._copy_best(bi, bp)
        return min_cost

    def _search_bipred(self, bi: BlockInfo, part, mv_center, mvp, me_mode):
        """search_bipred_prediction_params (enc/encode_block.c:1679-1833)."""
        p = self.params
        fi = self.fi
        size = bi.size
        lam = bi.lambda_
        sqrt_lam = math.sqrt(lam)
        if me_mode:
            r_idx0 = 1 if fi.interp_ref else 0
            r_idx1 = 2 if fi.interp_ref else 1
            ref0 = self._ref_frame(fi.ref_array[r_idx0])
            ref1 = self._ref_frame(fi.ref_array[r_idx1])
            ncand = [fi.mvcand_num[r_idx0]]
            sad, mv = ME.motion_estimate_bi(
                bi.org_y, ref0, ref1, bi.ypos, bi.xpos, size, size, size,
                mv_center[r_idx0], mvp, sqrt_lam, p, 0, self.width,
                self.height, fi.mvcand[r_idx0], ncand, 1, p.bitdepth)
            # the C writes mvcand[4]/[5] in-place; mirror list growth
            return r_idx0, r_idx1, [mv] * 4, [mv] * 4

        num_iter = 2 if p.encoder_speed == 0 else 1
        if fi.frame_type == B_FRAME and fi.interp_ref > 0:
            ridx = 1
        else:
            ridx = 0
        min_ref_idx0 = ridx
        min_ref_idx1 = 0
        min_mv0 = [mvp] * 4
        min_mv1 = [mvp] * 4
        min_sad = 1 << 30
        bd = p.bitdepth
        hi = (1 << bd) - 1
        for n in range(num_iter):
            stop = 0 if part == 0 else 1
            for lst in range(1, stop - 1, -1):
                mv = min_mv0[0] if lst else min_mv1[0]
                ref_idx = min_ref_idx0 if lst else min_ref_idx1
                r = fi.ref_array[ref_idx]
                ref = self._ref_frame(r)
                sign = int(ref.frame_num > self.rec.frame_num)
                pred = inter.get_inter_prediction_yuv(
                    ref, min_mv0 if lst else min_mv1, bi.ypos, bi.xpos,
                    size, size, size, sign, self.width, self.height,
                    p.enable_bipred, int(part > 0), bd)[0]
                org8 = np.clip(2 * bi.org_y.astype(np.int16) -
                               pred.astype(np.int16), 0, hi).astype(np.int32)
                if fi.frame_type == P_FRAME:
                    ref_start, ref_end = 0, fi.num_ref - 1
                else:
                    ref_start = ref_end = (1 if lst else 0)
                    if fi.interp_ref:
                        ref_start += 1
                        ref_end += 1
                for ref_idx in range(ref_start, ref_end + 1):
                    r = fi.ref_array[ref_idx]
                    ref = self._ref_frame(r)
                    sign = int(ref.frame_num > self.rec.frame_num)
                    mvp2 = mv if (fi.frame_type == B_FRAME and lst == 1) \
                        else mvp
                    mvc = mv_center[ref_idx]
                    saved_org = bi.org_y
                    bi.org_y = org8
                    try:
                        sad, mvs = self._search_inter(bi, ref, mvc, mvp2,
                                                      part, lam, sign,
                                                      ref_idx)
                    finally:
                        bi.org_y = saved_org
                    for i in range(4):
                        self._add_mvcand(ref_idx, mvs[i])
                    if sad < min_sad:
                        min_sad = sad
                        if lst:
                            min_ref_idx1 = ref_idx
                            min_mv1 = list(mvs)
                        else:
                            min_ref_idx0 = ref_idx
                            min_mv0 = list(mvs)
        return min_ref_idx0, min_ref_idx1, min_mv0, min_mv1

    # ---------- early skip ----------

    def _check_early_skip(self, bi: BlockInfo, cand, skip_idx=0):
        """check_early_skip_block (enc/encode_block.c:2231-2350)."""
        p = self.params
        size = bi.size
        size0 = min(size, EARLY_SKIP_BLOCK_SIZE)
        qpY = bi.qp
        qpC = int(CHROMA_QP[qpY]) if bi.sub else qpY
        thr = np.float32(p.early_skip_thr)
        if p.encoder_speed > 1 and size == (1 << p.log2_sb_size):
            thr = np.float32(thr + thr / np.float32(4))
        thr = float(thr)
        sub = bi.sub
        sizec = size >> sub
        size0c = size0 >> sub
        significant = False
        fi = self.fi

        if cand[6] == 2:
            refs = (self._ref_frame(fi.ref_array[cand[4]]),
                    self._ref_frame(fi.ref_array[cand[5]]))
            signs = (int(refs[0].frame_num >= fi.frame_num),
                     int(refs[1].frame_num >= fi.frame_num))
        else:
            ref = self._ref_frame(fi.ref_array[cand[4]])
            sign = int(ref.frame_num > fi.frame_num)

        for i in range(0, size, size0):
            for j in range(0, size, size0):
                if significant:
                    break
                ypos, xpos = bi.ypos + i, bi.xpos + j
                if (cand[6] == 2 and self.fi.frame_type == B_FRAME and
                        p.interp_ref == 2 and skip_idx == 0):
                    sub_bi = BlockInfo()
                    sub_bi.size = size0
                    sub_bi.ypos, sub_bi.xpos = ypos, xpos
                    sub_bi.bwidth = sub_bi.bheight = size0
                    py, pu, pv = self._inter_pred_temp(sub_bi)
                elif cand[6] == 2:
                    p0 = inter.get_inter_prediction_yuv(
                        refs[0], [(cand[0], cand[1])] * 4, ypos, xpos, size0,
                        size0, size0, signs[0], self.width, self.height,
                        p.enable_bipred, 0, p.bitdepth)
                    p1 = inter.get_inter_prediction_yuv(
                        refs[1], [(cand[2], cand[3])] * 4, ypos, xpos, size0,
                        size0, size0, signs[1], self.width, self.height,
                        p.enable_bipred, 0, p.bitdepth)
                    py, pu, pv = (inter.average_blocks(a, b)
                                  for a, b in zip(p0, p1))
                else:
                    py, pu, pv = inter.get_inter_prediction_yuv(
                        ref, [(cand[0], cand[1])] * 4, ypos, xpos, size0,
                        size0, size0, sign, self.width, self.height,
                        p.enable_bipred, 0, p.bitdepth)
                oy = bi.org_y[i:i + size0, j:j + size0]
                significant = significant or self._early_skip_luma(
                    oy, py, size0, qpY, thr)
                if self.mono:
                    continue
                ic, jc = i >> sub, j >> sub
                ou = bi.org_u[ic:ic + size0c, jc:jc + size0c]
                ov = bi.org_v[ic:ic + size0c, jc:jc + size0c]
                significant = significant or self._early_skip_chroma(
                    ou, pu, size0c, qpC, thr)
                significant = significant or self._early_skip_chroma(
                    ov, pv, size0c, qpC, thr)
            if significant:
                break
        return not significant

    def _early_skip_luma(self, orig, pred, size, qp, thr):
        """check_early_skip_sub_block (enc/encode_block.c:2147-2180)."""
        p = self.params
        bd = p.bitdepth
        block = orig.astype(np.int16) - pred.astype(np.int16)
        if size > 4:
            s2 = size // 2
            b = block.astype(np.int32).reshape(s2, 2, s2, 2)
            tmp = ((b[:, 0, :, 0] + b[:, 0, :, 1] + b[:, 1, :, 0] +
                    b[:, 1, :, 1] + 2) >> 2)
            coeff = transform_fwd(tmp, s2, False, bd)
            return self._early_skip_coeff(coeff, qp, s2, 0.5 * thr)
        coeff = transform_fwd(block, size, False, bd)
        return self._early_skip_coeff(coeff, qp, size, thr)

    @staticmethod
    def _early_skip_coeff(coeff, qp, size, rel_thr):
        """check_early_skip_transform_coeff (enc/encode_block.c:2123)."""
        scale = int(GQUANT[qp % 6])
        shift2 = 21 - log2i(size) + qp // 6
        fql = float(1 << shift2) / float(scale)
        threshold = int(rel_thr * fql)
        return bool((np.abs(coeff.astype(np.int32)) > threshold).any())

    def _early_skip_chroma(self, orig, pred, size, qp, thr):
        """check_early_skip_sub_blockC + calc_cbp_simd
        (enc/encode_block.c:2214, enc/enc_kernels.c:828).

        The SIMD kernel is normative: column sums wrap in int16 lanes; for
        size 4 the test is (c1 + |c0| > thr) || (c3 + |c2| > thr) with
        SIGNED c1/c3 and no final abs - quite different from the scalar
        calc_cbp fallback."""
        p = self.params
        scale = int(GQUANT[qp % 6])
        shift2 = 21 - 5 + qp // 6
        fql = float(1 << shift2) / float(scale)
        threshold = int(thr * fql) << (p.bitdepth - 8)
        block = (orig.astype(np.int16) - pred.astype(np.int16))
        cols = block.astype(np.int16)
        sums = np.zeros(size, np.int16)
        for i in range(size):
            sums = (sums + cols[i]).astype(np.int16)
        if size in (8, 16):
            absd = np.abs(sums.astype(np.int32)).astype(np.int16)
            return bool((absd > threshold).any())
        c0, c1, c2, c3 = (int(sums[0]), int(sums[1]), int(sums[2]),
                          int(sums[3]))
        a0 = int(np.abs(np.int16(c0)).astype(np.int16))
        a2 = int(np.abs(np.int16(c2)).astype(np.int16))
        return (c1 + a0 > threshold) or (c3 + a2 > threshold)

    def _search_early_skip(self, bi: BlockInfo):
        """search_early_skip_candidates (enc/encode_block.c:2352-2392)."""
        min_cost = MAX_UINT32
        early = 0
        for skip_idx in range(bi.num_skip_vec):
            c = bi.skip_candidates[skip_idx]
            if self._check_early_skip(bi, c, skip_idx):
                early = 1
                bp = {"mode": MODE_SKIP, "tb_param": 0, "pb_part": 0,
                      "skip_idx": skip_idx, "ref_idx0": c[4],
                      "ref_idx1": c[5], "mv_arr0": [(c[0], c[1])] * 4,
                      "mv_arr1": [(c[2], c[3])] * 4, "dir": c[6]}
                nbits = self.encode_block(bi, bp)
                cost = self.cost_calc(bi, nbits)
                if cost < min_cost:
                    min_cost = cost
                    self._copy_best(bi, bp)
        return early

    # ---------- process_block ----------

    def process_block(self, size, ypos, xpos, qp):
        """enc/encode_block.c:2401-2565. Returns cost."""
        p = self.params
        fi = self.fi
        w = self.writer
        if ypos + 8 > self.height or xpos + 8 > self.width:
            return 0
        encode_smaller = size > 8
        encode_this = ypos + size <= self.height and xpos + size <= self.width
        encode_rect = not encode_this and fi.frame_type != I_FRAME
        top_down = (size == 16 and encode_this and
                    fi.frame_type != I_FRAME and not p.sync and
                    p.encoder_speed > 0)
        IQ8 = [6, 7, 8, 8, 10, 11, 12, 13, 15, 17, 19, 21, 24, 27, 30, 34,
               38, 43, 48, 54, 60, 68, 76, 86, 96, 108, 121, 136, 152, 171,
               192, 216, 242, 272, 305, 342, 384, 431, 484, 543, 610, 684,
               768, 862, 968, 1086, 1219, 1368, 1536, 1724, 1935, 2172]
        top_down_threshold = size * size * IQ8[qp] // 8
        cost_small = 1 << 28
        cost = 1 << 28
        pos_ref = w.save_pos()

        bi = BlockInfo()
        bi.size = size
        bi.ypos, bi.xpos = ypos, xpos
        bi.bwidth = min(size, self.width - xpos)
        bi.bheight = min(size, self.height - ypos)
        bi.sub = self.sub
        bi.qp = qp
        bi.delta_qp = qp - fi.prev_qp
        bi.max_num_tb_part = 2 if p.enable_tb_split == 1 else 1
        bi.max_num_pb_part = 4 if p.enable_pb_split else 1
        if p.max_delta_qp > 0:
            bi.lambda_ = fi.lambda_coeff * SQUARED_LAMBDA_QP[fi.qp]
        else:
            bi.lambda_ = fi.lambda_coeff * SQUARED_LAMBDA_QP[qp]
        bi.best = None
        bi.rec = None
        bi.rec_best = None
        bi.mvp = (0, 0)

        # compact original block (replicated edges via copy_frame_to_block's
        # bwidth/bheight limited copies - the rest is stale/zero like C's
        # uninitialised buffer; only the valid area is ever read)
        bi.org_y = np.zeros((size, size), np.int32)
        bi.org_y[:bi.bheight, :bi.bwidth] = \
            self.orig.y[ypos:ypos + bi.bheight, xpos:xpos + bi.bwidth]
        sC = size >> self.sub
        bi.org_u = np.zeros((sC, sC), np.int32)
        bi.org_v = np.zeros((sC, sC), np.int32)
        if not self.mono:
            bhc = bi.bheight >> self.sub
            bwc = bi.bwidth >> self.sub
            yC, xC = ypos >> self.sub, xpos >> self.sub
            bi.org_u[:bhc, :bwc] = self.orig.u[yC:yC + bhc, xC:xC + bwc]
            bi.org_v[:bhc, :bwc] = self.orig.v[yC:yC + bhc, xC:xC + bwc]

        bi.ctx_split, bi.ctx_cbp, bi.ctx_index = self._find_block_context(
            ypos, xpos, size)

        if fi.frame_type != I_FRAME and (encode_this or encode_rect):
            bi.skip_candidates = inter.get_mv_skip(
                ypos, xpos, self.width, self.height, size, size,
                1 << p.log2_sb_size, self.dd)
            bi.num_skip_vec = len(bi.skip_candidates)
            if fi.frame_type == B_FRAME and p.interp_ref == 2:
                bi.skip_candidates = self._get_mv_skip_temp(
                    bi, bi.skip_candidates)
                bi.num_skip_vec = len(bi.skip_candidates)
            bi.merge_candidates = inter.get_mv_merge(
                ypos, xpos, self.width, self.height, size, size,
                1 << p.log2_sb_size, self.dd)
            bi.num_merge_vec = len(bi.merge_candidates)
        else:
            bi.skip_candidates = []
            bi.merge_candidates = []
            bi.num_skip_vec = bi.num_merge_vec = 0

        if encode_this and fi.frame_type != I_FRAME and p.early_skip_thr > 0:
            bi.final_encode = 2
            early = self._search_early_skip(bi)
            w.restore_pos(pos_ref)
            if early:
                bi.final_encode = 3
                nbits = self.encode_block(bi, bi.best)
                cost = self.cost_calc(bi, nbits)
                self._copy_to_frame(bi)
                self._copy_deblock(bi)
                return cost

        if encode_smaller and not top_down:
            ns = size // 2
            W.write_super_mode(w, self, bi, MODE_SKIP, 0, 1, encode_this)
            if size == (1 << p.log2_sb_size) and (p.max_delta_qp or
                                                  p.bitrate):
                W.write_delta_qp(w, bi.delta_qp)
            cost_small = 0
            cost_small += self.process_block(ns, ypos, xpos, qp)
            cost_small += self.process_block(ns, ypos + ns, xpos, qp)
            cost_small += self.process_block(ns, ypos, xpos + ns, qp)
            cost_small += self.process_block(ns, ypos + ns, xpos + ns, qp)

        if encode_this or encode_rect:
            bi.final_encode = 0
            cost = self.mode_decision_rdo(bi)
            if top_down and cost > top_down_threshold:
                ns = size // 2
                W.write_super_mode(w, self, bi, MODE_SKIP, 0, 1, encode_this)
                cost_small = 0
                cost_small += self.process_block(ns, ypos, xpos, qp)
                cost_small += self.process_block(ns, ypos + ns, xpos, qp)
                cost_small += self.process_block(ns, ypos, xpos + ns, qp)
                cost_small += self.process_block(ns, ypos + ns, xpos + ns, qp)
            if cost <= cost_small:
                w.restore_pos(pos_ref)
                bi.final_encode = 1
                self.encode_block(bi, bi.best)
                self._copy_to_frame(bi)
                self._copy_deblock(bi)

        if size == (1 << p.log2_sb_size):
            if cost > cost_small or (bi.best or {}).get("mode") != MODE_SKIP:
                fi.prev_qp = qp

        return min(cost, cost_small)

    def _find_block_context(self, ypos, xpos, size):
        return find_block_contexts(ypos, xpos, self.height, self.width,
                                   size, self.dd,
                                   self.params.use_block_contexts)

    def _copy_to_frame(self, bi: BlockInfo):
        rec_y, rec_u, rec_v = bi.rec
        bw, bh = bi.bwidth, bi.bheight
        self.rec.y[bi.ypos:bi.ypos + bh, bi.xpos:bi.xpos + bw] = \
            rec_y[:bh, :bw].astype(self.rec.dtype)
        if not self.mono:
            sub = bi.sub
            yC, xC = bi.ypos >> sub, bi.xpos >> sub
            self.rec.u[yC:yC + (bh >> sub), xC:xC + (bw >> sub)] = \
                rec_u[:bh >> sub, :bw >> sub].astype(self.rec.dtype)
            self.rec.v[yC:yC + (bh >> sub), xC:xC + (bw >> sub)] = \
                rec_v[:bh >> sub, :bw >> sub].astype(self.rec.dtype)

    def _copy_deblock(self, bi: BlockInfo):
        """copy_deblock_data (enc/encode_block.c:1568-1613)."""
        bp = bi.best
        dd = self.dd
        size = bi.size
        posy = bi.ypos // MIN_PB_SIZE
        posx = bi.xpos // MIN_PB_SIZE
        div = size // (2 * MIN_PB_SIZE)
        tb_split = int(max(0, bp.get("tb_param", 0)) > 0)
        pb_part = bp["pb_part"] if bp["mode"] == MODE_INTER else 0
        nh = bi.bheight // MIN_PB_SIZE
        nw = bi.bwidth // MIN_PB_SIZE
        k = ((posy + np.arange(nh))[:, None] * dd.bs +
             posx + np.arange(nw)[None, :]).reshape(-1)
        dd.cbp_y[k], dd.cbp_u[k], dd.cbp_v[k] = bp["cbp"]
        dd.tb_split[k] = tb_split
        dd.pb_part[k] = pb_part
        dd.size[k] = size
        dd.mode[k] = bp["mode"]
        if (self.fi.frame_type == B_FRAME and
                self.params.interp_ref == 2 and
                bp["mode"] == MODE_SKIP and
                bp.get("skip_idx", 0) == 0):
            phase = self.fi.phase
            mv = dd.arr_mv0[k, phase]
            dd.mv0[k] = mv
            if self.params.num_reorder_pics == 2 and phase == 1:
                dd.mv1[k] = mv * 2
            else:
                dd.mv1[k] = mv
        else:
            if div > 0:
                idx = (2 * (np.arange(nh) // div).clip(0, 1)[:, None] +
                       (np.arange(nw) // div).clip(0, 1)[None, :]
                       ).reshape(-1)
            else:
                idx = np.zeros(nh * nw, np.int64)
            dd.mv0[k] = np.asarray(bp["mv_arr0"])[idx]
            dd.mv1[k] = np.asarray(bp["mv_arr1"])[idx]
        dd.ref_idx0[k] = bp["ref_idx0"]
        dd.ref_idx1[k] = bp["ref_idx1"]
        dd.bipred_flag[k] = bp["dir"]

    # ---------- frame level ----------

    def encode_frame(self):
        """enc/encode_frame.c:637-850."""
        p = self.params
        fi = self.fi
        w = self.writer
        sb_size = 1 << p.log2_sb_size
        nsh = (self.width + sb_size - 1) // sb_size
        nsv = (self.height + sb_size - 1) // sb_size

        if fi.frame_type == I_FRAME:
            self.dd.clear()
        qp = fi.qp
        lc = frame_lambda_coeff(p, fi)
        fi.lambda_coeff = lc
        fi.lambda_ = lc * SQUARED_LAMBDA_QP[fi.qp]

        self.cdef_damping = 5
        self.cdef_bits = (3 if fi.frame_type == I_FRAME
                          else 3 - (fi.qp + 4) // 16)
        self.cdef_strengths = [127] * 8
        self.cdef_uv_strengths = [127] * 8

        W.write_frame_header(w, self)
        fi.prev_qp = fi.qp

        sb_idx = 0
        if p.bitrate > 0:
            start_bits_frame = w.get_bit_pos()
            max_qp = p.max_qpI if fi.frame_type == I_FRAME else p.max_qp
            min_qp = p.min_qpI if fi.frame_type == I_FRAME else p.min_qp
            self.rc.init_frame(min_qp, max_qp)
        if self.device_sb_loop and device_lc.lc_supported(self):
            device_lc.encode_frame_device(self)
            return self._encode_frame_tail(qp)
        if self.turbo and turbo.turbo_supported(self):
            self._turbo_frame = True
            try:
                turbo.encode_frame_turbo(self)
                return self._encode_frame_tail(qp)
            finally:
                self._turbo_frame = False
        for k in range(nsv):
            for l in range(nsh):
                fi.mvcand = self.mvcand
                fi.mvcand_num = [0] * 4
                fi.mvcand_mask = [0] * 4
                fi.best_ref = -1
                if p.max_delta_qp:
                    # RDO search over SB-level QP (encode_frame.c:708-730)
                    min_cost = 1 << 30
                    pos_ref = w.save_pos()
                    best_qp = qp
                    pqp = fi.prev_qp
                    for qp0 in range(qp - p.max_delta_qp,
                                     qp + p.max_delta_qp + 1,
                                     p.delta_qp_step):
                        cost = self.process_block(sb_size, k * sb_size,
                                                  l * sb_size, qp0)
                        if cost < min_cost:
                            min_cost = cost
                            best_qp = qp0
                    fi.prev_qp = pqp
                    w.restore_pos(pos_ref)
                    self.process_block(sb_size, k * sb_size, l * sb_size,
                                       best_qp)
                elif p.bitrate > 0:
                    start_bits_sb = w.get_bit_pos()
                    self.process_block(sb_size, k * sb_size, l * sb_size, qp)
                    nbits_sb = w.get_bit_pos() - start_bits_sb
                    qp = self.rc.update_sb(sb_idx, nbits_sb, qp)
                    sb_idx += 1
                else:
                    self.process_block(sb_size, k * sb_size, l * sb_size, qp)

        if p.bitrate > 0:
            self._rc_start_bits = start_bits_frame
        return self._encode_frame_tail(qp)

    @TR.spanned("enc.encoder")
    def _encode_frame_tail(self, qp):
        """Post-SB-loop frame work: in-loop filters, RC update, ref window
        (enc/encode_frame.c:760-850)."""
        p = self.params
        fi = self.fi
        w = self.writer
        qp = fi.qp = fi.prev_qp

        if p.interp_ref > 1:
            store_mv(self.dd, self.width, self.height, fi.b_level,
                     fi.frame_type, fi.frame_num, p.num_reorder_pics + 1)

        if p.deblocking:
            qpc = int(CHROMA_QP[qp]) if p.subsample != 444 else qp
            self._deblock_device(qp, qpc)

        if p.cdef:
            cdef_bits = FR.cdef_search(self, self.rec, self.orig, self.dd)
            FR.apply_cdef_enc(self, self.rec, self.dd)
            cur = w.save_pos()
            self.cdef_bits = cdef_bits
            w.restore_pos(self.cdef_header_pos)
            W.write_cdef_params(w, self)
            w.restore_pos(cur)

        if p.clpf:
            if qp <= 16:
                w.put_flc(2, 0)
            else:
                sy, fb_size_log2 = FR.clpf_test_frame(
                    self.rec, self.orig, self.dd, fi, p.bitdepth, 0,
                    p.max_clpf_strength, self.device)
                su, _ = FR.clpf_test_frame(self.rec, self.orig, self.dd, fi,
                                           p.bitdepth, 1,
                                           p.max_clpf_strength, self.device)
                sv, _ = FR.clpf_test_frame(self.rec, self.orig, self.dd, fi,
                                           p.bitdepth, 2,
                                           p.max_clpf_strength, self.device)
                enable_fb = 1
                if not fb_size_log2:
                    enable_fb = 0
                    fb_size_log2 = log2i(128)
                w.put_flc(2, sy - int(sy == 4))
                w.put_flc(2, su - int(su == 4))
                w.put_flc(2, sv - int(sv == 4))
                if sy:
                    w.put_flc(2, (fb_size_log2 - 4) * enable_fb)
                    self._clpf_apply(0, sy, fb_size_log2, enable_fb, qp)
                if su:
                    self._clpf_apply(1, su, 4, 0, qp)
                if sv:
                    self._clpf_apply(2, sv, 4, 0, qp)

        if p.bitrate > 0:
            self.rc.update_frame(w.get_bit_pos() - self._rc_start_bits)

        # reference sliding window
        tmp = self.ref[MAX_REF_FRAMES - 1]
        self.ref[1:] = self.ref[:-1]
        self.ref[0] = tmp
        self.ref[0].copy_from(self.rec)
        if self.turbo or self.device_sb_loop:
            self._note_dev_ref(self.ref[0].frame_num)

    def _deblock_device(self, qp, qpc):
        """Encoder-side deblock on the device (the decoder's deblock
        passes, ops/filters.py:deblock_exec; one packed pull)."""
        H, W_ = self.height, self.width
        Hc, Wc = H >> self.sub, W_ >> self.sub
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        mv_, mh_ = OF.deblock_masks_y(self.dd, W_, H)
        if not self.mono:
            cmv, cmh = OF.deblock_masks_uv(self.dd, W_, H)
            u = up(self.rec.u.astype(np.int16))
            v = up(self.rec.v.astype(np.int16))
        else:
            cmv = cmh = np.zeros((1, 1), bool)
            u = v = torch.zeros((1, 1), dtype=torch.int16, device=dev)
        packed = OF.deblock_exec(
            up(self.rec.y.astype(np.int16)), u, v, up(mv_), up(mh_),
            up(cmv), up(cmh), qp=qp, qpc=qpc, bd=self.params.bitdepth,
            sub=self.sub, mono=self.mono).cpu().numpy()
        self.rec.y[:] = packed[:H].astype(self.rec.y.dtype)
        if not self.mono:
            if self.sub:
                self.rec.u[:] = packed[H:H + Hc, :Wc].astype(
                    self.rec.u.dtype)
                self.rec.v[:] = packed[H:H + Hc, Wc:].astype(
                    self.rec.v.dtype)
            else:
                self.rec.u[:] = packed[H:2 * H].astype(self.rec.u.dtype)
                self.rec.v[:] = packed[2 * H:].astype(self.rec.v.dtype)

    @TR.spanned("enc.clpf_apply")
    def _clpf_apply(self, plane, strength, fb_size_log2, enable_fb, qp):
        """clpf_frame with the encoder decision fn writing bits."""
        p = self.params
        plane_arr = (self.rec.y, self.rec.u, self.rec.v)[plane]
        if enable_fb:
            bits = self._clpf_decisions(plane, strength, fb_size_log2, qp)
        else:
            bits = None
        filters.clpf_frame(plane_arr, self.dd, self.width, plane, strength,
                           fb_size_log2, p.bitdepth, qp, self.sub, bits)

    def _clpf_decisions(self, plane, strength, fb_size_log2, qp):
        """Run clpf_decision per non-allskip fb in raster order, emitting
        bits (mirrors clpf_frame's decision callback invocation)."""
        p = self.params
        rec, org = self.rec, self.orig
        bs = 4 if (plane != 0 and self.sub) else 8
        width = self.width >> (self.sub if plane else 0)
        height = self.height >> (self.sub if plane else 0)
        nfh = (width + (1 << fb_size_log2) - 1) >> fb_size_log2
        nfv = (height + (1 << fb_size_log2) - 1) >> fb_size_log2
        bstr = width // MIN_PB_SIZE
        psub = self.sub if plane else 0
        strength_sh = strength << (p.bitdepth - 8)
        tables = None
        if plane == 0:
            dmp = (p.bitdepth - 8) + 4 + (qp >> 4)
            tables = {0: FR._clpf_tables_plane_dev(rec.y, org.y,
                                                   p.bitdepth - 8, dmp,
                                                   self.device)}
        bits = []
        for k in range(nfv):
            for l in range(nfh):
                xoff = l << fb_size_log2
                yoff = k << fb_size_log2
                allskip = True
                for m in range((1 << fb_size_log2) // bs):
                    for n in range((1 << fb_size_log2) // bs):
                        xpos = xoff + n * bs
                        ypos = yoff + m * bs
                        if xpos < width and ypos < height:
                            idx = (((ypos << psub) // MIN_PB_SIZE) * bstr +
                                   ((xpos << psub) // MIN_PB_SIZE))
                            if self.dd.mode[idx] != 0:
                                allskip = False
                if allskip:
                    continue
                h = min(height, (k + 1) << fb_size_log2) & \
                    ((1 << fb_size_log2) - 1)
                wde = min(width, (l + 1) << fb_size_log2) & \
                    ((1 << fb_size_log2) - 1)
                h += (not h) << fb_size_log2
                wde += (not wde) << fb_size_log2
                bit = FR.clpf_decision(k, l, rec, org, self.dd, bs, wde // bs,
                                       h // bs, self.writer, strength_sh,
                                       fb_size_log2, p.bitdepth - 8, bs, qp,
                                       tables)
                bits.append(bit)
        return bits


@TR.spanned("enc.clip", root=True)
def encode_sequence(params: EncParams, yuv: bytes, progress=None,
                    device=None, schedule_only=False, encoder_hook=None,
                    megakernel=True):
    """The sequence loop (enc/mainenc.c:79-704).
    Returns (bitstream bytes, recon bytes in display order).

    Every frame takes the exact host-RDO encoder, or with `device_enc=1`
    the wavefront device encoder where it supports the frame, or with
    `turbo=1` the turbo encoder where it supports the frame
    (Encoder.encode_frame).
    The device passes run on `device`: CUDA by default, the CPU only
    when the caller asks for it (dec/decoder.py:resolve_device).

    schedule_only=True runs only the frame-scheduling logic (frame
    types, QP ladder, reference windows, interp specs) with a
    metadata-only reference window, and returns the list of per-frame
    snapshots instead of encoding - the GOP lanes' lookahead
    source (enc/gop_lanes.py).  It reads no pixels and uses no device
    (`device` is not resolved).  Pass a deep-copied EncParams: the
    sequence-tail sub-gop collapse mutates params in place.
    encoder_hook(enc) runs once after the Encoder is built.
    megakernel=False takes the wavefront device encoder's host loop
    (device_lc.run_diagonal per diagonal, thor_tpu's
    THOR_LC_MEGAKERNEL=0) instead of its default, frame_megakernel."""
    p = params
    enc = Encoder(p, "cpu" if schedule_only else resolve_device(device),
                  megakernel=megakernel)
    schedule = []
    if encoder_hook is not None:
        encoder_hook(enc)
    fi = enc.fi
    out = bytearray()
    recon = {}

    W.write_sequence_header(enc.writer, p)

    num_encoded = 0
    sub_gop = max(1, p.num_reorder_pics + 1)
    last_intra_frame_num = 0
    last_PorI = -1
    frame_size = enc.orig.frame_bytes_in_file()
    input_size = len(yuv)

    def interpolate(ref1, ref2, ratio, pos):
        if schedule_only:
            return
        dst = enc.interp_frames[0]
        # the GOP-lane prefetcher (enc/gop_lanes.py) interpolated this
        # frame's reference from the same coded frames for its decision
        done = getattr(enc, "_lane_interp", {}).pop(
            (fi.frame_num, ref1.frame_num, ref2.frame_num, ratio, pos), None)
        if done is not None:
            for a in ("y_full", "u_full", "v_full"):
                getattr(dst, a)[:] = getattr(done, a)
        else:
            from ..ops.tempinterp import interpolate_frames_auto
            interpolate_frames_auto(dst, ref1, ref2, ratio, pos,
                                    device=enc.device)
            dst.pad_frame()
        dst.frame_num = fi.frame_num

    frame_num0 = p.skip
    while (frame_num0 < p.skip + p.num_frames and
           (frame_num0 + 1) * frame_size <= input_size):
        for k in range(sub_gop):
            if p.dyadic_coding and sub_gop > 1:
                off = CD[sub_gop][k] - sub_gop + 1
            else:
                off = 0 if k == 0 else k - sub_gop
            frame_num = frame_num0 + off
            if frame_num < p.skip:
                continue
            fi.frame_num = frame_num - p.skip
            rec_idx = fi.frame_num % MAX_REORDER_BUFFER
            enc.rec = enc.rec_buf[rec_idx]
            enc.rec.frame_num = fi.frame_num
            if p.num_reorder_pics == 0:
                if p.intra_period > 0:
                    fi.frame_type = (I_FRAME if num_encoded % p.intra_period
                                     == 0 else P_FRAME)
                else:
                    fi.frame_type = I_FRAME if num_encoded == 0 else P_FRAME
            else:
                if p.intra_period > 0:
                    fi.frame_type = (
                        I_FRAME if fi.frame_num % p.intra_period == 0 else
                        (P_FRAME if fi.frame_num % sub_gop == 0 else
                         B_FRAME))
                else:
                    fi.frame_type = (
                        I_FRAME if fi.frame_num == 0 else
                        (P_FRAME if fi.frame_num % sub_gop == 0 else
                         B_FRAME))
            coded_phase = (num_encoded + sub_gop - 2) % sub_gop + 1
            fi.b_level = log2i(coded_phase) if coded_phase > 0 else 0
            fi.phase = fi.frame_num % (p.num_reorder_pics + 1)
            if fi.frame_type == I_FRAME:
                last_intra_frame_num = fi.frame_num
            fi.qp = frame_qp(p, fi, num_encoded, sub_gop)
            fi.num_ref = (0 if fi.frame_type == I_FRAME
                          else min(num_encoded, p.max_num_ref))
            fi.interp_ref = 0
            interp_spec = None
            fi.ref_array = [0] * fi.num_ref

            if fi.num_ref > 0:
                if p.num_reorder_pics > 0:
                    min_interp_depth = log2i(p.num_reorder_pics + 1) - 3
                    if p.frame_rate > 30:
                        min_interp_depth -= 1
                    if p.dyadic_coding:
                        if (num_encoded - 1) % sub_gop == 0:
                            fi.ref_array[0] = (0 if num_encoded == 1
                                               else sub_gop - 1)
                            if fi.num_ref > 1:
                                fi.ref_array[1] = min(
                                    MAX_REF_FRAMES - 1,
                                    min(num_encoded - 1, 2 * sub_gop - 1))
                            for r in range(2, fi.num_ref):
                                fi.ref_array[r] = r - 2
                        elif fi.num_ref > 0:
                            display_phase = (fi.frame_num - 1) % sub_gop
                            ref_offset = sub_gop >> (fi.b_level + 1)
                            dcm = DC[sub_gop]
                            if (fi.b_level >= min_interp_depth and
                                    p.interp_ref == 1):
                                if fi.num_ref == 2:
                                    fi.num_ref += 1
                                    fi.ref_array.append(0)
                                fi.interp_ref = p.interp_ref
                                fi.ref_array[1] = min(
                                    num_encoded - 1,
                                    coded_phase -
                                    dcm[display_phase - ref_offset + 1] - 1)
                                fi.ref_array[2] = min(
                                    num_encoded - 1,
                                    coded_phase -
                                    dcm[display_phase + ref_offset + 1] - 1)
                                fi.ref_array[0] = -1
                                interp_spec = (fi.ref_array[1],
                                               fi.ref_array[2], 2, 1)
                                interpolate(enc.ref[fi.ref_array[1]],
                                            enc.ref[fi.ref_array[2]], 2, 1)
                                for r in range(3, fi.num_ref):
                                    fi.ref_array[r] = r - 3
                            else:
                                fi.ref_array[0] = min(
                                    num_encoded - 1,
                                    coded_phase -
                                    dcm[display_phase - ref_offset + 1] - 1)
                                fi.ref_array[1] = min(
                                    num_encoded - 1,
                                    coded_phase -
                                    dcm[display_phase + ref_offset + 1] - 1)
                                for r in range(2, fi.num_ref):
                                    fi.ref_array[r] = r - 2
                    else:
                        if (num_encoded - 1) % sub_gop == 0:
                            fi.ref_array[0] = (0 if num_encoded == 1
                                               else sub_gop - 1)
                            if fi.num_ref > 1:
                                fi.ref_array[1] = min(
                                    MAX_REF_FRAMES - 1,
                                    min(num_encoded - 1, 2 * sub_gop - 1))
                            for r in range(2, fi.num_ref):
                                fi.ref_array[r] = r - 1
                        else:
                            phase = (num_encoded + sub_gop - 2) % sub_gop
                            if p.interp_ref == 1:
                                if fi.num_ref == 2:
                                    fi.num_ref += 1
                                    fi.ref_array.append(0)
                                fi.interp_ref = p.interp_ref
                                if fi.num_ref > 0:
                                    fi.ref_array[1] = 0
                                if fi.num_ref > 1:
                                    fi.ref_array[2] = (
                                        min(sub_gop, num_encoded - 1)
                                        if phase == 0 else
                                        min(phase, num_encoded - 1))
                                fi.ref_array[0] = -1
                                interp_spec = (
                                    fi.ref_array[1], fi.ref_array[2],
                                    sub_gop - phase,
                                    1 if phase != 0 else sub_gop - phase - 1)
                                interpolate(enc.ref[fi.ref_array[1]],
                                            enc.ref[fi.ref_array[2]],
                                            *interp_spec[2:])
                                if fi.num_ref > 2:
                                    fi.ref_array[3] = min(
                                        phase + sub_gop if phase
                                        else 2 * sub_gop, num_encoded - 1)
                                for r in range(4, fi.num_ref):
                                    fi.ref_array[r] = r - 4 + 1
                            else:
                                if fi.num_ref > 0:
                                    fi.ref_array[0] = 0
                                if fi.num_ref > 1:
                                    fi.ref_array[1] = (
                                        min(sub_gop, num_encoded - 1)
                                        if phase == 0 else
                                        min(phase, num_encoded - 1))
                                if fi.num_ref > 2:
                                    fi.ref_array[2] = min(
                                        phase + sub_gop if phase
                                        else 2 * sub_gop, num_encoded - 1)
                                for r in range(3, fi.num_ref):
                                    fi.ref_array[r] = r - 3 + 1
                    if (p.num_reorder_pics == 2 and
                            fi.frame_type == B_FRAME and fi.b_level == 0):
                        off = 1 if p.interp_ref == 1 else 0
                        (fi.ref_array[0 + off], fi.ref_array[1 + off]) = (
                            fi.ref_array[1 + off], fi.ref_array[0 + off])
                else:
                    fi.ref_array[0] = last_PorI
                    if fi.num_ref == 2:
                        r1 = ((num_encoded + p.HQperiod - 2) %
                              p.HQperiod) + 1
                        fi.ref_array[1] = r1
                    elif fi.num_ref == 3:
                        r1 = ((num_encoded + p.HQperiod - 2) %
                              p.HQperiod) + 1
                        r2 = 2 if r1 == 1 else 1
                        fi.ref_array[1] = r1
                        fi.ref_array[2] = r2
                    elif fi.num_ref == 4:
                        r1 = ((num_encoded + p.HQperiod - 2) %
                              p.HQperiod) + 1
                        r2 = 2 if r1 == 1 else 1
                        r3 = r2 + 1
                        if r3 == r1:
                            r3 += 1
                        fi.ref_array[1:4] = [r1, r2, r3]
                    else:
                        for r in range(1, fi.num_ref):
                            fi.ref_array[r] = r

            # dedup refs (enc/mainenc.c:489-502)
            r = fi.num_ref - 1
            while r > 0:
                if fi.ref_array[r] in fi.ref_array[:r]:
                    del fi.ref_array[r]
                    fi.num_ref -= 1
                r -= 1
            # drop refs breaking random access (enc/mainenc.c:504-518)
            if fi.frame_num > last_intra_frame_num:
                for r in range(fi.num_ref - 1, -1, -1):
                    if fi.ref_array[r] >= 0:
                        rfn = enc.ref[fi.ref_array[r]].frame_num
                        if rfn < last_intra_frame_num:
                            del fi.ref_array[r]
                            fi.num_ref -= 1

            if (p.intra_rdo == 0 or
                    (fi.frame_type != I_FRAME and p.encoder_speed > 0)):
                fi.num_intra_modes = 4
            else:
                fi.num_intra_modes = 10

            if schedule_only:
                # record the coding schedule; shift the reference window
                # metadata only (no pixels, no bits)
                rfn = [enc.ref[r].frame_num if 0 <= r < len(enc.ref)
                       else None for r in fi.ref_array]
                schedule.append({
                    "frame_num": fi.frame_num,
                    "orig_offset": frame_num * (frame_size +
                                                p.frame_headerlen) +
                    p.file_headerlen + p.frame_headerlen,
                    "frame_type": fi.frame_type,
                    "b_level": fi.b_level,
                    "phase": fi.phase,
                    "qp": fi.qp,
                    "num_ref": fi.num_ref,
                    "ref_array": list(fi.ref_array),
                    "ref_frame_nums": rfn,
                    "interp_ref": fi.interp_ref,
                    "interp_spec": interp_spec,
                    "num_intra_modes": fi.num_intra_modes,
                })
                num_encoded += 1
                tmp = enc.ref[MAX_REF_FRAMES - 1]
                enc.ref[1:] = enc.ref[:-1]
                enc.ref[0] = tmp
                enc.ref[0].frame_num = fi.frame_num
                last_PorI = (0 if fi.frame_type != B_FRAME
                             else last_PorI + 1)
                continue

            enc.orig.read_from(
                yuv, frame_num * (frame_size + p.frame_headerlen) +
                p.file_headerlen + p.frame_headerlen)
            enc.orig.frame_num = fi.frame_num

            # window state as used for this frame (the shift at the end of
            # encode_frame would otherwise show the just-coded frame)
            rfn = [enc.ref[r].frame_num if 0 <= r < len(enc.ref)
                   else None for r in fi.ref_array]
            start_bits = enc.writer.get_bit_pos()
            with TR.span("enc.frame"):
                enc.encode_frame()
            end_bits = enc.writer.get_bit_pos()
            num_encoded += 1
            out += enc.writer.flush_frame()
            recon[fi.frame_num] = enc.rec.to_bytes()
            if progress:
                # per-frame stats mirroring enc/mainenc.c:547-592
                progress(frame_num, fi.frame_type, {
                    "qp": fi.qp, "bits": end_bits - start_bits,
                    "num_ref": fi.num_ref,
                    "ref_array": list(fi.ref_array[:fi.num_ref]),
                    "ref_frame_nums": rfn,
                    "rec": recon[fi.frame_num],
                    "orig_frame": fi.frame_num + p.skip,
                })
            last_PorI = 0 if fi.frame_type != B_FRAME else last_PorI + 1
        if (((frame_num0 + sub_gop + 1) * frame_size > input_size or
             frame_num0 + sub_gop >= p.skip + p.num_frames) and
                sub_gop >= 2):
            sub_gop_prev = sub_gop
            p.HQperiod = sub_gop
            sub_gop = 1
            p.num_reorder_pics = 0
            if schedule_only:
                schedule.append({"transition": sub_gop_prev})
        frame_num0 += sub_gop

    if schedule_only:
        return schedule
    return bytes(out), b"".join(recon[k] for k in sorted(recon))
