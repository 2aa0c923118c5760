"""Thor encoder of the port: the turbo encoder's frame loop (torch port
of the turbo path of thor_tpu/enc/encoder.py).

Mirrors enc/mainenc.c (sequence loop, GOP, refs) and enc/encode_frame.c
(frame drive, in-loop filter RDO).  The frame scheduling of `encode_sequence`
(frame types, QP ladder, reference windows, temporal interpolation) is
thor_tpu's, verbatim; each frame is decided and finalized by the turbo
encoder (enc/turbo.py, enc/turbo_final.py) on the encoder's torch device,
and the filter tail (deblock, CDEF search and application, CLPF RDO)
runs its pixel passes there too.

The port runs turbo only.  thor_tpu's exact (host RDO) encoder, its
wavefront device encoder (`device_enc`), rate control and the GOP lanes
are not ported: `turbo != 1` or `device_enc == 1` raise
NotImplementedError (ROADMAP.md item 11), and a frame that turbo does
not support (`turbo.turbo_reject_reason`) raises ValueError with the
reason, where thor_tpu falls back to its host RDO.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..bitstream import BitWriter
from ..frame import YuvFrame, new_ref_frame
from ..tables import (CHROMA_QP, MAX_REF_FRAMES, MAX_REORDER_BUFFER,
                      MIN_PB_SIZE, log2i)
from ..spec import inter
from ..spec.tempinterp import store_mv
from ..spec import filters
from ..ops import filters as OF
from ..dec.decoder import find_block_contexts, resolve_device
from . import writer as W
from . import filters_rdo as FR
from . import turbo
from .params import EncParams

I_FRAME, P_FRAME, B_FRAME = 0, 1, 2
MODE_SKIP, MODE_INTER = 0, 2

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

NOT_PORTED = ("thor_tpu_torch encodes with the turbo encoder only "
              "(-turbo 1); the exact host-RDO encoder and the wavefront "
              "device encoder (-device_enc 1) are not ported (ROADMAP.md "
              "Queue 1, item 11)")


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
    # every frame is a turbo frame: the CDEF anti-shrink guard of
    # filters_rdo._cdef_pick_and_emit always applies (turbo streams must
    # always decode; see the comment there)
    _turbo_frame = True

    def __init__(self, params: EncParams, device):
        self.params = params.validate()
        p = self.params
        if p.turbo != 1 or p.device_enc == 1:
            raise NotImplementedError(NOT_PORTED)
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
        self.cdef_damping = 5
        self.cdef_bits = 0
        self.cdef_strengths = [127] * 8
        self.cdef_uv_strengths = [127] * 8
        self.cdef_header_pos = None
        self.cdef_sel = {}
        self.cdef_dirs = {}
        self.wmatrix = self.iwmatrix = None
        if p.qmtx:
            from ..qmtx import get_wmatrices, get_iwmatrices
            self.wmatrix = get_wmatrices()
            self.iwmatrix = get_iwmatrices()
        # device-resident reference ring: frame_num -> padded int16
        # (y, u, v) device planes
        self._dev_refs = OrderedDict()

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

    def _find_block_context(self, ypos, xpos, size):
        return find_block_contexts(ypos, xpos, self.height, self.width,
                                   size, self.dd,
                                   self.params.use_block_contexts)

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
        """enc/encode_frame.c:637-850, the turbo branch."""
        p = self.params
        fi = self.fi
        w = self.writer

        reason = turbo.turbo_reject_reason(self)
        if reason is not None:
            raise ValueError(
                f"thor_tpu_torch: the turbo encoder does not support this "
                f"frame (rejecting parameter: {reason}), and the port has "
                f"no host-RDO encoder to fall back to (ROADMAP.md item 11)")
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
        turbo.encode_frame_turbo(self)
        return self._encode_frame_tail(qp)

    def _encode_frame_tail(self, qp):
        """Post-SB-loop frame work: in-loop filters and the reference
        window (enc/encode_frame.c:760-850)."""
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

        # reference sliding window
        tmp = self.ref[MAX_REF_FRAMES - 1]
        self.ref[1:] = self.ref[:-1]
        self.ref[0] = tmp
        self.ref[0].copy_from(self.rec)
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


def encode_sequence(params: EncParams, yuv: bytes, progress=None,
                    device=None):
    """The sequence loop (enc/mainenc.c:79-704) with the turbo encoder.
    Returns (bitstream bytes, recon bytes in display order).

    Encodes on `device`: CUDA by default, the CPU only when the caller
    asks for it (dec/decoder.py:resolve_device).  Raises
    NotImplementedError for parameters that need thor_tpu's exact
    encoder (`turbo != 1`, `device_enc == 1`) and ValueError for a frame
    the turbo encoder does not support."""
    p = params
    enc = Encoder(p, resolve_device(device))
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
        from ..ops.tempinterp import interpolate_frames
        interpolate_frames(enc.interp_frames[0], ref1, ref2, ratio, pos,
                           device=enc.device)
        enc.interp_frames[0].pad_frame()
        enc.interp_frames[0].frame_num = fi.frame_num

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
                                interpolate(enc.ref[fi.ref_array[1]],
                                            enc.ref[fi.ref_array[2]],
                                            sub_gop - phase,
                                            1 if phase != 0 else
                                            sub_gop - phase - 1)
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

            enc.orig.read_from(
                yuv, frame_num * (frame_size + p.frame_headerlen) +
                p.file_headerlen + p.frame_headerlen)
            enc.orig.frame_num = fi.frame_num

            # window state as used for this frame (the shift at the end of
            # encode_frame would otherwise show the just-coded frame)
            rfn = [enc.ref[r].frame_num if 0 <= r < len(enc.ref)
                   else None for r in fi.ref_array]
            start_bits = enc.writer.get_bit_pos()
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
            p.HQperiod = sub_gop
            sub_gop = 1
            p.num_reorder_pics = 0
        frame_num0 += sub_gop

    return bytes(out), b"".join(recon[k] for k in sorted(recon))
