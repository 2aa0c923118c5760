"""Thor bitstream decoder of the port: thor_tpu/dec/decoder.py with a
torch device tier.

Mirrors the reference decoder: dec/maindec.c (driver), dec/decode_frame.c,
dec/decode_block.c, dec/read_bits.c.  The headers, the Python syntax walk
(`decode_super_mode` .. `process_block`), the host pixel functions over
the port's spec/ and the bit accounting are copied from thor_tpu's
decoder as written; the copy differs in its imports (the port's own
tables, spec, native parser and device modules), in `read_coeff` (the
coefficient scan always goes through the port's C library, which the
loader builds or raises), in `Decoder.__init__` (an explicit device, no
JAX backend probe, no environment switches), in `decode_frame` and
`_loop_filters_device` (torch tensors on the decoder's device) and in
`decode_stream` (the `device` and `fused` arguments).

A frame takes one of four routes, chosen by what the stream needs, as in
thor_tpu (`ROUTE_FRAMES` counts them):
  fused         the native parse, then `DeviceFrameDecoder` (pixels, loop
                filters and their stream reads on the device): 4:2:0
                without cfl_inter and without tb-split intra;
  two_stage     the native parse of a P or B frame with tb-split intra
                (4:2:0, no cfl_inter, no qmtx): `device_pixels.execute`
                decodes the inter cells on the device (or the callable in
                `Decoder.plan_executor`, where a multi-stream decode
                attaches its batched executor), then the intra blocks
                replay on the host;
  host_records  every other natively parsed frame (4:4:4, mono,
                cfl_inter, I frames and qmtx frames with tb-split intra):
                the block records execute on the host over spec/;
  python_walk   a frame whose records the native parser's buffers cannot
                hold: `process_block` per superblock, pixels as above.
The last three then run the loop filters unfused: stream reads and masks
on the host, `ops/filters.py:filters_exec` on the device.  `fused=False`
sends every frame past the first route.  The host numpy of the last two
routes is the reference decoder's own design (sequential intra
dependencies, the streams the dense device passes do not cover), not a
fallback from a device failure: nothing here leaves the device unasked,
and a kernel that does not build or launch raises.  thor_tpu's numpy loop
filters (`_loop_filters_spec`, `_apply_cdef`), which it falls back to
when no JAX backend starts, have no counterpart.
"""
from __future__ import annotations

import ctypes
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import _native
from ..bitstream import BitReader, FrameUnitReader
from ..frame import YuvFrame, new_ref_frame
from ..tables import (CHROMA_QP, MAX_REF_FRAMES, MAX_REORDER_BUFFER,
                      MIN_PB_SIZE, MIN_BLOCK_SIZE, MAX_QUANT_SIZE, ZIGZAG,
                      log2i, qp_to_qlevel)
from ..qmtx import get_iwmatrices
from ..spec import inter, intra, filters
from ..spec.transform_quant import dequantize, transform_inv, reconstruct_block
from ..spec.cfl import improve_uv_prediction
from ..spec.tempinterp import store_mv
from ..ops import filters as OF
from ..ops.tempinterp import interpolate_frames
from .device_frame import DeviceFrameDecoder
from . import device_pixels as DP
from . import native_parse as NP

I_FRAME, P_FRAME, B_FRAME = 0, 1, 2
MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED, MODE_MERGE = 0, 1, 2, 3, 4
# stat_mode_t (common/types.h:113-123)
(STAT_SKIP, STAT_SPLIT, STAT_REF_IDX0, STAT_MERGE, STAT_BIPRED,
 STAT_INTRA, STAT_REF_IDX1) = range(7)

# frames decoded by each route since the counts were last set to 0 (plain
# integers; chip_smoke.py and the tests read and reset them)
ROUTE_FRAMES = {"fused": 0, "two_stage": 0, "host_records": 0,
                "python_walk": 0}


class BitCount:
    """Decoder bit-accounting (bit_count_t), filled at the same syntax
    boundaries as the reference (dec/read_bits.c, decode_block.c,
    decode_frame.c) so the BIT/PARAMETER STATISTICS reports match."""

    def __init__(self):
        def z3():
            return [0, 0, 0]
        self.sequence_header = 0
        self.frame_header = z3()
        self.frame_type = z3()
        self.super_mode = z3()
        self.intra_mode = z3()
        self.mv = z3()
        self.skip_idx = z3()
        self.coeff_y = z3()
        self.coeff_u = z3()
        self.coeff_v = z3()
        self.cbp = z3()
        self.clpf = z3()  # never incremented by the reference decoder
        self.mode = [[0] * 5 for _ in range(3)]
        self.size = [[0] * 5 for _ in range(3)]
        self.size_and_mode = [[[0] * 5 for _ in range(5)] for _ in range(3)]
        self.super_mode_stat = [[[0] * 9 for _ in range(5)]
                                for _ in range(3)]
        self.size_and_ref_idx = [[[0] * 4 for _ in range(5)]
                                 for _ in range(3)]
        self.bi_ref = [[0] * 16 for _ in range(3)]


@dataclass
class SequenceHeader:
    """dec/read_bits.c:49-82."""
    width: int = 0
    height: int = 0
    log2_sb_size: int = 7
    pb_split: int = 0
    tb_split_enable: int = 0
    max_num_ref: int = 1
    interp_ref: int = 0
    max_delta_qp: int = 0
    deblocking: int = 1
    clpf: int = 0
    use_block_contexts: int = 0
    bipred: int = 0
    qmtx: int = 0
    qmtx_offset: int = 0
    subsample: int = 420
    num_reorder_pics: int = 0
    cfl_intra: int = 0
    cfl_inter: int = 0
    bitdepth: int = 8
    input_bitdepth: int = 8

    @classmethod
    def read(cls, s: BitReader) -> "SequenceHeader":
        h = cls()
        h.width = s.get_flc(16)
        h.height = s.get_flc(16)
        h.log2_sb_size = min(max(s.get_flc(3), 3), 7)
        h.pb_split = s.get_flc(1)
        h.tb_split_enable = s.get_flc(1)
        h.max_num_ref = s.get_flc(2) + 1
        h.interp_ref = s.get_flc(2)
        h.max_delta_qp = s.get_flc(1)
        h.deblocking = s.get_flc(1)
        h.clpf = s.get_flc(1)
        h.use_block_contexts = s.get_flc(1)
        h.bipred = s.get_flc(2)
        h.qmtx = s.get_flc(1)
        if h.qmtx:
            h.qmtx_offset = s.get_flc(6) - 32
        ss = s.get_flc(2)
        h.subsample = (ss & 1) * 20 + (ss & 2) * 22 + ((ss & 3) == 3) * 2 + 400
        h.num_reorder_pics = s.get_flc(4)
        if h.subsample != 400:
            h.cfl_intra = s.get_flc(1)
            h.cfl_inter = s.get_flc(1)
        h.bitdepth = 10 if s.get_flc(1) else 8
        if h.bitdepth == 10:
            h.bitdepth += 2 * s.get_flc(1)
        h.input_bitdepth = 10 if s.get_flc(1) else 8
        if h.input_bitdepth == 10:
            h.input_bitdepth += 2 * s.get_flc(1)
        return h


@dataclass
class FrameInfo:
    frame_type: int = I_FRAME
    qp: int = 32
    qpb: int = 32
    num_intra_modes: int = 4
    num_ref: int = 0
    ref_array: list = field(default_factory=list)
    display_frame_num: int = 0
    decode_order_frame_num: int = 0
    interp_ref: int = 0
    phase: int = 0


def read_frame_header(h: SequenceHeader, s: BitReader, fi: FrameInfo, dec):
    """dec/read_bits.c:84-119."""
    fi.frame_type = s.get_flc(1)
    fi.qp = s.get_flc(8)
    fi.num_intra_modes = s.get_flc(4)
    if fi.frame_type != I_FRAME:
        fi.num_ref = s.get_flc(2) + 1
        fi.ref_array = [s.get_flc(6) - 1 for _ in range(fi.num_ref)]
        if fi.num_ref == 2 and fi.ref_array[0] == -1:
            fi.ref_array.append(s.get_flc(5) - 1)
            fi.num_ref += 1
    else:
        fi.num_ref = 0
        fi.ref_array = []
    fi.display_frame_num = s.get_flc(16)
    # CDEF params
    dec.cdef_damping = s.get_flc(2) + 3
    dec.cdef_bits = s.get_flc(2)
    dec.cdef_presets = []
    for _ in range(1 << dec.cdef_bits):
        p = {}
        p["pri_strength0"] = s.get_flc(4)
        p["skip_condition0"] = s.get_flc(1)
        p["sec_strength0"] = s.get_flc(2)
        if h.subsample != 400:
            p["pri_strength1"] = s.get_flc(4)
            p["skip_condition1"] = s.get_flc(1)
            p["sec_strength1"] = s.get_flc(2)
        dec.cdef_presets.append(p)


def read_mv(s: BitReader, mvp):
    """dec/read_bits.c:122-138. Returns (y,x)."""
    mvabs = s.get_vlc(7)
    mvsign = s.get_flc(1) if mvabs else 0
    dx = -mvabs if mvsign else mvabs
    mvabs = s.get_vlc(7)
    if mvabs:
        mvsign = s.get_flc(1)
    dy = -mvabs if mvsign else mvabs
    return (mvp[0] + dy, mvp[1] + dx)



def read_coeff(s: BitReader, size: int, ctype: int) -> np.ndarray:
    """Zigzag run/level coefficient decode (dec/read_bits.c:142-241)
    through the C library's scan.  Returns (size,size) int16 (only
    top-left qsize x qsize populated)."""
    qsize = min(size, MAX_QUANT_SIZE)
    br = _native.BrStruct(s.data, len(s.data), s.bitpos)
    # 512 entries: run-mode may land past N on valid streams (the
    # reference absorbs this in a 256-entry scratch, read_bits.c:144)
    sco = np.zeros(512, np.int16)
    _native.get_lib().read_coeff_scan(
        ctypes.byref(br), sco.ctypes.data_as(ctypes.c_void_p), qsize, ctype)
    s.bitcnt += br.bitpos - s.bitpos
    s.bitpos = br.bitpos
    if br.bitpos > (len(s.data) << 3) + 64:  # same rule as BitReader
        raise EOFError(
            "bitstream overrun in coefficient scan: bit %d of a "
            "%d-byte unit" % (br.bitpos, len(s.data)))
    out = np.zeros((size, size), np.int16)
    out[:qsize, :qsize] = sco[ZIGZAG[qsize]].reshape(qsize, qsize)
    return out


def find_block_contexts(ypos, xpos, height, width, size, dd, enable):
    """common/common_block.c:283-303. Returns (split, cbp, index)."""
    if (ypos >= MIN_BLOCK_SIZE and xpos >= MIN_BLOCK_SIZE and
            ypos + size < height and xpos + size < width and enable and
            size <= 128):
        by = ypos // MIN_PB_SIZE
        bx = xpos // MIN_PB_SIZE
        bs = dd.bs
        bi = by * bs + bx
        split = int(dd.size[bi - bs] < size) + int(dd.size[bi - 1] < size)
        cbp1 = int(dd.cbp_y[bi - bs] > 0) + int(dd.cbp_y[bi - 1] > 0)
        cbp2 = (int(dd.cbp_y[bi - bs] > 0 or dd.cbp_u[bi - bs] > 0 or
                    dd.cbp_v[bi - bs] > 0) +
                int(dd.cbp_y[bi - 1] > 0 or dd.cbp_u[bi - 1] > 0 or
                    dd.cbp_v[bi - 1] > 0))
        return split, cbp1, 3 * split + cbp2
    return -1, -1, -1


class Decoder:
    def __init__(self, header: SequenceHeader, device, fused: bool = True):
        self.h = header
        h = header
        self.width, self.height = h.width, h.height
        self.rec_buf = [YuvFrame(h.width, h.height, h.subsample, 0,
                                 h.bitdepth, h.input_bitdepth)
                        for _ in range(MAX_REORDER_BUFFER + 1)]
        self.ref = [new_ref_frame(h.width, h.height, h.subsample,
                                  h.bitdepth, h.input_bitdepth)
                    for _ in range(MAX_REF_FRAMES)]
        self.interp_frames = [new_ref_frame(h.width, h.height, h.subsample,
                                            h.bitdepth, h.input_bitdepth)
                              for _ in range(1 if h.interp_ref else 0)]
        self.dd = inter.DeblockData(h.width, h.height)
        self.fi = FrameInfo()
        self.cdef_damping = 3
        self.cdef_bits = 0
        self.cdef_presets = []
        self.iwmatrix = get_iwmatrices() if h.qmtx else None
        self.rec: YuvFrame | None = None
        self.sub = 1 if h.subsample == 420 else 0
        self.mono = h.subsample == 400
        self.stat_frame_type = I_FRAME
        self.bc = BitCount()
        self.device = torch.device(device)
        # Fully-resident fused frame decoder (dec/device_frame.py): one
        # dispatch + one pull per frame, refs resident on the device.
        # `fused=False` keeps every frame off it (the two-stage executor
        # or the host records, then the unfused loop filters).
        self.fused = fused
        self._device_frame = DeviceFrameDecoder(self.device)
        # executor of a two-stage frame's device half; None means
        # device_pixels.execute
        self.plan_executor = None
        self._plan = None
        self._plan_slots = None
        self._plan_refs = None

    # ----- super mode -----
    def decode_super_mode(self, s: BitReader, size, decode_this_size, ctx_index):
        """dec/decode_block.c:458-611. Returns (split_flag, mode, ref_idx)."""
        fi = self.fi
        if fi.frame_type == I_FRAME:
            if size > MIN_BLOCK_SIZE and decode_this_size:
                split = s.get_flc(1)
            else:
                split = int(not decode_this_size)
            return split, MODE_INTRA, 0
        if not decode_this_size:
            return int(not s.get_flc(1)), MODE_SKIP, 0
        if size > 128:
            split = int(not s.get_flc(1))
            return split, MODE_SKIP, 0

        num_ref = fi.num_ref
        bipred_possible = int(num_ref > 1 and self.h.bipred)
        split_possible = int(size > MIN_BLOCK_SIZE)
        maxbit = 2 + num_ref + split_possible + bipred_possible
        interp_ref = fi.interp_ref
        if interp_ref > 2:
            maxbit -= 1
        code = s.get_vlc(10 + maxbit)

        # statistics (decode_block.c:516,565,608)
        sms = self.bc.super_mode_stat[self.stat_frame_type][log2i(size) - 3]

        if interp_ref:
            if (ctx_index == 2 or ctx_index > 3) and size > MIN_BLOCK_SIZE:
                if code < 3:
                    code = (code + 1) % 3
            if split_possible and code == 1:
                sms[STAT_SPLIT] += 1
                return 1, MODE_SKIP, 0
            if not split_possible and code > 0:
                code += 1
            if not bipred_possible and code >= 3:
                code += 1
            if code == 0:
                sms[STAT_SKIP] += 1
                return 0, MODE_SKIP, 0
            if code == 2:
                sms[STAT_MERGE] += 1
                return 0, MODE_MERGE, 0
            if code == 3:
                sms[STAT_BIPRED] += 1
                return 0, MODE_BIPRED, 0
            if code == 4:
                sms[STAT_INTRA] += 1
                return 0, MODE_INTRA, 0
            if code == 4 + num_ref:
                sms[STAT_REF_IDX0] += 1
                return 0, MODE_INTER, 0
            sms[STAT_REF_IDX1 + code - 5] += 1
            return 0, MODE_INTER, code - 4
        else:
            if (ctx_index == 2 or ctx_index > 3) and size > MIN_BLOCK_SIZE:
                if code < 4:
                    code = (code + 1) % 4
            if split_possible and code == 1:
                sms[STAT_SPLIT] += 1
                return 1, MODE_SKIP, 0
            if not split_possible and code > 0:
                code += 1
            if not bipred_possible and code >= 4:
                code += 1
            if code == 0:
                sms[STAT_SKIP] += 1
                return 0, MODE_SKIP, 0
            if code == 2:
                sms[STAT_REF_IDX0] += 1
                return 0, MODE_INTER, 0
            if code == 3:
                sms[STAT_MERGE] += 1
                return 0, MODE_MERGE, 0
            if code == 4:
                sms[STAT_BIPRED] += 1
                return 0, MODE_BIPRED, 0
            if code == 5:
                sms[STAT_INTRA] += 1
                return 0, MODE_INTRA, 0
            sms[STAT_REF_IDX1 + code - 6] += 1
            return 0, MODE_INTER, code - 5

    # ----- block syntax (dec/read_bits.c:252-773) -----
    def read_block(self, s: BitReader, size, ypos, xpos, mode, ref_idx, ctx_cbp):
        h = self.h
        fi = self.fi
        sizeY = size
        sizeC = size >> self.sub if not self.mono else 0
        bp = {"mode": mode, "tb_split": 0, "pb_part": 0, "intra_mode": 0,
              "skip_idx": 0, "ref_idx0": 0, "ref_idx1": 0, "dir": 0,
              "mv_arr0": [(0, 0)] * 4, "mv_arr1": [(0, 0)] * 4,
              "cbp": (0, 0, 0)}
        coeffs = {"y": None, "u": None, "v": None}
        sb_size = 1 << h.log2_sb_size
        bc = self.bc
        ft = self.stat_frame_type
        bit_start = s.bitcnt  # read_bits.c:292

        if mode in (MODE_SKIP, MODE_MERGE):
            cands = inter.get_mv_skip(ypos, xpos, self.width, self.height,
                                      size, size, sb_size, self.dd)
            if (mode == MODE_SKIP and self.stat_frame_type == B_FRAME and
                    h.interp_ref == 2):
                cands = self.get_mv_skip_temp(ypos, xpos, size, cands)
            num = len(cands)
            if num == 4:
                skip_idx = s.get_flc(2)
            elif num == 3:
                skip_idx = s.get_vlc(12)
            elif num == 2:
                skip_idx = s.get_flc(1)
            else:
                skip_idx = 0
            bc.skip_idx[ft] += s.bitcnt - bit_start
            c = cands[0] if skip_idx == num else cands[skip_idx]
            bp["skip_idx"] = skip_idx
            bp["ref_idx0"], bp["ref_idx1"] = c[4], c[5]
            bp["dir"] = c[6]
            bp["mv_arr0"] = [(c[0], c[1])] * 4
            bp["mv_arr1"] = [(c[2], c[3])] * 4
        elif mode == MODE_INTER:
            pb_part = s.get_vlc(13) if h.pb_split else 0
            bp["pb_part"] = pb_part
            bc.size_and_ref_idx[ft][log2i(size) - 3][ref_idx] += 1
            mvp = inter.get_mv_pred(ypos, xpos, self.width, self.height,
                                    size, size, sb_size, self.dd)
            mv = [None] * 4
            mvp2 = mvp
            if pb_part == 0:
                mv[0] = read_mv(s, mvp2)
                mv[1] = mv[2] = mv[3] = mv[0]
            elif pb_part == 1:  # HOR
                mv[0] = read_mv(s, mvp2)
                mv[2] = read_mv(s, mv[0])
                mv[1], mv[3] = mv[0], mv[2]
            elif pb_part == 2:  # VER
                mv[0] = read_mv(s, mvp2)
                mv[1] = read_mv(s, mv[0])
                mv[2], mv[3] = mv[0], mv[1]
            else:
                mv[0] = read_mv(s, mvp2)
                mv[1] = read_mv(s, mv[0])
                mv[2] = read_mv(s, mv[0])
                mv[3] = read_mv(s, mv[0])
            bp["mv_arr0"] = mv
            bp["mv_arr1"] = list(mv)
            bc.mv[ft] += s.bitcnt - bit_start
            bp["ref_idx0"] = bp["ref_idx1"] = ref_idx
            bp["dir"] = 0
        elif mode == MODE_BIPRED:
            mvp = inter.get_mv_pred(ypos, xpos, self.width, self.height,
                                    size, size, sb_size, self.dd)
            mvp2 = mvp
            mv0 = [read_mv(s, mvp2)] * 4
            bp["mv_arr0"] = mv0
            if self.stat_frame_type == B_FRAME:
                mvp2 = mv0[0]
            mv1 = [read_mv(s, mvp2)] * 4
            bp["mv_arr1"] = mv1
            if self.stat_frame_type == B_FRAME:
                r0, r1 = 0, 1
                if fi.interp_ref > 0:
                    r0, r1 = 1, 2
                bp["ref_idx0"], bp["ref_idx1"] = r0, r1
            else:
                if fi.num_ref == 2:
                    code = s.get_vlc(13)
                    bp["ref_idx0"] = (code >> 1) & 1
                    bp["ref_idx1"] = code & 1
                else:
                    code = s.get_vlc(10)
                    bp["ref_idx0"] = (code >> 2) & 3
                    bp["ref_idx1"] = code & 3
            bp["dir"] = 2
            combined = bp["ref_idx0"] * fi.num_ref + bp["ref_idx1"]
            bc.bi_ref[ft][combined] += 1
            bc.mv[ft] += s.bitcnt - bit_start
        elif mode == MODE_INTRA:
            if fi.num_intra_modes <= 4:
                bp["intra_mode"] = s.get_flc(2)
            else:
                bp["intra_mode"] = s.get_vlc(8)
            bc.intra_mode[ft] += s.bitcnt - bit_start
            bp["dir"] = -1

        # cbp / tb_split / coefficients
        if mode != MODE_SKIP:
            ctype = (int(mode == MODE_INTRA) << 1)
            cbp_table = [1, 0, 5, 2, 6, 3, 7, 4]
            if self.mono:
                tb_split = 0
                cbpy = s.get_flc(1)
                if h.tb_split_enable and cbpy:
                    tb_split = s.get_flc(1)
                    cbpy &= int(not tb_split)
                cbp = (cbpy, 0, 0)
                code = 0
            else:
                bit_start = s.bitcnt  # read_bits.c:563
                code = s.get_vlc(0)
                off = 1 if mode == MODE_MERGE else 2
                if h.tb_split_enable:
                    tb_split = int(code == off)
                    if code > off:
                        code -= 1
                else:
                    tb_split = 0
            bp["tb_split"] = tb_split
            # mono keeps bit_start from block entry (read_bits.c:577 quirk:
            # the 400-path never resets it, double-counting mode bits)
            bc.cbp[ft] += s.bitcnt - bit_start
            if tb_split == 0:
                if not self.mono:
                    if mode == MODE_MERGE:
                        if code == 7:
                            code = 1
                        elif code > 0:
                            code = code + 1
                    else:
                        if ctx_cbp == 0 and code < 2:
                            code = 1 - code
                    tmp = 0
                    while tmp < 8 and code != cbp_table[tmp]:
                        tmp += 1
                    cbp = (tmp & 1, (tmp >> 1) & 1, (tmp >> 2) & 1)
                bp["cbp"] = cbp
                if cbp[0]:
                    bit_start = s.bitcnt
                    coeffs["y"] = read_coeff(s, sizeY, ctype | 0)
                    bc.coeff_y[ft] += s.bitcnt - bit_start
                else:
                    coeffs["y"] = np.zeros((sizeY, sizeY), np.int16)
                if not self.mono:
                    if cbp[1]:
                        bit_start = s.bitcnt
                        coeffs["u"] = read_coeff(s, sizeC, ctype | 1)
                        bc.coeff_u[ft] += s.bitcnt - bit_start
                    else:
                        coeffs["u"] = np.zeros((sizeC, sizeC), np.int16)
                    if cbp[2]:
                        bit_start = s.bitcnt
                        coeffs["v"] = read_coeff(s, sizeC, ctype | 1)
                        bc.coeff_v[ft] += s.bitcnt - bit_start
                    else:
                        coeffs["v"] = np.zeros((sizeC, sizeC), np.int16)
            else:
                # 4 sub-TUs
                if sizeC > 4:
                    ys = np.zeros((4, sizeY // 2, sizeY // 2), np.int16)
                    us = np.zeros((4, sizeC // 2, sizeC // 2), np.int16)
                    vs = np.zeros((4, sizeC // 2, sizeC // 2), np.int16)
                    for index in range(4):
                        bit_start = s.bitcnt
                        code = s.get_vlc(0)
                        tmp = 0
                        while code != cbp_table[tmp] and tmp < 8:
                            tmp += 1
                        if ctx_cbp == 0 and tmp < 2:
                            tmp = 1 - tmp
                        cy, cu, cv = tmp & 1, (tmp >> 1) & 1, (tmp >> 2) & 1
                        bc.cbp[ft] += s.bitcnt - bit_start
                        if cy:
                            bit_start = s.bitcnt
                            ys[index] = read_coeff(s, sizeY // 2, ctype | 0)
                            bc.coeff_y[ft] += s.bitcnt - bit_start
                        if cu:
                            bit_start = s.bitcnt
                            us[index] = read_coeff(s, sizeC // 2, ctype | 1)
                            bc.coeff_u[ft] += s.bitcnt - bit_start
                        if cv:
                            bit_start = s.bitcnt
                            vs[index] = read_coeff(s, sizeC // 2, ctype | 1)
                            bc.coeff_v[ft] += s.bitcnt - bit_start
                    coeffs["y"], coeffs["u"], coeffs["v"] = ys, us, vs
                else:
                    ys = np.zeros((4, sizeY // 2, sizeY // 2), np.int16)
                    for index in range(4):
                        bit_start = s.bitcnt
                        cy = s.get_flc(1)
                        bc.cbp[ft] += s.bitcnt - bit_start
                        if cy:
                            bit_start = s.bitcnt
                            ys[index] = read_coeff(s, sizeY // 2, ctype | 0)
                            bc.coeff_y[ft] += s.bitcnt - bit_start
                    coeffs["y"] = ys
                    if not self.mono:
                        bit_start = s.bitcnt
                        tmp = s.get_vlc(13)
                        cu, cv = tmp & 1, (tmp >> 1) & 1
                        bc.cbp[ft] += s.bitcnt - bit_start
                        if cu:
                            bit_start = s.bitcnt
                            coeffs["u"] = read_coeff(s, sizeC, ctype | 1)
                            bc.coeff_u[ft] += s.bitcnt - bit_start
                        else:
                            coeffs["u"] = np.zeros((sizeC, sizeC), np.int16)
                        if cv:
                            bit_start = s.bitcnt
                            coeffs["v"] = read_coeff(s, sizeC, ctype | 1)
                            bc.coeff_v[ft] += s.bitcnt - bit_start
                        else:
                            coeffs["v"] = np.zeros((sizeC, sizeC), np.int16)
                bp["cbp"] = (1, 1, 1)
        else:
            bp["cbp"] = (0, 0, 0)

        # mode / size statistics in 8x8-block units (read_bits.c:766-771)
        bwidth = min(size, self.width - xpos)
        bheight = min(size, self.height - ypos)
        n8 = (bwidth // MIN_BLOCK_SIZE) * (bheight // MIN_BLOCK_SIZE)
        bc.mode[ft][mode] += n8
        bc.size[ft][log2i(size) - 3] += n8
        bc.size_and_mode[ft][log2i(size) - 3][mode] += n8
        return bp, coeffs

    def get_mv_skip_temp(self, ypos, xpos, size, cands):
        """inter_prediction.c:836-881 (interp_ref=2 temporal candidates)."""
        gop = self.h.num_reorder_pics + 1
        phase = self.fi.phase
        dd = self.dd
        bw = min(size, self.width - xpos)
        bh = min(size, self.height - ypos)
        c0 = cands[0]
        duplicate = True
        for m in range(bh // MIN_PB_SIZE):
            for n in range(bw // MIN_PB_SIZE):
                bi = ((ypos // MIN_PB_SIZE + m) * dd.bs +
                      xpos // MIN_PB_SIZE + n)
                mv0 = (int(dd.arr_mv0[bi, phase, 0]), int(dd.arr_mv0[bi, phase, 1]))
                mv1 = mv0
                if gop == 3 and phase == 1:
                    mv1 = (mv1[0] * 2, mv1[1] * 2)
                if (mv0[0] != c0[0] or mv0[1] != c0[1] or mv1[0] != c0[2] or
                        mv1[1] != c0[3] or c0[4] != 0 or c0[5] != 1 or
                        c0[6] != 2):
                    duplicate = False
        new0 = (c0[0], c0[1], c0[2], c0[3], 0, 1, 2)
        if not duplicate:
            return [new0, c0]
        return [new0]

    # ----- block reconstruction -----
    def decode_block(self, s: BitReader, size, ypos, xpos, mode, ref_idx,
                     ctx_cbp):
        h = self.h
        fi = self.fi
        rec = self.rec
        sub = self.sub
        sizeY = size
        sizeC = size >> sub
        qpY = fi.qpb
        qpC = int(CHROMA_QP[qpY]) if sub else qpY
        bwidth = min(size, self.width - xpos)
        bheight = min(size, self.height - ypos)

        bp, coeffs = self.read_block(s, size, ypos, xpos, mode, ref_idx,
                                     ctx_cbp)
        mode = bp["mode"]

        if self._plan is not None:
            # device pixel pipeline: defer all pixel work (device_pixels)
            if mode == MODE_INTRA:
                self._plan.intra.append((size, ypos, xpos, bp, coeffs,
                                         qpY, qpC))
            else:
                DP.plan_block_mc(self._plan, self, bp, size, ypos, xpos,
                                 bwidth, bheight, self._plan_slots)
                if mode != MODE_SKIP:
                    self._plan_tbs(bp, coeffs, size, ypos, xpos, qpY, qpC)
            self._copy_deblock_data(bp, size, ypos, xpos, bwidth, bheight)
            return

        self._exec_block(bp, coeffs, size, ypos, xpos, qpY, qpC)
        self._copy_deblock_data(bp, size, ypos, xpos, bwidth, bheight)

    def _exec_block(self, bp, coeffs, size, ypos, xpos, qpY, qpC):
        """Pixel work for one parsed block (intra/inter prediction,
        dequant + itransform, reconstruct) - the body of decode_block
        with the syntax already consumed (native or Python walk)."""
        h = self.h
        rec = self.rec
        sub = self.sub
        sizeY = size
        sizeC = size >> sub
        bwidth = min(size, self.width - xpos)
        bheight = min(size, self.height - ypos)
        mode = bp["mode"]
        tb_split = bp["tb_split"]
        ql = qp_to_qlevel(qpY, h.qmtx_offset) if h.qmtx else 0

        def iwm(plane, intra_f):
            # per-size matrix list (C iwmatrix[ql][plane][intra]); dequant
            # sites index by log2(size/4)
            if not h.qmtx:
                return None
            return self.iwmatrix[ql][plane][intra_f]

        if mode == MODE_INTRA:
            self._intra_block(bp, coeffs, size, ypos, xpos, qpY, qpC, iwm)
        else:
            # inter prediction
            py, pu, pv = self._inter_pred(bp, size, ypos, xpos, bwidth,
                                          bheight)
            if mode == MODE_SKIP:
                rec.y[ypos:ypos + bheight, xpos:xpos + bwidth] = \
                    py[:bheight, :bwidth].astype(rec.dtype)
                if not self.mono:
                    bh2, bw2 = bheight >> sub, bwidth >> sub
                    rec.u[ypos >> sub:(ypos >> sub) + bh2,
                          xpos >> sub:(xpos >> sub) + bw2] = \
                        pu[:bh2, :bw2].astype(rec.dtype)
                    rec.v[ypos >> sub:(ypos >> sub) + bh2,
                          xpos >> sub:(xpos >> sub) + bw2] = \
                        pv[:bh2, :bw2].astype(rec.dtype)
                return
            # dequant + itransform + reconstruct
            ry = self._inter_residual(coeffs["y"], sizeY, qpY, tb_split,
                                      iwm(0, 0), h.bitdepth)
            rec.y[ypos:ypos + sizeY, xpos:xpos + sizeY] = \
                reconstruct_block(ry, py, h.bitdepth).astype(rec.dtype)
            if not self.mono:
                if h.cfl_inter:
                    improve_uv_prediction(
                        py, pu, pv,
                        rec.y[ypos:ypos + sizeY, xpos:xpos + sizeY]
                        .astype(np.int32),
                        sizeY, sub, h.bitdepth)
                yC, xC = ypos >> sub, xpos >> sub
                ru = self._inter_residual(coeffs["u"], sizeC, qpC,
                                          tb_split and sizeC > 4,
                                          iwm(1, 0), h.bitdepth)
                rec.u[yC:yC + sizeC, xC:xC + sizeC] = \
                    reconstruct_block(ru, pu, h.bitdepth).astype(rec.dtype)
                rv = self._inter_residual(coeffs["v"], sizeC, qpC,
                                          tb_split and sizeC > 4,
                                          iwm(2, 0), h.bitdepth)
                rec.v[yC:yC + sizeC, xC:xC + sizeC] = \
                    reconstruct_block(rv, pv, h.bitdepth).astype(rec.dtype)

    def _intra_block(self, bp, coeffs, size, ypos, xpos, qpY, qpC, iwm):
        """Intra branch of decode_block (dec/decode_block.c:245-276)."""
        h = self.h
        rec = self.rec
        sub = self.sub
        sizeC = size >> sub
        tb_split = bp["tb_split"]
        sb_size = 1 << h.log2_sb_size
        ur = inter.get_upright_available(ypos, xpos, size, size,
                                         self.width, self.height, sb_size)
        dl = inter.get_downleft_available(ypos, xpos, size, size,
                                          self.width, self.height, sb_size)
        im = bp["intra_mode"]
        pred_y = self._intra_recon(rec.y, ypos, xpos, size, qpY,
                                   coeffs["y"], tb_split, ur, dl, im,
                                   iwm(0, 1), h.bitdepth)
        if not self.mono:
            self._intra_recon_uv(rec.u, rec.v, ypos >> sub, xpos >> sub,
                                 sizeC, qpC, coeffs["u"], coeffs["v"],
                                 tb_split and sizeC > 4, ur, dl, im,
                                 iwm(1, 1),
                                 pred_y if h.cfl_intra else None,
                                 rec.y, ypos, xpos, sub, h.bitdepth)

    def _plan_tbs(self, bp, coeffs, size, ypos, xpos, qpY, qpC):
        """Record the block's transform units into the frame plan."""
        plan = self._plan
        sub = self.sub
        sizeC = size >> sub
        yC, xC = ypos >> sub, xpos >> sub

        def qs(s):
            return min(s, 16)

        if not bp["tb_split"]:
            if bp["cbp"][0]:
                plan.add_tb("y", size, ypos, xpos, qpY,
                            coeffs["y"][:qs(size), :qs(size)])
            if not self.mono:
                if bp["cbp"][1]:
                    plan.add_tb("u", sizeC, yC, xC, qpC,
                                coeffs["u"][:qs(sizeC), :qs(sizeC)])
                if bp["cbp"][2]:
                    plan.add_tb("v", sizeC, yC, xC, qpC,
                                coeffs["v"][:qs(sizeC), :qs(sizeC)])
            return
        s2 = size // 2
        for index in range(4):
            i, j = (index >> 1) * s2, (index & 1) * s2
            c = coeffs["y"][index]
            if c.any():
                plan.add_tb("y", s2, ypos + i, xpos + j, qpY,
                            c[:qs(s2), :qs(s2)])
        if self.mono:
            return
        if sizeC > 4:
            sc2 = sizeC // 2
            for index in range(4):
                i, j = (index >> 1) * sc2, (index & 1) * sc2
                cu = coeffs["u"][index]
                if cu.any():
                    plan.add_tb("u", sc2, yC + i, xC + j, qpC,
                                cu[:qs(sc2), :qs(sc2)])
                cv = coeffs["v"][index]
                if cv.any():
                    plan.add_tb("v", sc2, yC + i, xC + j, qpC,
                                cv[:qs(sc2), :qs(sc2)])
        else:
            if coeffs["u"] is not None and coeffs["u"].any():
                plan.add_tb("u", sizeC, yC, xC, qpC,
                            coeffs["u"][:qs(sizeC), :qs(sizeC)])
            if coeffs["v"] is not None and coeffs["v"].any():
                plan.add_tb("v", sizeC, yC, xC, qpC,
                            coeffs["v"][:qs(sizeC), :qs(sizeC)])

    def _replay_intra(self):
        """Reconstruct the frame's deferred intra blocks in coding order
        (their left/top neighbours - device-decoded inter or earlier
        intra - are final by now)."""
        for (size, ypos, xpos, bp, coeffs, qpY, qpC) in self._plan.intra:
            self._intra_block(bp, coeffs, size, ypos, xpos, qpY, qpC,
                              lambda plane, intra_f: None)

    # ----- native-parse record replay -----
    def _record_iter(self, blks, tbs, coef, only_intra=False):
        """Yield (rec, bp, coeffs) for native leaf records in coding
        order, with per-block TB slices resolved."""
        if len(tbs):
            tb_blk = tbs[:, NP.T_BLK]
            idx = np.arange(len(blks))
            starts = np.searchsorted(tb_blk, idx, "left")
            ends = np.searchsorted(tb_blk, idx, "right")
        else:
            starts = ends = np.zeros(len(blks), np.int64)
        for i in range(len(blks)):
            rec = blks[i]
            if only_intra and rec[NP.B_MODE] != MODE_INTRA:
                continue
            bp = NP.block_params(rec)
            coeffs = NP.block_coeffs(self, rec, tbs[starts[i]:ends[i]],
                                     coef)
            yield rec, bp, coeffs

    def _exec_records_host(self, blks, tbs, coef):
        """Host pixel execution of a natively parsed frame (coding
        order; deblock-data was already written during the C parse)."""
        for rec, bp, coeffs in self._record_iter(blks, tbs, coef):
            self._exec_block(bp, coeffs, int(rec[NP.B_SIZE]),
                             int(rec[NP.B_YPOS]), int(rec[NP.B_XPOS]),
                             int(rec[NP.B_QPY]), int(rec[NP.B_QPC]))

    def _exec_intra_records(self, blks, tbs, coef):
        """Replay only the intra blocks of a natively parsed frame (the
        inter cells were reconstructed on device)."""
        ql_cache = {}

        def iwm_for(qpY):
            if not self.h.qmtx:
                return lambda plane, intra_f: None
            ql = qp_to_qlevel(qpY, self.h.qmtx_offset)
            if ql not in ql_cache:
                ql_cache[ql] = self.iwmatrix[ql]
            mat = ql_cache[ql]
            return lambda plane, intra_f: mat[plane][intra_f]

        for rec, bp, coeffs in self._record_iter(blks, tbs, coef,
                                                 only_intra=True):
            self._intra_block(bp, coeffs, int(rec[NP.B_SIZE]),
                              int(rec[NP.B_YPOS]), int(rec[NP.B_XPOS]),
                              int(rec[NP.B_QPY]), int(rec[NP.B_QPC]),
                              iwm_for(int(rec[NP.B_QPY])))

    def _inter_residual(self, coeff, size, qp, tb_split, iwmatrix, bitdepth):
        """decode_and_reconstruct_block_inter minus the final add."""
        if not tb_split:
            rco = dequantize(coeff[:min(size, 16), :min(size, 16)], qp, size,
                             self._iw_for(iwmatrix, size))
            return transform_inv(rco, size, bitdepth)
        size2 = size // 2
        out = np.zeros((size, size), np.int16)
        for index in range(4):
            i, j = (index >> 1) * size2, (index & 1) * size2
            sub_c = coeff[index]
            rco = dequantize(sub_c[:min(size2, 16), :min(size2, 16)], qp,
                             size2, self._iw_for(iwmatrix, size2))
            out[i:i + size2, j:j + size2] = transform_inv(rco, size2, bitdepth)
        return out

    @staticmethod
    def _iw_for(iwlist, size):
        if iwlist is None:
            return None
        return iwlist[log2i(size // 4)]

    def _intra_recon(self, plane, ypos, xpos, size, qp, coeff, tb_split,
                     ur, dl, im, iwmatrix, bitdepth):
        """decode_and_reconstruct_block_intra (dec/decode_block.c:48-87).
        Returns the prediction block (for CFL)."""
        pred_full = np.zeros((size, size), np.int32)
        if tb_split:
            size2 = size // 2
            for i in range(0, size, size2):
                for j in range(0, size, size2):
                    left, top, tl = intra.make_top_and_left(
                        plane, ypos, xpos, i, j, size2, ur, dl, 1, bitdepth)
                    p = intra.get_intra_prediction(left, top, tl, ypos + i,
                                                   xpos + j, size2, im,
                                                   bitdepth)
                    pred_full[i:i + size2, j:j + size2] = p
                    index = 2 * (i // size2) + (j // size2)
                    rco = dequantize(coeff[index][:min(size2, 16),
                                                  :min(size2, 16)],
                                     qp, size2, self._iw_for(iwmatrix, size2))
                    rb = transform_inv(rco, size2, bitdepth)
                    plane[ypos + i:ypos + i + size2,
                          xpos + j:xpos + j + size2] = \
                        reconstruct_block(rb, p, bitdepth).astype(plane.dtype)
        else:
            left, top, tl = intra.make_top_and_left(
                plane, ypos, xpos, 0, 0, size, ur, dl, 0, bitdepth)
            p = intra.get_intra_prediction(left, top, tl, ypos, xpos, size,
                                           im, bitdepth)
            pred_full[:, :] = p
            rco = dequantize(coeff[:min(size, 16), :min(size, 16)], qp, size,
                             self._iw_for(iwmatrix, size))
            rb = transform_inv(rco, size, bitdepth)
            plane[ypos:ypos + size, xpos:xpos + size] = \
                reconstruct_block(rb, p, bitdepth).astype(plane.dtype)
        return pred_full

    def _intra_recon_uv(self, pu_plane, pv_plane, ypos, xpos, size, qp,
                        coeff_u, coeff_v, tb_split, ur, dl, im, iwmatrix,
                        pred_y, rec_y_plane, yposY, xposY, sub, bitdepth):
        """decode_and_reconstruct_block_intra_uv (dec/decode_block.c:89-142)."""
        if tb_split:
            size2 = size // 2
            for i in range(0, size, size2):
                for j in range(0, size, size2):
                    lu, tu, tlu = intra.make_top_and_left(
                        pu_plane, ypos, xpos, i, j, size2, ur, dl, 1, bitdepth)
                    pu = intra.get_intra_prediction(lu, tu, tlu, ypos + i,
                                                    xpos + j, size2, im,
                                                    bitdepth)
                    lv, tv, tlv = intra.make_top_and_left(
                        pv_plane, ypos, xpos, i, j, size2, ur, dl, 1, bitdepth)
                    pv = intra.get_intra_prediction(lv, tv, tlv, ypos + i,
                                                    xpos + j, size2, im,
                                                    bitdepth)
                    if pred_y is not None:
                        # The reference indexes the luma pred buffer with
                        # chroma offsets and reads it with the sub-block's
                        # luma stride (dec/decode_block.c:110-111:
                        # &pblock_y[i*size+j] with chroma i,j,size) - a
                        # skewed window, replicated here verbatim.
                        n2 = size2 << sub
                        flat = pred_y.reshape(-1)
                        start = i * size + j
                        ys_skewed = flat[start:start + n2 * n2].reshape(n2, n2)
                        ry = rec_y_plane[yposY + (i << sub):yposY + (i << sub) + n2,
                                         xposY + (j << sub):xposY + (j << sub) + n2]
                        improve_uv_prediction(
                            ys_skewed, pu, pv, ry.astype(np.int32), n2, sub,
                            bitdepth)
                    index = 2 * (i // size2) + (j // size2)
                    rco = dequantize(coeff_u[index][:min(size2, 16),
                                                    :min(size2, 16)],
                                     qp, size2, self._iw_for(iwmatrix, size2))
                    rb = transform_inv(rco, size2, bitdepth)
                    pu_plane[ypos + i:ypos + i + size2,
                             xpos + j:xpos + j + size2] = \
                        reconstruct_block(rb, pu, bitdepth).astype(pu_plane.dtype)
                    rco = dequantize(coeff_v[index][:min(size2, 16),
                                                    :min(size2, 16)],
                                     qp, size2, self._iw_for(iwmatrix, size2))
                    rb = transform_inv(rco, size2, bitdepth)
                    pv_plane[ypos + i:ypos + i + size2,
                             xpos + j:xpos + j + size2] = \
                        reconstruct_block(rb, pv, bitdepth).astype(pv_plane.dtype)
        else:
            lu, tu, tlu = intra.make_top_and_left(
                pu_plane, ypos, xpos, 0, 0, size, ur, dl, 0, bitdepth)
            pu = intra.get_intra_prediction(lu, tu, tlu, ypos, xpos, size,
                                            im, bitdepth)
            lv, tv, tlv = intra.make_top_and_left(
                pv_plane, ypos, xpos, 0, 0, size, ur, dl, 0, bitdepth)
            pv = intra.get_intra_prediction(lv, tv, tlv, ypos, xpos, size,
                                            im, bitdepth)
            if pred_y is not None:
                n = size << sub
                ry = rec_y_plane[yposY:yposY + n, xposY:xposY + n]
                improve_uv_prediction(pred_y, pu, pv, ry.astype(np.int32),
                                      n, sub, bitdepth)
            rco = dequantize(coeff_u[:min(size, 16), :min(size, 16)], qp,
                             size, self._iw_for(iwmatrix, size))
            rb = transform_inv(rco, size, bitdepth)
            pu_plane[ypos:ypos + size, xpos:xpos + size] = \
                reconstruct_block(rb, pu, bitdepth).astype(pu_plane.dtype)
            rco = dequantize(coeff_v[:min(size, 16), :min(size, 16)], qp,
                             size, self._iw_for(iwmatrix, size))
            rb = transform_inv(rco, size, bitdepth)
            pv_plane[ypos:ypos + size, xpos:xpos + size] = \
                reconstruct_block(rb, pv, bitdepth).astype(pv_plane.dtype)

    def _ref_frame(self, r):
        return self.ref[r] if r >= 0 else self.interp_frames[0]

    def _inter_pred(self, bp, size, ypos, xpos, bwidth, bheight):
        h = self.h
        fi = self.fi
        mode = bp["mode"]
        rec = self.rec
        if mode == MODE_SKIP and bp["dir"] == 2:
            if (self.stat_frame_type == B_FRAME and h.interp_ref == 2 and
                    bp["skip_idx"] == 0):
                return self._inter_pred_temp(bp, size, ypos, xpos, bwidth,
                                             bheight)
            ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
            sign0 = int(ref0.frame_num >= rec.frame_num)
            ref1 = self._ref_frame(fi.ref_array[bp["ref_idx1"]])
            sign1 = int(ref1.frame_num >= rec.frame_num)
            p0 = inter.get_inter_prediction_yuv(
                ref0, bp["mv_arr0"], ypos, xpos, size, bwidth, bheight,
                sign0, self.width, self.height, h.bipred, 0, h.bitdepth)
            p1 = inter.get_inter_prediction_yuv(
                ref1, bp["mv_arr1"], ypos, xpos, size, bwidth, bheight,
                sign1, self.width, self.height, h.bipred, 0, h.bitdepth)
            return tuple(inter.average_blocks(a, b) for a, b in zip(p0, p1))
        if mode in (MODE_SKIP, MODE_MERGE):
            if bp["dir"] == 2:  # merge bipred
                ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
                sign0 = int(ref0.frame_num >= rec.frame_num)
                ref1 = self._ref_frame(fi.ref_array[bp["ref_idx1"]])
                sign1 = int(ref1.frame_num >= rec.frame_num)
                p0 = inter.get_inter_prediction_yuv(
                    ref0, bp["mv_arr0"], ypos, xpos, size, bwidth, bheight,
                    sign0, self.width, self.height, h.bipred, 0, h.bitdepth)
                p1 = inter.get_inter_prediction_yuv(
                    ref1, bp["mv_arr1"], ypos, xpos, size, bwidth, bheight,
                    sign1, self.width, self.height, h.bipred, 0, h.bitdepth)
                return tuple(inter.average_blocks(a, b)
                             for a, b in zip(p0, p1))
            ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
            sign = int(ref0.frame_num > rec.frame_num)
            return inter.get_inter_prediction_yuv(
                ref0, bp["mv_arr0"], ypos, xpos, size, bwidth, bheight,
                sign, self.width, self.height, h.bipred, 0, h.bitdepth)
        if mode == MODE_INTER:
            # NB: the reference passes the sequence-level pb_split flag as
            # the split arg, not the block's pb_part (dec/decode_block.c:399)
            ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
            sign = int(ref0.frame_num > rec.frame_num)
            return inter.get_inter_prediction_yuv(
                ref0, bp["mv_arr0"], ypos, xpos, size, bwidth, bheight,
                sign, self.width, self.height, h.bipred, h.pb_split,
                h.bitdepth)
        if mode == MODE_BIPRED:
            ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
            sign0 = int(ref0.frame_num >= rec.frame_num)
            ref1 = self._ref_frame(fi.ref_array[bp["ref_idx1"]])
            sign1 = int(ref1.frame_num >= rec.frame_num)
            p0 = inter.get_inter_prediction_yuv(
                ref0, bp["mv_arr0"], ypos, xpos, size, bwidth, bheight,
                sign0, self.width, self.height, h.bipred, h.pb_split,
                h.bitdepth)
            p1 = inter.get_inter_prediction_yuv(
                ref1, bp["mv_arr1"], ypos, xpos, size, bwidth, bheight,
                sign1, self.width, self.height, h.bipred, h.pb_split,
                h.bitdepth)
            return tuple(inter.average_blocks(a, b) for a, b in zip(p0, p1))
        raise ValueError(mode)

    def _inter_pred_temp(self, bp, size, ypos, xpos, bwidth, bheight):
        """get_inter_prediction_temp (inter_prediction.c:352-411;
        refs come from the block's ref_idx0/1, dec/decode_block.c:317-321)."""
        h = self.h
        fi = self.fi
        gop = h.num_reorder_pics + 1
        phase = fi.phase
        ref0 = self._ref_frame(fi.ref_array[bp["ref_idx0"]])
        ref1 = self._ref_frame(fi.ref_array[bp["ref_idx1"]])
        sub = self.sub
        py = np.zeros((size, size), np.int32)
        pu = np.zeros((size >> sub, size >> sub), np.int32)
        pv = np.zeros((size >> sub, size >> sub), np.int32)
        for m in range(0, bheight, MIN_PB_SIZE):
            for n in range(0, bwidth, MIN_PB_SIZE):
                bi = ((ypos + m) // MIN_PB_SIZE) * self.dd.bs + \
                    (xpos + n) // MIN_PB_SIZE
                mv = (int(self.dd.arr_mv0[bi, phase, 0]),
                      int(self.dd.arr_mv0[bi, phase, 1]))
                p0 = inter.get_inter_prediction_yuv(
                    ref0, [mv] * 4, ypos + m, xpos + n, MIN_PB_SIZE,
                    MIN_PB_SIZE, MIN_PB_SIZE, 0, self.width, self.height,
                    2, 0, h.bitdepth)
                mv1 = mv
                if gop == 3 and phase == 1:
                    mv1 = (2 * mv[0], 2 * mv[1])
                p1 = inter.get_inter_prediction_yuv(
                    ref1, [mv1] * 4, ypos + m, xpos + n, MIN_PB_SIZE,
                    MIN_PB_SIZE, MIN_PB_SIZE, 1, self.width, self.height,
                    2, 0, h.bitdepth)
                avg = tuple(inter.average_blocks(a, b) for a, b in zip(p0, p1))
                py[m:m + 4, n:n + 4] = avg[0]
                if not self.mono:
                    pu[m >> sub:(m >> sub) + (4 >> sub),
                       n >> sub:(n >> sub) + (4 >> sub)] = avg[1]
                    pv[m >> sub:(m >> sub) + (4 >> sub),
                       n >> sub:(n >> sub) + (4 >> sub)] = avg[2]
        return py, pu, pv

    def _copy_deblock_data(self, bp, size, ypos, xpos, bwidth, bheight):
        """dec/decode_block.c:178-223."""
        dd = self.dd
        h = self.h
        posy = ypos // MIN_PB_SIZE
        posx = xpos // MIN_PB_SIZE
        div = size // (2 * MIN_PB_SIZE)
        tb_split = int(bp["tb_split"] > 0)
        pb_part = bp["pb_part"] if bp["mode"] == MODE_INTER else 0
        temp_case = (self.stat_frame_type == B_FRAME and h.interp_ref == 2 and
                     bp["mode"] == MODE_SKIP and bp["skip_idx"] == 0)
        phase = self.fi.phase
        nh, nw = bheight // MIN_PB_SIZE, bwidth // MIN_PB_SIZE
        bi = ((posy + np.arange(nh))[:, None] * dd.bs +
              posx + np.arange(nw)[None, :]).reshape(-1)
        dd.cbp_y[bi], dd.cbp_u[bi], dd.cbp_v[bi] = bp["cbp"]
        dd.tb_split[bi] = tb_split
        dd.pb_part[bi] = pb_part
        dd.size[bi] = size
        dd.mode[bi] = bp["mode"]
        if temp_case:
            mv = dd.arr_mv0[bi, phase]
            dd.mv0[bi] = mv
            if h.num_reorder_pics == 2 and phase == 1:
                dd.mv1[bi] = mv * 2
            else:
                dd.mv1[bi] = mv
        else:
            if div > 0:
                idx = (2 * (np.arange(nh) // div).clip(0, 1)[:, None] +
                       (np.arange(nw) // div).clip(0, 1)[None, :]
                       ).reshape(-1)
            else:
                idx = np.zeros(nh * nw, np.int64)
            dd.mv0[bi] = np.asarray(bp["mv_arr0"])[idx]
            dd.mv1[bi] = np.asarray(bp["mv_arr1"])[idx]
        dd.ref_idx0[bi] = bp["ref_idx0"]
        dd.ref_idx1[bi] = bp["ref_idx1"]
        dd.bipred_flag[bi] = bp["dir"]

    # ----- recursion & frame -----
    def process_block(self, s: BitReader, size, ypos, xpos):
        if ypos >= self.height or xpos >= self.width:
            return
        decode_this_size = (ypos + size <= self.height and
                            xpos + size <= self.width)
        decode_rect = (not decode_this_size and
                       self.fi.frame_type != I_FRAME)
        bit_start = s.bitcnt  # decode_block.c:628
        ctx = find_block_contexts(ypos, xpos, self.height, self.width, size,
                                  self.dd, self.h.use_block_contexts)
        split, mode, ref_idx = self.decode_super_mode(s, size,
                                                      decode_this_size,
                                                      ctx[2])
        if (size == (1 << self.h.log2_sb_size) and
                (split or mode != MODE_SKIP) and self.h.max_delta_qp > 0):
            abs_dq = s.get_vlc(0)
            sign_dq = s.get_flc(1) if abs_dq > 0 else 0
            delta_qp = -abs_dq if sign_dq else abs_dq
            prev_qp = (self.fi.qp if (ypos == 0 and xpos == 0)
                       else self.fi.qpb)
            self.fi.qpb = prev_qp + delta_qp
        self.bc.super_mode[self.stat_frame_type] += s.bitcnt - bit_start
        if split and size >= MIN_BLOCK_SIZE:
            ns = size // 2
            self.process_block(s, ns, ypos, xpos)
            self.process_block(s, ns, ypos + ns, xpos)
            self.process_block(s, ns, ypos, xpos + ns)
            self.process_block(s, ns, ypos + ns, xpos + ns)
        elif decode_this_size or decode_rect:
            self.decode_block(s, size, ypos, xpos, mode, ref_idx, ctx[1])

    def decode_frame(self, s: BitReader, decode_order_frame_num: int):
        """dec/decode_frame.c:52-212: headers, temporal interpolation,
        then one of the four routes of the module docstring."""
        h = self.h
        fi = self.fi
        fi.decode_order_frame_num = decode_order_frame_num
        fi.interp_ref = 0
        bit_start = s.bitcnt  # decode_frame.c:62
        read_frame_header(h, s, fi, self)
        self.stat_frame_type = fi.frame_type
        qp = fi.qp
        if fi.frame_type != I_FRAME:
            for r in range(fi.num_ref):
                if fi.ref_array[r] == -1:
                    fi.interp_ref = h.interp_ref
        else:
            self.dd.clear()
            fi.num_ref = 0
        fi.phase = fi.display_frame_num % (h.num_reorder_pics + 1)
        for r in range(fi.num_ref):
            if fi.ref_array[r] != -1:
                if (self.ref[fi.ref_array[r]].frame_num >
                        fi.display_frame_num):
                    self.stat_frame_type = B_FRAME

        rec_idx = fi.display_frame_num % MAX_REORDER_BUFFER
        self.rec = self.rec_buf[rec_idx]
        self.rec.frame_num = fi.display_frame_num

        if fi.num_ref > 2 and fi.ref_array[0] == -1:
            # temporal interpolation reads host reference pixels:
            # resolve any in-flight fused frame first
            self.flush_pixels()
            ref1 = self.ref[fi.ref_array[1]]
            ref2 = self.ref[fi.ref_array[2]]
            dfn = fi.display_frame_num
            off1 = ref2.frame_num - dfn
            off2 = dfn - ref1.frame_num
            if off1 < 0 and off2 < 0:
                off1, off2 = -off1, -off2
            if off1 == off2:
                off1 = off2 = 1
            interpolate_frames(self.interp_frames[0], ref1, ref2,
                               off1 + off2, off2,
                               device=self.device)
            self.interp_frames[0].pad_frame()
            self.interp_frames[0].frame_num = dfn

        # decode_frame.c:115-116
        self.bc.frame_header[self.stat_frame_type] += s.bitcnt - bit_start
        self.bc.frame_type[self.stat_frame_type] += 1

        fi.qpb = qp

        # Device pixel pipeline: the entropy scan fills a dense frame
        # plan; the device executes MC + residual + recon in batched calls
        # and the few intra blocks replay on the host afterwards.
        # qmtx streams are fused-route only (the weighted dequant lives in
        # pixel_core; the two-stage executor stays qm-free).
        stream_gate = (h.subsample == 420 and not h.cfl_inter
                       and (not h.qmtx or self.fused))
        plan_gate = (stream_gate and fi.frame_type != I_FRAME
                     and not h.qmtx)
        slots, refs = {}, []
        if stream_gate:
            for r in range(fi.num_ref):
                ra = fi.ref_array[r]
                if ra not in slots:
                    slots[ra] = len(refs)
                    refs.append(self._ref_frame(ra))

        # Native (C) block-layer parse: one call for the whole SB walk,
        # filling the device plan grids / leaf records directly.
        plan = DP.FramePlan(self.width, self.height) if stream_gate else None
        native_res = NP.parse_frame(self, s, plan,
                                    slots if stream_gate else None)
        route = "python_walk"
        if native_res is not None:
            blks, tbs, coef = native_res
            if (stream_gate and self.fused
                    and self._device_frame.eligible(self, blks)):
                route = "fused"
            elif plan_gate:
                route = "two_stage"
                self.flush_pixels()  # host-pixel consumer below
                (self.plan_executor or DP.execute)(self, plan, slots, refs)
                self._exec_intra_records(blks, tbs, coef)
            else:
                route = "host_records"
                self.flush_pixels()
                self._exec_records_host(blks, tbs, coef)
        else:
            # Python walk: the native parser's buffers overflowed
            self.flush_pixels()
            if plan_gate:
                self._plan = DP.FramePlan(self.width, self.height)
                self._plan_slots = slots
                self._plan_refs = refs

            sb_size = 1 << h.log2_sb_size
            num_sb_hor = (self.width + sb_size - 1) // sb_size
            num_sb_ver = (self.height + sb_size - 1) // sb_size
            for k in range(num_sb_ver):
                for l in range(num_sb_hor):
                    self.process_block(s, sb_size, k * sb_size,
                                       l * sb_size)

            if self._plan is not None:
                (self.plan_executor or DP.execute)(
                    self, self._plan, self._plan_slots, self._plan_refs)
                self._replay_intra()
                self._plan = None
                self._plan_slots = None
                self._plan_refs = None
        ROUTE_FRAMES[route] += 1

        # qp threading + temporal MV store happen before the filter-stage
        # stream reads
        fi.qp = fi.qpb
        if h.interp_ref > 1:
            gop = h.num_reorder_pics + 1
            coded_phase = (fi.decode_order_frame_num + gop - 2) % gop + 1
            store_mv(self.dd, self.width, self.height, log2i(coded_phase),
                     self.stat_frame_type, fi.display_frame_num, gop)
        if route == "fused":
            self._device_frame.run(self, s, blks, plan, refs)
        else:
            self._loop_filters_device(s, fi.qp)

        # reference sliding window; when the fused frame is still in
        # flight the host copy is deferred to its flush (the device ring
        # already holds the padded reference planes)
        tmp = self.ref[MAX_REF_FRAMES - 1]
        self.ref[1:] = self.ref[:-1]
        self.ref[0] = tmp
        if not self._device_frame.note_ref(self.ref[0], self.rec):
            self.ref[0].copy_from(self.rec)

    def flush_pixels(self):
        """Resolve any in-flight fused-frame pull (pipelined decode)."""
        self._device_frame.flush()

    def _loop_filters_device(self, s: BitReader, qp: int):
        """deblock -> CDEF -> CLPF on the decoder's device
        (ops/filters.py:filters_exec) for a frame that did not take the
        fused route; stream reads (CDEF presets, CLPF decision bits) stay
        on the host in the reference order."""
        h = self.h
        bd = h.bitdepth
        qpc = int(CHROMA_QP[qp]) if h.subsample != 444 else qp
        H, W = self.height, self.width
        Hc, Wc = H >> self.sub, W >> self.sub

        # ---- host side: stream reads + block-metadata masks, in the
        # exact reference order (deblock masks, CDEF presets, CLPF bits)
        if h.deblocking:
            mv_, mh_ = OF.deblock_masks_y(self.dd, W, H)
            if not self.mono:
                cmv, cmh = OF.deblock_masks_uv(self.dd, W, H)
        else:
            mv_ = mh_ = np.zeros((1, 1), bool)
            cmv = cmh = np.zeros((1, 1), bool)
        if self.mono:
            cmv = cmh = np.zeros((1, 1), bool)

        presets_y, presets_uv = self._read_cdef_presets(s)
        cs = bd - 8
        lv0, sec0, m0 = OF.cdef_block_maps(self.dd, presets_y, W, H, 0,
                                           self.sub)
        if not self.mono:
            lv1, sec1, m1 = OF.cdef_block_maps(self.dd, presets_uv, W, H,
                                               1, self.sub)
            _, _, m2 = OF.cdef_block_maps(self.dd, presets_uv, W, H, 2,
                                          self.sub)
        else:
            lv1 = sec1 = np.zeros((1, 1), np.int32)
            m1 = m2 = np.zeros((1, 1), bool)

        s_y = s_u = s_v = 0
        clpf_my = np.zeros((1, 1), bool)
        clpf_mu = clpf_mv_ = np.zeros((1, 1), bool)
        if h.clpf:
            s_y = s.get_flc(2)
            s_u = s.get_flc(2)
            s_v = s.get_flc(2)
            if s_y:
                fb_size_log2 = s.get_flc(2) + 4
                enable_fb = fb_size_log2 != 4
                if fb_size_log2 == 4:
                    fb_size_log2 = 7
                if enable_fb:
                    nbits = filters.count_clpf_decisions(
                        self.dd, W, H, 0, fb_size_log2, self.sub)
                    bits = [s.get_flc(1) for _ in range(nbits)]
                else:
                    bits = None
                clpf_my, _ = OF.clpf_pixel_mask(self.dd, W, H, 0,
                                                fb_size_log2, self.sub,
                                                decision_bits=bits)
            if s_u and not self.mono:
                clpf_mu, _ = OF.clpf_pixel_mask(self.dd, W, H, 1, 4,
                                                self.sub)
            if s_v and not self.mono:
                clpf_mv_, _ = OF.clpf_pixel_mask(self.dd, W, H, 2, 4,
                                                 self.sub)

        # ---- device side: one packed pull ----
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if self.mono:
            u = v = torch.zeros((1, 1), dtype=torch.int16,
                                device=self.device)
        else:
            u = up(self.rec.u.astype(np.int16))
            v = up(self.rec.v.astype(np.int16))
        packed = OF.filters_exec(
            up(self.rec.y.astype(np.int16)), u, v, up(mv_), up(mh_),
            up(cmv), up(cmh), up(lv0), up(sec0), up(m0), up(lv1), up(sec1),
            up(m1), up(m2), up(clpf_my), up(clpf_mu), up(clpf_mv_), qp=qp,
            qpc=qpc, bd=bd, sub=self.sub, mono=self.mono,
            deblocking=bool(h.deblocking), cdef_damping=self.cdef_damping,
            cs=cs, s_y=s_y, s_u=s_u, s_v=s_v, qpclpf=qp >> 4)
        packed = packed.cpu().numpy()
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

    def _read_cdef_presets(self, s: BitReader):
        """Read per-fb CDEF preset indices; returns (presets_y, presets_uv)
        as dicts for cdef_block_maps (dec/decode_frame.c:152-175)."""
        fb = 6
        nfb_h = (self.height + 63) >> fb
        nfb_w = (self.width + 63) >> fb
        presets_y, presets_uv = [], []
        for k in range(nfb_h):
            for l in range(nfb_w):
                xpos, ypos = l << fb, k << fb
                preset = 0
                if self.cdef_bits:
                    allskip = filters.cdef_allskip(xpos, ypos, self.width,
                                                   self.height, self.dd, fb)
                    if not allskip:
                        preset = s.get_flc(self.cdef_bits)
                p = self.cdef_presets[preset]
                presets_y.append({
                    "level": p["pri_strength0"] * 2 + p["skip_condition0"],
                    "sec_strength": p["sec_strength0"]})
                if not self.mono:
                    presets_uv.append({
                        "level": p["pri_strength1"] * 2 + p["skip_condition1"],
                        "sec_strength": p["sec_strength1"]})
        return presets_y, presets_uv


def resolve_device(device=None) -> torch.device:
    """The device the port decodes on: CUDA unless the caller asks for
    another.  Raises RuntimeError when CUDA is meant and torch sees no
    card: the port never falls back to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "thor_tpu_torch decodes on a CUDA card and torch sees none; "
            "ask for the CPU with device=\"cpu\" (THOR_TORCH_DEVICE=cpu "
            "for the command line)")
    return dev


def decode_stream(data: bytes, progress=None, device=None, fused=True):
    """Decode a full Thor stream; returns (header, list of frames in
    display order as bytes).  Decodes on `device`: CUDA by default (see
    `resolve_device`), the CPU only when the caller asks for it.
    `fused=False` keeps every frame off the fused frame decoder (see
    `Decoder`)."""
    device = resolve_device(device)
    fur = FrameUnitReader(data)
    s = fur.next_frame()
    header = SequenceHeader.read(s)
    if not NP.available():
        raise RuntimeError("the native block parser (thor_tpu_torch/_native)"
                           " is unavailable: thor_tpu_torch needs it")
    dec = Decoder(header, device, fused)
    dec.bc.sequence_header = s.bitcnt  # maindec.c:129-139
    outputs = {}
    n = 0
    bitcnt = 0
    pend_out = None
    while s is not None:
        dec.decode_frame(s, n)
        # desync detection (dec/getbits.c framing: each unit is length-
        # prefixed, a compliant frame consumes the unit to within byte
        # padding).  A parse that left >=1 full byte unread, or ran past
        # the unit, decoded from wrong bit offsets - say so loudly
        # instead of silently emitting wrong YUV.
        slack = (len(s.data) << 3) - s.bitpos
        if slack < 0 or slack >= 8:
            what = ("overran the unit by %d bits" % -slack if slack < 0
                    else "left %d bits unread" % slack)
            print(f"thor_tpu_torch: WARNING: frame {n}: bitstream desync - "
                  f"the {len(s.data)}-byte frame unit {what}; decoded "
                  f"output for this frame is unreliable", file=sys.stderr)
        # output deferred ONE frame: the fused executor leaves frame N's
        # pull in flight while the host parses and dispatches N+1; by
        # the time decode_frame(N+1) returns, N is resolved
        if pend_out is not None:
            outputs[pend_out[0]] = pend_out[1].to_bytes()
        pend_out = (dec.fi.display_frame_num, dec.rec)
        bitcnt += s.bitcnt
        if progress:
            progress(n, dec.fi.display_frame_num, bitcnt)
        n += 1
        s = fur.next_frame()
    dec.flush_pixels()
    if pend_out is not None:
        outputs[pend_out[0]] = pend_out[1].to_bytes()
    header.bit_count = dec.bc  # for the CLI statistics report
    return header, [outputs[k] for k in sorted(outputs)]
