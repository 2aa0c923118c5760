"""Thor bitstream decoder of the port: the frame driver of
thor_tpu/dec/decoder.py, with every frame parsed by the port's native C
parser (dec/native_parse.py) and every pixel decoded by the torch/CUDA
`DeviceFrameDecoder` (dec/device_frame.py).

Mirrors the reference decoder: dec/maindec.c (driver), dec/decode_frame.c,
dec/read_bits.c.  The sequence and frame headers, `Decoder.__init__`'s
state, the frame driver and `decode_stream` are copied from thor_tpu's
decoder; the copy differs in its imports (the port's own tables, spec,
native parser and device modules), in `Decoder.__init__` (the device path
is always on and has no JAX backend probe), in `decode_frame` (one route:
native parse, then the fused frame; temporal interpolation has one route
too, ops/tempinterp.py on the decoder's device) and in `decode_stream`
(the device argument and the slice check).  What the slice never runs is
not copied: thor_tpu's Python syntax walk (`decode_super_mode` ..
`process_block`) and its host-pixel and JAX loop filters (ROADMAP.md
Queue 1, item 7).  Where a stream would need them, a NotImplementedError
names the item, so that it fails loudly instead of decoding on another
path.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field

import torch

from ..bitstream import BitReader, FrameUnitReader
from ..frame import YuvFrame, new_ref_frame
from ..tables import MAX_REF_FRAMES, MAX_REORDER_BUFFER, log2i
from ..qmtx import get_iwmatrices
from ..spec import inter, filters
from ..spec.tempinterp import store_mv
from ..ops.tempinterp import interpolate_frames
from .device_frame import DeviceFrameDecoder
from . import device_pixels as DP
from . import native_parse as NP

I_FRAME, P_FRAME, B_FRAME = 0, 1, 2

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



def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to thor_tpu_torch (ROADMAP.md Queue 1, "
        f"item {item})")


class Decoder:
    def __init__(self, header: SequenceHeader, device):
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
        # Fully-resident fused frame decoder (dec/device_frame.py): one
        # dispatch + one pull per frame, refs resident on `device`.  The
        # port has no other pixel path.
        self._device_frame = DeviceFrameDecoder(device)


    def decode_frame(self, s: BitReader, decode_order_frame_num: int):
        """dec/decode_frame.c:52-212: the native parser walks the frame
        and fills the device plan, the fused frame decoder executes it
        (pixels, loop filters and their stream reads)."""
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
                               device=self._device_frame.device)
            self.interp_frames[0].pad_frame()
            self.interp_frames[0].frame_num = dfn

        # decode_frame.c:115-116
        self.bc.frame_header[self.stat_frame_type] += s.bitcnt - bit_start
        self.bc.frame_type[self.stat_frame_type] += 1

        fi.qpb = qp

        slots, refs = {}, []
        for r in range(fi.num_ref):
            ra = fi.ref_array[r]
            if ra not in slots:
                slots[ra] = len(refs)
                refs.append(self._ref_frame(ra))

        # Native (C) block-layer parse: one call for the whole SB walk,
        # filling the device plan grids / leaf records directly.
        plan = DP.FramePlan(self.width, self.height)
        native_res = NP.parse_frame(self, s, plan, slots)
        if native_res is None:
            # thor_tpu's decoder walks such a frame in Python
            _not_ported("the Python syntax walk (the native parser's "
                        "buffers overflowed)", "7, Decoder fallbacks")
        blks = native_res[0]
        self._device_frame.eligible(self, blks)
        # qp threading + temporal MV store happen before the filter-stage
        # stream reads, as in the Python path
        fi.qp = fi.qpb
        if h.interp_ref > 1:
            gop = h.num_reorder_pics + 1
            coded_phase = (fi.decode_order_frame_num + gop - 2) % gop + 1
            store_mv(self.dd, self.width, self.height, log2i(coded_phase),
                     self.stat_frame_type, fi.display_frame_num, gop)
        self._device_frame.run(self, s, blks, plan, refs)

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

    def _ref_frame(self, r):
        return self.ref[r] if r >= 0 else self.interp_frames[0]

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


def check_slice(header):
    """Raise NotImplementedError for a stream outside the ported slice."""
    if header.subsample != 420 or header.cfl_inter:
        _not_ported(
            "this stream (subsample=%d cfl_inter=%d; the port decodes 4:2:0 "
            "with cfl_inter=0)" % (header.subsample, header.cfl_inter),
            "7, Decoder fallbacks")


def decode_stream(data: bytes, progress=None, device=None):
    """Decode a full Thor stream; returns (header, list of frames in
    display order as bytes).  Decodes on `device`: CUDA by default (see
    `resolve_device`), the CPU only when the caller asks for it."""
    device = resolve_device(device)
    fur = FrameUnitReader(data)
    s = fur.next_frame()
    header = SequenceHeader.read(s)
    check_slice(header)
    if not NP.available():
        raise RuntimeError("the native block parser (thor_tpu_torch/_native)"
                           " is unavailable: thor_tpu_torch needs it")
    dec = Decoder(header, device)
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
