"""Padded YUV frame buffers and raw-YUV file I/O.

TPU-first layout: each plane is a dense padded 2D array (no pointer
arithmetic); the visible frame is plane[pad:pad+h, pad:pad+w].  Mirrors
reference common/common_frame.c:435-763 semantics (pad extent PADDING_Y,
edge-replicate padding, reference = copy + pad).
"""
from __future__ import annotations

import numpy as np

from .tables import PADDING_Y


class YuvFrame:
    def __init__(self, width: int, height: int, subsample: int = 420,
                 pad: int = 0, bitdepth: int = 8, input_bitdepth: int = 8):
        self.width = width
        self.height = height
        self.subsample = subsample
        # reference encodes mono as sub=31 (shifts wipe chroma); we keep a flag
        self.mono = subsample == 400
        self.sub = 1 if subsample == 420 else 0
        self.pad = pad
        self.bitdepth = bitdepth
        self.input_bitdepth = input_bitdepth
        self.frame_num = 0
        # False while a deferred device->host pixel copy is outstanding
        # (dec/device_frame.py note_ref): the metadata (frame_num) is
        # already current but y_full/u_full/v_full still hold the
        # previous frame.  Consumers of the host pixel planes should
        # assert this flag so an unguarded read fails loudly instead of
        # decoding from stale pixels.
        self.host_pixels_valid = True
        dtype = np.uint8 if bitdepth == 8 else np.uint16
        self.dtype = dtype
        pc = pad >> self.sub
        self.pad_c = pc
        wsub = 1 if subsample in (420, 422) else 0
        self.wsub = wsub
        cw = width >> self.sub
        ch = height >> self.sub
        self.cwidth, self.cheight = cw, ch
        self.y_full = np.zeros((height + 2 * pad, width + 2 * pad), dtype)
        if not self.mono:
            self.u_full = np.zeros((ch + 2 * pc, cw + 2 * pc), dtype)
            self.v_full = np.zeros((ch + 2 * pc, cw + 2 * pc), dtype)
        else:
            self.u_full = self.v_full = np.zeros((0, 0), dtype)

    # visible-area views
    @property
    def y(self) -> np.ndarray:
        p = self.pad
        return self.y_full[p:p + self.height, p:p + self.width]

    @property
    def u(self) -> np.ndarray:
        p = self.pad_c
        return self.u_full[p:p + self.cheight, p:p + self.cwidth]

    @property
    def v(self) -> np.ndarray:
        p = self.pad_c
        return self.v_full[p:p + self.cheight, p:p + self.cwidth]

    def planes(self):
        return (self.y, self.u, self.v)

    def pad_frame(self):
        """Edge-replicate into the padding ring (common_frame.c:657 pad_yuv_frame)."""
        for full, p in ((self.y_full, self.pad), (self.u_full, self.pad_c),
                        (self.v_full, self.pad_c)):
            if full.size == 0 or p == 0:
                continue
            full[p:-p, :p] = full[p:-p, p:p + 1]
            full[p:-p, -p:] = full[p:-p, -p - 1:-p]
            full[:p, :] = full[p:p + 1, :]
            full[-p:, :] = full[-p - 1:-p, :]

    def copy_from(self, other: "YuvFrame"):
        """create_reference_frame: copy visible area then pad."""
        self.frame_num = other.frame_num
        self.host_pixels_valid = True
        self.y[:] = other.y
        if not self.mono:
            self.u[:] = other.u
            self.v[:] = other.v
        self.pad_frame()

    # --- raw planar I/O (8-bit I/O path; HBD file I/O added with HBD work) ---
    def frame_bytes_in_file(self) -> int:
        bpp = 1 + (self.input_bitdepth > 8)
        n = self.width * self.height
        if not self.mono:
            n += 2 * (self.width >> self.wsub) * self.cheight
        return n * bpp

    def _scale_in(self, plane):
        """File sample -> internal bitdepth (common_frame.c:478-543)."""
        ib, b = self.input_bitdepth, self.bitdepth
        if ib == b:
            return plane.astype(self.dtype)
        if b > ib:
            return (plane.astype(np.uint16) << (b - ib)).astype(self.dtype)
        rnd = 1 << (ib - b - 1)
        return ((plane.astype(np.int32) + rnd) >> (ib - b)).astype(self.dtype)

    def _scale_out(self, plane):
        """Internal -> file sample (common_frame.c:546-650)."""
        ib, b = self.input_bitdepth, self.bitdepth
        if ib == b:
            return plane
        if ib > b:
            return plane.astype(np.uint16) << (ib - b)
        rnd = 1 << (b - ib - 1)
        v = np.clip((plane.astype(np.int32) + rnd) >> (b - ib),
                    0, (1 << ib) - 1)
        return v.astype(np.uint8 if ib == 8 else np.uint16)

    def read_from(self, data: bytes, offset: int = 0) -> int:
        w, h = self.width, self.height
        ftype = np.uint8 if self.input_bitdepth == 8 else np.uint16
        bpp = ftype().nbytes

        def rd(n):
            nonlocal offset
            a = np.frombuffer(data, ftype, n, offset)
            offset += n * bpp
            return a

        self.y[:] = self._scale_in(rd(w * h).reshape(h, w))
        if not self.mono:
            cw, ch = w >> self.wsub, self.cheight
            u = rd(cw * ch).reshape(ch, cw)
            v = rd(cw * ch).reshape(ch, cw)
            if self.subsample == 422:
                u = np.repeat(u, 2, axis=1)
                v = np.repeat(v, 2, axis=1)
            self.u[:] = self._scale_in(u)
            self.v[:] = self._scale_in(v)
        return offset

    def to_bytes(self) -> bytes:
        parts = [self._scale_out(self.y).tobytes()]
        if not self.mono:
            u, v = self._scale_out(self.u), self._scale_out(self.v)
            if self.subsample == 422:
                u = ((u[:, ::2].astype(np.uint32) + u[:, 1::2] + 1) >> 1).astype(u.dtype)
                v = ((v[:, ::2].astype(np.uint32) + v[:, 1::2] + 1) >> 1).astype(v.dtype)
            parts += [u.tobytes(), v.tobytes()]
        return b"".join(parts)


def new_ref_frame(width, height, subsample=420, bitdepth=8, input_bitdepth=8):
    return YuvFrame(width, height, subsample, PADDING_Y, bitdepth, input_bitdepth)
