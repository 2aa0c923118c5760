"""Encoder syntax writer (mirrors enc/write_bits.c)."""
from __future__ import annotations

import numpy as np

from ..bitstream import BitWriter
from ..tables import ZIGZAG, MAX_QUANT_SIZE, log2i

MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED, MODE_MERGE = 0, 1, 2, 3, 4
I_FRAME, P_FRAME, B_FRAME = 0, 1, 2


def write_sequence_header(w: BitWriter, p):
    """enc/write_bits.c:49-79."""
    w.put_flc(16, p.width)
    w.put_flc(16, p.height)
    w.put_flc(3, p.log2_sb_size)
    w.put_flc(1, p.enable_pb_split)
    w.put_flc(1, p.enable_tb_split)
    w.put_flc(2, p.max_num_ref - 1)
    w.put_flc(2, p.interp_ref)
    w.put_flc(1, int(bool(p.max_delta_qp or p.bitrate)))
    w.put_flc(1, p.deblocking)
    w.put_flc(1, 1 if p.clpf else 0)
    w.put_flc(1, p.use_block_contexts)
    w.put_flc(2, p.enable_bipred)
    w.put_flc(1, p.qmtx)
    if p.qmtx:
        w.put_flc(6, p.qmtx_offset + 32)
    w.put_flc(2, (int((p.subsample & 4) == 4) + (p.subsample & 2) +
                  int((p.subsample & 8) == 8) * 2))
    w.put_flc(4, p.num_reorder_pics)
    if p.subsample != 400:
        w.put_flc(1, p.cfl_intra)
        w.put_flc(1, p.cfl_inter)
    w.put_flc(1, int(p.bitdepth != 8))
    if p.bitdepth != 8:
        w.put_flc(1, int(p.bitdepth == 12))
    w.put_flc(1, int(p.input_bitdepth != 8))
    if p.input_bitdepth != 8:
        w.put_flc(1, int(p.input_bitdepth == 12))


def write_cdef_params(w: BitWriter, enc):
    """enc/write_bits.c:81-95."""
    p = enc.params
    if p.cdef:
        w.put_flc(2, enc.cdef_damping - 3)
        w.put_flc(2, enc.cdef_bits)
        for i in range(1 << enc.cdef_bits):
            w.put_flc(7, enc.cdef_strengths[i])
            if p.subsample != 400:
                w.put_flc(7, enc.cdef_uv_strengths[i])
    else:
        w.put_flc(18 if p.subsample != 400 else 11, 0)


def write_frame_header(w: BitWriter, enc):
    """enc/write_bits.c:98-121."""
    fi = enc.fi
    w.put_flc(1, int(fi.frame_type != I_FRAME))
    w.put_flc(8, fi.qp)
    w.put_flc(4, fi.num_intra_modes)
    if fi.frame_type != I_FRAME:
        w.put_flc(2, fi.num_ref - 1)
    for r in range(fi.num_ref):
        w.put_flc(6, fi.ref_array[r] + 1)
    w.put_flc(16, fi.frame_num)
    enc.cdef_header_pos = w.save_pos()
    write_cdef_params(w, enc)


def write_mv(w: BitWriter, mv, mvp):
    """enc/write_bits.c:123-143; mv/mvp are (y,x)."""
    dx = mv[1] - mvp[1]
    dy = mv[0] - mvp[0]
    w.put_vlc(7, abs(dx))
    if abs(dx) > 0:
        w.put_flc(1, 1 if dx < 0 else 0)
    w.put_vlc(7, abs(dy))
    if abs(dy) > 0:
        w.put_flc(1, 1 if dy < 0 else 0)


_NATIVE_W = None


def _native_writer():
    global _NATIVE_W
    if _NATIVE_W is None:
        import ctypes
        from .._native import get_lib, BwStruct
        lib = get_lib()
        if lib is not None:
            lib.write_coeff_scan.argtypes = [
                ctypes.POINTER(BwStruct),
                ctypes.POINTER(ctypes.c_int16), ctypes.c_int,
                ctypes.c_int, ctypes.c_int]
            lib.write_coeff_scan.restype = None
        _NATIVE_W = (lib,)
    return _NATIVE_W[0]


def _write_coeff_native(w: BitWriter, lib, scoeff16, qsize, ctype, vlc10):
    """Run the C coefficient scan into a scratch buffer continuing the
    BitWriter's pending word, then splice the output back."""
    import ctypes
    from .._native import BwStruct
    buf = (ctypes.c_uint8 * 8192)()
    bw = BwStruct(ctypes.cast(buf, ctypes.c_void_p), 8192, 0,
                  w.bitbuf, w.bitrest)
    lib.write_coeff_scan(
        ctypes.byref(bw),
        scoeff16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        qsize, ctype, vlc10)
    nb = bw.bytepos
    if nb:
        end = w.bytepos + nb
        if len(w.buf) < end:
            w.buf.extend(b"\0" * (end - len(w.buf)))
        w.buf[w.bytepos:end] = bytes(buf[:nb])
        w.bytepos = end
    w.bitbuf = bw.bitbuf
    w.bitrest = bw.bitrest


def write_coeff(w: BitWriter, coeff: np.ndarray, size: int, ctype: int):
    """Zigzag run/level coding (enc/write_bits.c:145-242).
    coeff: (qsize,qsize) int array."""
    qsize = min(MAX_QUANT_SIZE, size)
    N = qsize * qsize
    chroma_flag = ctype & 1
    intra_flag = (ctype >> 1) & 1
    vlc_adaptive = int(intra_flag and not chroma_flag)
    eob_pos = 0 if chroma_flag else 2
    lib = _native_writer()
    if lib is not None:
        sc16 = np.zeros(N, np.int16)
        sc16[ZIGZAG[qsize]] = coeff[:qsize, :qsize].reshape(-1)
        if not sc16.any():
            raise ValueError("No coeffs even if cbp nonzero")
        _write_coeff_native(w, lib, sc16, qsize, ctype,
                            int(bool(chroma_flag and size <= 8)))
        return
    scoeff = np.zeros(N, np.int32)
    scoeff[ZIGZAG[qsize]] = coeff[:qsize, :qsize].reshape(-1)
    sc = scoeff.tolist()

    pos = N - 1
    while not sc[pos] and pos:
        pos -= 1
    if pos == 0 and not sc[0]:
        raise ValueError("No coeffs even if cbp nonzero")
    last_pos = pos

    pos = 0
    if chroma_flag:
        if last_pos == 0 and abs(sc[0]) == 1:
            w.put_flc(2, 2 + int(sc[0] < 0))
            pos = N
        else:
            w.put_flc(1, 0)

    level_mode = level = 1
    c = 0
    while pos <= last_pos:
        if level_mode:
            while pos <= last_pos and level > 0:
                c = sc[pos]
                pos += 1
                level = abs(c)
                w.put_vlc(vlc_adaptive, level)
                if level > 0:
                    w.put_flc(1, int(c < 0))
                if chroma_flag == 0:
                    vlc_adaptive = int(level > 3)
        run = 0
        c = 0
        while c == 0 and pos <= last_pos:
            c = sc[pos]
            pos += 1
            run += int(not c)
            if c:
                interval = 5
                level = abs(c)
                sign = int(c < 0)
                if level == 1:
                    cn = (run * interval) // (interval - 1)
                else:
                    cn = run * interval + interval - 1
                w.put_vlc(10 if (chroma_flag and size <= 8) else 6,
                          cn + int(cn >= eob_pos))
                level_mode = int(level > 1)
                if level > 1:
                    w.put_vlc(0, (level - 2) * 2 + sign)
                else:
                    w.put_flc(1, sign)
                run = 0
    if pos < N and level_mode:
        w.put_vlc(vlc_adaptive, 0)
        pos += 1
    if pos < N:
        w.put_vlc(10 if (chroma_flag and size <= 8) else 6, eob_pos)


def write_delta_qp(w: BitWriter, delta_qp: int):
    w.put_vlc(0, abs(delta_qp))
    if abs(delta_qp) > 0:
        w.put_flc(1, 1 if delta_qp < 0 else 0)


def write_super_mode(w: BitWriter, enc, block_info, mode, ref_idx0,
                     split_flag, encode_this_size):
    """enc/write_bits.c:257-358."""
    fi = enc.fi
    size = block_info.size
    if fi.frame_type != I_FRAME:
        if not encode_this_size:
            w.put_flc(1, int(not split_flag))
            return
        bipred_possible = int(fi.num_ref > 1 and enc.params.enable_bipred)
        split_possible = int(size > 8)
        interp_ref = fi.interp_ref
        maxbit = 2 + fi.num_ref + split_possible + bipred_possible
        if interp_ref > 2:
            maxbit -= 1
        if split_flag == 1:
            if size > 128:
                w.put_flc(1, 0)
            else:
                code = 1
                if block_info.ctx_index == 2 or block_info.ctx_index > 3:
                    code = (code + 3) % 4
                w.put_vlc(10 + maxbit, code)
            return
        if interp_ref:
            if mode == MODE_SKIP:
                code = 0
            elif mode == MODE_MERGE:
                code = 2
            elif mode == MODE_BIPRED:
                code = 3
            elif mode == MODE_INTRA:
                code = 4
            elif mode == MODE_INTER and ref_idx0 > 0:
                code = 4 + ref_idx0
            else:
                code = 4 + fi.num_ref
            if not bipred_possible and code > 3:
                code -= 1
            if not split_possible and code > 1:
                code -= 1
            if ((block_info.ctx_index == 2 or block_info.ctx_index > 3)
                    and size > 8):
                if code < 3:
                    code = (code + 2) % 3
        else:
            if mode == MODE_SKIP:
                code = 0
            elif mode == MODE_INTER and ref_idx0 == 0:
                code = 2
            elif mode == MODE_MERGE:
                code = 3
            elif mode == MODE_BIPRED:
                code = 4
            elif mode == MODE_INTRA:
                code = 5
            else:  # MODE_INTER, ref_idx0 > 0
                code = 5 + ref_idx0
            if not bipred_possible and code > 4:
                code -= 1
            if not split_possible and code > 1:
                code -= 1
            if ((block_info.ctx_index == 2 or block_info.ctx_index > 3)
                    and size > 8):
                if code < 4:
                    code = (code + 3) % 4
        w.put_vlc(10 + maxbit, code)
    else:
        if encode_this_size and (size > 8 or split_flag == 1):
            w.put_flc(1, split_flag)


CBP_TABLE = [1, 0, 5, 2, 6, 3, 7, 4]


def write_block(w: BitWriter, enc, block_info, bp):
    """enc/write_bits.c:360-600. Returns bit count."""
    p = enc.params
    fi = enc.fi
    size = block_info.size
    sub = block_info.sub
    size_uv = size >> sub
    mode = bp["mode"]
    tb_split = bp["tb_split"]
    coeff_type = (int(mode == MODE_INTRA)) << 1

    start_bits = w.get_bit_pos()
    encode_this_size = (block_info.ypos + size <= enc.height and
                        block_info.xpos + size <= enc.width)
    write_super_mode(w, enc, block_info, mode, bp["ref_idx0"], 0,
                     encode_this_size)

    if (size == (1 << p.log2_sb_size) and mode != MODE_SKIP and
            (p.max_delta_qp or p.bitrate)):
        write_delta_qp(w, block_info.delta_qp)

    if mode == MODE_INTRA:
        if fi.num_intra_modes <= 4:
            w.put_flc(2, bp["intra_mode"])
        else:
            w.put_vlc(8, bp["intra_mode"])
    elif mode == MODE_INTER:
        if block_info.max_num_pb_part > 1:
            w.put_vlc(13, bp["pb_part"])
        mvp2 = block_info.mvp
        part = bp["pb_part"]
        mv0 = bp["mv_arr0"]
        if part == 0:
            write_mv(w, mv0[0], mvp2)
        elif part == 1:
            write_mv(w, mv0[0], mvp2)
            write_mv(w, mv0[2], mv0[0])
        elif part == 2:
            write_mv(w, mv0[0], mvp2)
            write_mv(w, mv0[1], mv0[0])
        else:
            write_mv(w, mv0[0], mvp2)
            write_mv(w, mv0[1], mv0[0])
            write_mv(w, mv0[2], mv0[0])
            write_mv(w, mv0[3], mv0[0])
    elif mode == MODE_BIPRED:
        mvp2 = block_info.mvp
        part = bp["pb_part"]
        mv0, mv1 = bp["mv_arr0"], bp["mv_arr1"]
        if part == 0:
            write_mv(w, mv0[0], mvp2)
        if fi.frame_type == B_FRAME:
            mvp2 = mv0[0]
        if part == 0:
            write_mv(w, mv1[0], mvp2)
        elif part == 1:
            write_mv(w, mv1[0], mvp2)
            write_mv(w, mv1[2], mv1[0])
        elif part == 2:
            write_mv(w, mv1[0], mvp2)
            write_mv(w, mv1[1], mv1[0])
        else:
            write_mv(w, mv1[0], mvp2)
            write_mv(w, mv1[1], mv1[0])
            write_mv(w, mv1[2], mv1[0])
            write_mv(w, mv1[3], mv1[0])
        if fi.frame_type == P_FRAME:
            if fi.num_ref == 2:
                w.put_vlc(13, 2 * bp["ref_idx0"] + bp["ref_idx1"])
            else:
                w.put_vlc(10, 4 * bp["ref_idx0"] + bp["ref_idx1"])
    elif mode == MODE_SKIP:
        n = block_info.num_skip_vec
        if n == 4:
            w.put_flc(2, bp["skip_idx"])
        elif n == 3:
            w.put_vlc(12, bp["skip_idx"])
        elif n == 2:
            w.put_flc(1, bp["skip_idx"])
    elif mode == MODE_MERGE:
        n = block_info.num_merge_vec
        if n == 4:
            w.put_flc(2, bp["skip_idx"])
        elif n == 3:
            w.put_vlc(12, bp["skip_idx"])
        elif n == 2:
            w.put_flc(1, bp["skip_idx"])

    if mode != MODE_SKIP:
        cbp_y, cbp_u, cbp_v = bp["cbp"]
        max_num_tb_part = block_info.max_num_tb_part
        if p.subsample == 400:
            w.put_flc(1, int(bool(cbp_y or tb_split)))
            if max_num_tb_part > 1 and (cbp_y or tb_split):
                w.put_flc(1, tb_split)
        else:
            off = 1 if mode == MODE_MERGE else 2
            if max_num_tb_part > 1 and tb_split:
                code = off
            else:
                cbp = int(bool(cbp_y)) + (int(bool(cbp_u)) << 1) + \
                    (int(bool(cbp_v)) << 2)
                code = CBP_TABLE[cbp]
                if mode == MODE_MERGE:
                    if code == 1:
                        code = 7
                    elif code > 1:
                        code -= 1
                else:
                    if block_info.ctx_cbp == 0 and code < 2:
                        code = 1 - code
                if max_num_tb_part > 1 and code >= off:
                    code += 1
            w.put_vlc(0, code)

        if tb_split == 0:
            if cbp_y:
                write_coeff(w, bp["coeff_y"], size, coeff_type | 0)
            if cbp_u:
                write_coeff(w, bp["coeff_u"], size_uv, coeff_type | 1)
            if cbp_v:
                write_coeff(w, bp["coeff_v"], size_uv, coeff_type | 1)
        else:
            if size_uv > 4:
                for index in range(4):
                    cy = (cbp_y >> (3 - index)) & 1
                    cu = (cbp_u >> (3 - index)) & 1
                    cv = (cbp_v >> (3 - index)) & 1
                    cbp = cy + (cu << 1) + (cv << 2)
                    code = CBP_TABLE[cbp]
                    if block_info.ctx_cbp == 0 and code < 2:
                        code = 1 - code
                    w.put_vlc(0, code)
                    if cy:
                        write_coeff(w, bp["coeff_y4"][index], size // 2,
                                    coeff_type | 0)
                    if cu:
                        write_coeff(w, bp["coeff_u4"][index], size_uv // 2,
                                    coeff_type | 1)
                    if cv:
                        write_coeff(w, bp["coeff_v4"][index], size_uv // 2,
                                    coeff_type | 1)
            else:
                for index in range(4):
                    cy = (cbp_y >> (3 - index)) & 1
                    w.put_flc(1, cy)
                    if cy:
                        write_coeff(w, bp["coeff_y4"][index], size // 2,
                                    coeff_type | 0)
                cbp = int(bool(cbp_u)) + 2 * int(bool(cbp_v))
                if p.subsample != 400:
                    w.put_vlc(13, cbp)
                if cbp_u:
                    write_coeff(w, bp["coeff_u"], size_uv, coeff_type | 1)
                if cbp_v:
                    write_coeff(w, bp["coeff_v"], size_uv, coeff_type | 1)

    return w.get_bit_pos() - start_bits
