"""Native (C) host-side entropy tier: the port's copy of the block parser.

The bit-serial VLC coefficient scan and the block-layer syntax walk
dominate host time; this module compiles the port's copies of entropy.c
and blockparse.c (plain cc, no external deps) into build/thor_tpu_torch/
on first use and exposes the ctypes mirrors of the parser's context and
of the C bit reader (the Python syntax walk scans coefficients through
`read_coeff_scan`).  A failed build raises with the compiler's
output.  (thor_tpu/_native/__init__.py also binds the encoder's
blockemit.c; that half comes with the port's encoder.)
"""
from __future__ import annotations

import ctypes
import os
import subprocess

from ..kernels.build import BUILD_DIR

_DIR = os.path.dirname(__file__)
_SO = os.path.join(BUILD_DIR, "libthorentropy.so")
_SRCS = [os.path.join(_DIR, "entropy.c"),
         os.path.join(_DIR, "blockparse.c")]

_lib = None


def _build():
    # built under a temporary name and renamed into place, so that a
    # concurrent process never loads a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    os.makedirs(BUILD_DIR, exist_ok=True)
    r = subprocess.run(["cc", "-O3", "-shared", "-fPIC"] + _SRCS +
                       ["-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SO} from {_DIR} failed "
                           f"(cc exit {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, _SO)


def get_lib():
    """Load the native library, building it first when it is missing or
    older than its sources."""
    global _lib
    if _lib is not None:
        return _lib
    src_mtime = max(os.path.getmtime(s) for s in _SRCS)
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < src_mtime:
        _build()
    lib = ctypes.CDLL(_SO)
    lib.parse_frame.restype = ctypes.c_long
    lib.parse_frame.argtypes = [ctypes.POINTER(ParseCtx)]
    lib.read_coeff_scan.restype = None
    lib.read_coeff_scan.argtypes = [ctypes.POINTER(BrStruct),
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
    _lib = lib
    return _lib


class BrStruct(ctypes.Structure):
    """Mirror of br_t in thor_native.h (the C bit reader)."""
    _fields_ = [("data", ctypes.c_char_p), ("nbytes", ctypes.c_long),
                ("bitpos", ctypes.c_long)]


_i32p = ctypes.POINTER(ctypes.c_int32)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i64p = ctypes.POINTER(ctypes.c_int64)


class ParseCtx(ctypes.Structure):
    """Mirror of parse_ctx_t in blockparse.c (field order must match)."""
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("sb_size", ctypes.c_int32),
        ("pb_split", ctypes.c_int32), ("tb_split_enable", ctypes.c_int32),
        ("max_delta_qp", ctypes.c_int32),
        ("use_block_contexts", ctypes.c_int32),
        ("bipred", ctypes.c_int32), ("seq_interp_ref", ctypes.c_int32),
        ("num_reorder_pics", ctypes.c_int32),
        ("sub", ctypes.c_int32), ("mono", ctypes.c_int32),
        ("frame_type", ctypes.c_int32), ("stat_frame_type", ctypes.c_int32),
        ("num_ref", ctypes.c_int32), ("interp_ref", ctypes.c_int32),
        ("num_intra_modes", ctypes.c_int32), ("qp", ctypes.c_int32),
        ("qpb", ctypes.c_int32),
        ("phase", ctypes.c_int32), ("rec_frame_num", ctypes.c_int32),
        ("ref_frame_num", ctypes.c_int32 * 8),
        ("ref_slot", ctypes.c_int32 * 8),
        ("bs", ctypes.c_int32), ("rows", ctypes.c_int32),
        ("dd_mode", _i32p), ("dd_size", _i32p), ("dd_tb_split", _i32p),
        ("dd_pb_part", _i32p),
        ("dd_cbp_y", _i32p), ("dd_cbp_u", _i32p), ("dd_cbp_v", _i32p),
        ("dd_mv0", _i32p), ("dd_mv1", _i32p),
        ("dd_ref0", _i32p), ("dd_ref1", _i32p), ("dd_bipred", _i32p),
        ("dd_arr_mv0", _i32p),
        ("blk", _i32p), ("blk_cap", ctypes.c_long),
        ("n_blk", ctypes.c_long),
        ("tb", _i32p), ("tb_cap", ctypes.c_long), ("n_tb", ctypes.c_long),
        ("coef", _i16p), ("coef_cap", ctypes.c_long),
        ("coef_len", ctypes.c_long),
        ("enable_plan", ctypes.c_int32),
        ("gh", ctypes.c_int32), ("gw", ctypes.c_int32),
        ("ly", _i32p * 14),
        ("ch", _i32p * 10),
        ("avg", _i32p), ("inter", _i32p),
        ("dcoef_y", _i16p), ("dcoef_u", _i16p), ("dcoef_v", _i16p),
        ("dcy_stride", ctypes.c_long), ("dcc_stride", ctypes.c_long),
        ("qp4_y", _i32p), ("ls4_y", _i32p), ("qp4_c", _i32p),
        ("ls4_c", _i32p),
        ("q4y_stride", ctypes.c_long), ("q4c_stride", ctypes.c_long),
        ("zz4", _i32p), ("zz8", _i32p), ("zz16", _i32p),
        ("stats", _i64p),
        ("data", ctypes.c_char_p), ("nbytes", ctypes.c_long),
        ("bitpos", ctypes.c_long),
        ("error", ctypes.c_int32),
    ]


def i32p(arr):
    return arr.ctypes.data_as(_i32p)


def i16p(arr):
    return arr.ctypes.data_as(_i16p)


def i64p(arr):
    return arr.ctypes.data_as(_i64p)
