"""The wavefront device encoder's decision pass, LDB low-complexity path
(torch port of thor_tpu/enc/device_lc.py).

The full RDO quadtree of the reference's process_block
(enc/encode_block.c:2401) is evaluated on the device as a static z-order
"node program" per superblock, batched over the superblocks (lanes) of an
anti-diagonal (dependencies: left, top-left, top, top-right), with every
decision - early skip, skip/merge/inter/intra mode costs, motion search
trajectories, quadtree split compares - replicated bit-exactly.  The host
then replays only the winning syntax through the ordinary bit writer,
producing the stream of the sequential encoder byte for byte.

Scope: P and I frames of the LDB low-complexity preset family
(`lc_supported`): encoder_speed 2, no tb/pb split, no bipred, no
intra_rdo (4 intra modes), early skip on, 4:2:0, 8-bit, fixed QP.

The frame takes one of two routes, as in thor_tpu (encode_frame_device):
- `frame_megakernel`, the default: one diagonal body (`diagonal_body`:
  gather_lanes, all 106 steps, flush_lanes) whose lane positions are
  device data (the [4, D, L] `lane_tables`), so every diagonal does the
  same work and reads nothing back to the host.  On the CPU it runs
  eagerly per diagonal; on the card (`DiagonalGraph`) diagonal 0 runs
  eagerly, the body is captured once per frame configuration as a CUDA
  graph, and each other diagonal is one replay after a device-to-device
  copy of its lane table (thor_tpu's jit(scan(switch)) call);
- the host loop (`run_diagonal`, megakernel=False; thor_tpu's
  THOR_LC_MEGAKERNEL=0): per diagonal the lanes are host integers, each
  step is dispatched from Python and steps outside the frame are
  skipped.
Both give thor_tpu's records; the decision records stay on the device
and are pulled once per frame.

Functions that take the lane state `st` update it in place (the JAX
version returns a new dict).  Index semantics: window starts that depend
on data (`_wins3`, the MC and motion-search reads) follow
lax.dynamic_slice, wrap then clamp (`_dstart`); every other index is
either a Python integer, checked in range on the host (`_span`), or an
in-range lane index (`_gat`; tests/test_torch_device_lc.py checks it).
"""
from __future__ import annotations

import collections
import functools
import math
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..tables import CHROMA_QP, COEFFS_CHROMA, GQUANT, ZIGZAG, log2i
from ..ops.enc_kernels import (widesad_batch, fasthalf_batch,
                               fastquarter_phase)
from ..ops.transform import (fwd_transform_batch, dequantize_batch,
                             inv_transform_batch, reconstruct_batch, _i16)
from ..ops.quant import quantize_batch
from ..ops.coeff_cost import coeff_bits_batch, _log2i
from ..ops.mc import _luma_variants
from ..ops.me_batch import _dstart
from ..ops import intra_batch as IB

I32, I64, F64 = torch.int32, torch.int64, torch.float64
MAX_MV_EXT = 144
MAX_UINT32 = 1 << 31          # the encoder's MAX_UINT32 sentinel
MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED, MODE_MERGE = 0, 1, 2, 3, 4
I_FRAME, P_FRAME, B_FRAME = 0, 1, 2
SB = 128                       # log2_sb_size 7 (LDB defaults)
NCAND = 64                     # mvcand slots per ref
KEY_NONE = 1 << 62             # the keyed argmins' "no candidate"

# ---------------------------------------------------------------------------
# node program
# ---------------------------------------------------------------------------
# Node ids: z-order enumeration; sizes 128,64,32,16,8.
N_OFF = {128: 0, 64: 1, 32: 5, 16: 21, 8: 85}
N_NODES = 341

K_E128, K_E64, K_E32, K_D32, K_D64, K_D128, K_16SUB = range(7)


def node_id(size, oy, ox):
    """z-order node slot for a block at SB-local offset (oy, ox)."""
    if size == 128:
        return 0
    idx = 0
    s = 128
    while s > size:
        s //= 2
        q = (oy // s % 2) * 2 + (ox // s % 2)
        idx = idx * 4 + q
    return N_OFF[size] + idx


# quadtree recursion order in the reference is (ypos,xpos), (ypos+ns,xpos),
# (ypos,xpos+ns), (ypos+ns,xpos+ns) - i.e. NW, SW, NE, SE (column-major)
# (enc/encode_block.c:2505-2512).  Keep exactly: it orders every
# neighbour-state dependency.
def child_offsets(size):
    h = size // 2
    return [(0, 0), (h, 0), (0, h), (h, h)]


def build_program():
    """The static step program for one SB (LC path, fused 16-subtrees):
    a list of 106 (kind, oy, ox)."""
    prog = []

    def walk(size, oy, ox):
        if size == 16:
            prog.append((K_16SUB, oy, ox))
            return
        prog.append(({128: K_E128, 64: K_E64, 32: K_E32}[size], oy, ox))
        for dy, dx in child_offsets(size):
            walk(size // 2, oy + dy, ox + dx)
        prog.append(({128: K_D128, 64: K_D64, 32: K_D32}[size], oy, ox))

    walk(128, 0, 0)
    assert len(prog) == 106
    return prog


# ---------------------------------------------------------------------------
# VLC length helpers
# ---------------------------------------------------------------------------

def _log2i_j(v):
    """31 - clz(max(v, 1)) (frexp form, ops/coeff_cost.py)."""
    return _log2i(torch.clamp(v, min=1))


def len_vlc_low(n: int, cn):
    """Length of put_vlc(n, cn) for tables 0..5 (bitstream.py:119-125)."""
    e = 5
    thr = e * (1 << n)
    code = cn - thr + (1 << n)
    return torch.where(cn < thr, 1 + n + (cn >> n),
                       (e - n) + 1 + 2 * _log2i_j(code))


def len_vlc7(cn):
    """put_vlc(7, cn) length: 0->2, 1->3, 2..3->4, else table 3 on cn+4."""
    return torch.where(cn == 0, 2,
                       torch.where(cn == 1, 3,
                                   torch.where(cn < 4, 4,
                                               len_vlc_low(3, cn + 4))))


def len_unary_hi(n: int, cn):
    """put_vlc(n, cn) for 11<=n<=18: cn==n-10 -> n-10 bits else cn+1."""
    return torch.where(cn == n - 10, n - 10, cn + 1)


def mv_bits_exact(dy, dx):
    """write_mv length (enc/write_bits.c:123-143)."""
    ax, ay = dx.abs(), dy.abs()
    return len_vlc7(ax) + (ax > 0).to(I32) + len_vlc7(ay) + (ay > 0).to(I32)


# quote_mv_bits' per-component length below |mv| 36
_QUOTE_LEN = np.array([2, 4, 5, 5] + [6 + ((m - 4) >> 3)
                                      for m in range(4, 36)], np.int32)


def quote_mv_bits_j(dy, dx):
    """quote_mv_bits (enc/encode_block.c:467-515) for ME cost: both
    components at once, a table below 36."""
    m = torch.stack([dy, dx]).abs()
    ln = torch.where(m < 36, _tabs(m.device)["quote"][m.clamp(max=35)],
                     11 + ((m - 36) >> 4))
    return ln[0] + ln[1]


def mv_cost_j(sqrt_lam, dy, dx):
    """floor(sqrt_lam * bits + 0.5) in float64 (no fused multiply-add)."""
    bits = quote_mv_bits_j(dy, dx)
    return torch.floor(sqrt_lam * bits.to(F64) + 0.5).to(I64)


def super_mode_bits(mode_code_args, size: int, num_ref: int,
                    encode_this: bool):
    """Length of write_super_mode for a non-split block at LC
    (enc/write_bits.c:257-358; interp_ref=0, bipred off).
    mode_code_args: (mode, ref_idx0, ctx_index) [L].  Returns bits [L]
    int32; encode_this False -> 1 bit."""
    mode, ref_idx0, ctx_index = mode_code_args
    if not encode_this:
        return torch.ones_like(mode)
    split_possible = 1 if size > 8 else 0
    maxbit = 2 + num_ref + split_possible        # bipred_possible = 0
    code = torch.where(
        mode == MODE_SKIP, 0,
        torch.where((mode == MODE_INTER) & (ref_idx0 == 0), 2,
                    torch.where(mode == MODE_MERGE, 3,
                                torch.where(mode == MODE_BIPRED, 4,
                                            torch.where(mode == MODE_INTRA,
                                                        5, 5 + ref_idx0)))))
    code = torch.where(code > 4, code - 1, code)   # bipred impossible
    if not split_possible:
        code = torch.where(code > 1, code - 1, code)
    ctx_hit = (ctx_index == 2) | (ctx_index > 3)
    if size > 8:
        code = torch.where(ctx_hit & (code < 4), (code + 3) % 4, code)
    return len_unary_hi(10 + maxbit, code).to(I32)


def super_mode_bits_i(size: int, encode_this: bool):
    """I-frame super mode: 1 bit if size > 8 (or split)."""
    return 1 if (encode_this and size > 8) else 0


CBP_TABLE = np.array([1, 0, 5, 2, 6, 3, 7, 4], np.int32)


def _cbp_code_bits(cbp, ctx_cbp, merge: bool):
    """The CBP code's length from the 3-bit cbp pattern."""
    code = _tabs(cbp.device)["cbp"][cbp.long()]
    if merge:
        code = torch.where(code == 1, 7, torch.where(code > 1, code - 1,
                                                     code))
    else:
        code = torch.where((ctx_cbp == 0) & (code < 2), 1 - code, code)
    return len_vlc_low(0, code).to(I32)


@functools.cache
def _cbp_table(merge: bool, device: str):
    """_cbp_code_bits over every (ctx_cbp == 0, pattern), indexed by
    (ctx_cbp == 0) * 8 + pattern."""
    pat = torch.arange(16, dtype=I32, device=device)
    return _cbp_code_bits(pat % 8, torch.where(pat >= 8, 0, 1), merge)


def cbp_bits(cbp_y, cbp_u, cbp_v, ctx_cbp, merge: bool):
    """CBP code length for the no-tb-split 4:2:0 path
    (enc/write_bits.c:500-525, max_num_tb_part == 1), by table."""
    idx = ((cbp_y > 0).to(I32) + ((cbp_u > 0).to(I32) << 1) +
           ((cbp_v > 0).to(I32) << 2) + ((ctx_cbp == 0).to(I32) << 3))
    return _cbp_table(merge, str(idx.device))[idx]


# intra mode bits at <=4 modes: put_flc(2, .) = 2 bits
INTRA_MODE_BITS = 2


@functools.cache
def _tabs_on(device: str):
    def t(a, dt=I64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return {"cbp": t(CBP_TABLE, I32),
            "zzinv": {s: t(np.argsort(ZIGZAG[min(16, s)]))
                      for s in (4, 8, 16, 32, 64)},
            "mvp": t(_MVP_TABLE),
            # the hexagon's (diy, dix) (enc/encode_block.c:607)
            "hex": t([[1, 2, 1, -1, -2, -1], [-1, 0, 1, 1, 0, -1]], I32),
            "order4": t(SEARCH_ORDER4, I32),
            "quote": t(_QUOTE_LEN, I32),
            "arange": {}, "const": {}}


def _tabs(device):
    """Constant tables on `device`, uploaded once per device (an upload
    per call would synchronise the stream)."""
    return _tabs_on(str(torch.device(device)))


def _const_index(device, *rows):
    """Constant index tensors on `device`, one per row of host integers,
    uploaded once: an index given as a Python list is uploaded on every
    call, which synchronises the stream and cannot be captured."""
    tab = _tabs(device)["const"]
    key = tuple(map(tuple, rows))
    if key not in tab:
        tab[key] = tuple(torch.tensor(r, device=device) for r in key)
    return tab[key]


def _ar(n: int, device):
    """torch.arange(n) on `device`, built once."""
    tab = _tabs(device)["arange"]
    if n not in tab:
        tab[n] = torch.arange(n, device=device)
    return tab[n]


# ---------------------------------------------------------------------------
# lane-local grid helpers
# ---------------------------------------------------------------------------

def _span(o: int, n: int, dim: int):
    """slice(o, o + n) for a Python-integer start, which must lie inside
    (where lax.dynamic_slice would clamp; the host checks it)."""
    assert 0 <= o and o + n <= dim, (o, n, dim)
    return slice(o, o + n)


def _gat(arr, iy, ix):
    """arr [L, C, H, W] at per-lane cells (iy[l], ix[l]) -> [L, C].  The
    cells are in range by construction (take_along_axis would fill an
    index past the end)."""
    lanes = _ar(arr.shape[0], arr.device)
    return arr[lanes, :, iy.long(), ix.long()]


def _wins3(arr3d, k, y0, x0, h: int, w: int):
    """Windows [..., h, w] from a stacked variant array [V,H,W] at
    (k, y0, x0) of any common shape, with dynamic_slice's start rule."""
    V, H, W = arr3d.shape
    sh = tuple(y0.shape)
    dev = arr3d.device
    kk = _dstart(k.reshape(-1), 1, V)
    ys = _dstart(y0.reshape(-1), h, H)[:, None] + _ar(h, dev)
    xs = _dstart(x0.reshape(-1), w, W)[:, None] + _ar(w, dev)
    out = arr3d[kk[:, None, None], ys[:, :, None], xs[:, None, :]]
    return out.reshape(sh + (h, w))


def trunc_div4(v):
    """C truncation toward zero of v/4: (v + 3) >> 2 for a negative v."""
    return torch.where(v < 0, v + 3, v) >> 2


def clip_mv_j(mvy, mvx, ypos, xpos, fw: int, fh: int, bw, bh, sign: int = 0):
    """inter_prediction.c:51-63 over tensors."""
    def clip(mv, pos, b, f):
        mv = torch.where(pos + trunc_div4(mv) < -MAX_MV_EXT,
                         (-MAX_MV_EXT - pos) * 4, mv)
        return torch.where(pos + trunc_div4(mv) + b > f + MAX_MV_EXT,
                           (f + MAX_MV_EXT - pos - b) * 4, mv)
    if sign:
        mvy, mvx = -mvy, -mvx
    mvy, mvx = clip(mvy, ypos, bh, fh), clip(mvx, xpos, bw, fw)
    if sign:
        mvy, mvx = -mvy, -mvx
    return mvy, mvx


# ---------------------------------------------------------------------------
# motion compensation via pre-filtered variant stacks
# ---------------------------------------------------------------------------

def make_luma_variants(ref_full, bitdepth: int = 8):
    """16 quarter-pel variants of a padded plane (ops/mc.py layout),
    int16."""
    return _luma_variants(ref_full.to(I32), 0, bitdepth).to(torch.int16)


def make_chroma_variants(ref_full_c, bitdepth: int = 8):
    """The 64 eighth-pel variants of a padded chroma plane, int16:
    V[f*8+g][y, x] is the 4-tap output for pixel (y+1, x+1)."""
    r = ref_full_c.to(I32)
    hp, wp = r.shape
    maxval = (1 << bitdepth) - 1
    horiz = []
    for g in range(8):
        t = torch.zeros((hp, wp - 3), dtype=I32, device=r.device)
        for m in range(4):
            c = int(COEFFS_CHROMA[g][m])
            if c:
                t = t + c * r[:, m:wp - 3 + m]
        horiz.append(t)
    out = []
    for f in range(8):
        for g in range(8):
            if f == 0 and g == 0:
                out.append(r[1:hp - 2, 1:wp - 2])
                continue
            t = torch.zeros((hp - 3, wp - 3), dtype=I32, device=r.device)
            for m in range(4):
                c = int(COEFFS_CHROMA[f][m])
                if c:
                    t = t + c * horiz[g][m:hp - 3 + m]
            out.append(((t + 2048) >> 12).clamp(0, maxval))
    return torch.stack(out).to(torch.int16)


# ---------------------------------------------------------------------------
# local deblock-data derivation (per-lane [L,14,34,34] grid, origin (1,1))
# ---------------------------------------------------------------------------

DD_FIELDS = ("mode", "size", "tb", "pb", "cbp_y", "cbp_u", "cbp_v",
             "mv0y", "mv0x", "mv1y", "mv1x", "ref0", "ref1", "bip")
DD = {f: i for i, f in enumerate(DD_FIELDS)}
DD_CAND = slice(DD["mv0y"], DD["bip"] + 1)     # the 7 candidate fields


def _avail_flags(ypos, xpos, oy: int, ox: int, size: int, fw: int,
                 fh: int):
    """Up, up-right, left and down-left availability of the block at
    (ypos, xpos) = SB origin + (oy, ox) (common/common_block.c).  The SB
    origin is a multiple of every quadtree size, so the quadtree terms
    (ypos % size2 == oy % size2) are the host's; only the frame edges
    read the lanes."""
    up = ypos > 0
    left = xpos > 0
    ur_bad = False
    size2 = size
    while size2 < SB:
        ur_bad |= ((oy % (size2 << 1)) == size2 and
                   (ox % size2) == (size2 - size))
        size2 *= 2
    dl_bad = (oy % SB) == (SB - size) and (ox % SB) == 0
    size2 = 2 * size
    while size2 <= SB:
        dl_bad |= (oy % size2) == (size2 - size) and (ox % size2) > 0
        size2 *= 2
    ur = up & (xpos + size < fw) if not ur_bad else torch.zeros_like(up)
    dl = left & (ypos + size < fh) if not dl_bad else torch.zeros_like(up)
    return up, ur, left, dl


# median-MVP neighbour cases (inter_prediction.c:413-526): the cells
# read, and for each availability code U*8 + UR*4 + L*2 + DL the three
# cells (a, b, c); 9 is the zero cell
_UP0, _UP1, _UP2, _LEFT0, _LEFT1, _LEFT2, _DOWNLEFT, _UPRIGHT, _UPLEFT, \
    _ZERO = range(10)
_MVP_CASES = {
    0b1000: (_UP0, _UP1, _UP2),
    0b1100: (_UP0, _UP2, _UPRIGHT),
    0b0010: (_LEFT0, _LEFT1, _LEFT2),
    0b1010: (_UPLEFT, _UP2, _LEFT2),
    0b1110: (_UP0, _UPRIGHT, _LEFT2),
    0b0011: (_LEFT0, _LEFT2, _DOWNLEFT),
    0b1011: (_UP2, _LEFT0, _DOWNLEFT),
    0b1111: (_UP0, _UPRIGHT, _LEFT0),
}
_MVP_TABLE = np.array([_MVP_CASES.get(c, (_ZERO,) * 3) for c in range(16)],
                      np.int64)


def mv_pred_local(st, oy: int, ox: int, size: int, ypos, xpos, fw: int,
                  fh: int):
    """Median MVP from the per-lane local dd grid
    (inter_prediction.c:413-526).  oy/ox: SB-local offsets."""
    bsz = size // 4
    by, bx = 1 + oy // 4, 1 + ox // 4
    U, UR, Lv, DL = _avail_flags(ypos, xpos, oy, ox, size, fw, fh)
    cells = ((-1, 0), (-1, (bsz - 1) // 2), (-1, bsz - 1), (0, -1),
             ((bsz - 1) // 2, -1), (bsz - 1, -1), (bsz, -1), (-1, bsz),
             (-1, -1))
    cy = [by + dy for dy, _ in cells]
    cx = [bx + dx for _, dx in cells]
    assert min(cy + cx) >= 0 and max(cy + cx) < st["dd"].shape[2]
    iy, ix = _const_index(st["dd"].device, cy, cx)
    g = st["dd"][:, DD["mv0y"]:DD["mv0x"] + 1, iy, ix]          # [L,2,9]
    g = F.pad(g, (0, 1))                                        # + zero
    code = ((U.to(I64) << 3) | (UR.to(I64) << 2) | (Lv.to(I64) << 1) |
            DL.to(I64))
    sel = _tabs(g.device)["mvp"][code]                            # [L,3]
    abc = g.gather(2, sel[:, None, :].expand(-1, 2, -1))        # [L,2,3]
    a, b, c = abc[:, :, 0], abc[:, :, 1], abc[:, :, 2]
    med = torch.where(a < b, torch.minimum(b, torch.maximum(a, c)),
                      torch.minimum(a, torch.maximum(b, c))).to(I32)
    return med[:, 0], med[:, 1]


def two_cands_local(st, oy: int, ox: int, size: int, ypos, xpos, fw: int,
                    fh: int):
    """Skip/merge candidates from local dd (inter_prediction.c:565-679).
    Returns cand [L,2,7] int32 and count [L]."""
    bsz = size // 4
    by, bx = 1 + oy // 4, 1 + ox // 4
    up = ypos > 0
    left = xpos > 0
    ur = _avail_flags(ypos, xpos, oy, ox, size, fw, fh)[1]
    dd = st["dd"]
    l2_dy = torch.where(ypos + size > fh, 0, bsz - 1)
    u2_dx = torch.where(xpos + size > fw, 0, bsz - 1)
    c_left2 = _gat(dd[:, DD_CAND], by + l2_dy, torch.full_like(ypos, bx - 1))
    c_up2 = _gat(dd[:, DD_CAND], torch.full_like(ypos, by - 1), bx + u2_dx)
    c_upright = dd[:, DD_CAND, by - 1, bx + bsz]
    c0 = torch.where(left[:, None], c_left2, 0)
    c1 = torch.where(ur[:, None], c_upright,
                     torch.where(up[:, None], c_up2, 0))
    eq6 = (c0[:, :6] == c1[:, :6]).all(dim=1)
    dup = eq6 & ((c0[:, 6] == c1[:, 6]) | (c1[:, 6] == -1))
    n = torch.where(dup, 1, 2).to(I32)
    return torch.stack([c0, c1], dim=1).to(I32), n


def contexts_local(st, oy: int, ox: int, size: int, ypos, xpos, fw: int,
                   fh: int, enable: int):
    """find_block_contexts (common/common_block.c:283-303) on local dd."""
    by, bx = 1 + oy // 4, 1 + ox // 4
    if enable:
        ok = ((ypos >= 8) & (xpos >= 8) & (ypos + size < fh) &
              (xpos + size < fw))
    else:
        ok = torch.zeros_like(ypos, dtype=torch.bool)
    dd = st["dd"]
    s_up = dd[:, DD["size"], by - 1, bx]
    s_left = dd[:, DD["size"], by, bx - 1]
    cbp_up = dd[:, DD["cbp_y"]:DD["cbp_v"] + 1, by - 1, bx] > 0   # [L,3]
    cbp_left = dd[:, DD["cbp_y"]:DD["cbp_v"] + 1, by, bx - 1] > 0
    split = (s_up < size).to(I32) + (s_left < size).to(I32)
    cbp1 = cbp_up[:, 0].to(I32) + cbp_left[:, 0].to(I32)
    cbp2 = cbp_up.any(dim=1).to(I32) + cbp_left.any(dim=1).to(I32)
    return (torch.where(ok, split, -1), torch.where(ok, cbp1, -1),
            torch.where(ok, 3 * split + cbp2, -1))


# ---------------------------------------------------------------------------
# motion estimation (lockstep, LC fast path), batched candidate probes
# ---------------------------------------------------------------------------

def _take(a, i):
    """a [N, K] at per-row column i [N] -> [N]."""
    return a.gather(1, i[:, None].long())[:, 0]


def me_lc(org, ref_stack, ref_idx, pad: int, ypos, xpos, size: int,
          mvp_y, mvp_x, sqrt_lam, cand_y, cand_x, cand_n, fw: int,
          fh: int):
    """Reference motion_estimate (enc/encode_block.c:517-711), LC path:
    candidate stage (+widesad at 16) -> hexagon (sizes<=16) -> fast
    half/quarter-pel.  sign=0 (P frames).  org [L,s,s]; ref_stack
    [R,Hp,Wp] with per-lane ref_idx [L]; cand_* [L,NCAND]; sqrt_lam a
    float.  Returns (sad [L] int64, mv_y, mv_x [L] int32)."""
    Lb = org.shape[0]
    dev = org.device
    y0 = pad + ypos
    x0 = pad + xpos
    org = org.to(I32)
    min_sad = torch.full((Lb,), MAX_UINT32, dtype=I64, device=dev)
    slot = _ar(NCAND, dev)[None, :]

    # ---- candidate stage (:575-605): all NCAND probes in one gather ----
    cy = cand_y << 2
    cx = cand_x << 2
    cy, cx = clip_mv_j(cy, cx, ypos[:, None], xpos[:, None], fw, fh,
                       size, size)
    wy = y0[:, None] + (cy >> 2)
    rsel = ref_idx[:, None].expand(cy.shape)
    if size == 16:
        wx = x0[:, None] + (cx >> 2) - 3
        win = _wins3(ref_stack, rsel, wy, wx, size, size + 6)
        sad, xoff = widesad_batch(
            org[:, None].expand(Lb, NCAND, size, size).reshape(
                Lb * NCAND, size, size),
            win.reshape(Lb * NCAND, size, size + 6))
        sad = sad.reshape(Lb, NCAND)
        cx = cx + (xoff.reshape(Lb, NCAND) << 2)
    else:
        wx = x0[:, None] + (cx >> 2)
        win = _wins3(ref_stack, rsel, wy, wx, size, size).to(I32)
        sad = (org[:, None] - win).abs().sum(dim=(2, 3))
    sad = sad + mv_cost_j(sqrt_lam, cy - mvp_y[:, None],
                          cx - mvp_x[:, None])
    live = slot < cand_n[:, None]
    key = torch.where(live, sad * NCAND + slot, KEY_NONE)
    bi = key.argmin(dim=1)
    bsad = _take(sad, bi)
    take = bsad < min_sad
    min_sad = torch.where(take, bsad, min_sad)
    opt_y = torch.where(take, _take(cy, bi), 0).to(I32)
    opt_x = torch.where(take, _take(cx, bi), 0).to(I32)
    ref_y, ref_x = opt_y, opt_x

    # ---- hexagon refinement (:607-641), sizes <= 16: five rounds ----
    if size <= 16:
        hexd = _tabs(dev)["hex"]
        start = torch.zeros((Lb,), dtype=I32, device=dev)
        end = torch.full((Lb,), 5, dtype=I32, device=dev)
        active = torch.ones((Lb,), dtype=torch.bool, device=dev)
        direc = _ar(6, dev)[None, :]
        for _ in range(1, 6):
            # NB: C indexes dix with the y-delta and diy with x (quirk)
            cy6 = ref_y[:, None] + hexd[1][None, :] * 4
            cx6 = ref_x[:, None] + hexd[0][None, :] * 4
            cy6, cx6 = clip_mv_j(cy6, cx6, ypos[:, None], xpos[:, None],
                                 fw, fh, size, size)
            win = _wins3(ref_stack, ref_idx[:, None].expand(cy6.shape),
                         y0[:, None] + (cy6 >> 2),
                         x0[:, None] + (cx6 >> 2), size, size).to(I32)
            sad6 = (org[:, None] - win).abs().sum(dim=(2, 3))
            sad6 = sad6 + mv_cost_j(sqrt_lam, cy6 - mvp_y[:, None],
                                    cx6 - mvp_x[:, None])
            # visit order (start..end mod 6) with first-better-wins
            pos = (direc - start[:, None]) % 6
            length = ((end - start) % 6) + 1
            livex = active[:, None] & (pos < length[:, None])
            key = torch.where(livex & (sad6 < min_sad[:, None]),
                              sad6 * 8 + pos, KEY_NONE)
            bj = key.argmin(dim=1)
            found = _take(key, bj) < KEY_NONE
            min_sad = torch.where(found, _take(sad6, bj), min_sad)
            opt_y = torch.where(found, _take(cy6, bj), opt_y)
            opt_x = torch.where(found, _take(cx6, bj), opt_x)
            best_dir = torch.where(found, bj.to(I32), -1)
            start = torch.where(best_dir != 0, best_dir - 1, 5).to(I32)
            end = torch.where(start + 2 >= 6, start + 2 - 6, start + 2)
            active = active & (best_dir >= 0)
            ref_y, ref_x = opt_y, opt_x

    # ---- fast bilinear sub-pel (:653-700) ----
    cmin = min_sad
    hwin = _wins3(ref_stack, ref_idx, y0 + (ref_y >> 2) - 2,
                  x0 + (ref_x >> 2) - 2, size + 4, size + 4)
    hsad, spx, spy = fasthalf_batch(org, hwin)
    hsad = hsad + mv_cost_j(sqrt_lam, ref_y + spy - mvp_y,
                            ref_x + spx - mvp_x)
    better = hsad < cmin
    cmin = torch.where(better, hsad, cmin)
    spy = torch.where(better, spy, 0)
    spx = torch.where(better, spx, 0)
    mr_y = opt_y + spy
    mr_x = opt_x + spx
    opt_y = mr_y
    opt_x = mr_x

    qwin = _wins3(ref_stack, ref_idx, y0 + (mr_y >> 2) - 1,
                  x0 + (mr_x >> 2) - 1, size + 2, size + 2)
    # the four quarter-pel searches, each block at its own half-pel phase
    # (the JAX version runs all four and keeps the block's)
    qsad, qx2, qy2 = fastquarter_phase(org, qwin, spx != 0, spy != 0)
    qsad = qsad + mv_cost_j(sqrt_lam, mr_y + qy2 - mvp_y,
                            mr_x + qx2 - mvp_x)
    better = qsad < cmin
    cmin = torch.where(better, qsad, cmin)
    return (torch.minimum(cmin, min_sad),
            opt_y + torch.where(better, qy2, 0),
            opt_x + torch.where(better, qx2, 0))


def add_mvcand(mvc_y, mvc_x, mvc_mask, mvc_num, mvy, mvx, enable):
    """add_mvcandidate (enc/encode_block.c:69-82) for one ref column.
    mvc_y/x [L,NCAND]; mask [L] int64; num [L]; mv [L]; enable [L] bool."""
    iy = (mvy + 2) >> 2
    ix = (mvx + 2) >> 2
    bit = (((iy << 3) ^ ix) & 63).to(I64)
    m = torch.ones_like(bit) << bit
    fresh = enable & ((m & mvc_mask) == 0)
    upd = (_ar(NCAND, mvy.device)[None, :] == mvc_num[:, None]) & \
        fresh[:, None]
    mvc_y = torch.where(upd, iy[:, None], mvc_y)
    mvc_x = torch.where(upd, ix[:, None], mvc_x)
    mvc_num = mvc_num + fresh.to(I32)
    mvc_mask = torch.where(enable, mvc_mask | m, mvc_mask)
    return mvc_y, mvc_x, mvc_mask, mvc_num


# ---------------------------------------------------------------------------
# motion compensation + trial encodes
# ---------------------------------------------------------------------------
PADY = 160
PADC = 80


def _mc_luma(vars_y, ref_sel, mvy, mvx, ypos, xpos, size: int, bw, bh,
             fw: int, fh: int, cl_y, cl_x):
    """Quarter-pel luma MC window via the per-ref 16-variant stack
    (inter_prediction.c:117-181).  vars_y: [R*16, Hv, Wv]; all other args
    tensors of a common shape S; returns [S, size, size] int32.  bw/bh
    are the extents the integer clamps use; cl_y/cl_x the clamp
    origins."""
    fv = mvy & 3
    fhh = mvx & 3
    vi = torch.minimum(mvy >> 2, fh - cl_y)
    vi = torch.maximum(vi, -cl_x - bh)      # (sic) reference quirk: xpos
    hi = torch.minimum(mvx >> 2, fw - cl_x)
    hi = torch.maximum(hi, -cl_x - bw)
    oy = PADY + ypos + vi - 2
    ox = PADY + xpos + hi - 2
    k = ref_sel * 16 + fv * 4 + fhh
    return _wins3(vars_y, k, oy, ox, size, size).to(I32)


def _mc_chroma(vars_c, ref_sel, mvy, mvx, ypos_c, xpos_c, size_c: int,
               bw_c, bh_c, fw_c: int, fh_c: int, cl_y, cl_x):
    """Eighth-pel chroma MC windows of U and V via the per-ref 64-variant
    stacks (inter_prediction.c:65-115).  vars_c: [2*R*64, Hv, Wv], the U
    stacks then the V stacks.  Chroma coordinates; mv in luma quarter-pel
    units.  Returns (pu, pv) [S, size_c, size_c] int32."""
    fv = mvy & 7
    fhh = mvx & 7
    vi = torch.minimum(mvy >> 3, fh_c - cl_y)
    vi = torch.maximum(vi, -cl_x - bh_c)
    hi = torch.minimum(mvx >> 3, fw_c - cl_x)
    hi = torch.maximum(hi, -cl_x - bw_c)
    oy = PADC + ypos_c + vi - 1
    ox = PADC + xpos_c + hi - 1
    k = ref_sel * 64 + fv * 8 + fhh
    puv = _wins3(vars_c, torch.stack([k, k + vars_c.shape[0] // 2]),
                 oy.expand((2,) + oy.shape), ox.expand((2,) + ox.shape),
                 size_c, size_c).to(I32)
    return puv[0], puv[1]


def mc_yuv(fc, cfg, ref_sel, mvy, mvx, ypos, xpos, size: int, bw, bh):
    """get_inter_prediction_yuv (inter_prediction.c:185-226), LC path:
    no pb split, 4:2:0, sign 0.  All tensor args share a shape S; returns
    (py [S,size,size], pu, pv [S,size/2,size/2]) int32.  Pixels beyond
    (bw, bh) are garbage and must be masked by the caller."""
    fw, fh = cfg["w"], cfg["h"]
    mvy, mvx = clip_mv_j(mvy, mvx, ypos, xpos, fw, fh, bw, bh)
    py = _mc_luma(fc["vars_y"], ref_sel, mvy, mvx, ypos, xpos, size,
                  bw, bh, fw, fh, ypos, xpos)
    yc, xc = ypos >> 1, xpos >> 1
    pu, pv = _mc_chroma(fc["vars_c"], ref_sel, mvy, mvx, yc, xc, size // 2,
                        bw >> 1, bh >> 1, fw >> 1, fh >> 1, yc, xc)
    return py, pu, pv


def ssd_masked(a, b, bw, bh, s: int):
    """SSD over the (bh, bw) valid region of [L,s,s] blocks."""
    d = (a - b).to(I64)
    ar = _ar(s, a.device)
    rows = ar[None, :, None] < bh[:, None, None]
    cols = ar[None, None, :] < bw[:, None, None]
    return (d * d * (rows & cols)).sum(dim=(1, 2))


def cost_calc_j(ssd, nbits, lam):
    """enc/encode_block.c:916-926 (8-bit: ssd >> 0)."""
    cost = ssd.to(I64) + torch.floor(lam * nbits.to(F64) + 0.5).to(I64)
    return torch.clamp(cost, max=1 << 30)


def coeff_bits(cq, size: int, chroma: int, intra: int):
    """write_coeff bit count; cq raster [N,qs,qs] -> bits [N] (callers
    mask by cbp)."""
    qs = min(16, size)
    sc = cq.reshape(cq.shape[0], qs * qs)[:, _tabs(cq.device)["zzinv"][size]]
    return coeff_bits_batch(sc, size, chroma, intra)


def quantize_dyn(coeff, qp: int, size: int, intra_block):
    """The quantizer at a per-frame qp (enc/encode_block.c:84-160):
    ops/quant.py:quantize_batch, whose unweighted offsets fit int32 at
    every qp.  Returns (cq [N,qs,qs] int32, cbp [N] int32)."""
    cq, cbp = quantize_batch(coeff, qp, size, int(bool(intra_block)))
    return cq.to(I32), cbp


def dequantize_dyn(coeff, qp: int, size: int):
    """The dequantizer at a per-frame qp (common/common_block.c:45-73,
    unweighted): ops/transform.py:dequantize_batch."""
    return dequantize_batch(coeff, qp, size)


def trial_encode_plane(org, pred, size: int, qp: int, intra_q: int,
                       chroma: int, intra_bits: int):
    """encode_and_reconstruct_block_inter, one plane, no tb-split
    (enc/encode_block.c:1275-1338) + exact coefficient bit count.
    org/pred: [N,s,s] int32.  intra_q: quantizer offset class (frame
    type); intra_bits: coeff VLC class (block mode).  Fast transform (LC
    speed 2).  Returns (cbp [N], cq [N,qs,qs], rec [N,s,s], bits [N])."""
    res = _i16(org - pred)
    co = fwd_transform_batch(res, size, True, 8)
    cq, cbp = quantize_dyn(co, qp, size, intra_q)
    rb = inv_transform_batch(dequantize_dyn(cq, qp, size), size, 8)
    nz = cbp > 0
    rec = torch.where(nz[:, None, None], reconstruct_batch(rb, pred, 8),
                      pred)
    bits = torch.where(nz, coeff_bits(cq, size, chroma, intra_bits), 0)
    return cbp, cq, rec, bits


def pad16(cq, size: int):
    """Pad [L,qs,qs] raster coeffs into the [L,16,16] record slot."""
    qs = min(16, size)
    return cq if qs == 16 else F.pad(cq, (0, 16 - qs, 0, 16 - qs))


# ---------------------------------------------------------------------------
# early skip (enc/encode_block.c:2123-2392)
# ---------------------------------------------------------------------------

def early_skip_thresholds(qp: int, qpC: int, thr_f: float, sb_bump: bool):
    """Host-side threshold derivation (exact float semantics).
    Returns (luma thresholds by s2 {4,8,16}, chroma threshold)."""
    thr = np.float32(thr_f)
    if sb_bump:
        thr = np.float32(thr + thr / np.float32(4))
    thr = float(thr)
    out = {}
    scale = int(GQUANT[qp % 6])
    for s2 in (4, 8, 16):
        shift2 = 21 - log2i(s2) + qp // 6
        fql = float(1 << shift2) / float(scale)
        out[s2] = int(0.5 * thr * fql)
    scale_c = int(GQUANT[qpC % 6])
    shift2 = 21 - 5 + qpC // 6
    fql = float(1 << shift2) / float(scale_c)
    thr_c = int(thr * fql)
    return out, thr_c


def _tiles(blk, nt: int, s: int):
    """[L, nt*s, nt*s] -> [L, nt*nt, s, s], tiles in raster order."""
    Lb = blk.shape[0]
    return blk.reshape(Lb, nt, s, nt, s).permute(0, 1, 3, 2, 4).reshape(
        Lb, nt * nt, s, s)


def early_skip_check(fc, cfg, cand, nsv, ypos, xpos, size: int,
                     org_y, org_u, org_v, thr_l: int, thr_c: int,
                     preds=None):
    """check_early_skip_block (enc/encode_block.c:2231-2350) for both
    skip candidates in lockstep.  org_*: [L,s,s]/[L,sC,sC] int32 (full
    block).  `preds`: the candidates' whole-block predictions where a
    block is one tile (size <= 32), which are the tiles' (skip_trials
    makes the same).  Returns skippable [L,2] bool."""
    Lb = cand.shape[0]
    dev = cand.device
    s0 = min(size, 32)
    nt = size // s0                      # tiles per side
    T = nt * nt
    s2 = s0 // 2
    s0c = s0 // 2
    t = _ar(T, dev).to(I32)
    toy = (t // nt * s0)[None, None, :]
    tox = (t % nt * s0)[None, None, :]
    yy = (ypos[:, None, None] + toy).expand(Lb, 2, T)
    xx = (xpos[:, None, None] + tox).expand(Lb, 2, T)
    mvy = cand[:, :, 0:1].expand(Lb, 2, T)
    mvx = cand[:, :, 1:2].expand(Lb, 2, T)
    ref = cand[:, :, 4:5].expand(Lb, 2, T)
    bwa = torch.full((Lb, 2, T), s0, dtype=I32, device=dev)
    if preds is None:
        preds = mc_yuv(fc, cfg, ref, mvy, mvx, yy, xx, s0, bwa, bwa)
    else:
        assert T == 1
    py, pu, pv = preds

    def per_tile(org, s):
        return _tiles(org, nt, s)[:, None].expand(Lb, 2, T, s, s).reshape(
            Lb * 2 * T, s, s)

    # luma: 2x2 aggregate -> fwd transform (non-fast) -> |coeff| > thr
    res = _i16(per_tile(org_y, s0) - py.reshape(Lb * 2 * T, s0, s0))
    agg = res.reshape(-1, s2, 2, s2, 2)
    tmp = (agg[:, :, 0, :, 0] + agg[:, :, 0, :, 1] + agg[:, :, 1, :, 0] +
           agg[:, :, 1, :, 1] + 2) >> 2
    co = fwd_transform_batch(tmp, s2, False, 8)
    sig_y = (co.abs() > thr_l).flatten(1).any(dim=1)

    # chroma: int16 column sums (SIMD calc_cbp semantics, enc_kernels.c:828)
    def chroma_sig(oc, pc):
        resc = _i16(oc - pc.reshape(Lb * 2 * T, s0c, s0c))
        sums = _i16(resc.sum(dim=1))
        if s0c >= 8:
            return (_i16(sums.abs()) > thr_c).any(dim=1)
        c0, c1, c2, c3 = sums[:, 0], sums[:, 1], sums[:, 2], sums[:, 3]
        a0 = _i16(_i16(c0).abs())
        a2 = _i16(_i16(c2).abs())
        return (c1 + a0 > thr_c) | (c3 + a2 > thr_c)

    sig = (sig_y | chroma_sig(per_tile(org_u, s0c), pu) |
           chroma_sig(per_tile(org_v, s0c), pv))
    sig = sig.reshape(Lb, 2, T).any(dim=2)
    live = _ar(2, dev)[None, :] < nsv[:, None]
    return ~sig & live


# ---------------------------------------------------------------------------
# intra: local-tile reference samples + CFL
# ---------------------------------------------------------------------------

def make_refs_local(tile, oy: int, ox: int, size: int, ur, dl, ypos, xpos):
    """make_top_and_left (intra_prediction.c:57-116) reading the per-lane
    local rec tile (origin (1,1); row/col 0 = halo).  oy/ox: local pixel
    offsets.  Returns (left [L,2n], top [L,2n], top_left [L]) int32."""
    n = size
    _, th, tw = tile.shape
    trow = tile[:, oy, _span(ox + 1, n + 1, tw)].to(I32)
    lcol = tile[:, _span(oy + 1, n + 1, th), ox].to(I32)
    tl_px = tile[:, oy, ox].to(I32)
    idx = _ar(2 * n, tile.device)[None, :]
    top = trow.gather(1, torch.minimum(idx, (n - 1 + ur.long())[:, None]))
    left = lcol.gather(1, torch.minimum(idx, (n - 1 + dl.long())[:, None]))
    top = torch.where((ypos == 0)[:, None], 128, top)
    left = torch.where((xpos == 0)[:, None], 128, left)
    top_left = torch.where(ypos == 0, left[:, 0],
                           torch.where(xpos > 0, tl_px, top[:, 0]))
    return left, top, top_left


def improve_uv_pred_j(pred_y, pred_u, pred_v, rec_y, n: int):
    """improve_uv_prediction (common/common_block.c:347-428), 4:2:0,
    8-bit, U and V in one batch: the decoder's CFL
    (dec/device_frame.py:_cfl_j).  The division truncates toward zero
    (the sign-split form); the int32 products wrap as in the JAX version.
    Returns updated (pred_u, pred_v)."""
    sh = 2 * log2i(n // 2)
    py = pred_y.to(I64)
    d = rec_y.to(I64) - py
    ys = (py[:, 0::2, 0::2] + py[:, 0::2, 1::2] + py[:, 1::2, 0::2] +
          py[:, 1::2, 1::2] + 2) >> 2
    xs = torch.stack([pred_u, pred_v])
    x64 = xs.to(I64)
    ysum = ys.sum((1, 2))
    ssyy = (ys * ys).sum((1, 2)) - ((ysum * ysum) >> sh)
    gate = (((d * d).sum((1, 2)) >> (2 * log2i(n))) > 64) & (ssyy != 0)
    xsum = x64.sum((2, 3))
    ssxx = (x64 * x64).sum((2, 3)) - ((xsum * xsum) >> sh)
    ssyx = (ys * x64).sum((2, 3)) - ((ysum * xsum) >> sh)
    cond = gate & (ssyx * ssyx * 2 > ssyy * ssxx)                # [2, L]
    num = ssyx << 16
    den = torch.where(ssyy == 0, 1, ssyy)
    a64 = torch.where(num < 0, -((-num) // den), num // den)
    b64 = ((xsum << 16) - a64 * ysum) >> sh
    a = a64.clamp(-(1 << 23), 1 << 23).to(I32)
    b = (b64 + (1 << 15)).clamp(-(1 << 31), (1 << 31) - 1).to(I32)
    m = ((a[..., None, None] * rec_y.to(I32) + b[..., None, None]) >> 16
         ).clamp(0, 255)
    m2 = (m[..., 0::2, 0::2] + m[..., 0::2, 1::2] + m[..., 1::2, 0::2] +
          m[..., 1::2, 1::2] + 2) >> 2
    out = torch.where(cond[..., None, None], m2, xs)
    return out[0], out[1]


@functools.cache
def _planar_taps(n: int, device: str):
    """The planar filter's 5 clamped taps [5, n] and weights (its edge
    cases, intra_prediction.c:229-247, are the clamped taps)."""
    i = torch.arange(n)
    idx = torch.stack([(i + d).clamp(0, n - 1) for d in (-2, -1, 0, 1, 2)])
    return idx.to(device), torch.tensor([[1], [2], [2], [2], [1]],
                                        dtype=I32, device=device)


def predict4(left, top, top_left, ypos, xpos, n: int):
    """The DC, PLANAR, HOR and VER predictions [4,L,n,n] int32 by mode id
    (ops/intra_batch.py:predict_all_modes at 4 modes, 8-bit)."""
    ls, ts = left[:, :n].sum(1), top[:, :n].sum(1)
    dc = (torch.where(ypos != 0, ts, ls) + torch.where(xpos != 0, ls, ts) +
          n) // (2 * n)
    idx, w5 = _planar_taps(n, str(left.device))
    tF, lF = (torch.stack([top, left])[:, :, idx] * w5).sum(2)
    tlF = (left[:, 1] + top[:, 1]) + 2 * (left[:, 0] + top_left + top[:, 0])
    val = lF[:, :, None] + tF[:, None, :] - tlF[:, None, None] + 4
    # C's val / 8 clamped to [0, 255] is the floor division clamped
    planar = (val >> 3).clamp(0, 255)
    L = left.shape[0]
    return torch.stack([dc[:, None, None].expand(L, n, n), planar,
                        left[:, :n, None].expand(L, n, n),
                        top[:, None, :n].expand(L, n, n)]).to(I32)


def intra_predict4(st, plane: str, oy: int, ox: int, size: int, ypos, xpos,
                   fw: int, fh: int):
    """4-mode intra predictions + search refs from the local tiles.
    Returns (preds [4,L,size,size] by mode id, left, top)."""
    _, ur, _, dl = _avail_flags(ypos, xpos, oy, ox, size, fw, fh)
    left, top, tl = make_refs_local(st[plane], oy, ox, size, ur, dl,
                                    ypos, xpos)
    return predict4(left, top, tl, ypos, xpos, size), left, top


# mode id order of the SAD search visits (enc/encode_block.c:943-1020):
# DC, HOR, VER, PLANAR  (ids 0, 2, 3, 1)
SEARCH_ORDER4 = (0, 2, 3, 1)


def search_intra_mode_j(st, oy: int, ox: int, size: int, ypos, xpos,
                        org_y, cfg):
    """search_intra_prediction_params (enc/encode_block.c:928-1031),
    4 modes.  Returns (best_mode [L], min_sad [L] int64, preds)."""
    preds, left, top = intra_predict4(st, "rec_y", oy, ox, size, ypos,
                                      xpos, cfg["w"], cfg["h"])
    # the search's DC variant ignores the edge rule (left/top always)
    dc = IB.search_dc_pred(left, top, size)
    cand = torch.stack([dc[:, None, None].expand_as(preds[0]).to(I32)] +
                       [preds[m] for m in SEARCH_ORDER4[1:]])
    sads = (org_y[None] - cand).abs().sum(dim=(2, 3))            # [4,L]
    k = sads.argmin(dim=0)               # first minimum in visit order
    return (_tabs(org_y.device)["order4"][k], sads.gather(0, k[None])[0],
            preds)


# ---------------------------------------------------------------------------
# mode decision (enc/encode_block.c:1835-2121, LC feature set)
# ---------------------------------------------------------------------------

def _idx_bits(n, idx):
    """Skip/merge index signalling length (enc/write_bits.c:467-489):
    n==4 -> 2 bits, n==3 -> vlc12 (idx+1 capped), n==2 -> 1, n==1 -> 0."""
    return torch.where(n == 4, 2,
                       torch.where(n == 3, torch.where(idx == 2, 2, idx + 1),
                                   torch.where(n == 2, 1, 0))).to(I32)


def _org_block(st, oy: int, ox: int, size: int):
    sC = size // 2
    return (st["org_y"][:, _span(oy, size, 128), _span(ox, size, 128)],
            st["org_u"][:, _span(oy // 2, sC, 64), _span(ox // 2, sC, 64)],
            st["org_v"][:, _span(oy // 2, sC, 64), _span(ox // 2, sC, 64)])


def _best_init(Lb: int, size: int, device):
    z = torch.zeros((Lb,), dtype=I32, device=device)
    zc = torch.zeros((Lb, 16, 16), dtype=I32, device=device)
    best = {k: z for k in ("mode", "idx", "intra_mode", "mvp_y", "mvp_x",
                           "mv0y", "mv0x", "mv1y", "mv1x", "ref0", "ref1",
                           "dir", "cbp_y", "cbp_u", "cbp_v")}
    best.update(
        cost=torch.full((Lb,), MAX_UINT32, dtype=I64, device=device),
        coeff_y=zc, coeff_u=zc, coeff_v=zc,
        rec_y=torch.zeros((Lb, size, size), dtype=I32, device=device),
        rec_u=torch.zeros((Lb, size // 2, size // 2), dtype=I32,
                          device=device),
        rec_v=torch.zeros((Lb, size // 2, size // 2), dtype=I32,
                          device=device))
    return best


def _best_update(best, take, fields):
    out = dict(best)
    for k, v in fields.items():
        cur = best[k]
        t = take.reshape(take.shape + (1,) * (v.dim() - 1))
        out[k] = torch.where(t, v.to(cur.dtype), cur)
    return out


@functools.cache
def _sm_table(size: int, num_ref: int, device: str):
    """super_mode_bits over every (context hit, mode, ref_idx0 < 2), as a
    table on `device` indexed by hit * 10 + mode * 2 + ref_idx0."""
    hit, mode, ref = np.meshgrid([0, 2], np.arange(5), [0, 1],
                                 indexing="ij")
    bits = super_mode_bits(tuple(torch.as_tensor(a.reshape(-1), dtype=I32)
                                 for a in (mode, ref, hit)), size, num_ref,
                           True)
    return bits.to(device)


def _sm_bits_sel(cfg, mode, ref0, ctx_index, size: int, encode_this):
    """Per-lane super-mode bits: full code where encode_this else 1 bit
    (super_mode_bits by table: modes 0-4, ref_idx0 0-1)."""
    if cfg["is_i"]:
        return torch.where(encode_this, super_mode_bits_i(size, True), 0
                           ).to(I32)
    hit = (ctx_index == 2) | (ctx_index > 3)
    full = _sm_table(size, cfg["num_ref"], str(mode.device))[
        hit.to(I32) * 10 + mode * 2 + ref0]
    return torch.where(encode_this, full, 1)


def skip_mc(fc, cfg, cand, ypos, xpos, size: int, bw, bh):
    """Both skip candidates' predictions (py, pu, pv) [L,2,...]."""
    Lb = cand.shape[0]
    return mc_yuv(fc, cfg, cand[:, :, 4], cand[:, :, 0], cand[:, :, 1],
                  ypos[:, None].expand(Lb, 2), xpos[:, None].expand(Lb, 2),
                  size, bw[:, None].expand(Lb, 2), bh[:, None].expand(Lb, 2))


def skip_trials(fc, cfg, st, oy, ox, size: int, ypos, xpos, bw, bh,
                encode_this, cand, nsv, ctx_index, org_y, org_u, org_v,
                ok_mask=None, preds=None):
    """Evaluate both skip candidates (SSD + exact bits); returns
    (cost [L,2], preds (py,pu,pv) [L,2,...]); `preds` are skip_mc's."""
    Lb = cand.shape[0]
    sC = size // 2
    ref = cand[:, :, 4]
    if preds is None:
        preds = skip_mc(fc, cfg, cand, ypos, xpos, size, bw, bh)
    py, pu, pv = preds

    def two(a, s):
        return a[:, None].expand(Lb, 2, s, s).reshape(Lb * 2, s, s)

    bw2 = bw.repeat_interleave(2)
    bh2 = bh.repeat_interleave(2)
    ssd = (ssd_masked(two(org_y, size), py.reshape(Lb * 2, size, size),
                      bw2, bh2, size) +
           ssd_masked(two(org_u, sC), pu.reshape(Lb * 2, sC, sC),
                      bw2 >> 1, bh2 >> 1, sC) +
           ssd_masked(two(org_v, sC), pv.reshape(Lb * 2, sC, sC),
                      bw2 >> 1, bh2 >> 1, sC)).reshape(Lb, 2)
    mode = torch.full((Lb * 2,), MODE_SKIP, dtype=I32, device=cand.device)
    sm = _sm_bits_sel(cfg, mode, ref.reshape(-1),
                      ctx_index.repeat_interleave(2), size,
                      encode_this.repeat_interleave(2)).reshape(Lb, 2)
    k = _ar(2, cand.device)[None, :]
    nbits = sm + _idx_bits(nsv[:, None], k)
    cost = cost_calc_j(ssd, nbits, fc["dyn"]["lam"])
    live = k < nsv[:, None]
    if ok_mask is not None:
        live = live & ok_mask
    return torch.where(live, cost, MAX_UINT32), (py, pu, pv)


def _pick_first_min(cost2):
    """First minimum over axis 1 with strict '<' order semantics."""
    n = cost2.shape[1]
    key = cost2 * n + _ar(n, cost2.device)[None, :]
    idx = key.argmin(dim=1)
    return idx.to(I32), _take(cost2, idx)


def _skip_best_fields(cand, idx, preds, size: int):
    """Best-candidate field bundle for a skip/merge pick."""
    lanes = _ar(cand.shape[0], cand.device)
    i = idx.long()
    c = cand[lanes, i]
    py, pu, pv = preds
    z = torch.zeros_like(idx)
    zc = torch.zeros((idx.shape[0], 16, 16), dtype=I32, device=idx.device)
    return {
        "mode": torch.full_like(idx, MODE_SKIP), "idx": idx,
        "intra_mode": z,
        "mv0y": c[:, 0], "mv0x": c[:, 1], "mv1y": c[:, 2], "mv1x": c[:, 3],
        "ref0": c[:, 4], "ref1": c[:, 5], "dir": c[:, 6],
        "cbp_y": z, "cbp_u": z, "cbp_v": z,
        "coeff_y": zc, "coeff_u": zc, "coeff_v": zc,
        "rec_y": py[lanes, i], "rec_u": pu[lanes, i], "rec_v": pv[lanes, i],
    }


def _coded_fields(fc, cfg, size: int, mode_const: int, y, u, v, orgs, bw,
                  bh, encode_this, ref, ctx_cbp, ctx_index, side_bits):
    """Cost and fields of trial-coded blocks: the tail of
    encode_and_reconstruct_block_inter / _intra (enc/encode_block.c:
    1340-1514, :1100-1273).  y/u/v: trial_encode_plane's outputs;
    side_bits: the mode's own syntax (merge index, mv, intra mode)."""
    (cbp_y, cq_y, rec_y, bits_y), (cbp_u, cq_u, rec_u, bits_u), \
        (cbp_v, cq_v, rec_v, bits_v) = y, u, v
    org_y, org_u, org_v = orgs
    sC = size // 2
    ssd = (ssd_masked(org_y, rec_y, bw, bh, size) +
           ssd_masked(org_u, rec_u, bw >> 1, bh >> 1, sC) +
           ssd_masked(org_v, rec_v, bw >> 1, bh >> 1, sC))
    mode = torch.full_like(cbp_y, mode_const)
    nbits = (_sm_bits_sel(cfg, mode, ref, ctx_index, size, encode_this) +
             side_bits + cbp_bits(cbp_y, cbp_u, cbp_v, ctx_cbp,
                                  mode_const == MODE_MERGE) +
             bits_y + bits_u + bits_v)
    z = torch.zeros_like(mode)
    return cost_calc_j(ssd, nbits, fc["dyn"]["lam"]), {
        "mode": mode, "cbp_y": cbp_y, "cbp_u": cbp_u, "cbp_v": cbp_v,
        "coeff_y": pad16(cq_y, size), "coeff_u": pad16(cq_u, sC),
        "coeff_v": pad16(cq_v, sC),
        "rec_y": rec_y, "rec_u": rec_u, "rec_v": rec_v,
        "idx": z, "intra_mode": z, "dir": z}


def _split(outs, sizes):
    """trial_encode_plane's outputs of a batch -> one tuple per group."""
    parts = [torch.split(o, sizes) for o in outs]
    return [tuple(p[g] for p in parts) for g in range(len(sizes))]


def _intra_chroma(st, oy: int, ox: int, size: int, ypos, xpos, cfg, imode,
                  pred_y, rec_y):
    """The intra chroma predictions (same mode as luma) from the local
    u/v tiles, then CFL (enc/encode_block.c:1160-1200)."""
    Lb = imode.shape[0]
    sC = size // 2
    _, ur, _, dl = _avail_flags(ypos, xpos, oy, ox, size, cfg["w"],
                                 cfg["h"])
    refs = [make_refs_local(st[p], oy // 2, ox // 2, sC, ur, dl, ypos,
                            xpos) for p in ("rec_u", "rec_v")]
    left, top, tl = (torch.cat(r) for r in zip(*refs))
    # chroma DC edge rule uses chroma block coords (yposC, xposC)
    yc, xc = (torch.cat([a >> 1, a >> 1]) for a in (ypos, xpos))
    puv = IB.select_mode(predict4(left, top, tl, yc, xc, sC),
                         torch.cat([imode, imode]))
    pu, pv = puv[:Lb], puv[Lb:]
    if cfg["cfl_intra"]:
        pu, pv = improve_uv_pred_j(pred_y, pu, pv, rec_y, size)
    return pu, pv


def _intra_fields(fields, imode):
    fields.update(intra_mode=imode, dir=torch.full_like(imode, -1))
    for k in ("mv0y", "mv0x", "mv1y", "mv1x", "ref0", "ref1"):
        fields[k] = torch.zeros_like(imode)
    return fields


def intra_trial(fc, cfg, st, oy: int, ox: int, size: int, ypos, xpos, bw,
                bh, encode_this, imode, ctx_cbp, ctx_index, org_y, org_u,
                org_v, preds_y):
    """MODE_INTRA trial encode (enc/encode_block.c:1100-1273), no
    tb-split, CFL intra on.  imode [L]; preds_y [4,L,s,s] luma
    predictions.  Returns (cost [L], fields dict)."""
    dyn = fc["dyn"]
    sC = size // 2
    intra_q = 1 if cfg["is_i"] else 0
    pred_y = IB.select_mode(preds_y, imode)
    y = trial_encode_plane(org_y, pred_y, size, dyn["qp"], intra_q, 0, 1)
    pu, pv = _intra_chroma(st, oy, ox, size, ypos, xpos, cfg, imode,
                           pred_y, y[2])
    u, v = _split(trial_encode_plane(torch.cat([org_u, org_v]),
                                     torch.cat([pu, pv]), sC, dyn["qpC"],
                                     intra_q, 1, 1), [len(pu)] * 2)
    cost, fields = _coded_fields(
        fc, cfg, size, MODE_INTRA, y, u, v, (org_y, org_u, org_v), bw, bh,
        encode_this, torch.zeros_like(imode), ctx_cbp, ctx_index,
        INTRA_MODE_BITS)
    return cost, _intra_fields(fields, imode)


def mode_decision(fc, cfg, st, oy: int, ox: int, size: int, ypos, xpos, bw,
                  bh, encode_this, cand, nsv, ctx_cbp, ctx_index,
                  skip_only: bool):
    """mode_decision_rdo (enc/encode_block.c:1835-2121), LC feature set.
    The merge candidates are the skip candidates at LC (the JAX version's
    callers pass the same arrays as mcand/nmv), so merge reuses the skip
    predictions.  The merge, inter and intra trials of a P block are
    coded in one batch per plane kind (luma, then chroma, which the
    intra CFL needs the luma of); the best pick runs in the reference's
    order: skip, merge, inter, intra.  Returns the best dict; st's
    mvcand and best_ref are updated in place."""
    Lb = st["org_y"].shape[0]
    dev = st["org_y"].device
    dyn = fc["dyn"]
    fw, fh = cfg["w"], cfg["h"]
    sC = size // 2
    orgs = _org_block(st, oy, ox, size)
    org_y, org_u, org_v = orgs
    best = _best_init(Lb, size, dev)
    full = encode_this

    if cfg["is_i"]:
        if skip_only:
            return best
        best_im, _, preds_y = search_intra_mode_j(
            st, oy, ox, size, ypos, xpos, org_y, cfg)
        cost, fields = intra_trial(fc, cfg, st, oy, ox, size, ypos, xpos,
                                   bw, bh, encode_this, best_im, ctx_cbp,
                                   ctx_index, org_y, org_u, org_v, preds_y)
        fields["cost"] = cost
        return _best_update(best, full & (cost < best["cost"]), fields)

    cost2, preds = skip_trials(fc, cfg, st, oy, ox, size, ypos, xpos, bw,
                               bh, encode_this, cand, nsv, ctx_index,
                               org_y, org_u, org_v)
    idx, c = _pick_first_min(cost2)
    fields = _skip_best_fields(cand, idx, preds, size)
    fields["cost"] = c
    best = _best_update(best, c < best["cost"], fields)
    if skip_only:
        return best

    lanes = _ar(Lb, dev)
    K = 2
    R = cfg["num_ref"]

    def rep(a, n):
        """[L,...] -> [L*n,...] repeat along a new axis 1."""
        return a.repeat_interleave(n, dim=0)

    def sel_axis(fields, cost2, idx, n):
        """The idx-th of n batched trials of a fields dict."""
        i = idx.long()
        out = {k: v.reshape((Lb, n) + v.shape[1:])[lanes, i]
               for k, v in fields.items()}
        out["cost"] = _take(cost2, i)
        return out

    # ---- intra SAD gate (speed > 0: intra_inter_sad) ----
    best_im, sad_i, preds_y = search_intra_mode_j(
        st, oy, ox, size, ypos, xpos, org_y, cfg)
    sad_intra = sad_i + dyn["isqrt_bias"]

    # ---- inter: ME, both references in one batch ----
    mvp_y, mvp_x = mv_pred_local(st, oy, ox, size, ypos, xpos, fw, fh)
    refs = _ar(R, dev).to(I32).repeat(Lb)                      # [L*R]
    br = rep(st["best_ref"], R)
    ref_live = rep(full, R) & ((br < 0) | (br == refs))
    my = st["mvc_y"][:, :R].reshape(Lb * R, NCAND)
    mx = st["mvc_x"][:, :R].reshape(Lb * R, NCAND)
    mm = st["mvc_mask"][:, :R].reshape(Lb * R)
    mn = st["mvc_num"][:, :R].reshape(Lb * R)
    my, mx, mm, mn = add_mvcand(my, mx, mm, mn, rep(mvp_y, R),
                                rep(mvp_x, R), ref_live)
    sad_r, mv_y, mv_x = me_lc(
        rep(org_y, R), fc["raw_y"], refs, PADY, rep(ypos, R), rep(xpos, R),
        size, rep(mvp_y, R), rep(mvp_x, R), dyn["sqrt_lam"], my, mx, mn,
        fw, fh)
    my, mx, mm, mn = add_mvcand(my, mx, mm, mn, mv_y, mv_x, ref_live)
    st["mvc_y"][:, :R] = my.reshape(Lb, R, NCAND)
    st["mvc_x"][:, :R] = mx.reshape(Lb, R, NCAND)
    st["mvc_mask"][:, :R] = mm.reshape(Lb, R)
    st["mvc_num"][:, :R] = mn.reshape(Lb, R)
    execd = (ref_live & (sad_r < rep(sad_intra, R))).reshape(Lb, R)
    do_intra = full & ~execd.any(dim=1)
    pi = mc_yuv(fc, cfg, refs, mv_y, mv_x, rep(ypos, R), rep(xpos, R),
                size, rep(bw, R), rep(bh, R))

    # ---- the trial encodes: merge (K per lane), inter (R), intra (1) ----
    groups = [K * Lb, R * Lb, Lb]
    pred_in = IB.select_mode(preds_y, best_im)
    intra_rows = _ar(sum(groups), dev) >= K * Lb + R * Lb

    def rows(o):
        return torch.cat([rep(o, K), rep(o, R), o])

    ym, yi, yn = _split(trial_encode_plane(
        rows(org_y), torch.cat([preds[0].reshape(K * Lb, size, size),
                                pi[0], pred_in]),
        size, dyn["qp"], 0, 0, intra_rows), groups)
    pu_n, pv_n = _intra_chroma(st, oy, ox, size, ypos, xpos, cfg, best_im,
                               pred_in, yn[2])
    um, ui, un, vm, vi, vn = _split(trial_encode_plane(
        torch.cat([rows(org_u), rows(org_v)]),
        torch.cat([preds[1].reshape(K * Lb, sC, sC), pi[1], pu_n,
                   preds[2].reshape(K * Lb, sC, sC), pi[2], pv_n]),
        sC, dyn["qpC"], 0, 1, 0), groups * 2)

    # ---- merge (tb_param 0 only) ----
    cf = cand.reshape(Lb * K, 7)
    kk = _ar(K, dev).to(I32).repeat(Lb)
    cost, fields = _coded_fields(
        fc, cfg, size, MODE_MERGE, ym, um, vm, [rep(o, K) for o in orgs],
        rep(bw, K), rep(bh, K), rep(encode_this, K), cf[:, 4],
        rep(ctx_cbp, K), rep(ctx_index, K), _idx_bits(rep(nsv, K), kk))
    fields.update(idx=kk, mv0y=cf[:, 0], mv0x=cf[:, 1], mv1y=cf[:, 2],
                  mv1x=cf[:, 3], ref0=cf[:, 4], ref1=cf[:, 5], dir=cf[:, 6])
    cost2 = torch.where(_ar(K, dev)[None, :] < nsv[:, None],
                        cost.reshape(Lb, K), MAX_UINT32)
    kidx, kcost = _pick_first_min(cost2)
    best = _best_update(best, full & (kcost < best["cost"]),
                        sel_axis(fields, cost2, kidx, K))

    # ---- inter ----
    cost, fields = _coded_fields(
        fc, cfg, size, MODE_INTER, yi, ui, vi, [rep(o, R) for o in orgs],
        rep(bw, R), rep(bh, R), rep(encode_this, R), refs, rep(ctx_cbp, R),
        rep(ctx_index, R), mv_bits_exact(mv_y - rep(mvp_y, R),
                                         mv_x - rep(mvp_x, R)))
    fields.update(mv0y=mv_y, mv0x=mv_x, mv1y=mv_y, mv1x=mv_x, ref0=refs,
                  ref1=refs, mvp_y=rep(mvp_y, R), mvp_x=rep(mvp_x, R))
    costR = cost.reshape(Lb, R)
    cost2 = torch.where(execd, costR, MAX_UINT32)
    ridx, rcost = _pick_first_min(cost2)
    best = _best_update(best, (rcost < best["cost"]) & execd.any(dim=1),
                        sel_axis(fields, cost2, ridx, R))
    worst = torch.where(execd, costR, 0).amax(dim=1)
    st["best_ref"] = torch.where(
        full & (worst > 0) & (worst * 3 > cost2.amin(dim=1) * 4), 0,
        st["best_ref"])

    # ---- intra (mode from the SAD search) ----
    cost, fields = _coded_fields(
        fc, cfg, size, MODE_INTRA, yn, un, vn, orgs, bw, bh, encode_this,
        torch.zeros_like(best_im), ctx_cbp, ctx_index, INTRA_MODE_BITS)
    fields = _intra_fields(fields, best_im)
    fields["cost"] = cost
    return _best_update(best, do_intra & (cost < best["cost"]), fields)


# ---------------------------------------------------------------------------
# node finalize: rec tile + dd + record writes
# ---------------------------------------------------------------------------
FLAG_DECIDED, FLAG_EARLY, FLAG_SELF = 1, 2, 4
REC_W = 18
(RF_FLAGS, RF_MODE, RF_IDX, RF_IMODE, RF_MVPY, RF_MVPX, RF_MVY, RF_MVX,
 RF_REF, RF_CBPY, RF_CBPU, RF_CBPV, RF_NSV, RF_NMV, RF_CTXCBP, RF_CTXIDX,
 RF_COSTLO, RF_COSTHI) = range(REC_W)
RF_NAMES = ("flags", "mode", "idx", "intra_mode", "mvp_y", "mvp_x", "mv_y",
            "mv_x", "ref", "cbp_y", "cbp_u", "cbp_v", "nsv", "nmv",
            "ctx_cbp", "ctx_index", "cost_lo", "cost_hi")


def _masked_write(arr, index, patch, mask):
    """arr[index] = where(mask, patch, arr[index]); mask [L] on dim 0."""
    cur = arr[index]
    m = mask.reshape(mask.shape + (1,) * (cur.dim() - 1))
    arr[index] = torch.where(m, patch.to(cur.dtype), cur)


def finalize_node(st, oy: int, ox: int, size: int, best, mask):
    """copy_block_to_frame + copy_deblock_data
    (enc/encode_block.c:1516-1613) into the per-lane local state."""
    sC = size // 2
    for plane, o, s, key in (("rec_y", 1 + oy, size, "rec_y"),
                             ("rec_u", 1 + oy // 2, sC, "rec_u"),
                             ("rec_v", 1 + oy // 2, sC, "rec_v")):
        ox_ = 1 + ox if plane == "rec_y" else 1 + ox // 2
        dim = st[plane].shape[1]
        _masked_write(st[plane], (slice(None), _span(o, s, dim),
                                  _span(ox_, s, dim)), best[key], mask)
    bsz = size // 4
    by, bx = 1 + oy // 4, 1 + ox // 4
    z = torch.zeros_like(best["mode"])
    vals = torch.stack([best["mode"], torch.full_like(z, size), z, z,
                        best["cbp_y"], best["cbp_u"], best["cbp_v"],
                        best["mv0y"], best["mv0x"], best["mv1y"],
                        best["mv1x"], best["ref0"], best["ref1"],
                        best["dir"]], dim=1).to(I32)       # DD_FIELDS order
    dim = st["dd"].shape[2]
    idx = (slice(None), slice(None), _span(by, bsz, dim), _span(bx, bsz, dim))
    _masked_write(st["dd"], idx, vals[:, :, None, None].expand(
        -1, -1, bsz, bsz), mask)


def write_record(st, nid: int, best, flags, nsv, nmv, ctx_cbp, ctx_index,
                 cost, mask):
    """Store the node decision into the per-lane record buffers."""
    vals = torch.stack([
        flags.to(I32), best["mode"], best["idx"], best["intra_mode"],
        best["mvp_y"], best["mvp_x"], best["mv0y"], best["mv0x"],
        best["ref0"], best["cbp_y"], best["cbp_u"], best["cbp_v"],
        nsv, nmv, ctx_cbp, ctx_index, (cost & 0x7FFFFFFF).to(I32),
        (cost >> 31).to(I32)], dim=-1).to(I32)
    _masked_write(st["recA"], (slice(None), nid), vals, mask)
    coeffs = torch.stack([best["coeff_y"], best["coeff_u"],
                          best["coeff_v"]], dim=1)
    _masked_write(st["recC"], (slice(None), nid), coeffs, mask)


# ---------------------------------------------------------------------------
# node bodies
# ---------------------------------------------------------------------------

DEPTH = {128: 0, 64: 1, 32: 2, 16: 3}
BIG = 1 << 28                  # the split compare's "no cost" (int64)


def _geom(st, cfg, oy: int, ox: int, size: int):
    ypos = st["sby"] + oy
    xpos = st["sbx"] + ox
    exists = st["live"] & (ypos + 8 <= cfg["h"]) & (xpos + 8 <= cfg["w"])
    encode_this = (ypos + size <= cfg["h"]) & (xpos + size <= cfg["w"])
    bw = torch.clamp(cfg["w"] - xpos, max=size)
    bh = torch.clamp(cfg["h"] - ypos, max=size)
    return ypos, xpos, exists, encode_this, bw, bh


def _dead_above(st, d: int):
    if d == 0:
        return torch.zeros_like(st["live"])
    return st["dead"][:, :d].any(dim=1)


def _early_eval(fc, cfg, st, oy: int, ox: int, size: int, ypos, xpos,
                encode_this, alive, cand, nsv, ctx_index, nid: int):
    """search_early_skip_candidates (enc/encode_block.c:2352-2392) +
    final encode of the winner.  Returns (early [L], cost [L])."""
    Lb = cand.shape[0]
    dyn = fc["dyn"]
    org_y, org_u, org_v = _org_block(st, oy, ox, size)
    thr_c = dyn["thr_c128"] if size == SB else dyn["thr_c"]
    bws = torch.full((Lb,), size, dtype=I32, device=cand.device)
    # a block of one early-skip tile: the test's and the trial's MC agree
    preds = (skip_mc(fc, cfg, cand, ypos, xpos, size, bws, bws)
             if size <= 32 else None)
    ok = early_skip_check(fc, cfg, cand, nsv, ypos, xpos, size,
                          org_y, org_u, org_v, dyn["thr_l_%d" % size], thr_c,
                          preds)
    early = alive & encode_this & ok.any(dim=1)
    cost2, preds = skip_trials(fc, cfg, st, oy, ox, size, ypos, xpos,
                               bws, bws, encode_this, cand, nsv,
                               ctx_index, org_y, org_u, org_v, ok_mask=ok,
                               preds=preds)
    idx, c = _pick_first_min(cost2)
    fields = _skip_best_fields(cand, idx, preds, size)
    fields["mvp_y"] = fields["mvp_x"] = torch.zeros_like(idx)
    finalize_node(st, oy, ox, size, fields, early)
    flags = torch.where(early, FLAG_DECIDED | FLAG_EARLY | FLAG_SELF, 0)
    write_record(st, nid, fields, flags, nsv, torch.zeros_like(nsv),
                 torch.full_like(ctx_index, -1), ctx_index, c, early)
    return early, c


def body_enter(st, fc, oy: int, ox: int, nid: int, size: int, cfg):
    """K_E<size>: process_block prologue - early-skip test + children
    cost accumulator reset (enc/encode_block.c:2401-2439)."""
    d = DEPTH[size]
    ypos, xpos, exists, encode_this, bw, bh = _geom(st, cfg, oy, ox, size)
    alive = exists & ~_dead_above(st, d)
    st["cs"][:, d] = 0
    if cfg["is_i"]:
        st["dead"][:, d] = False
        return
    cand, nsv = two_cands_local(st, oy, ox, size, ypos, xpos,
                                cfg["w"], cfg["h"])
    _, _, ctx_index = contexts_local(st, oy, ox, size, ypos, xpos,
                                     cfg["w"], cfg["h"], cfg["ctx"])
    early, c = _early_eval(fc, cfg, st, oy, ox, size, ypos, xpos,
                           encode_this, alive, cand, nsv, ctx_index, nid)
    st["dead"][:, d] = early
    if d > 0:
        st["cs"][:, d - 1] += torch.where(early, c, 0)


def body_decide(st, fc, oy: int, ox: int, nid: int, size: int, cfg):
    """K_D<size>: mode_decision_rdo + split compare + winner finalize
    (enc/encode_block.c:2514-2549)."""
    d = DEPTH[size]
    ypos, xpos, exists, encode_this, bw, bh = _geom(st, cfg, oy, ox, size)
    not_early = ~st["dead"][:, d]
    alive = exists & ~_dead_above(st, d) & not_early
    rect = (~encode_this & exists) if not cfg["is_i"] else \
        torch.zeros_like(exists)
    ran = (encode_this | rect) & alive
    cand, nsv = two_cands_local(st, oy, ox, size, ypos, xpos,
                                cfg["w"], cfg["h"])
    _, ctx_cbp, ctx_index = contexts_local(
        st, oy, ox, size, ypos, xpos, cfg["w"], cfg["h"], cfg["ctx"])
    md = mode_decision(fc, cfg, st, oy, ox, size, ypos, xpos, bw, bh,
                       encode_this & alive, cand, nsv, ctx_cbp, ctx_index,
                       skip_only=(size == SB))
    cost = torch.where(ran, md["cost"], BIG)
    cost_small = st["cs"][:, d].clone()
    chose = ran & (cost <= cost_small)
    finalize_node(st, oy, ox, size, md, chose)
    flags = (torch.where(ran, FLAG_DECIDED, 0) |
             torch.where(chose, FLAG_SELF, 0))
    write_record(st, nid, md, flags, nsv, nsv, ctx_cbp, ctx_index, cost,
                 alive)
    if d > 0:
        st["cs"][:, d - 1] += torch.where(alive, torch.minimum(
            cost, cost_small), 0)
    st["dead"][:, d] = False


def body_16sub(st, fc, oy: int, ox: int, nid: int, cfg):
    """Fused 16-subtree: early-skip@16, mode_decision@16 (top-down), the
    four 8x8 children, and the split compare
    (enc/encode_block.c:2401-2565 at sizes 16 and 8)."""
    size = 16
    d = 3
    Lb = st["live"].shape[0]
    dev = st["live"].device
    w, h = cfg["w"], cfg["h"]
    ypos, xpos, exists, encode_this, bw, bh = _geom(st, cfg, oy, ox, size)
    alive = exists & ~_dead_above(st, d)
    rect = (~encode_this & exists) if not cfg["is_i"] else \
        torch.zeros_like(exists)
    ran = (encode_this | rect) & alive

    cand, nsv = two_cands_local(st, oy, ox, size, ypos, xpos, w, h)
    _, ctx_cbp, ctx_index = contexts_local(st, oy, ox, size, ypos, xpos,
                                           w, h, cfg["ctx"])
    if not cfg["is_i"]:
        early, ecost = _early_eval(fc, cfg, st, oy, ox, size, ypos, xpos,
                                   encode_this, alive, cand, nsv, ctx_index,
                                   nid)
    else:
        early = torch.zeros_like(alive)
        ecost = torch.zeros((Lb,), dtype=I64, device=dev)

    # 16-level mode decision (top-down order for P encode_this lanes;
    # identical data for the I/rect orders)
    md = mode_decision(fc, cfg, st, oy, ox, size, ypos, xpos, bw, bh,
                       encode_this & alive & ~early, cand, nsv, ctx_cbp,
                       ctx_index, skip_only=False)
    cost16 = torch.where(ran & ~early, md["cost"], BIG)
    descend = alive & ~early
    if not cfg["is_i"]:
        descend = descend & (~encode_this | (cost16 > fc["dyn"]["thr16"]))

    # ---- children (NW, SW, NE, SE) ----
    cs = torch.where(descend, 0, BIG).to(I64)
    for i in range(4):
        dy = (i & 1) * 8
        dx = (i >> 1) * 8
        coy, cox = oy + dy, ox + dx
        cnid = N_OFF[8] + (nid - N_OFF[16]) * 4 + (dy // 8) * 2 + dx // 8
        y8 = ypos + dy
        x8 = xpos + dx
        et8 = (y8 + 8 <= h) & (x8 + 8 <= w)          # size 8 fits
        exists8 = descend & et8
        bw8 = torch.clamp(w - x8, max=8)
        bh8 = torch.clamp(h - y8, max=8)
        cand8, nsv8 = two_cands_local(st, coy, cox, 8, y8, x8, w, h)
        _, ccbp, cidx = contexts_local(st, coy, cox, 8, y8, x8, w, h,
                                       cfg["ctx"])
        if not cfg["is_i"]:
            early8, ec8 = _early_eval(fc, cfg, st, coy, cox, 8, y8, x8,
                                      et8, exists8, cand8, nsv8, cidx,
                                      cnid)
        else:
            early8 = torch.zeros_like(exists8)
            ec8 = torch.zeros((Lb,), dtype=I64, device=dev)
        ran8 = exists8 & ~early8     # size 8: encode_this == exists
        md8 = mode_decision(fc, cfg, st, coy, cox, 8, y8, x8, bw8, bh8,
                            et8 & ran8, cand8, nsv8, ccbp, cidx,
                            skip_only=False)
        cost8 = torch.where(ran8, md8["cost"], BIG)
        chose8 = ran8 & (cost8 <= BIG)
        finalize_node(st, coy, cox, 8, md8, chose8)
        flags8 = torch.where(ran8, FLAG_DECIDED | FLAG_SELF, 0)
        write_record(st, cnid, md8, flags8, nsv8, nsv8, ccbp, cidx, cost8,
                     ran8)
        contrib = torch.where(early8, ec8, torch.where(
            exists8, torch.clamp(cost8, max=BIG), 0))
        cs = cs + torch.where(descend, contrib, 0)

    # ---- split compare (cost <= cost_small keeps the 16 winner) ----
    chose16 = ran & ~early & (cost16 <= cs)
    finalize_node(st, oy, ox, size, md, chose16)
    flags = (torch.where(ran & ~early, FLAG_DECIDED, 0) |
             torch.where(chose16, FLAG_SELF, 0))
    write_record(st, nid, md, flags, nsv, nsv, ctx_cbp, ctx_index, cost16,
                 alive & ~early)
    st["cs"][:, 2] += torch.where(early, ecost, torch.where(
        exists & alive, torch.minimum(cost16, cs), 0))


# ---------------------------------------------------------------------------
# frame state + diagonal gather/flush
# ---------------------------------------------------------------------------

# rows below each frame-state plane that frame_megakernel's dead lanes
# write and no gather reads: a scatter of device positions has no order,
# so a dead lane must not write where a live lane does (on the first
# diagonal both sit at (0, 0))
DUMP_ROWS = {"rec_y": 128, "rec_u": 64, "rec_v": 64, "dd": 32}


def alloc_frame_state(w: int, h: int, nsb: int, device):
    """Device frame-resident state (origin (1,1) aprons for halo reads;
    the planes end in their DUMP_ROWS).  recA/recC hold one row per SB
    and a last row `nsb` that the dead lanes of a diagonal write and
    nothing reads."""
    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)
    i16 = torch.int16
    return {
        "rec_y": z((1 + h + 144 + DUMP_ROWS["rec_y"], 1 + w + 144), i16),
        "rec_u": z((1 + h // 2 + 80 + DUMP_ROWS["rec_u"], 1 + w // 2 + 80),
                   i16),
        "rec_v": z((1 + h // 2 + 80 + DUMP_ROWS["rec_v"], 1 + w // 2 + 80),
                   i16),
        "recA": z((nsb + 1, N_NODES, REC_W), I32),
        "recC": z((nsb + 1, N_NODES, 3, 16, 16), i16),
        "dd": z((len(DD_FIELDS), 1 + h // 4 + 40 + DUMP_ROWS["dd"],
                 1 + w // 4 + 40), i16),
    }


def _lane_windows(plane, starts, n: int):
    """torch.stack of the [..., n, n] windows of `plane` at the host
    integer (y, x) starts, each inside the plane."""
    H, W = plane.shape[-2:]
    return torch.stack([plane[..., _span(y, n, H), _span(x, n, W)]
                        for y, x in starts])


def gather_lanes_host(fs, org, lanes, L: int, device):
    """gather_lanes for the host loop: lanes are the live lanes' (sby,
    sbx) as host integers; the diagonal is padded to L lanes with dead
    lanes at (0, 0)."""
    pos = list(lanes) + [(0, 0)] * (L - len(lanes))
    c = [(y >> 1, x >> 1) for y, x in pos]
    yx = torch.tensor([[y for y, _ in pos], [x for _, x in pos],
                       [1] * len(lanes) + [0] * (L - len(lanes))],
                      dtype=I32).to(device)
    return {
        "sby": yx[0], "sbx": yx[1], "live": yx[2] > 0,
        "rec_y": _lane_windows(fs["rec_y"], pos, 130),
        "rec_u": _lane_windows(fs["rec_u"], c, 66),
        "rec_v": _lane_windows(fs["rec_v"], c, 66),
        "org_y": _lane_windows(org[0], pos, 128).to(I32),
        "org_u": _lane_windows(org[1], c, 64).to(I32),
        "org_v": _lane_windows(org[2], c, 64).to(I32),
        **_lane_scratch(L, device),
        "dd": _lane_windows(fs["dd"], [(y >> 2, x >> 2) for y, x in pos],
                            34).to(I32),
    }


def _lane_scratch(L: int, device):
    """The lane state that every diagonal starts from zero (the mv
    candidates, the split-cost accumulators, the records)."""
    def z(shape, dt, fill=0):
        return torch.full(shape, fill, dtype=dt, device=device)
    return {
        "mvc_y": z((L, 2, NCAND), I32),
        "mvc_x": z((L, 2, NCAND), I32),
        "mvc_mask": z((L, 2), I64),
        "mvc_num": z((L, 2), I32),
        "best_ref": z((L,), I32, -1),
        "cs": z((L, 4), I64),
        "dead": z((L, 4), torch.bool),
        "recA": z((L, N_NODES, REC_W), I32),
        "recC": z((L, N_NODES, 3, 16, 16), torch.int16),
    }


def flush_lanes_host(fs, st, lanes, sb_index, L: int, nsb: int):
    """flush_lanes for the host loop: the live lanes' interiors, each
    written at its host (sby, sbx), and every lane's records (the dead
    lanes' into row nsb)."""
    for li, (y, x) in enumerate(lanes):
        fs["rec_y"][1 + y:1 + y + 128, 1 + x:1 + x + 128] = \
            st["rec_y"][li, 1:129, 1:129]
        for p in ("rec_u", "rec_v"):
            fs[p][1 + (y >> 1):1 + (y >> 1) + 64,
                  1 + (x >> 1):1 + (x >> 1) + 64] = st[p][li, 1:65, 1:65]
        fs["dd"][:, 1 + (y >> 2):1 + (y >> 2) + 32,
                 1 + (x >> 2):1 + (x >> 2) + 32] = st["dd"][li, :, 1:33,
                                                            1:33]
    sbi = torch.tensor(list(sb_index) + [nsb] * (L - len(lanes))).to(
        st["recA"].device)
    fs["recA"][sbi] = st["recA"]
    fs["recC"][sbi] = st["recC"]


def _lane_wins(plane, y0, x0, n: int):
    """The [L, n, n] windows of a plane [H, W] (or [L, F, n, n] of a
    stack [F, H, W]) at per-lane device starts y0, x0 [L], with
    lax.dynamic_slice's start rule."""
    H, W = plane.shape[-2:]
    dev = plane.device
    ys = (_dstart(y0, n, H)[:, None] + _ar(n, dev))[:, :, None]
    xs = (_dstart(x0, n, W)[:, None] + _ar(n, dev))[:, None, :]
    if plane.dim() == 2:
        return plane[ys, xs]
    f = _ar(plane.shape[0], dev)[None, :, None, None]
    return plane[f, ys[:, None], xs[:, None]]


def gather_lanes(fs, org, lanes, L: int):
    """Per-diagonal lane state from the frame state
    (thor_tpu/enc/device_lc.py:gather_lanes).  lanes: the diagonal's
    [4, L] int32 device table (sby, sbx, live, sbi; dead lanes at (0,
    0)), so the work is the same for every diagonal and reads nothing
    back to the host."""
    sby, sbx = lanes[0], lanes[1]
    yc, xc = sby >> 1, sbx >> 1
    return {
        "sby": sby, "sbx": sbx, "live": lanes[2] > 0,
        "rec_y": _lane_wins(fs["rec_y"], sby, sbx, 130),
        "rec_u": _lane_wins(fs["rec_u"], yc, xc, 66),
        "rec_v": _lane_wins(fs["rec_v"], yc, xc, 66),
        "org_y": _lane_wins(org[0], sby, sbx, 128).to(I32),
        "org_u": _lane_wins(org[1], yc, xc, 64).to(I32),
        "org_v": _lane_wins(org[2], yc, xc, 64).to(I32),
        **_lane_scratch(L, lanes.device),
        "dd": _lane_wins(fs["dd"], sby >> 2, sbx >> 2, 34).to(I32),
    }


def flush_lanes(fs, st, sbi):
    """Write the lanes' interiors and records back into the frame state
    (thor_tpu/enc/device_lc.py:flush_lanes), one scatter per array.  A
    dead lane writes its tiles into the plane's DUMP_ROWS and its
    records into row nsb (its `sbi`): the live lanes of a diagonal never
    overlap, so every cell that is read again has one writer."""
    live = st["live"]
    for key, shift, n in (("rec_y", 0, 128), ("rec_u", 1, 64),
                          ("rec_v", 1, 64), ("dd", 2, 32)):
        plane = fs[key]
        dev = plane.device
        y0 = torch.where(live, 1 + (st["sby"] >> shift),
                         plane.shape[-2] - DUMP_ROWS[key])
        x0 = torch.where(live, 1 + (st["sbx"] >> shift), 0)
        ys = (y0[:, None] + _ar(n, dev))[:, :, None]
        xs = (x0[:, None] + _ar(n, dev))[:, None, :]
        tile = st[key][..., 1:1 + n, 1:1 + n].to(plane.dtype)
        if plane.dim() == 2:
            plane[ys, xs] = tile
        else:
            f = _ar(plane.shape[0], dev)[None, :, None, None]
            plane[f, ys[:, None], xs[:, None]] = tile
    sbi = sbi.long()
    fs["recA"][sbi] = st["recA"]
    fs["recC"][sbi] = st["recC"]


_PROGRAM = build_program()
_PROG_NID = [node_id({K_E128: 128, K_E64: 64, K_E32: 32, K_D128: 128,
                      K_D64: 64, K_D32: 32, K_16SUB: 16}[k], oy, ox)
             for (k, oy, ox) in _PROGRAM]
_ENTER = {K_E128: 128, K_E64: 64, K_E32: 32}
_DECIDE = {K_D128: 128, K_D64: 64, K_D32: 32}


def _step(kind: int, st, fc, oy: int, ox: int, nid: int, cfg):
    """One program step, dispatched on its kind (thor_tpu's
    _step_switch)."""
    if kind == K_16SUB:
        body_16sub(st, fc, oy, ox, nid, cfg)
    elif kind in _ENTER:
        body_enter(st, fc, oy, ox, nid, _ENTER[kind], cfg)
    else:
        body_decide(st, fc, oy, ox, nid, _DECIDE[kind], cfg)


def run_diagonal(fs, fc, cfg, org, lanes, sb_index, Lmax: int, nsb: int):
    """The host loop's diagonal (thor_tpu's THOR_LC_MEGAKERNEL=0 route):
    the 106-step node program, each step dispatched on its kind on the
    host, its work queued on the device without a synchronisation.

    A node that lies outside the frame in every live lane (`exists` is
    false everywhere) changes nothing but its depth's split-cost
    accumulator and early flag, whatever its body computes (every other
    write is masked by `exists`): such a step only resets those.
    frame_megakernel runs every step, and both routes give thor_tpu's
    records (tests/test_torch_megakernel.py)."""
    st = gather_lanes_host(fs, org, lanes, Lmax, fs["recA"].device)
    for (kind, oy, ox), nid in zip(_PROGRAM, _PROG_NID):
        if not any(y + oy + 8 <= cfg["h"] and x + ox + 8 <= cfg["w"]
                   for y, x in lanes):
            if kind in _ENTER:
                st["cs"][:, DEPTH[_ENTER[kind]]] = 0
                st["dead"][:, DEPTH[_ENTER[kind]]] = False
            elif kind in _DECIDE:
                st["dead"][:, DEPTH[_DECIDE[kind]]] = False
            continue
        _step(kind, st, fc, oy, ox, nid, cfg)
    flush_lanes_host(fs, st, lanes, sb_index, Lmax, nsb)


def diagonal_body(fs, fc, cfg, org, lanes, L: int):
    """One diagonal of frame_megakernel: gather the lanes that the
    device table `lanes` [4, L] names, run all 106 steps of the program,
    flush.  The work is the same for every diagonal of a frame and reads
    nothing back to the host, so on the card it is captured once as a
    CUDA graph and replayed per diagonal."""
    st = gather_lanes(fs, org, lanes, L)
    for (kind, oy, ox), nid in zip(_PROGRAM, _PROG_NID):
        _step(kind, st, fc, oy, ox, nid, cfg)
    flush_lanes(fs, st, lanes[3])


def lane_tables(diagonals, L: int, nsb: int):
    """The wavefront's lane tables (thor_tpu/enc/device_lc.py:1938-1948)
    as one int32 array [4, D, L]: sby, sbx, live, sbi; each diagonal's
    lanes first, then dead lanes at (0, 0) whose records go to row
    nsb."""
    tab = np.zeros((4, len(diagonals), L), np.int32)
    tab[3] = nsb
    for d, (lanes, idx) in enumerate(diagonals):
        for li, ((y, x), i) in enumerate(zip(lanes, idx)):
            tab[:, d, li] = (y, x, 1, i)
    return tab


def frame_megakernel(fs, fc, org, tables, cfg, L: int, nsb: int):
    """Whole-frame SB decision pass (thor_tpu/enc/device_lc.py:
    frame_megakernel): diagonal_body for each diagonal d of the device
    lane tables [4, D, L], in order, updating fs in place.  On the CPU
    each diagonal runs eagerly; on the card through the frame
    configuration's DiagonalGraph (diagonal 0 eagerly where the graph is
    new, then one replay per diagonal)."""
    if fs["recA"].device.type != "cuda":
        for d in range(tables.shape[1]):
            diagonal_body(fs, fc, cfg, org, tables[:, d], L)
        return
    DiagonalGraph.get(fs, fc, org, cfg, L, nsb).run(fs, fc, org, tables)


class DiagonalGraph:
    """A frame configuration's diagonal body as a CUDA graph: device
    buffers whose addresses never change (the frame state, the frame
    constants and org, the diagonal's lane table), the body captured
    once and replayed once per diagonal.  Everything the body bakes in
    is in the key: cfg, L, nsb, the per-frame scalars (fc["dyn"], Python
    numbers) and the shapes.  Bounded (KEEP, least recently used first
    out), so that the graphs' pools do not grow with a sequence (LC_KW
    gives four keys: the I frame, P frames with one and with two
    references, and every HQperiod-th P frame at the base qp).  Any
    failure raises: there is no fallback."""

    KEEP = 4
    _cache = collections.OrderedDict()
    _cache_lock = threading.Lock()     # the cache
    _capture_lock = threading.Lock()   # one capture at a time per process

    @classmethod
    def get(cls, fs, fc, org, cfg, L: int, nsb: int):
        key = (str(fs["recA"].device), tuple(sorted(cfg.items())), L, nsb,
               tuple(sorted(fc["dyn"].items())),
               tuple((k, tuple(v.shape)) for k, v in sorted(fc.items())
                     if k != "dyn"),
               tuple(tuple(o.shape) for o in org))
        with cls._cache_lock:
            g = cls._cache.pop(key, None) or cls(fs, fc, org, cfg, L)
            cls._cache[key] = g
            evicted = [cls._cache.popitem(last=False)[1]
                       for _ in range(len(cls._cache) - cls.KEEP)]
        for e in evicted:      # each waits for its last replay
            e.drop()
        return g

    def __init__(self, fs, fc, org, cfg, L: int):
        self.fs = {k: torch.empty_like(v) for k, v in fs.items()}
        self.fc = {k: (v if k == "dyn" else torch.empty_like(v))
                   for k, v in fc.items()}
        self.org = tuple(torch.empty_like(o) for o in org)
        self.lanes = torch.zeros((4, L), dtype=I32, device=org[0].device)
        self.cfg, self.L = cfg, L
        self.graph = None
        self.done = None        # the last run's end, on its stream
        self.lock = threading.Lock()

    def body(self):
        diagonal_body(self.fs, self.fc, self.cfg, self.org, self.lanes,
                      self.L)

    def warm_up(self):
        """The body eagerly, on diagonal 0: its real result, and the
        warm-up that fills the cached device tables (_tabs, _ar, the
        functools.cache tables) outside any capture."""
        self.body()

    def capture(self):
        """Capture the body into a CUDA graph with a pool of its own
        (thread-local capture mode: other threads may launch meanwhile;
        one capture at a time in the process)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with DiagonalGraph._capture_lock:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self.body()
        self.graph = graph

    def instantiate(self):
        self.graph.instantiate()

    def replay(self):
        self.graph.replay()

    def run(self, fs, fc, org, tables):
        """frame_megakernel on the card: copy the frame in, run its
        diagonals (where the graph is new: diagonal 0 by warm_up, then
        capture; every other diagonal one replay after a device-to-device
        copy of its lane table), copy the state out."""
        with self.lock:
            if self.done is not None:
                torch.cuda.current_stream().wait_event(self.done)
            for k, v in fs.items():
                self.fs[k].copy_(v)
            for k, v in fc.items():
                if k != "dyn":
                    self.fc[k].copy_(v)
            for s, o in zip(self.org, org):
                s.copy_(o)
            first = 0
            if self.graph is None:
                self.lanes.copy_(tables[:, 0])
                self.warm_up()
                first = 1
                if tables.shape[1] > 1:
                    self.capture()
                    self.instantiate()
            for d in range(first, tables.shape[1]):
                self.lanes.copy_(tables[:, d])
                self.replay()
            for k, v in fs.items():
                v.copy_(self.fs[k])
            self.done = torch.cuda.Event()
            self.done.record()

    def drop(self):
        """Leave the cache: wait for the last run before the graph and
        its pool go."""
        with self.lock:
            if self.done is not None:
                self.done.synchronize()
            self.graph = None


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def lc_supported(enc) -> bool:
    """Feature gate for the device decision pass (LDB LC preset family)."""
    p = enc.params
    fi = enc.fi
    return (p.subsample == 420 and p.bitdepth == 8 and
            p.input_bitdepth == 8 and p.encoder_speed == 2 and
            not p.enable_tb_split and not p.enable_pb_split and
            not p.enable_bipred and not p.intra_rdo and
            not p.qmtx and p.bitrate == 0 and p.max_delta_qp == 0 and
            not p.sync and p.interp_ref == 0 and
            p.log2_sb_size == 7 and p.early_skip_thr > 0 and
            fi.frame_type in (I_FRAME, P_FRAME) and fi.num_ref <= 2 and
            fi.num_intra_modes == 4 and
            p.width % 8 == 0 and p.height % 8 == 0)


def build_frame_consts(enc):
    """Per-frame device constants: org planes + per-ref raw/variant
    stacks.  An I frame reads no reference, so it gets no stacks; a
    reference used twice is filtered once."""
    p = enc.params
    fi = enc.fi
    dev = enc.device
    h, w = p.height, p.width
    org_y = np.zeros((h + 136, w + 136), np.int16)
    org_y[:h, :w] = enc.orig.y
    org_u = np.zeros((h // 2 + 72, w // 2 + 72), np.int16)
    org_u[:h // 2, :w // 2] = enc.orig.u
    org_v = np.zeros_like(org_u)
    org_v[:h // 2, :w // 2] = enc.orig.v
    org = tuple(torch.from_numpy(a).to(dev) for a in (org_y, org_u, org_v))
    if fi.frame_type == I_FRAME:
        return {}, org
    refs = [fi.ref_array[min(r, fi.num_ref - 1)] for r in range(2)]
    planes = {}
    for r in refs:
        if r not in planes:
            ref = enc.ref[r]
            planes[r] = enc._dev_ref_planes(ref) or tuple(
                torch.from_numpy(a.astype(np.int16)).to(dev)
                for a in (ref.y_full, ref.u_full, ref.v_full))
    return ref_stacks([planes[r] for r in refs]), org


def ref_stacks(planes):
    """The references' device constants from their padded (y, u, v)
    int16 planes, one triple per reference slot: raw luma, the luma
    variant stack, and the chroma stacks (U's, then V's); a plane object
    given twice is filtered once."""
    done = {}

    def var(fn, a):
        if id(a) not in done:
            done[id(a)] = fn(a)
        return done[id(a)]
    return {"raw_y": torch.stack([p[0] for p in planes]),
            "vars_y": torch.cat([var(make_luma_variants, p[0])
                                 for p in planes]),
            "vars_c": torch.cat([var(make_chroma_variants, p[c])
                                 for c in (1, 2) for p in planes])}


IQ8 = [6, 7, 8, 8, 10, 11, 12, 13, 15, 17, 19, 21, 24, 27, 30, 34,
       38, 43, 48, 54, 60, 68, 76, 86, 96, 108, 121, 136, 152, 171,
       192, 216, 242, 272, 305, 342, 384, 431, 484, 543, 610, 684,
       768, 862, 968, 1086, 1219, 1368, 1536, 1724, 1935, 2172]


def build_cfg(enc):
    """Per-frame configuration: frame type, geometry, feature flags."""
    p = enc.params
    fi = enc.fi
    return dict(w=p.width, h=p.height, num_ref=max(fi.num_ref, 1),
                is_i=(fi.frame_type == I_FRAME), cfl_intra=p.cfl_intra,
                ctx=p.use_block_contexts)


def build_dyn(enc):
    """Per-frame scalars (qp ladder, lambda, early-skip thresholds, the
    16->8 top-down threshold): Python numbers, lambda in float64."""
    from .encoder import SQUARED_LAMBDA_QP
    p = enc.params
    fi = enc.fi
    qp = fi.qp
    qpC = int(CHROMA_QP[qp])
    lam = fi.lambda_coeff * SQUARED_LAMBDA_QP[qp]
    sqrt_lam = math.sqrt(lam)
    dyn = {"qp": qp, "qpC": qpC, "lam": lam, "sqrt_lam": sqrt_lam,
           "isqrt_bias": int(sqrt_lam * 2 + 0.5),
           "thr16": 16 * 16 * IQ8[qp] // 8}
    for size in (8, 16, 32, 64, 128):
        tl, tc = early_skip_thresholds(qp, qpC, p.early_skip_thr,
                                       sb_bump=(size == SB))
        dyn["thr_l_%d" % size] = tl[min(size, 32) // 2]
        if size == 8:
            dyn["thr_c"] = tc
        if size == 128:
            dyn["thr_c128"] = tc
    return dyn


def wavefront(nsh: int, nsv: int):
    """The diagonals s = 2k + l (deps: left, top-left, top, top-right):
    [(lanes [(sby, sbx)], SB indices)]."""
    diagonals = []
    for s in range(2 * (nsv - 1) + (nsh - 1) + 1):
        lanes = [(k * SB, (s - 2 * k) * SB)
                 for k in range(nsv) if 0 <= s - 2 * k < nsh]
        if lanes:
            diagonals.append((lanes, [(y // SB) * nsh + x // SB
                                      for y, x in lanes]))
    return diagonals


@torch.inference_mode()
def encode_frame_device(enc):
    """Run the SB loop of encode_frame on the device, then replay the
    syntax.  Replaces the raster process_block loop of
    enc/encode_frame.c:697-758 bit-exactly: identical bitstream, recon
    and deblock data.  The route is the encoder's (Encoder.megakernel,
    encode_sequence(megakernel=...)): frame_megakernel (thor_tpu's
    default) or the host loop over run_diagonal (thor_tpu's
    THOR_LC_MEGAKERNEL=0).  Runs in inference mode: the decision pass
    issues millions of small torch ops a frame, and autograd's
    bookkeeping is a fifth of each one's host time."""
    p = enc.params
    h, w = p.height, p.width
    nsh = (w + SB - 1) // SB
    nsv = (h + SB - 1) // SB
    nsb = nsh * nsv
    cfg = build_cfg(enc)
    fc, org = build_frame_consts(enc)
    fc["dyn"] = build_dyn(enc)
    fs = alloc_frame_state(w, h, nsb, enc.device)
    diagonals = wavefront(nsh, nsv)
    Lmax = max(len(lanes) for lanes, _ in diagonals)
    if enc.megakernel:
        tables = torch.from_numpy(lane_tables(diagonals, Lmax, nsb)).to(
            enc.device)
        frame_megakernel(fs, fc, org, tables, cfg, Lmax, nsb)
    else:
        for lanes, idx in diagonals:
            run_diagonal(fs, fc, cfg, org, lanes, idx, Lmax, nsb)
    recA, recC = pull_frame(enc, fs, nsb)
    emit_frame(enc, recA, recC, nsh, nsv)


# deblock-data fields of the frame state -> DeblockData arrays
_DD_PULL = (("mode", "mode"), ("size", "size"), ("tb", "tb_split"),
            ("pb", "pb_part"), ("cbp_y", "cbp_y"), ("cbp_u", "cbp_u"),
            ("cbp_v", "cbp_v"), ("ref0", "ref_idx0"), ("ref1", "ref_idx1"),
            ("bip", "bipred_flag"))


def pull_frame(enc, fs, nsb: int):
    """Pull the records, the recon and the deblock data from the device
    into enc.rec and enc.dd.  Returns (recA, recC) numpy."""
    p = enc.params
    h, w = p.height, p.width
    hc, wc = h // 4, w // 4
    recA = fs["recA"][:nsb].cpu().numpy()
    recC = fs["recC"][:nsb].cpu().numpy()
    enc.rec.y[:, :] = fs["rec_y"][1:1 + h, 1:1 + w].cpu().numpy()
    enc.rec.u[:, :] = fs["rec_u"][1:1 + h // 2, 1:1 + w // 2].cpu().numpy()
    enc.rec.v[:, :] = fs["rec_v"][1:1 + h // 2, 1:1 + w // 2].cpu().numpy()
    dd = fs["dd"][:, 1:1 + hc, 1:1 + wc].to(I32).cpu().numpy().reshape(
        len(DD_FIELDS), -1)
    for f, attr in _DD_PULL:
        getattr(enc.dd, attr)[:] = dd[DD[f]]
    enc.dd.mv0[:, 0] = dd[DD["mv0y"]]
    enc.dd.mv0[:, 1] = dd[DD["mv0x"]]
    enc.dd.mv1[:, 0] = dd[DD["mv1y"]]
    enc.dd.mv1[:, 1] = dd[DD["mv1x"]]
    return recA, recC


# ---------------------------------------------------------------------------
# syntax emission replay (host, no numerics)
# ---------------------------------------------------------------------------

class _EmitBI:
    """Minimal BlockInfo stand-in for writer.write_block."""


def emit_frame(enc, recA, recC, nsh: int, nsv: int):
    from . import writer as W
    p = enc.params
    h, w = p.height, p.width

    def emit(sbi, sby, sbx, size, oy, ox):
        ypos, xpos = sby + oy, sbx + ox
        if ypos + 8 > h or xpos + 8 > w:
            return
        encode_this = ypos + size <= h and xpos + size <= w
        nid = node_id(size, oy, ox)
        rec = recA[sbi, nid]
        bi = _EmitBI()
        bi.size = size
        bi.ypos, bi.xpos = ypos, xpos
        bi.sub = 1
        bi.max_num_tb_part = 1
        bi.max_num_pb_part = 1
        bi.num_skip_vec = int(rec[RF_NSV])
        bi.num_merge_vec = int(rec[RF_NMV])
        bi.mvp = (int(rec[RF_MVPY]), int(rec[RF_MVPX]))
        bi.ctx_cbp = int(rec[RF_CTXCBP])
        bi.ctx_index = int(rec[RF_CTXIDX])
        bi.delta_qp = 0
        if int(rec[RF_FLAGS]) & FLAG_SELF:
            mv = (int(rec[RF_MVY]), int(rec[RF_MVX]))
            qs = min(16, size)
            qsc = min(16, size // 2)
            bp = {
                "mode": int(rec[RF_MODE]), "tb_split": 0, "pb_part": 0,
                "skip_idx": int(rec[RF_IDX]),
                "intra_mode": int(rec[RF_IMODE]),
                "ref_idx0": int(rec[RF_REF]), "ref_idx1": int(rec[RF_REF]),
                "mv_arr0": [mv] * 4, "mv_arr1": [mv] * 4,
                "cbp": (int(rec[RF_CBPY]), int(rec[RF_CBPU]),
                        int(rec[RF_CBPV])),
                "coeff_y": recC[sbi, nid, 0, :qs, :qs].astype(np.int32),
                "coeff_u": recC[sbi, nid, 1, :qsc, :qsc].astype(np.int32),
                "coeff_v": recC[sbi, nid, 2, :qsc, :qsc].astype(np.int32),
            }
            W.write_block(enc.writer, enc, bi, bp)
            return
        # split: super-mode split signal then recurse
        W.write_super_mode(enc.writer, enc, bi, MODE_SKIP, 0, 1,
                           encode_this)
        for dy, dx in child_offsets(size):
            emit(sbi, sby, sbx, size // 2, oy + dy, ox + dx)

    for k in range(nsv):
        for sl in range(nsh):
            emit(k * nsh + sl, k * SB, sl * SB, SB, 0, 0)
