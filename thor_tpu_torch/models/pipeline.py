"""Decode pixel pipeline over 16x16 inter tiles (torch port of
thor_tpu/models/pipeline.py).

`decode_inter_frame_16` is the device side of decoding a P frame whose
blocks are all 16x16 inter: batched MC, dequantize, inverse transform,
reconstruct.  `decode_p_frame_420` adds the chroma planes and the in-loop
chain deblock -> CDEF -> CLPF.  The host supplies dense per-tile metadata
(window origins and fractions), the coefficient tensors and the masks
folded from the block metadata; `make_example` and `make_example_full`
make such inputs from a seed, as numpy arrays.

Every function takes the device it runs on (the CUDA card when none is
given).  On the card the MC goes through the hand-written kernels of
ops/mc.py: the luma kernel, and for chroma the U+V kernel when the tile
count is a multiple of 16, else the one-plane kernel once per plane (the
branch of thor_tpu's pipeline that picks between its Pallas kernels).
thor_tpu's `multi_stream_step` and `multi_stream_full` shard these
functions over a JAX mesh and are not part of this module.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dec.decoder import resolve_device
from ..ops import filters as OF
from ..ops.mc import mc_chroma_tiles, mc_chroma_uv_tiles, mc_luma_tiles
from ..ops.transform import (dequantize_batch, inv_transform_batch,
                             reconstruct_batch)
from ..spec import inter
from ..tables import CHROMA_QP

TILE = 16


def _to(device, arrays):
    return tuple(a.to(device) if isinstance(a, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in arrays)


def _tiles_to_frame(t, h: int, w: int, ts: int):
    return t.reshape(h // ts, w // ts, ts, ts).permute(0, 2, 1, 3).reshape(
        h, w)


def decode_inter_frame_16(ref_padded, oy, ox, frac_v, frac_h, coeff,
                          height: int, width: int, qp: int = 32,
                          bitdepth: int = 8, device=None):
    """Decode one frame of 16x16 inter tiles.

    ref_padded: [Hp,Wp] integer plane.  oy/ox/frac_v/frac_h: [N] per-tile
    MC metadata (window origins into ref_padded, inside the plane).
    coeff: [N,16,16] quantized coefficients.  Arguments are numpy arrays
    or tensors; they are moved to `device`.  Returns the reconstructed
    frame [H,W] int32 on `device`."""
    device = resolve_device(device)
    ref_padded, oy, ox, frac_v, frac_h, coeff = _to(
        device, (ref_padded, oy, ox, frac_v, frac_h, coeff))
    pred = mc_luma_tiles(ref_padded, oy, ox, frac_v, frac_h, tile=TILE,
                         bipred=0, bitdepth=bitdepth)
    res = inv_transform_batch(dequantize_batch(coeff, qp, TILE), TILE,
                              bitdepth)
    rec = reconstruct_batch(res, pred, bitdepth)
    return _tiles_to_frame(rec, height, width, TILE)


def make_example(height=288, width=352, qp=32, seed=0):
    """Example args for decode_inter_frame_16 (CIF by default), numpy."""
    rng = np.random.default_rng(seed)
    pad = 64
    ref = rng.integers(0, 256, (height + 2 * pad, width + 2 * pad),
                       dtype=np.int32)
    n = (height // TILE) * (width // TILE)
    ty, tx = np.mgrid[0:height:TILE, 0:width:TILE]
    mvy = rng.integers(-32, 33, n)
    mvx = rng.integers(-32, 33, n)
    oy = (pad + ty.ravel() + (mvy >> 2) - 2).astype(np.int32)
    ox = (pad + tx.ravel() + (mvx >> 2) - 2).astype(np.int32)
    fv = (mvy & 3).astype(np.int32)
    fh = (mvx & 3).astype(np.int32)
    coeff = np.zeros((n, TILE, TILE), np.int32)
    coeff[:, :4, :4] = rng.integers(-80, 80, (n, 4, 4))
    return ref, oy, ox, fv, fh, coeff


def decode_p_frame_420(refy, refu, refv, oy, ox, fv, fh, coy, cox, cfv, cfh,
                       coeff_y, coeff_u, coeff_v,
                       dbl_maskv, dbl_maskh, dbl_cmaskv, dbl_cmaskh,
                       cdef_level, cdef_sec, cdef_mask_y, cdef_mask_u,
                       cdef_mask_v, clpf_mask_y, clpf_mask_u, clpf_mask_v,
                       height: int, width: int, qp: int = 32,
                       bitdepth: int = 8, device=None,
                       clpf_strengths: tuple = (2, 2, 2),
                       cdef_damping: tuple = (6, 5)):
    """Full device side of decoding a 4:2:0 P frame of 16x16 inter tiles:
    MC (luma quarter-pel + chroma eighth-pel), dequant + inverse
    transform, reconstruction, then the in-loop chain deblock -> CDEF
    (directions computed on the device from the deblocked luma) -> CLPF,
    exactly as dec/decode_frame.c:140-198 orders it.

    The host supplies per-tile MC metadata, coefficients, and the
    block-metadata masks/maps folded from deblock_data (ops.filters
    helpers), as numpy arrays or tensors.  Returns (y, u, v)
    reconstructed planes on `device`."""
    device = resolve_device(device)
    (refy, refu, refv, oy, ox, fv, fh, coy, cox, cfv, cfh, coeff_y, coeff_u,
     coeff_v, dbl_maskv, dbl_maskh, dbl_cmaskv, dbl_cmaskh, cdef_level,
     cdef_sec, cdef_mask_y, cdef_mask_u, cdef_mask_v, clpf_mask_y,
     clpf_mask_u, clpf_mask_v) = _to(device, (
         refy, refu, refv, oy, ox, fv, fh, coy, cox, cfv, cfh, coeff_y,
         coeff_u, coeff_v, dbl_maskv, dbl_maskh, dbl_cmaskv, dbl_cmaskh,
         cdef_level, cdef_sec, cdef_mask_y, cdef_mask_u, cdef_mask_v,
         clpf_mask_y, clpf_mask_u, clpf_mask_v))
    ch, cw = height // 2, width // 2

    # ---- prediction + residual + reconstruction ----
    pred_y = mc_luma_tiles(refy, oy, ox, fv, fh, tile=TILE, bipred=0,
                           bitdepth=bitdepth)
    if coy.shape[0] % 16 == 0:
        # U/V share per-tile metadata: one kernel over both planes
        pred_u, pred_v = mc_chroma_uv_tiles(refu, refv, coy, cox, cfv, cfh,
                                            tile=8, bitdepth=bitdepth)
    else:
        pred_u = mc_chroma_tiles(refu, coy, cox, cfv, cfh, tile=8,
                                 bitdepth=bitdepth)
        pred_v = mc_chroma_tiles(refv, coy, cox, cfv, cfh, tile=8,
                                 bitdepth=bitdepth)
    qpc = int(CHROMA_QP[qp])
    res_y = inv_transform_batch(dequantize_batch(coeff_y, qp, TILE), TILE,
                                bitdepth)
    res_u = inv_transform_batch(dequantize_batch(coeff_u, qpc, 8), 8,
                                bitdepth)
    res_v = inv_transform_batch(dequantize_batch(coeff_v, qpc, 8), 8,
                                bitdepth)
    y = _tiles_to_frame(reconstruct_batch(res_y, pred_y, bitdepth),
                        height, width, TILE)
    u = _tiles_to_frame(reconstruct_batch(res_u, pred_u, bitdepth),
                        ch, cw, 8)
    v = _tiles_to_frame(reconstruct_batch(res_v, pred_v, bitdepth),
                        ch, cw, 8)

    # ---- deblock ----
    y = OF.deblock_plane_y(y, dbl_maskv, dbl_maskh, qp, bitdepth)
    u = OF.deblock_plane_uv(u, dbl_cmaskv, dbl_cmaskh, qpc, 1, bitdepth)
    v = OF.deblock_plane_uv(v, dbl_cmaskv, dbl_cmaskh, qpc, 1, bitdepth)

    # ---- CDEF (dirs from the deblocked luma, shared with chroma) ----
    cs = bitdepth - 8
    dirs, var = OF.cdef_dirs(y, cs)
    y = OF.cdef_plane(y, dirs, var, cdef_level, cdef_sec, cdef_mask_y,
                      8, 0, cdef_damping[0], cdef_damping[1], cs)
    u = OF.cdef_plane(u, dirs, var, cdef_level, cdef_sec, cdef_mask_u,
                      4, 1, cdef_damping[0] - 1, cdef_damping[1] - 1, cs)
    v = OF.cdef_plane(v, dirs, var, cdef_level, cdef_sec, cdef_mask_v,
                      4, 1, cdef_damping[0] - 1, cdef_damping[1] - 1, cs)

    # ---- CLPF ----
    sy, su, sv = clpf_strengths
    if sy:
        y = OF.clpf_plane(y, clpf_mask_y, sy << cs,
                          bitdepth - 4 + (qp >> 4))
    if su:
        u = OF.clpf_plane(u, clpf_mask_u, su << cs,
                          bitdepth - 5 + (qp >> 4))
    if sv:
        v = OF.clpf_plane(v, clpf_mask_v, sv << cs,
                          bitdepth - 5 + (qp >> 4))
    return y, u, v


def make_example_full(height=288, width=352, qp=32, seed=0, bitdepth=8):
    """Random-but-consistent inputs for decode_p_frame_420 (numpy arrays)
    plus the spec objects needed to cross-check it (dd, presets)."""
    rng = np.random.default_rng(seed)
    pad = 64
    maxv = (1 << bitdepth)
    H, W = height, width
    ch, cw = H // 2, W // 2
    refy = rng.integers(0, maxv, (H + 2 * pad, W + 2 * pad), dtype=np.int32)
    refu = rng.integers(0, maxv, (ch + pad, cw + pad), dtype=np.int32)
    refv = rng.integers(0, maxv, (ch + pad, cw + pad), dtype=np.int32)
    n = (H // TILE) * (W // TILE)
    ty, tx = np.mgrid[0:H:TILE, 0:W:TILE]
    mvy = rng.integers(-32, 33, n)
    mvx = rng.integers(-32, 33, n)
    oy = (pad + ty.ravel() + (mvy >> 2) - 2).astype(np.int32)
    ox = (pad + tx.ravel() + (mvx >> 2) - 2).astype(np.int32)
    fv = (mvy & 3).astype(np.int32)
    fh = (mvx & 3).astype(np.int32)
    cty, ctx = np.mgrid[0:ch:8, 0:cw:8]
    coy = (pad // 2 + cty.ravel() + (mvy >> 3) - 1).astype(np.int32)
    cox = (pad // 2 + ctx.ravel() + (mvx >> 3) - 1).astype(np.int32)
    cfv = (mvy & 7).astype(np.int32)
    cfh = (mvx & 7).astype(np.int32)
    coeff_y = np.zeros((n, TILE, TILE), np.int32)
    coeff_y[:, :4, :4] = rng.integers(-80, 80, (n, 4, 4))
    coeff_u = np.zeros((n, 8, 8), np.int32)
    coeff_u[:, :2, :2] = rng.integers(-40, 40, (n, 2, 2))
    coeff_v = np.zeros((n, 8, 8), np.int32)
    coeff_v[:, :2, :2] = rng.integers(-40, 40, (n, 2, 2))

    dd = inter.DeblockData(W, H)
    nn = dd.size.shape[0]
    dd.size[:] = 16
    dd.cbp_y[:] = rng.integers(0, 2, nn)
    dd.mode[:] = rng.choice([0, 2, 2, 4], nn)
    dd.mv0[:] = np.repeat(np.stack([mvy, mvx], 1), 16, 0)[:nn]
    dd.mv1[:] = dd.mv0
    mv_, mh_ = OF.deblock_masks_y(dd, W, H)
    cmv, cmh = OF.deblock_masks_uv(dd, W, H)

    nfb = ((H + 63) // 64) * ((W + 63) // 64)
    presets = [{"level": int(rng.integers(0, 12)),
                "sec_strength": int(rng.integers(0, 4))} for _ in range(nfb)]
    lv, sec, m_y = OF.cdef_block_maps(dd, presets, W, H, 0, 1)
    _, _, m_u = OF.cdef_block_maps(dd, presets, W, H, 1, 1)
    _, _, m_v = OF.cdef_block_maps(dd, presets, W, H, 2, 1)
    cm_y, _ = OF.clpf_pixel_mask(dd, W, H, 0, 7, 1)
    cm_u, _ = OF.clpf_pixel_mask(dd, W, H, 1, 4, 1)
    cm_v, _ = OF.clpf_pixel_mask(dd, W, H, 2, 4, 1)

    args = tuple(np.asarray(a) for a in (
        refy, refu, refv, oy, ox, fv, fh, coy, cox, cfv, cfh,
        coeff_y, coeff_u, coeff_v, mv_, mh_, cmv, cmh,
        lv, sec, m_y, m_u, m_v, cm_y, cm_u, cm_v))
    return args, dd, presets
