"""Batched encoder quantizer, the adaptive-deadzone scalar quantizer
(torch port of thor_tpu/ops/quant.py; reference enc/encode_block.c:84-160).

The level-mode state threaded along the zigzag scan is a two-state
automaton: both candidate levels are evaluated per position and the
realized state is resolved by a log-depth (Hillis-Steele) scan over the
per-position state-transition maps.  The maps are integers, so any scan
order gives the reference's result.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import tables as T
from .transform import _i32


@functools.cache
def _zz_perms_on(qsize: int, device: str):
    zz = np.asarray(T.ZIGZAG[qsize], np.int64)
    inv = np.argsort(zz)            # sc[pos] = flat[inv[pos]]
    return (torch.as_tensor(zz, device=device),
            torch.as_tensor(inv, device=device))


def _zz_perms(qsize: int, device):
    """(zigzag order, its inverse) as index tensors on `device`, built
    once per device (an upload per call would synchronise the stream)."""
    return _zz_perms_on(qsize, str(torch.device(device)))


def _wrap_i32(v: int) -> int:
    """A Python integer wrapped to int32."""
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _compose2(a0, a1, b0, b1):
    """2-state maps (image of state 0, image of state 1): b after a."""
    return torch.where(a0 == 0, b0, b1), torch.where(a1 == 0, b0, b1)


def scan_maps2(m0, m1):
    """Inclusive scan along dim 1 of 2-state maps: out[p] = m[p] o ... o
    m[0].  log2(n) steps of whole-row compositions."""
    n = m0.shape[1]
    d = 1
    while d < n:
        c0, c1 = _compose2(m0[:, :-d], m1[:, :-d], m0[:, d:], m1[:, d:])
        m0 = torch.cat([m0[:, :d], c0], dim=1)
        m1 = torch.cat([m1[:, :d], c1], dim=1)
        d *= 2
    return m0, m1


def quantize_batch(coeff, qp: int, size: int, intra_block: int,
                   wmatrix=None, weighted: bool = False):
    """Quantize a batch of transform blocks (enc/encode_block.c:84-160).

    coeff: [N, qsize, qsize] integer transform output (qsize =
    min(16,size)), int16-range values.  `wmatrix` [qsize, qsize] is the
    qmtx forward weight matrix of a weighted quantize (products in int64,
    as the reference's x64 path).  Returns (coeffq [N,qsize,qsize] int16,
    cbp [N] int32 0/1)."""
    dev = coeff.device
    tr_log2size = T.log2i(size)
    qsize = min(T.MAX_QUANT_SIZE, size)
    n2 = qsize * qsize
    qp = int(qp)
    scale = int(T.GQUANT[qp % 6])
    shift2 = 21 - tr_log2size + qp // 6 + (T.WEIGHT_SHIFT if weighted
                                            else 0)
    zz, inv = _zz_perms(qsize, dev)

    # every product fits int64 (the unweighted ones also fit the
    # reference's int32: |c| <= 2^15, scale < 2^15).  The deadzone
    # offsets are int32 in the reference (a Python int shifted by its
    # int32 shift count) and wrap where the weighted shift passes 2^31:
    # `_i32` keeps that
    c = coeff.reshape(coeff.shape[0], n2).to(torch.int64)
    if weighted:
        c = c * wmatrix.reshape(1, n2).to(torch.int64)
    sc = c[:, inv]                               # zigzag order [N, n2]
    absc = sc.abs()
    sign = torch.where(sc < 0, -1, 1)
    a = absc * scale

    # ---- last_pos (reverse deadzone scan, :117-124) ----
    off_r = _wrap_i32((38 if intra_block else -26) << (shift2 - 8))
    lev_r = (a + off_r).abs() >> shift2
    idx = torch.arange(n2, device=dev)
    last_pos = torch.where(lev_r != 0, idx, -1).max(dim=1).values

    # ---- forward adaptive-deadzone scan (:129-155): state = level_mode
    offset0 = 102 if intra_block else 51
    offset1 = 115 if intra_block else 90
    level0 = a >> shift2
    off_s0 = _i32(torch.where(level0 > 1, offset1, offset0) <<
                  (shift2 - 8)).to(torch.int64)
    off_s1 = _i32(torch.where(level0 > 0, offset1, offset0) <<
                  (shift2 - 8)).to(torch.int64)
    lv0 = (a + off_s0) >> shift2                  # level if mode==0
    lv1 = (a + off_s1) >> shift2                  # level if mode==1
    active = idx[None, :] <= last_pos[:, None]
    m0 = torch.where(active, (lv0 > 1).to(torch.int32), 0)
    m1 = torch.where(active, (lv1 != 0).to(torch.int32), 1)

    # state BEFORE position p: the exclusive scan from state 1
    _, cm1 = scan_maps2(m0, m1)
    state = torch.cat([torch.ones((sc.shape[0], 1), dtype=torch.int32,
                                  device=dev), cm1[:, :-1]], dim=1)
    level = torch.where(state == 1, lv1, lv0)
    level = torch.where(active, level, 0)
    scq = sign * level
    cbp = (scq != 0).any(dim=1).to(torch.int32)
    coeffq = scq[:, zz].reshape(coeff.shape[0], qsize, qsize).to(
        torch.int16)
    return coeffq, cbp
