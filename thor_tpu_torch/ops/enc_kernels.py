"""The encoder's batched block kernels (torch port of
thor_tpu/ops/enc_kernels.py): the SAD evaluators that the wavefront
device encoder runs, `widesad_batch` (:59), `fasthalf_batch` (:79) and
`fastquarter_batch` (:139), and the plain ones, `sad_batch` (:27),
`ssd_batch` (:33), `avg_batch` (:40) and `scale_down2x2` (:47), which
the lockstep motion search (ops/me_batch.py) runs.

The evaluators take a batch of blocks and return, per block, the
smallest SAD and where it lies.  Sums are int64, as a JAX sum of int32
values is under 64-bit JAX.  Ties keep the first candidate in the listed
order: torch's argmin returns the first minimal index, as jnp.argmin
does.  The plain kernels also take numpy arrays, which go to their
`device=` keyword (`on_device`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _i32(x):
    return x.to(torch.int32)


def _same_device(a: torch.device, b: torch.device):
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


def on_device(device, *arrays):
    """The arrays of one call as tensors on one device.  Tensor arguments
    stay where they are; numpy arrays go to `device`, resolved as
    dec/decoder.py:resolve_device resolves it (CUDA unless the caller
    asks for the CPU; raises when CUDA is meant and torch sees no card),
    or to the tensor arguments' device where `device` is None.  Raises
    for tensors on several devices or on another than `device`."""
    from ..dec.decoder import resolve_device
    devs = [a.device for a in arrays if isinstance(a, torch.Tensor)]
    dev = resolve_device(device) if device is not None or not devs else \
        devs[0]
    if not all(_same_device(d, dev) for d in devs):
        raise ValueError(f"arguments on {sorted({str(d) for d in devs})}, "
                         f"not all on {dev}")
    return [a if isinstance(a, torch.Tensor) else
            torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in arrays]


def sad_batch(org, cand, device=None):
    """SAD per block: [N,h,w] x [N,h,w] -> [N] int64 (enc_kernels.c:84)."""
    org, cand = on_device(device, org, cand)
    return _sad(_i32(org), _i32(cand))


def ssd_batch(org, cand, device=None):
    """SSD per block -> [N] int64 (enc_kernels.c:119)."""
    org, cand = on_device(device, org, cand)
    d = org.to(torch.int64) - cand.to(torch.int64)
    return (d * d).sum(dim=(1, 2))


def avg_batch(p0, p1, device=None):
    """Bi-prediction average (p0+p1)>>1, no rounding
    (inter_prediction.c:228-248).  Returns int32."""
    p0, p1 = on_device(device, p0, p1)
    return (_i32(p0) + _i32(p1)) >> 1


def scale_down2x2(plane, device=None):
    """Temporal-interp pyramid downscale, SIMD rounding semantics
    (temporal_interp.c:143: column-pair averages, then >>1).  Returns
    int32."""
    (plane,) = on_device(device, plane)
    s = _i32(plane)
    a = s[0::2, 0::2]
    b = s[1::2, 0::2]
    c = s[0::2, 1::2]
    d = s[1::2, 1::2]
    return (((a + b + 1) >> 1) + ((c + d + 1) >> 1)) >> 1


def _avg(a, b):
    return (a + b + 1) >> 1


def _sad(o, p):
    """Per-block SADs, summed in int64 (torch sums int32 into int64)."""
    return (o - p).abs().sum(dim=(1, 2))


@functools.cache
def _offsets(xs, ys, device: str):
    """A candidate list's (x, y) offsets on `device`, uploaded once (an
    upload per call would synchronise the stream)."""
    return torch.tensor([xs, ys], dtype=torch.int32, device=device)


def _pick(cands, xs, ys):
    """(best SAD, its x, its y) over the candidate columns of [N, K]."""
    best = cands.argmin(dim=1)
    t = _offsets(xs, ys, str(cands.device))
    return (cands.gather(1, best[:, None])[:, 0], t[0][best], t[1][best])


def widesad_batch(org, win):
    """SAD at 5 x-offsets (-3,-1,0,1,3) per block (enc_kernels.c:430-453
    pattern x.xXx.x).  org: [N,h,w]; win: [N,h,w+6] with the centre
    candidate at column offset 3.  Returns (best_sad [N], best_x [N]);
    the earlier offset wins a tie, like the reference."""
    o = _i32(org)
    wi = _i32(win)
    w = org.shape[2]
    offs = (-3, -1, 0, 1, 3)
    sads = torch.stack([_sad(o, wi[:, :, 3 + off:3 + off + w])
                        for off in offs], dim=1)
    s, x, _ = _pick(sads, offs, (0,) * 5)
    return s, x


def fasthalf_batch(org, win):
    """8 half-pel SADs via the reference's averaging trees
    (enc/encode_block.c:174-282).  org: [N,h,w]; win: [N,h+4,w+4] with
    the full-pel candidate at win[:, 2:2+h, 2:2+w].  Returns (best_sad,
    best_x, best_y [N]), x/y in {-2,0,2}, in the reference's tie order."""
    o = _i32(org)
    wi = _i32(win)
    _, h, w = org.shape

    def b(dy, dx):
        return wi[:, 2 + dy:2 + dy + h, 2 + dx:2 + dx + w]

    def sad(p):
        return _sad(o, p)

    t2 = _avg(b(0, -1), b(0, 0))
    left = sad(t2)
    t8 = _avg(b(0, 0), b(0, 1))
    right = sad(t8)
    down = sad(_avg(b(0, 0), b(1, 0)))
    top = sad(_avg(b(0, 0), b(-1, 0)))

    # corners via the exact averaging trees (the JAX version's names)
    t1 = (_avg(b(-1, -1), b(-1, 0)) + t2) >> 1
    t4 = _avg(b(-2, 0), b(1, 0))
    t3 = (_avg(b(-2, -1), b(1, -1)) + t4) >> 1
    t6 = _avg(b(0, -2), b(0, 1))
    t5a = (_avg(b(-1, -2), b(-1, 1)) + t6) >> 1
    tl = sad((((t3 + t5a) >> 1) + t1) >> 1)

    t1 = (_avg(b(-1, 0), b(-1, 1)) + t8) >> 1
    t3 = (t4 + _avg(b(-2, 1), b(1, 1))) >> 1
    t7 = _avg(b(0, -1), b(0, 2))
    t5c = (t7 + _avg(b(-1, -1), b(-1, 2))) >> 1
    tr = sad((((t3 + t5c) >> 1) + t1) >> 1)

    t3 = (_avg(b(1, -1), b(1, 0)) + t2) >> 1
    t4c = _avg(b(-1, 0), b(2, 0))
    t5d = (t4c + _avg(b(-1, -1), b(2, -1))) >> 1
    t2c = (t6 + _avg(b(1, -2), b(1, 1))) >> 1
    bl = sad((((t5d + t2c) >> 1) + t3) >> 1)

    t3 = (t8 + _avg(b(1, 0), b(1, 1))) >> 1
    t6b = (t4c + _avg(b(-1, 1), b(2, 1))) >> 1
    t1c = (t7 + _avg(b(1, -1), b(1, 2))) >> 1
    br = sad((((t6b + t1c) >> 1) + t3) >> 1)

    # strict-< scan order top,down,right,left,tl,tr,br,bl
    # (enc/encode_block.c:264-281)
    cands = torch.stack([top, down, right, left, tl, tr, br, bl], 1)
    return _pick(cands, (0, 0, 2, -2, -2, 2, 2, -2),
                 (-2, 2, 0, 0, -2, -2, 2, 2))


def fastquarter_batch(org, win, inx: int, iny: int):
    """8 quarter-pel SADs around a half-pel centre
    (enc/encode_block.c:286-415).  org: [N,h,w]; win: [N,h+2,w+2] with
    the centre full-pel anchor at win[:, 1:1+h, 1:1+w].  inx/iny: nonzero
    if the centre sits at a half-pel phase in x/y.  Returns (best_sad,
    best_x, best_y [N]), x/y in {-1,0,1}."""
    n = org.shape[0]
    return fastquarter_phase(
        org, win, torch.full((n,), bool(inx), device=org.device),
        torch.full((n,), bool(iny), device=org.device))


# fastquarter_batch's predictions as (operand, operand) pairs of the
# signals [a, d, e, f, ad, de, af, fe, dc, ab, ah, gf], for each half-pel
# phase inx * 2 + iny and each position of its scan order
_A, _D, _E, _F, _AD, _DE, _AF, _FE, _DC, _AB, _AH, _GF = range(12)
_QUARTER_ORDER = ((0, -1), (-1, -1), (1, -1), (-1, 0), (1, 0), (-1, 1),
                  (0, 1), (1, 1))
_QUARTER_OPS = (
    ((_AB, _A), (_AH, _AB), (_AD, _AB), (_AH, _A), (_AD, _A), (_AH, _AF),
     (_AF, _A), (_AF, _AD)),                                    # (0, 0)
    ((_AF, _A), (_AH, _AF), (_AD, _AF), (_GF, _A), (_AD, _F), (_AF, _GF),
     (_AF, _F), (_AF, _FE)),                                    # (0, 1)
    ((_DC, _A), (_AD, _AB), (_AD, _DC), (_AD, _A), (_AD, _D), (_AD, _AF),
     (_AF, _D), (_AD, _DE)),                                    # (1, 0)
    ((_DE, _A), (_AD, _AF), (_AD, _DE), (_AD, _F), (_AD, _E), (_AF, _FE),
     (_DE, _F), (_DE, _FE)))                                    # (1, 1)


@functools.cache
def _quarter_ops(device: str):
    return torch.tensor(_QUARTER_OPS, dtype=torch.int64, device=device)


def fastquarter_phase(org, win, inx, iny):
    """fastquarter_batch with the half-pel phase given per block: inx /
    iny [N] bool.  The four phases' predictions share their signals
    (_QUARTER_OPS lists thor_tpu's formulas), and each block gathers its
    own."""
    o = _i32(org)
    n, h, w = org.shape
    wi = _i32(win)

    def r(dy, dx):
        return wi[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    a, d, e, f = r(0, 0), r(0, 1), r(1, 1), r(1, 0)
    sig = torch.stack([a, d, e, f, _avg(a, d), _avg(d, e), _avg(a, f),
                       _avg(f, e), _avg(d, r(-1, 1)), _avg(a, r(-1, 0)),
                       _avg(a, r(0, -1)), _avg(r(1, -1), f)], dim=1)
    phase = inx.to(torch.int64) * 2 + iny.to(torch.int64)
    ops = _quarter_ops(str(org.device))[phase]                 # [N, 8, 2]
    rows = torch.arange(n, device=org.device)[:, None, None]
    pair = sig[rows, ops]                                      # [N,8,2,h,w]
    pred = (pair[:, :, 0] + pair[:, :, 1]) >> 1
    cands = (o[:, None] - pred).abs().sum(dim=(2, 3))
    return _pick(cands, tuple(k[0] for k in _QUARTER_ORDER),
                 tuple(k[1] for k in _QUARTER_ORDER))
