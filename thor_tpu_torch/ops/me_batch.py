"""Batched lockstep motion estimation (torch port of
thor_tpu/ops/me_batch.py).

Replicates the reference's per-PU search trajectory
(enc/encode_block.c:517-913) for a whole batch of independent blocks at
once, decision for decision: every stage evaluates its candidates for
all blocks in lockstep, with per-block masks carrying each block's own
control flow (candidate counts, hexagon direction windows, early
termination).  `motion_estimate_batch` (the candidate list, hexagon
full-pel refinement and the fast bilinear or, with speed0, the exact
sub-pel search), `motion_estimate_bi_batch` and
`motion_estimate_sync_batch` equal enc/me.py's `motion_estimate`,
`motion_estimate_bi` and `motion_estimate_sync` per block.  The turbo
encoder runs `clip_mv_batch` and `quote_mv_bits_batch`.

JAX's static arguments are Python integers and booleans here, and its
unrolled loops are Python loops that run eagerly.  The exact sub-pel
evaluations go through ops/mc.py:mc_luma_tiles, as in thor_tpu: one
launch of the luma MC kernel per call on a CUDA tensor, its plain
version on a CPU tensor.  Window origins follow lax.dynamic_slice, wrap
then clamp (`_dstart`), in `_gather` and before every mc_luma_tiles call
(whose kernel clamps each sample, where JAX clamps the whole window on
the variant stack, 5 samples smaller in each dimension): with the
encoder's 160-sample pad every window lies inside and the rule changes
nothing.  The searches take tensors, which stay on their device, or
numpy arrays, which go to `device=` (ops/enc_kernels.py:on_device).
"""
from __future__ import annotations

import functools

import torch

from .enc_kernels import (fasthalf_batch, fastquarter_batch, on_device,
                          sad_batch, widesad_batch)
from .mc import mc_luma_tiles

MAX_MV_EXT = 144
MAX_UINT32 = (1 << 32) - 1
I32, I64, F64 = torch.int32, torch.int64, torch.float64


def _trunc4(v):
    """C truncation toward zero of v/4 (vectorized)."""
    return torch.where(v >= 0, v >> 2, -((-v) >> 2))


def clip_mv_batch(mvy, mvx, ypos, xpos, fwidth, fheight, bwidth, bheight,
                  sign):
    """inter_prediction.c:51-63 over tensors."""
    if sign:
        mvy, mvx = -mvy, -mvx
    mvy = torch.where(ypos + _trunc4(mvy) < -MAX_MV_EXT,
                      4 * (-MAX_MV_EXT - ypos), mvy)
    mvy = torch.where(ypos + _trunc4(mvy) + bheight > fheight + MAX_MV_EXT,
                      4 * (fheight + MAX_MV_EXT - ypos - bheight), mvy)
    mvx = torch.where(xpos + _trunc4(mvx) < -MAX_MV_EXT,
                      4 * (-MAX_MV_EXT - xpos), mvx)
    mvx = torch.where(xpos + _trunc4(mvx) + bwidth > fwidth + MAX_MV_EXT,
                      4 * (fwidth + MAX_MV_EXT - xpos - bwidth), mvx)
    if sign:
        mvy, mvx = -mvy, -mvx
    return mvy, mvx


def quote_mv_bits_batch(dy, dx):
    """enc/encode_block.c:467-515 over tensors."""
    def ln(mvabs):
        return torch.where(
            mvabs < 1, 2,
            torch.where(mvabs < 2, 4,
                        torch.where(mvabs < 4, 5,
                                    torch.where(mvabs < 36,
                                                6 + ((mvabs - 4) >> 3),
                                                11 + ((mvabs - 36) >> 4)))))
    return ln(dx.abs()) + ln(dy.abs())


def _mv_cost(lam, dy, dx):
    """int(lam * quote_mv_bits + 0.5) with C float->int truncation, in
    float64 (lam: [N] float64)."""
    bits = quote_mv_bits_batch(dy, dx)
    return torch.floor(lam * bits.to(F64) + 0.5).to(I64)


def _dstart(start, size: int, dim: int):
    """lax.dynamic_slice's start index for a window of `size` along an
    axis of `dim`: a negative start counts from the end once, then the
    start is clamped so that the window lies inside (enc/device_lc.py
    cuts its windows with it too)."""
    start = start.to(I64)
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def _gather(ref, y0, x0, h: int, w: int):
    """[N,h,w] windows at per-block (y0,x0) from the padded plane."""
    hp, wp = ref.shape
    yy = _dstart(y0, h, hp)[:, None] + _arange(h, ref.device)
    xx = _dstart(x0, w, wp)[:, None] + _arange(w, ref.device)
    return ref[yy[:, :, None], xx[:, None, :]]


@functools.cache
def _arange(n: int, device):
    return torch.arange(n, device=device)


@functools.cache
def _hexagon(device):
    """(diy, dix) of the hexagon's six directions."""
    return (torch.tensor([1, 2, 1, -1, -2, -1], dtype=I32, device=device),
            torch.tensor([-1, 0, 1, 1, 0, -1], dtype=I32, device=device))


def _mc_ref(ref):
    """The reference plane as mc_luma_tiles takes it without a copy per
    call: int16 and contiguous on the card."""
    return ref.to(torch.int16).contiguous() if ref.is_cuda else ref


def _mc_tiles(ref, oy, ox, fv, fh, tile: int, bipred: int, bitdepth: int):
    """mc_luma_tiles at JAX's window origins: thor_tpu/ops/mc.py slices
    the [16, Hp-5, Wp-5] variant stack with dynamic_slice's start rule."""
    hp, wp = ref.shape
    return mc_luma_tiles(ref, _dstart(oy, tile, hp - 5).to(I32),
                         _dstart(ox, tile, wp - 5).to(I32), fv, fh,
                         tile=tile, bipred=bipred, bitdepth=bitdepth)


def _inputs(device, org, refs, ints, lam):
    """A search's arrays on one device: (org as int32, the reference
    planes as given, the positions and MVs as int32, the lambdas as
    float64)."""
    org, lam, *rest = on_device(device, org, lam, *refs, *ints)
    return (org.to(I32), rest[:len(refs)],
            [x.to(I32) for x in rest[len(refs):]], lam.to(F64))


def _take(better, sad, cy, cx, min_sad, opt_y, opt_x):
    return (torch.where(better, sad, min_sad), torch.where(better, cy, opt_y),
            torch.where(better, cx, opt_x))


def motion_estimate_batch(org, ref_full, pad, ypos, xpos, mvp_y, mvp_x,
                          lam, cand_y, cand_x, cand_n, width: int,
                          height: int, size: int, sign: int, fwidth: int,
                          fheight: int, bitdepth: int = 8,
                          maxcand: int = 4, telescope: bool = False,
                          widesad32: bool = False, mvc_y: int = 0,
                          mvc_x: int = 0, speed0: bool = False,
                          bipred: int = 0, device=None):
    """Lockstep ME for N same-sized PUs (thor_tpu/ops/me_batch.py:85).

    org: [N,h,w] original blocks; ref_full: padded reference plane;
    ypos/xpos: [N] parent block positions; mvp_*: [N] MV predictors
    (quarter-pel); lam: [N] lambdas; cand_*: [N,maxcand] full-pel
    candidates with per-block counts cand_n.  telescope enables the
    +-64 coarse-to-fine grid stage (mvc_* its common centre, widesad32
    the size-16 fast row scan at step 32); speed0 the exact sub-pel
    search (16 mc_luma_tiles calls) in place of the fast bilinear one.
    Returns (sad [N] int64, mv_y [N], mv_x [N] int32), equal to
    enc/me.py:motion_estimate per block."""
    org, (ref_full,), ints, lam = _inputs(
        device, org, (ref_full,),
        (ypos, xpos, mvp_y, mvp_x, cand_y, cand_x, cand_n), lam)
    ypos, xpos, mvp_y, mvp_x, cand_y, cand_x, cand_n = ints
    dev = org.device
    n = org.shape[0]
    s = -1 if sign else 1
    shift = bitdepth - 8
    y0 = pad + ypos            # per-block reference anchors
    x0 = pad + xpos

    min_sad = torch.full((n,), MAX_UINT32, dtype=I64, device=dev)
    opt_y = torch.zeros((n,), dtype=I32, device=dev)
    opt_x = torch.zeros((n,), dtype=I32, device=dev)

    def plain_sad(cy, cx):
        win = _gather(ref_full, y0 + s * (cy >> 2), x0 + s * (cx >> 2),
                      height, width)
        return sad_batch(org, win)

    def wide_sad(cy, cx):
        win = _gather(ref_full, y0 + s * (cy >> 2), x0 + s * (cx >> 2) - 3,
                      height, width + 6)
        sad, xoff = widesad_batch(org, win)
        return sad, cx + ((s * xoff) << 2)

    # ---- telescope stage (enc/encode_block.c:541-573) ----
    if telescope:
        ref_y = torch.full((n,), ((mvc_y + 2) >> 2) << 2, dtype=I32,
                           device=dev)
        ref_x = torch.full((n,), ((mvc_x + 2) >> 2) << 2, dtype=I32,
                           device=dev)
        step = 32
        while step >= 4:
            rng_ = 2 * step
            for k in range(-rng_, rng_ + 1, step):
                for l in range(-rng_, rng_ + 1, step):
                    if step < 32 and k == 0 and l == 0:
                        continue
                    cy, cx = clip_mv_batch(ref_y + k, ref_x + l, ypos,
                                           xpos, fwidth, fheight, size,
                                           size, sign)
                    if step == 32 and size == 16 and widesad32:
                        sad, cx = wide_sad(cy, cx)
                    else:
                        sad = plain_sad(cy, cx)
                    sad = (sad >> shift) + _mv_cost(lam, cy - mvp_y,
                                                    cx - mvp_x)
                    min_sad, opt_y, opt_x = _take(
                        sad < min_sad, sad, cy, cx, min_sad, opt_y, opt_x)
            ref_y, ref_x = opt_y, opt_x
            step >>= 1

    # ---- candidate stage (enc/encode_block.c:575-605) ----
    for idx in range(maxcand):
        live = idx < cand_n
        cy, cx = clip_mv_batch(cand_y[:, idx] << 2, cand_x[:, idx] << 2,
                               ypos, xpos, fwidth, fheight, size, size,
                               sign)
        if size == 16:
            sad, cx = wide_sad(cy, cx)
        else:
            sad = plain_sad(cy, cx)
        sad = (sad >> shift) + _mv_cost(lam, cy - mvp_y, cx - mvp_x)
        min_sad, opt_y, opt_x = _take(live & (sad < min_sad), sad, cy, cx,
                                      min_sad, opt_y, opt_x)

    ref_y, ref_x = opt_y, opt_x

    # ---- hexagon full-pel refinement (enc/encode_block.c:607-641) ----
    diy, dix = _hexagon(dev)
    maxsteps = 6 if (size <= 16 or speed0) else 1
    start = torch.zeros((n,), dtype=I32, device=dev)
    end = torch.full((n,), 5, dtype=I32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    for _step in range(1, maxsteps):
        best_dir = torch.full((n,), -1, dtype=I32, device=dev)
        # visit order: start, start+1, ... until end (mod 6), as
        # position-in-sequence masks over the six rotations
        length = ((end - start) % 6) + 1
        for pos in range(6):
            direc = (start + pos) % 6
            live = active & (pos < length)
            cy = ref_y + dix[direc] * 4   # NB: C indexes dix with the
            cx = ref_x + diy[direc] * 4   # y-delta and diy with x (quirk)
            cy, cx = clip_mv_batch(cy, cx, ypos, xpos, fwidth, fheight,
                                   size, size, sign)
            sad = (plain_sad(cy, cx) >> shift) + \
                _mv_cost(lam, cy - mvp_y, cx - mvp_x)
            better = live & (sad < min_sad)
            min_sad, opt_y, opt_x = _take(better, sad, cy, cx, min_sad,
                                          opt_y, opt_x)
            best_dir = torch.where(better, direc, best_dir)
        ref_y, ref_x = opt_y, opt_x
        start = torch.where(best_dir != 0, best_dir - 1, 5)
        end = torch.where(start + 2 >= 6, start + 2 - 6, start + 2)
        active = active & (best_dir >= 0)

    if speed0:
        # ---- exact sub-pel (enc/encode_block.c:643-652): 8 half-pel
        # then 8 quarter-pel MC evaluations around the full-pel optimum,
        # integer clamps at the block origin ----
        ref_mc = _mc_ref(ref_full)

        def mc_sad_at(cy, cx):
            oy, ox, fvv, fhh = _mc_params_batch(
                cy, cx, ypos, xpos, height, width, fwidth, fheight, sign)
            pred = _mc_tiles(ref_mc, pad + oy - 2, pad + ox - 2, fvv, fhh,
                             width, bipred, bitdepth)
            return sad_batch(org, pred) >> shift

        cmin = min_sad
        hm = [0, 0, -2, 2, 0, -2, -2, 2, 2]
        hn = [0, -2, 0, 0, 2, -2, 2, -2, 2]
        qm = [0, 0, -1, 1, 0, -1, -1, 1, 1]
        qn = [0, -1, 0, 0, 1, -1, 1, -1, 1]
        centre_y, centre_x = ref_y, ref_x
        for dm, dn in ((hm, hn), (qm, qn)):
            ydelta = torch.zeros((n,), dtype=I32, device=dev)
            xdelta = torch.zeros((n,), dtype=I32, device=dev)
            for i in range(1, 9):
                cy = centre_y + dm[i]
                cx = centre_x + dn[i]
                sad = mc_sad_at(cy, cx) + _mv_cost(lam, cy - mvp_y,
                                                   cx - mvp_x)
                better = sad < cmin
                cmin = torch.where(better, sad, cmin)
                ydelta = torch.where(better, dm[i], ydelta)
                xdelta = torch.where(better, dn[i], xdelta)
            opt_y = opt_y + ydelta
            opt_x = opt_x + xdelta
            centre_y, centre_x = opt_y, opt_x
        return torch.minimum(cmin, min_sad), opt_y, opt_x

    # ---- fast bilinear sub-pel (enc/encode_block.c:653-700) ----
    cmin = min_sad
    mr_y = ref_y * s
    mr_x = ref_x * s
    hwin = _gather(ref_full, y0 + (mr_y >> 2) - 2, x0 + (mr_x >> 2) - 2,
                   height + 4, width + 4)
    hsad, spx, spy = fasthalf_batch(org, hwin)
    hsad = (hsad >> shift) + \
        _mv_cost(lam, mr_y + s * spy - mvp_y, mr_x + s * spx - mvp_x)
    better = hsad < cmin
    cmin = torch.where(better, hsad, cmin)
    ydelta_hp = torch.where(better, s * spy, 0)
    xdelta_hp = torch.where(better, s * spx, 0)

    spx, spy = xdelta_hp, ydelta_hp
    mr_y = opt_y + s * spy
    mr_x = opt_x + s * spx
    opt_y = opt_y + ydelta_hp
    opt_x = opt_x + xdelta_hp

    # NB: C applies the sign AFTER the shift here (s*(mr>>2)), unlike the
    # half-pel centre where it multiplies the value first
    qwin = _gather(ref_full, y0 + s * (mr_y >> 2) - 1,
                   x0 + s * (mr_x >> 2) - 1, height + 2, width + 2)
    # the quarter search is specialised on the half-pel phase flags; all
    # four (inx,iny) variants are evaluated and selected per block
    ydelta_qp = torch.zeros((n,), dtype=I32, device=dev)
    xdelta_qp = torch.zeros((n,), dtype=I32, device=dev)
    for inx in (0, 1):
        for iny in (0, 1):
            qsad, qx2, qy2 = fastquarter_batch(org, qwin, inx, iny)
            qsad = (qsad >> shift) + \
                _mv_cost(lam, mr_y + s * qy2 - mvp_y, mr_x + s * qx2 - mvp_x)
            phase = ((spx != 0) == bool(inx)) & ((spy != 0) == bool(iny))
            better = phase & (qsad < cmin)
            cmin = torch.where(better, qsad, cmin)
            ydelta_qp = torch.where(better, s * qy2, ydelta_qp)
            xdelta_qp = torch.where(better, s * qx2, xdelta_qp)

    opt_y = opt_y + ydelta_qp
    opt_x = opt_x + xdelta_qp
    return torch.minimum(cmin, min_sad), opt_y, opt_x


def _mc_params_batch(my, mx, ypos, xpos, bh, bw, fwidth, fheight, sign):
    """Vectorized mc_luma offset/frac derivation incl. the reference's
    integer clamps and its -xpos-bheight quirk (inter_prediction.c:117-181,
    whole-block path: clamp origin == block origin)."""
    if sign:
        my, mx = -my, -mx
    fv = my & 3
    fh = mx & 3
    vi = my >> 2
    hi = mx >> 2
    vi = torch.minimum(vi, fheight - ypos)
    vi = torch.maximum(vi, -xpos - bh)   # (sic) the C quirk uses xpos here
    hi = torch.minimum(hi, fwidth - xpos)
    hi = torch.maximum(hi, -xpos - bw)
    return ypos + vi, xpos + hi, fv, fh


def _parity_live(ref_y, ref_x, k: int, l: int, step: int):
    """The telescope's step-1 quarter-pel parity pattern
    (encode_block.c:836-848): full-pel centres probe diagonals, half-pel
    centres the cross, the (2,2) centre nothing; None at other steps
    (every candidate live)."""
    if step != 1:
        return None
    vf = ref_y & 3
    hf = ref_x & 3
    centre00 = (vf == 0) & (hf == 0)
    centre22 = (vf == 2) & (hf == 2)
    if abs(k) != abs(l):
        return ~(centre00 | centre22)
    return centre00


def _telescope(n, dev, mvc_y, mvc_x, eval_at):
    """The mv1 = -mv0 / sync telescope, step 32 down to 1 (the cross and
    diagonals of each step, the centre only at step 32); eval_at(cy, cx)
    gives (cost, mv_y, mv_x).  Returns (min_sad, opt_y, opt_x)."""
    min_sad = torch.full((n,), MAX_UINT32, dtype=I64, device=dev)
    opt_y = torch.zeros((n,), dtype=I32, device=dev)
    opt_x = torch.zeros((n,), dtype=I32, device=dev)
    ref_y = torch.full((n,), ((mvc_y + 2) >> 2) << 2, dtype=I32, device=dev)
    ref_x = torch.full((n,), ((mvc_x + 2) >> 2) << 2, dtype=I32, device=dev)
    step = 32
    while step > 0:
        for k in range(-step, step + 1, step):
            for l in range(-step, step + 1, step):
                if step < 32 and k == 0 and l == 0:
                    continue
                live = _parity_live(ref_y, ref_x, k, l, step)
                sad, my, mx = eval_at(ref_y + k, ref_x + l)
                better = sad < min_sad
                if live is not None:
                    better = live & better
                min_sad, opt_y, opt_x = _take(better, sad, my, mx, min_sad,
                                              opt_y, opt_x)
        ref_y, ref_x = opt_y, opt_x
        step >>= 1
    return min_sad, opt_y, opt_x


def motion_estimate_bi_batch(org, ref0_full, ref1_full, pad, ypos, xpos,
                             mvp_y, mvp_x, lam, cand_y, cand_x, cand_n,
                             width: int, height: int, size: int, sign: int,
                             fwidth: int, fheight: int, bitdepth: int = 8,
                             bipred: int = 1, mvc_y: int = 0,
                             mvc_x: int = 0, device=None):
    """Lockstep simultaneous bi-prediction ME (thor_tpu/ops/me_batch.py:
    321; enc/encode_block.c:798-913): mv1 = -mv0 telescope (step 32..1
    with the quarter-pel parity pattern at step 1) + the 6 persistent
    candidate slots.  Every candidate is evaluated with the exact
    quarter-pel MC on both references (two mc_luma_tiles calls).

    cand_*: [N,4] slots with per-block counts cand_n; slots [n..3] are
    zero-filled and [4]=mvp, [5]=0 exactly as the reference mutates its
    persistent array (the caller owns writing those back).  Returns
    (sad [N], mv_y [N], mv_x [N]) equal to enc/me.py:motion_estimate_bi.
    """
    org, refs, ints, lam = _inputs(
        device, org, (ref0_full, ref1_full),
        (ypos, xpos, mvp_y, mvp_x, cand_y, cand_x, cand_n), lam)
    ypos, xpos, mvp_y, mvp_x, cand_y, cand_x, cand_n = ints
    dev = org.device
    n = org.shape[0]
    shift = bitdepth - 8
    ref0, ref1 = (_mc_ref(r) for r in refs)

    def bi_cost(cy, cx):
        m0y, m0x = clip_mv_batch(cy, cx, ypos, xpos, fwidth, fheight,
                                 size, size, sign)
        oy0, ox0, fv0, fh0 = _mc_params_batch(
            m0y, m0x, ypos, xpos, height, width, fwidth, fheight, sign)
        p0 = _mc_tiles(ref0, pad + oy0 - 2, pad + ox0 - 2, fv0, fh0,
                       width, bipred, bitdepth)
        # the C clips in place: the second clip sees the first's output
        m1y, m1x = clip_mv_batch(m0y, m0x, ypos, xpos, fwidth, fheight,
                                 size, size, 1 - sign)
        oy1, ox1, fv1, fh1 = _mc_params_batch(
            m1y, m1x, ypos, xpos, height, width, fwidth, fheight, 1 - sign)
        p1 = _mc_tiles(ref1, pad + oy1 - 2, pad + ox1 - 2, fv1, fh1,
                       width, bipred, bitdepth)
        sad = sad_batch(org, (p0 + p1) >> 1) >> shift
        return sad + _mv_cost(lam, m1y - mvp_y, m1x - mvp_x), m1y, m1x

    min_sad, opt_y, opt_x = _telescope(n, dev, mvc_y, mvc_x, bi_cost)

    # persistent slots: zero-fill [num..3], [4]=mvp, [5]=0
    zero = torch.zeros((n,), dtype=I32, device=dev)
    for idx in range(6):
        if idx < 4:
            cy = torch.where(idx < cand_n, cand_y[:, idx], 0)
            cx = torch.where(idx < cand_n, cand_x[:, idx], 0)
        elif idx == 4:
            cy, cx = mvp_y, mvp_x
        else:
            cy, cx = zero, zero
        sad, my, mx = bi_cost(cy, cx)
        min_sad, opt_y, opt_x = _take(sad < min_sad, sad, my, mx, min_sad,
                                      opt_y, opt_x)
    return min_sad, opt_y, opt_x


def motion_estimate_sync_batch(org, ref_full, pad, ypos, xpos, boy, box,
                               mvp_y, mvp_x, lam, cand_y, cand_x,
                               width: int, height: int, size: int,
                               sign: int, fwidth: int, fheight: int,
                               bitdepth: int = 8, bipred: int = 0,
                               mvc_y: int = 0, mvc_x: int = 0, device=None):
    """Lockstep wavefront-safe ME (thor_tpu/ops/me_batch.py:420;
    enc/encode_block.c:713-796): the telescope runs to quarter-pel
    resolution with exact MC, then the 6 persistent candidate slots.
    boy/box: [N] sub-PU offsets from the parent block (the MC integer
    clamps use the parent origin - inter_prediction.c:214 quirk).
    cand_*: [N,6] with slot [4]=mvp and [5]=0 prefilled by the caller (as
    the C mutates in place; slots [n..3] hold stale persistent values).
    Equals enc/me.py:motion_estimate_sync per block."""
    org, (ref_full,), ints, lam = _inputs(
        device, org, (ref_full,),
        (ypos, xpos, boy, box, mvp_y, mvp_x, cand_y, cand_x), lam)
    ypos, xpos, boy, box, mvp_y, mvp_x, cand_y, cand_x = ints
    dev = org.device
    n = org.shape[0]
    shift = bitdepth - 8
    ref_mc = _mc_ref(ref_full)

    def mc_cost(cy, cx):
        my, mx = clip_mv_batch(cy, cx, ypos, xpos, fwidth, fheight,
                               size, size, sign)
        oy, ox, fv, fh = _mc_params_batch(
            my, mx, ypos, xpos, height, width, fwidth, fheight, sign)
        # window base at the sub-PU, integer offsets clamped at the parent
        pred = _mc_tiles(ref_mc, pad + (oy - ypos) + ypos + boy - 2,
                         pad + (ox - xpos) + xpos + box - 2, fv, fh, width,
                         bipred, bitdepth)
        sad = sad_batch(org, pred) >> shift
        return sad + _mv_cost(lam, my - mvp_y, mx - mvp_x), my, mx

    min_sad, opt_y, opt_x = _telescope(n, dev, mvc_y, mvc_x, mc_cost)
    for idx in range(6):
        sad, my, mx = mc_cost(cand_y[:, idx], cand_x[:, idx])
        min_sad, opt_y, opt_x = _take(sad < min_sad, sad, my, mx, min_sad,
                                      opt_y, opt_x)
    return min_sad, opt_y, opt_x
