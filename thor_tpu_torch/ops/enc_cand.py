"""Device-side MV candidate derivation, MV prediction and block contexts
(torch port of thor_tpu/ops/enc_cand.py).

Batched (per-lane) twins of spec.inter.get_mv_pred / get_mv_skip /
get_mv_merge (reference common/inter_prediction.c:413-736) and
find_block_contexts (common/common_block.c:283-303), operating on the
deblock-data grid tensors of a decision pass.

All functions take [L] lane position arrays plus the dd grid tensors and
return [L]-shaped results; `size` is a Python integer (one
specialization per block size).  Tensor arguments stay on their device;
numpy arrays go to `device=` (ops/enc_kernels.py:on_device).
"""
from __future__ import annotations

import torch

from .enc_kernels import on_device

MIN_PB_SIZE = 4
I32 = torch.int32


def upright_available(ypos, xpos, size: int, fwidth: int, fheight: int,
                      sb_size: int, device=None):
    """common/common_block.h:60-74 (square blocks)."""
    ypos, xpos = on_device(device, ypos, xpos)
    avail = (ypos > 0) & (xpos + size < fwidth)
    size2 = size
    while size2 < sb_size:
        bad = (((ypos % (size2 << 1)) == size2) &
               ((xpos % size2) == (size2 - size)))
        avail = avail & ~bad
        size2 *= 2
    return avail


def downleft_available(ypos, xpos, size: int, fwidth: int, fheight: int,
                       sb_size: int, device=None):
    """common/common_block.h:76-95 (square blocks)."""
    ypos, xpos = on_device(device, ypos, xpos)
    avail = (xpos > 0) & (ypos + size < fheight)
    bad = ((ypos % sb_size) == (sb_size - size)) & ((xpos % sb_size) == 0)
    avail = avail & ~bad
    size2 = 2 * size
    while size2 <= sb_size:
        bad = ((ypos % size2) == (size2 - size)) & ((xpos % size2) > 0)
        avail = avail & ~bad
        size2 *= 2
    return avail


def mv_pred_batch(ypos, xpos, size: int, fwidth: int, fheight: int,
                  sb_size: int, dd_mv0y, dd_mv0x, device=None):
    """Median MVP (inter_prediction.c:413-526).  Returns (mvpy, mvpx) [L]
    int32."""
    ypos, xpos, dd_mv0y, dd_mv0x = on_device(device, ypos, xpos, dd_mv0y,
                                             dd_mv0x)
    bsz = size // MIN_PB_SIZE
    by = ypos // MIN_PB_SIZE
    bx = xpos // MIN_PB_SIZE

    U = ypos > 0
    UR = upright_available(ypos, xpos, size, fwidth, fheight, sb_size)
    L = xpos > 0
    DL = downleft_available(ypos, xpos, size, fwidth, fheight, sb_size)

    # neighbour cell coords (clamped to grid; masked selections below
    # never use out-of-range values)
    HB, WB = dd_mv0y.shape

    def cell(dy, dx):
        cy = (by + dy).clamp(0, HB - 1).long()
        cx = (bx + dx).clamp(0, WB - 1).long()
        return dd_mv0y[cy, cx], dd_mv0x[cy, cx]

    up0 = cell(-1, 0)
    up1 = cell(-1, (bsz - 1) // 2)
    up2 = cell(-1, bsz - 1)
    left0 = cell(0, -1)
    left1 = cell((bsz - 1) // 2, -1)
    left2 = cell(bsz - 1, -1)
    downleft = cell(bsz, -1)
    upright = cell(-1, bsz)
    upleft = cell(-1, -1)

    zero = (torch.zeros_like(up0[0]), torch.zeros_like(up0[1]))

    # availability-pattern table (inter_prediction.c:437-516), each
    # component built by masked selection over the cases
    cases = [
        ((U & ~UR & ~L & ~DL), (up0, up1, up2)),
        ((U & UR & ~L & ~DL), (up0, up2, upright)),
        ((~U & ~UR & L & ~DL), (left0, left1, left2)),
        ((U & ~UR & L & ~DL), (upleft, up2, left2)),
        ((U & UR & L & ~DL), (up0, upright, left2)),
        ((~U & ~UR & L & DL), (left0, left2, downleft)),
        ((U & ~UR & L & DL), (up2, left0, downleft)),
        ((U & UR & L & DL), (up0, upright, left0)),
    ]
    mva, mvb, mvc = zero, zero, zero
    for cond, (a, b, c) in cases:
        mva = tuple(torch.where(cond, a[i], mva[i]) for i in range(2))
        mvb = tuple(torch.where(cond, b[i], mvb[i]) for i in range(2))
        mvc = tuple(torch.where(cond, c[i], mvc[i]) for i in range(2))

    def median(a, b, c):
        return torch.where(a < b, torch.minimum(b, torch.maximum(a, c)),
                           torch.minimum(a, torch.maximum(b, c)))

    return (median(mva[0], mvb[0], mvc[0]).to(I32),
            median(mva[1], mvb[1], mvc[1]).to(I32))


DD_FIELDS = ("mv0y", "mv0x", "mv1y", "mv1x", "ref0", "ref1", "bip")


def two_candidates_batch(ypos, xpos, size: int, fwidth: int, fheight: int,
                         sb_size: int, dd, device=None):
    """Skip/merge candidate gathering + dedup (inter_prediction.c:565-679).

    dd: dict of grid tensors (mv0y, mv0x, mv1y, mv1x, ref0, ref1, bip).
    Returns cand [L, 2, 7] int32 and count [L] (1 or 2).  Candidate layout
    matches the host tuples: (mv0y, mv0x, mv1y, mv1x, ref0, ref1, bipred).
    """
    ypos, xpos, *grids = on_device(device, ypos, xpos,
                                   *(dd[k] for k in DD_FIELDS))
    bsz = size // MIN_PB_SIZE
    by = ypos // MIN_PB_SIZE
    bx = xpos // MIN_PB_SIZE
    HB, WB = grids[0].shape

    up = ypos > 0
    left = xpos > 0
    ur = upright_available(ypos, xpos, size, fwidth, fheight, sb_size)

    # cell offsets with the frame-edge adjustments (:577-580)
    l2_dy = torch.where(ypos + size > fheight, 0, bsz - 1)
    u2_dx = torch.where(xpos + size > fwidth, 0, bsz - 1)

    def pred_at(cy, cx):
        cy = cy.clamp(0, HB - 1).long()
        cx = cx.clamp(0, WB - 1).long()
        return torch.stack([g[cy, cx].long() for g in grids], dim=-1)

    zero = torch.zeros((ypos.shape[0], len(grids)), dtype=torch.int64,
                       device=ypos.device)
    c_left2 = pred_at(by + l2_dy, bx - 1)
    c_upright = pred_at(by - 1, bx + bsz)
    c_up2 = pred_at(by - 1, bx + u2_dx)

    c0 = torch.where(left[:, None], c_left2, zero)
    c1 = torch.where(ur[:, None], c_upright,
                     torch.where(up[:, None], c_up2, zero))

    # dedup (inter_prediction.c:661-679): c1 is dropped if it equals c0 on
    # the first six fields and (bip equal or c1.bip == -1)
    eq6 = (c0[:, :6] == c1[:, :6]).all(dim=1)
    dup = eq6 & ((c0[:, 6] == c1[:, 6]) | (c1[:, 6] == -1))
    n = torch.where(dup, 1, 2).to(I32)
    return torch.stack([c0, c1], dim=1).to(I32), n


def block_contexts_batch(ypos, xpos, size: int, fwidth: int, fheight: int,
                         enable: int, dd_size, dd_cbp_y, dd_cbp_u, dd_cbp_v,
                         device=None):
    """find_block_contexts (common/common_block.c:283-303).
    Returns (ctx_split, ctx_cbp, ctx_index) [L] int32 (-1 when disabled)."""
    ypos, xpos, dd_size, dd_cbp_y, dd_cbp_u, dd_cbp_v = on_device(
        device, ypos, xpos, dd_size, dd_cbp_y, dd_cbp_u, dd_cbp_v)
    by = ypos // MIN_PB_SIZE
    bx = xpos // MIN_PB_SIZE
    HB, WB = dd_size.shape
    ok = ((ypos >= 8) & (xpos >= 8) & (ypos + size < fheight) &
          (xpos + size < fwidth)) if enable and size <= 128 else \
        torch.zeros_like(ypos, dtype=torch.bool)
    byc = by.clamp(1, HB - 1).long()
    bxc = bx.clamp(1, WB - 1).long()
    s_up = dd_size[byc - 1, bxc]
    s_left = dd_size[byc, bxc - 1]
    cy_up, cy_left = dd_cbp_y[byc - 1, bxc], dd_cbp_y[byc, bxc - 1]
    cu_up, cu_left = dd_cbp_u[byc - 1, bxc], dd_cbp_u[byc, bxc - 1]
    cv_up, cv_left = dd_cbp_v[byc - 1, bxc], dd_cbp_v[byc, bxc - 1]
    split = (s_up < size).to(I32) + (s_left < size)
    cbp1 = (cy_up > 0).to(I32) + (cy_left > 0)
    cbp2 = (((cy_up > 0) | (cu_up > 0) | (cv_up > 0)).to(I32) +
            ((cy_left > 0) | (cu_left > 0) | (cv_left > 0)))
    m1 = torch.full_like(split, -1)
    return (torch.where(ok, split, m1), torch.where(ok, cbp1, m1),
            torch.where(ok, 3 * split + cbp2, m1))
