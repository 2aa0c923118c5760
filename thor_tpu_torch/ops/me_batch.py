"""The two motion helpers of thor_tpu/ops/me_batch.py that the turbo
encoder runs: `clip_mv_batch` (:37) and `quote_mv_bits_batch` (:55), as
torch.  The lockstep motion search of that module is not ported (the
turbo encoder has its own search, enc/turbo.py)."""
from __future__ import annotations

import torch

MAX_MV_EXT = 144


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
