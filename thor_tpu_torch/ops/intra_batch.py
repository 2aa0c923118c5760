"""Batched intra prediction, all 10 modes (torch port of
thor_tpu/ops/intra_batch.py; reference common/intra_prediction.c).

Floor and truncating divisions stay exactly where the JAX version has
them: torch's `//` floors like JAX's, and `_cdiv8` truncates toward zero.
"""
from __future__ import annotations

import torch

MODE_DC, MODE_PLANAR, MODE_HOR, MODE_VER = 0, 1, 2, 3
MODE_UPLEFT, MODE_UPRIGHT, MODE_UPUPRIGHT, MODE_UPUPLEFT = 4, 5, 6, 7
MODE_UPLEFTLEFT, MODE_DOWNLEFTLEFT = 8, 9


def _cdiv8(v):
    return torch.sign(v) * (v.abs() // 8)


def filter_121(a):
    """(1,2,1)/4 smoothing with edge replication along the last axis."""
    prev = torch.cat([a[..., :1], a[..., :-1]], dim=-1)
    nxt = torch.cat([a[..., 1:], a[..., -1:]], dim=-1)
    return (prev + 2 * a + nxt + 2) >> 2


def select_mode(preds, mode):
    """preds[mode[i], i, ...]: preds [M, L, ...], mode [L]; a mode
    outside [0, M) selects mode 0, as the JAX select chain does."""
    mode = mode.long()
    idx = torch.where((mode >= 0) & (mode < preds.shape[0]), mode, 0)
    return preds[idx, torch.arange(preds.shape[1], device=preds.device)]


def _slice_start(start, size: int, dim: int):
    """dynamic_slice's start clamp: the window always lies inside."""
    return start.clamp(0, dim - size)


def make_refs_batch(plane, cb_y, cb_x, size: int, ur, dl, bitdepth: int):
    """Reference samples for whole-CB intra (intra_prediction.c:57-116).

    plane: [>=H+size+1, >=W+size+1] int32 (visible frame at origin).
    cb_y/cb_x: [L]; ur/dl: [L] bool availability.
    Returns (left [L,2*size], top [L,2*size], top_left [L]) int32."""
    n = size
    half = 128 << (bitdepth - 8)
    Hp, Wp = plane.shape
    dev = plane.device
    cb_y = cb_y.long()
    cb_x = cb_x.long()
    k = torch.arange(n + 1, device=dev)
    y0 = (cb_y - 1).clamp(min=0)
    x0 = (cb_x - 1).clamp(min=0)
    ty = _slice_start(y0, 1, Hp)
    tx = _slice_start(cb_x, n + 1, Wp)
    trow = plane[ty[:, None], tx[:, None] + k]                   # [L, n+1]
    ly = _slice_start(cb_y, n + 1, Hp)
    lx = _slice_start(x0, 1, Wp)
    lcol = plane[ly[:, None] + k, lx[:, None]]                   # [L, n+1]
    tl_px = plane[y0.clamp(max=Hp - 1), x0.clamp(max=Wp - 1)]

    def _clamp_ext(row, avail):
        rep = torch.where(avail[:, None], row[:, n:n + 1], row[:, n - 1:n])
        return torch.cat([row[:, :n], rep.expand(-1, n)], dim=1)

    top = _clamp_ext(trow, ur)
    left = _clamp_ext(lcol, dl)
    top = torch.where((cb_y == 0)[:, None], half, top)
    left = torch.where((cb_x == 0)[:, None], half, left)
    top_left = torch.where(cb_y == 0, left[:, 0],
                           torch.where(cb_x > 0, tl_px, top[:, 0]))
    return (left.to(torch.int32), top.to(torch.int32),
            top_left.to(torch.int32))


def _planar_filt(v, n):
    """5-tap (1,2,2,2,1) with the reference's edge handling
    (intra_prediction.c:229-247); v: [L, >=n]."""
    i = torch.arange(n, device=v.device)
    km2 = (i - 2).clamp(0, n - 1)
    km1 = (i - 1).clamp(0, n - 1)
    kp1 = (i + 1).clamp(0, n - 1)
    kp2 = (i + 2).clamp(0, n - 1)
    out = (v[:, km2] + 2 * v[:, km1] + 2 * v[:, i] + 2 * v[:, kp1] +
           v[:, kp2])
    out[:, 0] = v[:, 0] + 2 * v[:, 0] + 2 * v[:, 0] + 2 * v[:, 1] + v[:, 2]
    out[:, 1] = v[:, 0] + 2 * v[:, 0] + 2 * v[:, 1] + 2 * v[:, 2] + v[:, 3]
    out[:, n - 2] = (v[:, n - 4] + 2 * v[:, n - 3] + 2 * v[:, n - 2] +
                     2 * v[:, n - 1] + v[:, n - 1])
    out[:, n - 1] = (v[:, n - 3] + 2 * v[:, n - 2] + 2 * v[:, n - 1] +
                     2 * v[:, n - 1] + v[:, n - 1])
    return out


def predict_all_modes(left, top, top_left, ypos, xpos, size: int,
                      bitdepth: int, num_modes: int = 10):
    """All intra mode predictions (intra_prediction.c:185-428).

    left/top: [L, 2*size]; top_left/ypos/xpos: [L].
    Returns [num_modes, L, size, size] int32 indexed by mode id."""
    n = size
    Lb = left.shape[0]
    dev = left.device
    ii = torch.arange(n, device=dev)[:, None]
    jj = torch.arange(n, device=dev)[None, :]
    maxval = (1 << bitdepth) - 1

    def clip(x, hi):
        return x.clamp(0, hi)

    out = []

    # DC (predictor rule: left unless xpos==0, top unless ypos==0)
    l_ = torch.where((xpos != 0)[:, None], left[:, :n], top[:, :n])
    t_ = torch.where((ypos != 0)[:, None], top[:, :n], left[:, :n])
    dc = (t_.sum(dim=1) + l_.sum(dim=1) + n) // (2 * n)
    out.append(dc[:, None, None].expand(Lb, n, n))

    # PLANAR
    tF = _planar_filt(top, n)
    lF = _planar_filt(left, n)
    tlF = (left[:, 1] + 2 * left[:, 0] + 2 * top_left + 2 * top[:, 0] +
           top[:, 1])
    val = lF[:, :, None] + tF[:, None, :] - tlF[:, None, None] + 4
    out.append(_cdiv8(val).clamp(0, maxval))

    # HOR / VER
    out.append(left[:, :n, None].expand(Lb, n, n))
    out.append(top[:, None, :n].expand(Lb, n, n))

    if num_modes > 4:
        lF1 = filter_121(left[:, :n])
        tF1 = filter_121(top[:, :n])
        tl1 = (2 * top_left + left[:, 0] + top[:, 0] + 2) >> 2
        lF2 = filter_121(left)          # 2n
        tF2 = filter_121(top)
        tl1b = tl1[:, None, None]

        # UPLEFT
        diag = ii - jj
        g_l = lF1[:, clip(diag - 1, n - 1)]
        g_t = tF1[:, clip(-diag - 1, n - 1)]
        out.append(torch.where(diag > 0, g_l,
                               torch.where(diag == 0, tl1b, g_t)))

        # UPRIGHT
        out.append(tF2[:, ii + jj + 1])

        # UPUPRIGHT
        diag = ii + 2 * jj
        odd = (diag & 1) == 1
        a = tF2[:, clip((diag + 1) // 2, 2 * n - 1)]
        b = (tF2[:, clip(diag // 2, 2 * n - 1)] +
             tF2[:, clip(diag // 2 + 1, 2 * n - 1)]) >> 1
        out.append(torch.where(odd, a, b))

        # UPUPLEFT
        diag = ii - 2 * jj
        nd = -diag
        t_odd = tF1[:, clip(nd // 2, n - 1)]
        t_even = (tF1[:, clip(nd // 2, n - 1)] +
                  tF1[:, clip(nd // 2 - 1, n - 1)]) >> 1
        neg = torch.where((diag & 1) == 1, t_odd, t_even)
        out.append(torch.where(
            diag > 1, lF1[:, clip(diag - 2, n - 1)],
            torch.where(diag == 1, tl1b,
                        torch.where(diag == 0,
                                    (tl1b + tF1[:, 0:1, None]) >> 1, neg))))

        # UPLEFTLEFT
        diag = 2 * ii - jj
        l_odd = lF1[:, clip(diag // 2, n - 1)]
        l_even = (lF1[:, clip(diag // 2, n - 1)] +
                  lF1[:, clip(diag // 2 - 1, n - 1)]) >> 1
        pos = torch.where((diag & 1) == 1, l_odd, l_even)
        out.append(torch.where(
            diag < -1, tF1[:, clip(-diag - 2, n - 1)],
            torch.where(diag == -1, tl1b,
                        torch.where(diag == 0,
                                    (tl1b + lF1[:, 0:1, None]) >> 1, pos))))

        # DOWNLEFTLEFT
        diag = 2 * ii + jj
        odd = (diag & 1) == 1
        a = lF2[:, clip((diag + 1) // 2, 2 * n - 1)]
        b = (lF2[:, clip(diag // 2, 2 * n - 1)] +
             lF2[:, clip(diag // 2 + 1, 2 * n - 1)]) >> 1
        out.append(torch.where(odd, a, b))

    return torch.stack([o.to(torch.int32) for o in out])
