"""Turbo (throughput) encoder mode: batched decisions, exact emission
(torch port of thor_tpu/enc/turbo.py).

All heavy numerics of the decision pass (motion search, trial
transform/quantize/bit-count, intra mode search) run batched over the
whole frame with no sequential feedback, using approximate neighbour
context; the final encode then replays the chosen decisions through the
bit-exact machinery (enc/turbo_final.py), deriving every normative
element - skip/merge candidate lists, MVP, contexts - from true coded
state.  Decision for decision the same as thor_tpu's turbo encoder, so
its streams are byte-identical with thor_tpu's.

Exactness rules the port keeps (the JAX version's arithmetic):
- SAD/SSD sums are int64: thor_tpu runs JAX with 64-bit types on
  (thor_tpu/__init__.py), where jnp.sum of int32 values promotes to
  int64 as numpy's does, so a 10-bit 128x128 SSD past 2^31 does not
  wrap (`_sum`);
- costs are float32 with `lam` a float32 0-d tensor, rounded where the
  reference's compiled costs round: XLA:CPU contracts each multiply-add
  of a cost into a fused multiply-add (one rounding), which `_fma32`
  reproduces exactly (`_cost`);
- argmin and the strict `<` updates keep the first minimum;
- gathers take indices as JAX does (`_jidx`: a negative index wraps once,
  then every index is clamped).

Scope: as thor_tpu's (`turbo_reject_reason`); a frame outside it takes
the exact host encoder (`turbo_supported`, enc/encoder.py).
`decide_frame(pull=False)` and `PendingDecision` (the GOP lanes' deferred
pull) are not ported (ROADMAP.md item 12), nor is the host finaliser of
`encode_frame_turbo` that thor_tpu's THOR_TURBO_FINAL=0 selects: the port
takes no environment switch, and its finalizer emits through the C
plan/emit passes or their Python walk (turbo_final.NATIVE).
"""
from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from ..tables import COEFFS_STANDARD, GDEQUANT, LOWPASS_K, ZIGZAG, log2i
from ..ops.transform import fwd_transform_batch, inv_transform_batch, _i16
from ..ops.quant import quantize_batch
from ..ops.coeff_cost import coeff_bits_batch
from ..ops import intra_batch as IB
from ..ops.me_batch import clip_mv_batch, quote_mv_bits_batch
from ..ops.mc import _jidx

I32 = torch.int32
F32 = torch.float32
I_FRAME, P_FRAME, B_FRAME = 0, 1, 2
INF = float(1 << 50)


def turbo_reject_reason(enc):
    """Name of the first parameter that turbo does not support, or None.

    pb_split presets are supported: turbo codes pb_part=NONE on every
    inter block (one VLC-13 code, enc/write_bits.c:405-406), which is
    fully compliant syntax."""
    p = enc.params
    fi = enc.fi
    for cond, name in (
            (p.subsample == 420, "subsample!=420"),
            (p.bitdepth in (8, 10, 12), "bitdepth"),
            (p.input_bitdepth <= p.bitdepth, "input_bitdepth>bitdepth"),
            (p.bitrate == 0, "bitrate (rate control)"),
            (p.max_delta_qp == 0, "max_delta_qp"),
            (not p.sync, "sync"),
            (p.log2_sb_size == 7, "log2_sb_size!=7"),
            (p.width % 8 == 0 and p.height % 8 == 0, "size%8"),
    ):
        if not cond:
            return name
    if fi.frame_type in (I_FRAME, P_FRAME):
        return None
    # B frames (RA/HDB families): uni per list + bipred + approximate
    # skip decisions; interp_ref=1 streams use the interpolated frame
    # as the skip/zero reference (interp_ref=2's temporal-MV skip mode
    # is host-path only)
    if fi.frame_type == B_FRAME and p.interp_ref > 1:
        return "interp_ref=2 (B frames)"
    return None


def turbo_supported(enc) -> bool:
    """True when turbo codes the frame; otherwise the frame takes the
    exact host encoder, and the first such frame of an encoder says so
    on stderr (a user who asked for turbo must never silently get the
    much slower host path)."""
    reason = turbo_reject_reason(enc)
    if reason is None:
        return True
    if not getattr(enc, "_turbo_warned", False):
        print(f"thor_tpu_torch: turbo unavailable for this frame "
              f"(rejecting parameter: {reason}); falling back to the "
              f"exact host encoder (much slower)", file=sys.stderr)
        enc._turbo_warned = True
    return False


# ---------------------------------------------------------------------------
# JAX-equivalent integer helpers
# ---------------------------------------------------------------------------

def _sum(x, dims):
    """jnp.sum of an int32 tensor under 64-bit JAX: an int64 sum."""
    return x.to(torch.int64).sum(dim=dims)


def _gather2(plane, ys, xs):
    """plane[ys, xs] with JAX's gather index rule on both axes."""
    H, W = plane.shape
    return plane[_jidx(ys, H), _jidx(xs, W)]


def _win(plane, y0, x0, n: int):
    """[N, n, n] windows with top-left (y0, x0), JAX gather indices."""
    d = torch.arange(n, device=plane.device)
    return _gather2(plane, (y0[:, None] + d)[:, :, None],
                    (x0[:, None] + d)[:, None, :])


# ---------------------------------------------------------------------------
# exact single-list motion-compensated prediction at any size
# ---------------------------------------------------------------------------

def _clip_mv_b(mvy, mvx, ypos, xpos, W: int, H: int, s: int):
    """clip_mv (inter_prediction.c:51-63), sign 0, square s-blocks."""
    return clip_mv_batch(mvy, mvx, ypos, xpos, W, H, s, s, 0)


def _mc_pred(reff, pad: int, ypos, xpos, mvy, mvx, s: int, W: int, H: int,
             bd: int):
    """Exact luma MC (spec.inter.mc_luma, standard filters, uni-pred):
    [N] blocks of size s at visible (ypos,xpos), quarter-pel (mvy,mvx)
    already clip_mv'ed.  Returns [N,s,s] int32."""
    vf = mvy & 3
    hf = mvx & 3
    vi = mvy >> 2
    hi = mvx >> 2
    vi = torch.minimum(vi, H - ypos)
    vi = torch.maximum(vi, -xpos - s)   # (sic) reference quirk
    hi = torch.minimum(hi, W - xpos)
    hi = torch.maximum(hi, -xpos - s)
    y0 = ypos + vi
    x0 = xpos + hi
    Wn = s + 5
    win = _win(reff, y0 + pad - 2, x0 + pad - 2, Wn)
    p_copy = win[:, 2:2 + s, 2:2 + s]
    bank = _on_device(reff.device)["bank"]
    fv = bank[vf.long()]
    fh = bank[hf.long()]
    N = win.shape[0]
    tmp = torch.zeros((N, s, Wn), dtype=I32, device=reff.device)
    for m in range(6):
        tmp = tmp + fv[:, m, None, None] * win[:, m:m + s, :]
    six = torch.zeros((N, s, s), dtype=I32, device=reff.device)
    for m in range(6):
        six = six + fh[:, m, None, None] * tmp[:, :, m:m + s]
    maxv = (1 << bd) - 1
    p_six = ((six + 2048) >> 12).clamp(0, maxv)
    lp = torch.zeros((N, s, s), dtype=I32, device=reff.device)
    for ky in range(4):
        for kx in range(4):
            kv = int(LOWPASS_K[ky, kx])
            if kv:
                lp = lp + kv * win[:, 1 + ky:1 + ky + s, 1 + kx:1 + kx + s]
    p_lp = ((lp + 8) >> 4).clamp(0, maxv)
    zero_f = (vf == 0) & (hf == 0)
    centre = (vf == 2) & (hf == 2)
    sel = torch.where(zero_f, 0, torch.where(centre, 1, 2))[:, None, None]
    return torch.where(sel == 0, p_copy,
                       torch.where(sel == 1, p_lp, p_six)).to(I32)


@functools.cache
def _on_device_str(device: str):
    return {"bank": torch.as_tensor(COEFFS_STANDARD.astype(np.int32),
                                    device=device),
            "zz": {q: torch.as_tensor(np.asarray(ZIGZAG[q], np.int64),
                                      device=device) for q in ZIGZAG}}


def _on_device(device):
    """Constant tables on `device`, built once per device: an upload per
    call would synchronise the stream."""
    return _on_device_str(str(torch.device(device)))


def _grid_pos(H: int, W: int, s: int, device):
    """Block origins of the size-s grid, row-major (arange on the
    device: no upload)."""
    nh, nw = H // s, W // s
    k = torch.arange(nh * nw, dtype=I32, device=device)
    return (k // nw * s).to(I32), (k % nw * s).to(I32), nh, nw


def _org_tiles(org, H: int, W: int, s: int):
    nh, nw = H // s, W // s
    return (org.reshape(nh, s, nw, s).permute(0, 2, 1, 3)
            .reshape(nh * nw, s, s))


def _update(c, best, vals):
    """The strict-< running minimum: (best, *vals) take c's values where
    c < best (the first minimum stays)."""
    upd = c < best
    return [torch.where(upd, c, best)] + [torch.where(upd, n, o)
                                          for n, o in vals]


# ---------------------------------------------------------------------------
# motion search
# ---------------------------------------------------------------------------

def prepass_half(orgh, refh, Hh: int, Wh: int):
    """Two-stage +-8 integer full search at half resolution, 8x8 blocks
    (16x16 at full res).  Returns int half-pel MVs [N,2] (y,x)."""
    dev = orgh.device
    yy, xx, nh, nw = _grid_pos(Hh, Wh, 8, dev)
    ot = _org_tiles(orgh, Hh, Wh, 8)
    pad = refh.shape[0] - Hh >> 1  # symmetric pad

    def sad_at(dy, dx):
        w = _win(refh, yy + pad + dy, xx + pad + dx, 8)
        return _sum((w - ot).abs(), (1, 2))

    best = torch.full((yy.shape[0],), 1 << 30, dtype=I32, device=dev)
    bdy = torch.zeros_like(best)
    bdx = torch.zeros_like(best)
    for dy in range(-8, 9, 2):
        for dx in range(-8, 9, 2):
            best, bdy, bdx = _update(sad_at(dy, dx), best,
                                     [(dy, bdy), (dx, bdx)])

    # +-1 refine around the coarse winner (dynamic offsets)
    def sad_dyn(dy, dx):
        w = _win(refh, yy + pad + bdy + dy, xx + pad + bdx + dx, 8)
        return _sum((w - ot).abs(), (1, 2))

    rdy = torch.zeros_like(best)
    rdx = torch.zeros_like(best)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            best, rdy, rdx = _update(sad_dyn(dy, dx), best,
                                     [(dy, rdy), (dx, rdx)])
    return torch.stack([bdy + rdy, bdx + rdx], -1).to(I32)


def refine16(org, reff, mv_half, H: int, W: int, bd: int):
    """Full-res +-1 integer + half + quarter refinement (exact MC SADs)
    for the 16x16 field.  Returns quarter-pel MVs [N,2]."""
    s = 16
    dev = org.device
    pad = (reff.shape[0] - H) >> 1
    yy, xx, nh, nw = _grid_pos(H, W, s, dev)
    ot = _org_tiles(org, H, W, s)
    mvy0 = mv_half[:, 0] * 8   # half-pel int at half res = 2 full px = 8 q
    mvx0 = mv_half[:, 1] * 8

    def probe(mvy, mvx, best, bmy, bmx):
        cy, cx = _clip_mv_b(mvy, mvx, yy, xx, W, H, s)
        p = _mc_pred(reff, pad, yy, xx, cy, cx, s, W, H, bd)
        return _update(_sum((p - ot).abs(), (1, 2)), best,
                       [(cy, bmy), (cx, bmx)])

    def probe_int(mvy, mvx, best, bmy, bmx):
        # integer-pel candidates: the MC is a plain copy, skip the taps
        cy, cx = _clip_mv_b(mvy, mvx, yy, xx, W, H, s)
        w = _win(reff, yy + (cy >> 2) + pad, xx + (cx >> 2) + pad, s)
        return _update(_sum((w - ot).abs(), (1, 2)), best,
                       [(cy, bmy), (cx, bmx)])

    best = torch.full((yy.shape[0],), 1 << 30, dtype=I32, device=dev)
    bmy = torch.zeros_like(best)
    bmx = torch.zeros_like(best)
    for dy in (-4, 0, 4):
        for dx in (-4, 0, 4):
            best, bmy, bmx = probe_int(mvy0 + dy, mvx0 + dx, best, bmy,
                                       bmx)
    cy, cx = bmy, bmx
    for dy in (-2, 0, 2):
        for dx in (-2, 0, 2):
            if dy or dx:
                best, bmy, bmx = probe(cy + dy, cx + dx, best, bmy, bmx)
    cy, cx = bmy, bmx
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                best, bmy, bmx = probe(cy + dy, cx + dx, best, bmy, bmx)
    return torch.stack([bmy, bmx], -1).to(I32)


def upsize_mv(org, reff, mv_child, H: int, W: int, s: int, bd: int):
    """MV for size-s blocks: best of the 4 child MVs + zero by exact-MC
    SAD at size s."""
    dev = org.device
    pad = (reff.shape[0] - H) >> 1
    yy, xx, nh, nw = _grid_pos(H, W, s, dev)
    ot = _org_tiles(org, H, W, s)
    ch = mv_child.reshape(2 * nh, 2 * nw, 2)
    cands = [ch[0::2, 0::2], ch[0::2, 1::2], ch[1::2, 0::2],
             ch[1::2, 1::2]]
    cands = [c.reshape(-1, 2) for c in cands]
    cands.append(torch.zeros_like(cands[0]))
    best = torch.full((yy.shape[0],), 1 << 30, dtype=I32, device=dev)
    bmy = torch.zeros_like(best)
    bmx = torch.zeros_like(best)
    for c in cands:
        cy, cx = _clip_mv_b(c[:, 0], c[:, 1], yy, xx, W, H, s)
        p = _mc_pred(reff, pad, yy, xx, cy, cx, s, W, H, bd)
        best, bmy, bmx = _update(_sum((p - ot).abs(), (1, 2)), best,
                                 [(cy, bmy), (cx, bmx)])
    return torch.stack([bmy, bmx], -1).to(I32)


# ---------------------------------------------------------------------------
# per-size mode costs
# ---------------------------------------------------------------------------

def _zz_fwd(qsize: int, device):
    """Flat indices that reorder a [qsize,qsize] block into zigzag scan."""
    return _on_device(device)["zz"][qsize]


def _bits_and_dequant(q, cbp, qp: int, s: int, intra: int):
    qs = min(16, s)
    sc = q.reshape(q.shape[0], qs * qs).to(I32)[:, _zz_fwd(qs, q.device)]
    bits = torch.where(cbp != 0, coeff_bits_batch(sc, s, 0, intra), 0)
    return bits, _dequant_j(q.to(I32), qp, s)


def _trial_bits_ssd(ot, pred, qp: int, s: int, intra: bool, bd: int):
    """Trial encode: residual -> transform -> quantize -> bits + recon
    SSD (enc/encode_block.c:1340-1514 single-TB path)."""
    res = ot - pred
    co = fwd_transform_batch(res, s, False, bd)
    q, cbp = quantize_batch(co.to(torch.int16), qp, s, int(intra))
    bits, rq = _bits_and_dequant(q, cbp, qp, s, int(intra))
    rec = (pred + inv_transform_batch(rq, s, bd)).clamp(0, (1 << bd) - 1)
    d = ot - rec
    ssd = _sum(d * d, (1, 2))
    return ssd, bits, cbp


def _trial_bits_ssd_tb1(ot, pred, qp: int, s: int, bd: int):
    """Trial encode with tb_split=1: four s/2 quadrant TBs per block
    (enc/encode_block.c:1275-1313).  Returns (ssd, bits) summed over the
    quadrants.  Quadrant order (0,0),(0,s/2),(s/2,0),(s/2,s/2)."""
    s2 = s // 2
    N = ot.shape[0]

    def quads(x):
        return (x.reshape(N, 2, s2, 2, s2).permute(0, 1, 3, 2, 4)
                .reshape(N * 4, s2, s2))

    res = quads(ot - pred)
    co = fwd_transform_batch(res, s2, False, bd)
    q, cbp = quantize_batch(co.to(torch.int16), qp, s2, 0)
    bits, rq = _bits_and_dequant(q, cbp, qp, s2, 0)
    rec = (quads(pred) + inv_transform_batch(rq, s2, bd)).clamp(
        0, (1 << bd) - 1)
    d = quads(ot) - rec
    ssd = _sum(d * d, (1, 2))
    return (_sum(ssd.reshape(N, 4), 1),
            _sum(bits.reshape(N, 4), 1))


def _dequant_j(q, qp: int, s: int):
    """Unweighted dequantize (common_block.c:45-73), int16 wrap."""
    qs = min(16, s)
    lshift = qp // 6
    rshift = log2i(s) - 1
    c = q.to(torch.int64) * int(GDEQUANT[qp % 6])
    d = lshift - rshift
    if d >= 0:
        r = c << d
    else:
        r = (c + (1 << (-d - 1))) >> -d
    out = torch.zeros((q.shape[0], s, s), dtype=I32, device=q.device)
    out[:, :qs, :qs] = _i16(r).to(I32)
    return out


def _fma32(a, b, c):
    """a * b + c for float32 tensors with ONE rounding to float32, as
    the fused multiply-add that XLA's CPU backend contracts these costs
    into.  The product of two float32 values is exact in float64; the
    float64 sum is exact up to a 53-bit span, and where it rounds, the
    float32 result is corrected from the sum's exact error (TwoSum): a
    float64 sum that lands exactly halfway between two float32 values
    takes the neighbour on the side of the error."""
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.to(F32)
    rd = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    lo = torch.where(rd <= s, r, torch.nextafter(r, -inf))
    hi = torch.where(rd <= s, torch.nextafter(r, inf), r)
    mid = (lo.to(torch.float64) + hi.to(torch.float64)) / 2
    fix = (s == mid) & (err != 0)
    return torch.where(fix, torch.where(err > 0, hi, lo), r)


def _cost(ssd, lam, bits, base_bits=None, shared_base=False):
    """The reference's float32 cost ssd.f32 + lam * bits.f32 (+ base,
    base = lam * base_bits.f32), rounded where thor_tpu's streams round
    it: XLA:CPU fuses each multiply-add into one rounding (`_fma32`),
    except that a base shared by two costs (the tb-split trials) is
    rounded to float32 on its own first."""
    c = _fma32(lam, bits.to(F32), ssd.to(F32))
    if base_bits is None:
        return c
    if shared_base:
        return c + lam * base_bits.to(F32)
    return _fma32(lam, base_bits.to(F32), c)


def _left_mvp(cy, cx, nh: int, nw: int):
    """MV of the left neighbour in the size grid (zero in column 0)."""
    mvg = torch.stack([cy, cx], -1).reshape(nh, nw, 2)
    return torch.cat([torch.zeros_like(mvg[:, :1]), mvg[:, :-1]],
                     dim=1).reshape(-1, 2)


def eval_inter(org, reff, mv_s, lam, qp: int, H: int, W: int, s: int,
               bd: int, tb_trial: bool = False):
    """Inter cost at size s for every block: exact MC pred, trial
    transform/quant, coeff+mv bits, recon SSD.  With tb_trial (HE
    presets, enable_tb_split=1) both tb_split=0 and =1 are trial-encoded
    and the min is taken (enc/encode_block.c:2031-2049); the returned tb
    flag drives the finalizer's TB geometry."""
    pad = (reff.shape[0] - H) >> 1
    yy, xx, nh, nw = _grid_pos(H, W, s, org.device)
    ot = _org_tiles(org, H, W, s)
    cy, cx = _clip_mv_b(mv_s[:, 0], mv_s[:, 1], yy, xx, W, H, s)
    pred = _mc_pred(reff, pad, yy, xx, cy, cx, s, W, H, bd)
    ssd, bits, cbp = _trial_bits_ssd(ot, pred, qp, s, False, bd)
    # mv bits vs the left neighbour (approximate MVP for the decision)
    mvp = _left_mvp(cy, cx, nh, nw)
    # +8: super-mode code + cbp code + pb_part flag - per-leaf syntax the
    # trial bits don't include
    mvbits = quote_mv_bits_batch(cy - mvp[:, 0], cx - mvp[:, 1])
    cost0 = _cost(ssd, lam, bits, mvbits + 8, shared_base=tb_trial)
    mv = torch.stack([cy, cx], -1).to(I32)
    if not tb_trial:
        return cost0, mv, torch.zeros_like(cy, dtype=I32)
    ssd1, bits1 = _trial_bits_ssd_tb1(ot, pred, qp, s, bd)
    # +8: approximate extra syntax of the three additional cbp codes
    cost1 = _cost(ssd1, lam, bits1 + 8, mvbits + 8, shared_base=True)
    tb = (cost1 < cost0).to(I32)
    return torch.minimum(cost0, cost1), mv, tb


def eval_skip(org, reff, mv_s, lam, H: int, W: int, s: int, bd: int):
    """Skip cost at size s: best of {zero, left, top, top-left} MVs
    (approximating the normative candidate list), no residual."""
    dev = org.device
    pad = (reff.shape[0] - H) >> 1
    yy, xx, nh, nw = _grid_pos(H, W, s, dev)
    ot = _org_tiles(org, H, W, s)
    mvg = mv_s.reshape(nh, nw, 2)
    zero = torch.zeros((nh, nw, 2), dtype=mv_s.dtype, device=dev)
    left = torch.cat([zero[:, :1], mvg[:, :-1]], dim=1)
    top = torch.cat([zero[:1], mvg[:-1]], dim=0)
    tl = torch.cat([zero[:1],
                    torch.cat([zero[1:, :1], mvg[:-1, :-1]], dim=1)], dim=0)
    best = torch.full((nh * nw,), float("inf"), dtype=F32, device=dev)
    bmy = torch.zeros((nh * nw,), dtype=I32, device=dev)
    bmx = torch.zeros((nh * nw,), dtype=I32, device=dev)
    three = lam * 3.0
    for cand in (zero, left, top, tl):
        c = cand.reshape(-1, 2)
        cy, cx = _clip_mv_b(c[:, 0], c[:, 1], yy, xx, W, H, s)
        p = _mc_pred(reff, pad, yy, xx, cy, cx, s, W, H, bd)
        d = ot - p
        cost = _sum(d * d, (1, 2)).to(F32) + three
        best, bmy, bmx = _update(cost, best, [(cy, bmy), (cx, bmx)])
    return best, torch.stack([bmy, bmx], -1).to(I32)


def eval_intra(orgp, org, lam, qp: int, H: int, W: int, s: int, bd: int,
               nim: int = 4):
    """Intra cost at size s: nim-mode search on ORG-neighbour reference
    samples (decision approximation; the final encode re-derives coeffs
    from true reconstructed neighbours).  nim mirrors the preset's
    frame_info.num_intra_modes."""
    dev = org.device
    yy, xx, nh, nw = _grid_pos(H, W, s, dev)
    ot = _org_tiles(org, H, W, s)
    ur = torch.zeros((nh * nw,), dtype=torch.bool, device=dev)
    dl = torch.zeros((nh * nw,), dtype=torch.bool, device=dev)
    left, top, tl = IB.make_refs_batch(orgp, yy, xx, s, ur, dl, bd)
    preds = IB.predict_all_modes(left, top, tl, yy, xx, s, bd,
                                 num_modes=nim)
    sads = torch.stack([_sum((preds[m] - ot).abs(), (1, 2))
                        for m in range(nim)])
    mode = torch.argmin(sads, dim=0)      # the first minimum, as jnp's
    pred = IB.select_mode(preds, mode)
    ssd, bits, cbp = _trial_bits_ssd(ot, pred, qp, s, True, bd)
    # +9: per-leaf syntax the trial doesn't count (super-mode code,
    # intra mode, cbp code, chroma cbp)
    cost = _cost(ssd, lam, bits + 9)
    return cost, mode.to(I32)


def eval_bipred(org, reffA, reffB, mvAs, mvBs, lam, qp: int, H: int,
                W: int, s: int, bd: int, tb_trial: bool = False):
    """Bipred cost at size s: average of the two uni predictions (decision
    approximation of the bipred filter pair), trial transform/quant bits.
    List-1 MV bits are quoted against list 0 (enc/write_bits.c:478)."""
    pad = (reffA.shape[0] - H) >> 1
    yy, xx, nh, nw = _grid_pos(H, W, s, org.device)
    ot = _org_tiles(org, H, W, s)
    cyA, cxA = _clip_mv_b(mvAs[:, 0], mvAs[:, 1], yy, xx, W, H, s)
    cyB, cxB = _clip_mv_b(mvBs[:, 0], mvBs[:, 1], yy, xx, W, H, s)
    pA = _mc_pred(reffA, pad, yy, xx, cyA, cxA, s, W, H, bd)
    pB = _mc_pred(reffB, pad, yy, xx, cyB, cxB, s, W, H, bd)
    pred = (pA + pB) >> 1
    ssd, bits, cbp = _trial_bits_ssd(ot, pred, qp, s, False, bd)
    mvp = _left_mvp(cyA, cxA, nh, nw)
    mvbA = quote_mv_bits_batch(cyA - mvp[:, 0], cxA - mvp[:, 1])
    # emitted list-1 MV is the negated displacement (future ref, sign=1)
    mvbB = quote_mv_bits_batch(-cyB - cyA, -cxB - cxA)
    cost0 = _cost(ssd, lam, bits, mvbA + mvbB + 8, shared_base=tb_trial)
    if not tb_trial:
        return cost0, torch.zeros_like(cyA, dtype=I32)
    ssd1, bits1 = _trial_bits_ssd_tb1(ot, pred, qp, s, bd)
    cost1 = _cost(ssd1, lam, bits1 + 8, mvbA + mvbB + 8, shared_base=True)
    tb = (cost1 < cost0).to(I32)
    return torch.minimum(cost0, cost1), tb


# ---------------------------------------------------------------------------
# frame decision + quadtree assembly
# ---------------------------------------------------------------------------

SIZES = (8, 16, 32, 64, 128)


def _stage_org(org, H: int, W: int, device):
    """Zero-pad the original (host plane, native dtype) to the decision
    geometry on the device: (org [H,W], org padded [H+130,W+130])."""
    H0, W0 = org.shape
    o = torch.from_numpy(np.ascontiguousarray(
        org if org.dtype == np.uint8 else org.astype(np.int32))).to(
            device).to(I32)
    orgj = torch.zeros((H, W), dtype=I32, device=device)
    orgj[:H0, :W0] = o
    orgpj = torch.zeros((H + 130, W + 130), dtype=I32, device=device)
    orgpj[:H0, :W0] = o
    return orgj, orgpj


def _stage_ref(ref_i16, H: int, W: int):
    """Edge-extend the padded reference plane to the decision geometry
    (bottom and right only), widened to int32."""
    sh, sw = ref_i16.shape
    r = ref_i16.to(I32)
    if (H + 320, W + 320) == (sh, sw):
        return r
    ri = torch.arange(H + 320, device=r.device).clamp(max=sh - 1)
    ci = torch.arange(W + 320, device=r.device).clamp(max=sw - 1)
    return r[ri[:, None], ci[None, :]]


def scale2(plane):
    s = plane.to(I32)
    a = s[0::2, 0::2]
    b = s[1::2, 0::2]
    c = s[0::2, 1::2]
    d = s[1::2, 1::2]
    return (((a + b + 1) >> 1) + ((c + d + 1) >> 1)) >> 1


def decide_frame(enc):
    """Run the batched decision pass on enc.device; returns per-size
    numpy decision grids + the final leaf map (one pull each for the
    costs and the metadata)."""
    from .encoder import SQUARED_LAMBDA_QP
    p = enc.params
    fi = enc.fi
    dev = enc.device
    qp = fi.qp
    lam = torch.tensor(np.float32(fi.lambda_coeff * SQUARED_LAMBDA_QP[qp]),
                       dtype=F32, device=dev)
    H0, W0 = p.height, p.width
    H = ((H0 + 127) // 128) * 128
    W = ((W0 + 127) // 128) * 128
    bd = p.bitdepth

    orgj, orgpj = _stage_org(enc.orig.y, H, W, dev)

    is_i = fi.frame_type == I_FRAME
    is_b = fi.frame_type == B_FRAME
    # real tb-split decisions on the HE presets
    tb_on = (p.enable_tb_split == 1) and not is_i
    # sizes whose first block already overhangs the visible frame can
    # never be leaves: their evals are skipped (INF below)
    eval_sizes = tuple(s for s in SIZES if s <= H0 and s <= W0)
    out = {"qp": qp, "is_b": is_b, "tb_on": tb_on,
           "eval_sizes": eval_sizes}

    def me_chain(reff, orgh):
        refh = scale2(reff)
        mv_h = prepass_half(orgh, refh, H // 2, W // 2)
        mv = {16: refine16(orgj, reff, mv_h, H, W, bd)}
        for s in (32, 64, 128):
            if s in eval_sizes:
                mv[s] = upsize_mv(orgj, reff, mv[s // 2], H, W, s, bd)
            else:
                mv[s] = torch.zeros(((H // s) * (W // s), 2), dtype=I32,
                                    device=dev)
        mv[8] = (mv[16].reshape(H // 16, W // 16, 2)
                 .repeat_interleave(2, 0).repeat_interleave(2, 1)
                 .reshape(-1, 2))
        return mv

    def stage(ref):
        # device-resident ring hit (encoder._note_dev_ref): no upload;
        # miss (the interpolated frame): native int16 upload
        planes = enc._dev_ref_planes(ref)
        if planes is None:
            planes = (torch.from_numpy(ref.y_full.astype(np.int16)).to(dev),)
        return _stage_ref(planes[0], H, W)

    if is_b:
        # two uni lists (past / future) + the skip/zero reference, which
        # under interp_ref=1 is the interpolated frame (ref slot 0)
        r0i = 1 if fi.interp_ref else 0
        r1i = 2 if fi.interp_ref else 1
        reffA = stage(enc._ref_frame(fi.ref_array[r0i]))
        reffB = stage(enc._ref_frame(fi.ref_array[r1i]))
        reffS = (stage(enc._ref_frame(fi.ref_array[0]))
                 if fi.interp_ref else reffA)
        orgh = scale2(orgj)
        mvA = me_chain(reffA, orgh)
        mvB = me_chain(reffB, orgh)
    elif not is_i:
        reff = stage(enc._ref_frame(fi.ref_array[0]))
        mv = me_chain(reff, scale2(orgj))

    fseg, iseg = [], []
    for s in eval_sizes:
        n = (H // s) * (W // s)
        if is_b:
            ci, mvc, tb0 = eval_inter(orgj, reffA, mvA[s], lam, qp, H, W,
                                      s, bd, tb_trial=tb_on)
            ciB, mvcB, tb1 = eval_inter(orgj, reffB, mvB[s], lam, qp, H,
                                        W, s, bd, tb_trial=tb_on)
            cbi, tbb = eval_bipred(orgj, reffA, reffB, mvA[s], mvB[s],
                                   lam, qp, H, W, s, bd, tb_trial=tb_on)
            cs, mvs = eval_skip(orgj, reffS, mvA[s], lam, H, W, s, bd)
            tbc = tb0 | (tb1 << 1) | (tbb << 2)
        elif not is_i:
            ci, mvc, tb0 = eval_inter(orgj, reff, mv[s], lam, qp, H, W, s,
                                      bd, tb_trial=tb_on)
            cs, mvs = eval_skip(orgj, reff, mv[s], lam, H, W, s, bd)
            tbc = tb0
        else:
            ci = torch.full((n,), float("inf"), dtype=F32, device=dev)
            cs = torch.full((n,), float("inf"), dtype=F32, device=dev)
            mvc = mvs = torch.zeros((n, 2), dtype=I32, device=dev)
            tbc = torch.zeros((n,), dtype=I32, device=dev)
        if s <= 64:
            cn, imode = eval_intra(orgpj, orgj, lam, qp, H, W, s, bd,
                                   nim=fi.num_intra_modes)
        else:
            cn = torch.full((n,), float("inf"), dtype=F32, device=dev)
            imode = torch.zeros((n,), dtype=I32, device=dev)
        fseg += [cs, ci, cn]
        iseg += [mvs.reshape(-1), mvc.reshape(-1), imode]
        if is_b:
            fseg += [ciB, cbi]
            iseg += [mvcB.reshape(-1)]
        if tb_on:
            iseg += [tbc]

    # ONE pull each for costs and metadata
    fpk = torch.cat(fseg).cpu().numpy()
    ipk = torch.cat([t.to(I32) for t in iseg]).cpu().numpy()
    return _finish_decide(fpk, ipk, out, (H, W, H0, W0, float(lam)))


def _finish_decide(fpk, ipk, out, geom):
    """Host unpack + quadtree aggregation over the pulled cost/meta."""
    H, W, H0, W0, lamf = geom
    is_b = out["is_b"]
    tb_on = out.get("tb_on", False)
    eval_sizes = out.get("eval_sizes", SIZES)
    nf, ni = (5, 7) if is_b else (3, 5)
    if tb_on:
        ni += 1
    cost, meta = {}, {}
    fo = io = 0
    for s in SIZES:
        n = (H // s) * (W // s)
        if s not in eval_sizes:
            # size skipped on device (no block of this size fits the
            # visible frame): INF costs force a split, zero meta
            cost[s] = tuple(np.full((n,), INF, np.float32)
                            for _ in range(nf))
            m = (np.zeros((n, 2), np.int64), np.zeros((n, 2), np.int64),
                 np.zeros((n,), np.int64))
            if is_b:
                m += (np.zeros((n, 2), np.int64),)
            if tb_on:
                m += (np.zeros((n,), np.int64),)
            meta[s] = m
            continue
        cost[s] = tuple(fpk[fo + k * n:fo + (k + 1) * n]
                        for k in range(nf))
        fo += nf * n
        m = (ipk[io:io + 2 * n].reshape(n, 2),
             ipk[io + 2 * n:io + 4 * n].reshape(n, 2),
             ipk[io + 4 * n:io + 5 * n])
        j = 5
        if is_b:
            m += (ipk[io + 5 * n:io + 7 * n].reshape(n, 2),)
            j = 7
        if tb_on:
            # packed tb flags: bit0 inter(list0), bit1 inter(list1),
            # bit2 bipred
            m += (ipk[io + j * n:io + (j + 1) * n],)
        meta[s] = m
        io += ni * n

    # blocks that don't fit the visible frame can't be leaves
    best = {}
    choice = {}
    for s in SIZES:
        nh, nw = H // s, W // s
        # cost order: skip, inter(list0), intra[, inter(list1), bipred];
        # choice codes: 0 skip, 1 inter0, 2 intra, 3 split, 4 inter1,
        # 5 bipred
        stackc = np.stack([c.reshape(nh, nw) for c in cost[s]])
        ch = np.argmin(stackc, axis=0)
        if is_b:
            ch = np.array([0, 1, 2, 4, 5])[ch]
        bc = np.min(stackc, axis=0)
        yy, xx = np.meshgrid(np.arange(nh) * s, np.arange(nw) * s,
                             indexing="ij")
        fits = (yy + s <= H0) & (xx + s <= W0)
        bc = np.where(fits, bc, INF)
        best[s] = bc
        choice[s] = ch
        if s > 8:
            quads = (best[s // 2].reshape(nh, 2, nw, 2)
                     .transpose(0, 2, 1, 3).reshape(nh, nw, 4))
            split_cost = np.minimum(quads, INF).sum(axis=2) + lamf * 2.0
            take_split = split_cost < bc
            best[s] = np.where(take_split, split_cost, bc)
            choice[s] = np.where(take_split, 3, ch)  # 3 = split

    out.update(cost=cost, meta=meta, choice=choice, H=H, W=W)
    return out


# ---------------------------------------------------------------------------
# emission
# ---------------------------------------------------------------------------

def encode_frame_turbo(enc):
    """Decide the frame, then finalize it on the device and emit its
    syntax (enc/turbo_final.py)."""
    from .turbo_final import encode_frame_turbo_final
    encode_frame_turbo_final(enc, decide_frame(enc))
