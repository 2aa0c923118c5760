"""Resident frame decoder on the device (torch port of
thor_tpu/dec/device_frame.py).

Per frame: dense residuals (dequant + inverse transform), inter MC from a
ring of reference planes kept on the device (through the CUDA kernels of
ops/mc.py), the intra wave scan with chroma-from-luma, then the in-loop
filters (deblock -> CDEF -> CLPF), display packing and reference edge
padding.  The host uploads the parsed plan and pulls one packed display
buffer.  Scope as in JAX, narrowed to the slice the port carries: 4:2:0,
no cfl_inter, no qmtx, no tb-split intra (`eligible` raises on the rest).

The host helpers (`LY_KEYS`, `CH_KEYS`, `SEG_BUCKETS`, `INTRA_SIZES`,
`_bucket`, `build_wave_segments`) are verbatim copies of
thor_tpu/dec/device_frame.py:42-54 and :226-269: the original imports JAX
at the top, and the host decoder imports this module under its name
(thor_tpu_torch/_host.py).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .._host import native_parse as NP
from .._host import spec_filters as SF
from .._host import spec_inter as inter
from .._host import tables
from ..ops import filters as OF
from ..ops import intra_batch as IB
from ..ops.transform import _i16
from . import device_pixels as DP

CHROMA_QP = tables.CHROMA_QP
log2i = tables.log2i

AP = 136                     # apron: window writes + ref reads
PADDING = 160                # luma ref padding (common/global.h:62)
MODE_INTRA = 1
I_FRAME = 0

LY_KEYS = ("op0", "y0_0", "x0_0", "vf0", "hf0", "fs0", "r0",
           "op1", "y0_1", "x0_1", "vf1", "hf1", "fs1", "r1")
CH_KEYS = ("op0", "y0_0", "x0_0", "vf0", "hf0",
           "op1", "y0_1", "x0_1", "vf1", "hf1")
SEG_BUCKETS = (8, 32, 128, 512, 2048)
INTRA_SIZES = (8, 16, 32, 64, 128)


def _bucket(n):
    for b in SEG_BUCKETS:
        if n <= b:
            return b
    raise ValueError(n)


# frames served by DeviceFrameDecoder.run since the count was last set to
# 0 (a plain integer; chip_smoke.py and the tests read and reset it)
RUNS = 0


# ---------------------------------------------------------------------------
# CFL (common/common_block.c:347-428) - int64 regression
# ---------------------------------------------------------------------------

def _cfl_j(pred_y, pu, pv, rec_y, n: int, bd: int):
    """improve_uv_prediction (4:2:0) for blocks [..., n, n] (any leading
    batch dims; the JAX version is per block under vmap)."""
    i64 = torch.int64

    def S(a):
        return a.sum(dim=(-2, -1))

    def e(a):
        return a[..., None, None]

    py = pred_y.to(i64)
    ry = rec_y.to(i64)
    sqres = S((ry - py) * (ry - py))
    skip_all = (sqres >> (2 * log2i(n))) <= (64 << (2 * (bd - 8)))
    nc = n >> 1
    lognc = log2i(nc)
    ys = ((py[..., 0::2, 0::2] + py[..., 0::2, 1::2] +
           py[..., 1::2, 0::2] + py[..., 1::2, 1::2] + 2) >> 2)
    us = pu.to(i64)
    vs = pv.to(i64)
    ysum, usum, vsum = S(ys), S(us), S(vs)
    yysum, yusum, yvsum = S(ys * ys), S(ys * us), S(ys * vs)
    uusum, vvsum = S(us * us), S(vs * vs)
    sh = 2 * lognc
    ssyy = yysum - ((ysum * ysum) >> sh)
    ssuu = uusum - ((usum * usum) >> sh)
    ssvv = vvsum - ((vsum * vsum) >> sh)
    ssyu = yusum - ((ysum * usum) >> sh)
    ssyv = yvsum - ((ysum * vsum) >> sh)
    gate = (~skip_all) & (ssyy != 0)
    ssyy_s = torch.where(ssyy == 0, 1, ssyy)
    hi = (1 << bd) - 1
    ry32 = rec_y.to(torch.int32)

    def remap(ssyx, xsum):
        num = ssyx << 16
        # C division truncates toward zero; torch's // floors
        a64 = torch.where(num < 0, -((-num) // ssyy_s), num // ssyy_s)
        b64 = ((xsum << 16) - a64 * ysum) >> sh
        a = a64.clamp(-(1 << (31 - bd)), 1 << (31 - bd)).to(torch.int32)
        b = (b64 + (1 << 15)).clamp(-(1 << 31), (1 << 31) - 1).to(
            torch.int32)
        # int32 products and sums wrap exactly as in the JAX version
        m = ((e(a) * ry32 + e(b)) >> 16).clamp(0, hi)
        return ((m[..., 0::2, 0::2] + m[..., 0::2, 1::2] +
                 m[..., 1::2, 0::2] + m[..., 1::2, 1::2] + 2) >> 2).to(
                     torch.int32)

    do_u = gate & (ssyu * ssyu * 2 > ssyy * ssuu)
    do_v = gate & (ssyv * ssyv * 2 > ssyy * ssvv)
    pu2 = torch.where(e(do_u), remap(ssyu, usum), pu)
    pv2 = torch.where(e(do_v), remap(ssyv, vsum), pv)
    return pu2, pv2


# ---------------------------------------------------------------------------
# intra wavefront scan (wave-batched; inter cells are final)
# ---------------------------------------------------------------------------

LANES = 64          # intra blocks processed per wave segment


def _slices(plane, yy, xx, n: int):
    """[L, n, n] windows of `plane` at (yy, xx), starts clamped so that
    each window lies inside (dynamic_slice semantics)."""
    H, W = plane.shape
    k = torch.arange(n, device=plane.device)
    y = yy.clamp(0, H - n)[:, None, None] + k[:, None]
    x = xx.clamp(0, W - n)[:, None, None] + k[None, :]
    return plane[y, x]


def _write(plane, rec, yy, xx, win: int):
    """Write blocks rec [L, n, n] into `plane` in place, where the JAX
    version's masked win x win window write puts them (its start is
    clamped so that the window lies inside the plane)."""
    H, W = plane.shape
    n = rec.shape[-1]
    k = torch.arange(n, device=plane.device)
    y = yy.clamp(0, H - win)[:, None, None] + k[:, None]
    x = xx.clamp(0, W - win)[:, None, None] + k[None, :]
    plane[y, x] = rec


def _intra_waves(y_pl, u_pl, v_pl, segs, segcls, res_y, res_u, res_v,
                 bd: int, cfl: bool, sizes):
    """segs: [S, LANES, 7] int32 (act, yy, xx, log2size, mode, ur, dl);
    segcls: [S] size-class per segment (0 inactive, i+1 -> sizes[i]).
    All blocks in a segment are one size and mutually independent
    (build_wave_segments guarantees it), so each segment reconstructs its
    active blocks batched.  segs/segcls are host arrays (numpy or CPU
    tensors): the loop over segments runs on the host.  The planes are
    updated in place and returned."""
    maxv = (1 << bd) - 1
    WMAX = max(sizes)
    WC = max(WMAX // 2, 4)
    dev = y_pl.device
    segs = np.asarray(segs)
    segcls = np.asarray(segcls)
    for nd_h, cls in zip(segs, segcls):
        if cls == 0:
            continue
        nd_h = nd_h[nd_h[:, 0] > 0]
        if not len(nd_h):
            continue
        n = sizes[int(cls) - 1]
        nc = n >> 1
        nd = torch.from_numpy(np.ascontiguousarray(nd_h)).to(dev).long()
        yy, xx = nd[:, 1], nd[:, 2]
        mode = nd[:, 4]
        ur, dl = nd[:, 5] > 0, nd[:, 6] > 0
        l, t, tl = IB.make_refs_batch(y_pl, yy, xx, n, ur, dl, bd)
        pred = IB.select_mode(
            IB.predict_all_modes(l, t, tl, yy, xx, n, bd, 10), mode)
        rec = (_slices(res_y, yy, xx, n) + _i16(pred)).clamp(0, maxv)
        yc, xc = yy >> 1, xx >> 1
        lu, tu, tlu = IB.make_refs_batch(u_pl, yc, xc, nc, ur, dl, bd)
        pu = IB.select_mode(
            IB.predict_all_modes(lu, tu, tlu, yc, xc, nc, bd, 10), mode)
        lv, tv, tlv = IB.make_refs_batch(v_pl, yc, xc, nc, ur, dl, bd)
        pv = IB.select_mode(
            IB.predict_all_modes(lv, tv, tlv, yc, xc, nc, bd, 10), mode)
        if cfl:
            pu, pv = _cfl_j(pred, pu, pv, rec, n, bd)
        recu = (_slices(res_u, yc, xc, nc) + _i16(pu)).clamp(0, maxv)
        recv = (_slices(res_v, yc, xc, nc) + _i16(pv)).clamp(0, maxv)
        _write(y_pl, rec.to(y_pl.dtype), yy, xx, WMAX)
        _write(u_pl, recu.to(u_pl.dtype), yc, xc, WC)
        _write(v_pl, recv.to(v_pl.dtype), yc, xc, WC)
    return y_pl, u_pl, v_pl


def build_wave_segments(recs, H, W, sizes, lanes=LANES):
    """Host: conservative dependency waves over the intra records
    (coding order), then (wave, size) groups cut into <=lanes segments.

    A block's nominal read set is the row above (x-1 .. x+2n-1) and the
    column left (y-1 .. y+2n-1); true reads are a subset (the
    availability clamps in make_top_and_left), so ordering by these
    levels preserves exact decoding."""
    gh8, gw8 = (H + 7) // 8, (W + 7) // 8
    g8 = np.zeros((gh8, gw8), np.int32)
    n_rec = len(recs)
    waves = np.zeros(n_rec, np.int32)
    ys = recs[:, NP.B_YPOS]
    xs = recs[:, NP.B_XPOS]
    szs = recs[:, NP.B_SIZE]
    for i in range(n_rec):
        y, x, n = int(ys[i]), int(xs[i]), int(szs[i])
        lvl = 0
        if y > 0:
            x0 = max(x - 1, 0) // 8
            xe = min((x + 2 * n - 1) // 8, gw8 - 1)
            lvl = int(g8[(y - 1) // 8, x0:xe + 1].max())
        if x > 0:
            y0 = max(y - 1, 0) // 8
            ye = min((y + 2 * n - 1) // 8, gh8 - 1)
            lvl = max(lvl, int(g8[y0:ye + 1, (x - 1) // 8].max()))
        w = lvl + 1
        g8[y // 8:(y + n) // 8, x // 8:(x + n) // 8] = w
        waves[i] = w
    segs = []
    size_cls = {s: k + 1 for k, s in enumerate(sizes)}
    order = np.lexsort((np.arange(n_rec), waves))
    wsorted = waves[order]
    starts = np.searchsorted(wsorted, np.arange(1, waves.max() + 2)
                             if n_rec else np.array([1]))
    for wi in range(len(starts) - 1):
        idx = order[starts[wi]:starts[wi + 1]]
        if not len(idx):
            continue
        for s in sizes:
            ii_ = idx[szs[idx] == s]
            for k in range(0, len(ii_), lanes):
                segs.append((size_cls[s], ii_[k:k + lanes]))
    return segs


# ---------------------------------------------------------------------------
# per-frame device passes
# ---------------------------------------------------------------------------

def _cells_to_plane(p, gh: int, gw: int, cs: int):
    return p.reshape(gh, gw, cs, cs).permute(0, 2, 1, 3).reshape(
        gh * cs, gw * cs)


def _up(m, k: int):
    return m.repeat_interleave(k, 0).repeat_interleave(k, 1)


def pixel_core(ystack, ustack, vstack, gstack, cstack, coef_y, coef_uv,
               q4y, q4c, segs, segcls, H: int, W: int, bd: int, pad: int,
               pad_c: int, has_inter: bool, has_avg: bool, cfl: bool):
    """Residuals + inter MC + intra scan for one frame.

    ystack/ustack/vstack [R,Hp,Wp] int16 padded reference planes;
    gstack [14, gh*gw] luma plan grids; cstack [12, gh*gw] chroma grids +
    avg + inter; coef_y [hp,wp] int16; coef_uv [2,hc,wc]; q4y/q4c
    [2,*,*] (qp4, ls4); segs [S,LANES,7] + segcls [S] host arrays
    (build_wave_segments).  Returns unfiltered (y, u, v) int32 planes."""
    gh, gw = H // 4, W // 4
    H2, W2 = H // 2, W // 2
    maxv = (1 << bd) - 1
    dev = coef_y.device

    # ---- dense residuals for ALL TBs ----
    res_y = DP._dense_residual(coef_y, q4y[0], q4y[1], bd,
                               (4, 8, 16, 32, 64, 128))[:H, :W]
    res_u = DP._dense_residual(coef_uv[0], q4c[0], q4c[1], bd,
                               (4, 8, 16, 32, 64))[:H2, :W2]
    res_v = DP._dense_residual(coef_uv[1], q4c[0], q4c[1], bd,
                               (4, 8, 16, 32, 64))[:H2, :W2]

    # ---- inter MC + reconstruct into base planes ----
    if has_inter:
        lg = {k: gstack[i] for i, k in enumerate(LY_KEYS)}
        cg = {k: cstack[i] for i, k in enumerate(CH_KEYS)}
        avg = cstack[10][:, None, None] == 1
        inter_m = cstack[11].reshape(gh, gw) == 1
        p0 = DP.mc_cells_luma(ystack, lg["r0"], lg["y0_0"] + pad,
                              lg["x0_0"] + pad, lg["op0"], lg["vf0"],
                              lg["hf0"], lg["fs0"], 4, bd)
        pu0, pv0 = DP.mc_cells_chroma_uv(
            ustack, vstack, lg["r0"], cg["y0_0"] + pad_c,
            cg["x0_0"] + pad_c, cg["op0"], cg["vf0"], cg["hf0"], 2, bd)
        if has_avg:
            p1 = DP.mc_cells_luma(ystack, lg["r1"], lg["y0_1"] + pad,
                                  lg["x0_1"] + pad, lg["op1"], lg["vf1"],
                                  lg["hf1"], lg["fs1"], 4, bd)
            pu1, pv1 = DP.mc_cells_chroma_uv(
                ustack, vstack, lg["r1"], cg["y0_1"] + pad_c,
                cg["x0_1"] + pad_c, cg["op1"], cg["vf1"], cg["hf1"], 2, bd)
            p0 = torch.where(avg, (p0 + p1) >> 1, p0)
            pu0 = torch.where(avg, (pu0 + pu1) >> 1, pu0)
            pv0 = torch.where(avg, (pv0 + pv1) >> 1, pv0)

        def recon(pred, res):
            return (_i16(pred) + res).clamp(0, maxv)

        im_y, im_c = _up(inter_m, 4), _up(inter_m, 2)
        base_y = torch.where(im_y, recon(_cells_to_plane(p0, gh, gw, 4),
                                         res_y), 0)
        base_u = torch.where(im_c, recon(_cells_to_plane(pu0, gh, gw, 2),
                                         res_u), 0)
        base_v = torch.where(im_c, recon(_cells_to_plane(pv0, gh, gw, 2),
                                         res_v), 0)
    else:
        base_y = torch.zeros((H, W), dtype=torch.int32, device=dev)
        base_u = torch.zeros((H2, W2), dtype=torch.int32, device=dev)
        base_v = torch.zeros((H2, W2), dtype=torch.int32, device=dev)

    # ---- intra scan over apron-extended planes ----
    def apron(base, h, w):
        pl = torch.zeros((h + AP, w + AP), dtype=torch.int32, device=dev)
        pl[:h, :w] = base
        return pl

    y_pl, u_pl, v_pl = (apron(base_y, H, W), apron(base_u, H2, W2),
                        apron(base_v, H2, W2))
    sizes = tuple(s for s in INTRA_SIZES if s <= min(H, W))
    _intra_waves(y_pl, u_pl, v_pl, segs, segcls, res_y, res_u, res_v, bd,
                 cfl, sizes)
    return y_pl[:H, :W], u_pl[:H2, :W2], v_pl[:H2, :W2]


def filter_pack(y, u, v, mv_, mh_, cmv, cmh, lv0, sec0, m0, lv1, sec1,
                m1, m2, clpf_my, clpf_mu, clpf_mv2, bd: int, pad: int,
                pad_c: int, qp: int, qpc: int, deblocking: bool,
                cdef_damping: int, cs: int, s_y: int, s_u: int, s_v: int,
                qpclpf: int, out8: bool):
    """In-loop filter chain + display packing + reference padding.
    Returns (packed, ref_y, ref_u, ref_v): packed [H + H/2, W] holds luma
    over u|v, uint8 for 8-bit and int16 otherwise; the references are
    edge-padded int16 planes."""
    if deblocking:
        y = OF.deblock_plane_y(y, mv_, mh_, qp, bd)
        u = OF.deblock_plane_uv(u, cmv, cmh, qpc, 1, bd)
        v = OF.deblock_plane_uv(v, cmv, cmh, qpc, 1, bd)
    dirs, var = OF.cdef_dirs(y, cs)
    y = OF.cdef_plane(y, dirs, var, lv0, sec0, m0, 8, 0,
                      cdef_damping, cdef_damping, cs)
    u = OF.cdef_plane(u, dirs, var, lv1, sec1, m1, 4, 1,
                      cdef_damping - 1, cdef_damping - 1, cs)
    v = OF.cdef_plane(v, dirs, var, lv1, sec1, m2, 4, 2,
                      cdef_damping - 1, cdef_damping - 1, cs)
    if s_y:
        y = OF.clpf_plane(y, clpf_my, (s_y + (s_y == 3)) << cs,
                          bd - 4 + qpclpf)
    if s_u:
        u = OF.clpf_plane(u, clpf_mu, (s_u + (s_u == 3)) << cs,
                          bd - 5 + qpclpf)
    if s_v:
        v = OF.clpf_plane(v, clpf_mv2, (s_v + (s_v == 3)) << cs,
                          bd - 5 + qpclpf)

    # ---- pack display output + padded reference planes ----
    dt = torch.uint8 if out8 else torch.int16
    packed = torch.cat([y.to(dt), torch.cat([u, v], dim=1).to(dt)], dim=0)
    i16 = torch.int16
    return (packed, OF.edge_pad(y.to(i16), pad),
            OF.edge_pad(u.to(i16), pad_c), OF.edge_pad(v.to(i16), pad_c))


def _check_bounds(plan, seg_list, recs, H, W, sizes, nref):
    """The apron (AP) and the reference padding (PADDING) keep every read
    and write of the frame inside its plane, as in the JAX version, whose
    clamping gathers would otherwise shift windows silently."""
    inter_c = plan.inter.astype(bool)
    for s, on in (("0", inter_c),
                  ("1", inter_c & plan.avg.astype(bool))):
        if not on.any():
            continue
        ly, ch = plan.ly, plan.ch
        ok = (ly["r" + s][on].min() >= 0 and ly["r" + s][on].max() < nref
              and ly["y0_" + s][on].min() + PADDING - 2 >= 0
              and ly["x0_" + s][on].min() + PADDING - 2 >= 0
              and ly["y0_" + s][on].max() + PADDING + 6 < H + 2 * PADDING
              and ly["x0_" + s][on].max() + PADDING + 6 < W + 2 * PADDING
              and ch["y0_" + s][on].min() + PADDING // 2 - 1 >= 0
              and ch["x0_" + s][on].min() + PADDING // 2 - 1 >= 0
              and ch["y0_" + s][on].max() + PADDING // 2 + 3
              < H // 2 + PADDING
              and ch["x0_" + s][on].max() + PADDING // 2 + 3
              < W // 2 + PADDING)
        if not ok:
            raise RuntimeError("MC window outside the padded reference")
    wmax = max(sizes)
    for _, idx in seg_list:
        r = recs[idx]
        if (r[:, NP.B_YPOS].max() + wmax > H + AP or
                r[:, NP.B_XPOS].max() + wmax > W + AP):
            raise RuntimeError("intra write window outside the apron")


# ---------------------------------------------------------------------------
# per-stream decoder
# ---------------------------------------------------------------------------

class DeviceFrameDecoder:
    """Per-stream device state: resident reference ring + per-frame passes.

    Frame pipelining: run() leaves the packed display pull IN FLIGHT
    (self._pending) so the host can parse/plan frame N+1 while the device
    executes frame N.  flush() resolves the pull; the decoder calls it
    before any host-pixel consumer."""

    # resident-reference capacity; tests shrink this to force evictions
    # of still-referenced entries (the flush()-on-ring-miss path)
    RING_CAP = 34

    def __init__(self, device):
        self.device = torch.device(device)
        self.ring = OrderedDict()   # frame_num -> (y, u, v) device planes
        self._pending = None        # (packed, rec, H, W, Wc)
        self._late = []             # deferred ref-window host copies

    def _resolve(self, pend):
        packed, rec, H, W, Wc = pend
        out = packed.cpu().numpy()
        rec.y[:] = out[:H].astype(rec.dtype)
        rec.u[:] = out[H:, :Wc].astype(rec.dtype)
        rec.v[:] = out[H:, Wc:].astype(rec.dtype)
        lates = [l for l in self._late if l[1] is rec]
        self._late = [l for l in self._late if l[1] is not rec]
        for dst, src in lates:
            dst.copy_from(src)

    def flush(self):
        """Resolve the in-flight frame (no-op when none)."""
        if self._pending is not None:
            p, self._pending = self._pending, None
            self._resolve(p)

    def note_ref(self, dst, src):
        """Defer `dst.copy_from(src)` until src's pixels are pulled.
        Returns True when deferred (src is the in-flight frame).

        The frame METADATA must propagate immediately even though the
        pixel copy is deferred: the next frame's `_ref_planes` keys the
        resident ring by `frame_num`, and a stale number would miss the
        ring and upload the buffer's stale host pixels."""
        if self._pending is not None and self._pending[1] is src:
            dst.frame_num = src.frame_num
            dst.host_pixels_valid = False  # set again by copy_from
            self._late.append((dst, src))
            return True
        return False

    def _upload(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _ref_planes(self, dec, r):
        """Device planes for one reference frame (ring hit or upload)."""
        is_interp = (dec.interp_frames and r is dec.interp_frames[0])
        key = None if is_interp else r.frame_num
        if key is not None and key in self.ring:
            return self.ring[key]
        if key is not None and any(dst is r for dst, _ in self._late):
            # ring miss on a ref whose host copy is still deferred
            # (evicted entry): resolve the pipeline before uploading
            self.flush()
        if not getattr(r, "host_pixels_valid", True):
            raise RuntimeError(
                "reading host pixels of a reference whose deferred device "
                "copy has not been resolved (frame_num=%s)" % r.frame_num)
        planes = tuple(self._upload(p.astype(np.int16))
                       for p in (r.y_full, r.u_full, r.v_full))
        if key is not None:
            self.ring[key] = planes
            while len(self.ring) > self.RING_CAP:
                self.ring.popitem(last=False)
        return planes

    def eligible(self, dec, blks):
        """True for every frame of the slice; raises on the rest, which
        the host decoder would otherwise send to host-pixel or JAX
        paths."""
        h = dec.h
        if h.subsample != 420 or h.cfl_inter or h.qmtx:
            raise NotImplementedError(
                "only 4:2:0 without cfl_inter or qmtx is ported "
                "(ROADMAP.md Queue 1, 'Decoder fallbacks')")
        if len(blks) == 0:
            raise NotImplementedError("a frame without block records")
        intra = blks[:, NP.B_MODE] == MODE_INTRA
        if (intra & (blks[:, NP.B_TBSPLIT] > 0)).any():
            raise NotImplementedError(
                "tb-split intra is not ported (device_pixels.execute, "
                "ROADMAP.md Queue 1, 'Decoder fallbacks')")
        return True

    def run(self, dec, s, blks, plan, refs):
        """Execute one parsed frame; fills dec.rec; consumes the filter
        stream reads (CDEF presets, CLPF bits) in reference order."""
        global RUNS
        h = dec.h
        fi = dec.fi
        H, W = dec.height, dec.width
        Hc, Wc = H >> 1, W >> 1
        bd = h.bitdepth
        qp = fi.qpb
        qpc = int(CHROMA_QP[qp])

        # ---- intra wave segments (dependency-batched) ----
        sb_size = 1 << h.log2_sb_size
        recs = blks[blks[:, NP.B_MODE] == MODE_INTRA]
        sizes = tuple(s for s in INTRA_SIZES if s <= min(H, W))
        seg_list = build_wave_segments(recs, H, W, sizes)
        scap = _bucket(max(len(seg_list), 1))
        segs = np.zeros((scap, LANES, 7), np.int32)
        segcls = np.zeros(scap, np.int32)
        for si, (cls, idx) in enumerate(seg_list):
            segcls[si] = cls
            for li, ri in enumerate(idx):
                r = recs[ri]
                y, x, size = int(r[NP.B_YPOS]), int(r[NP.B_XPOS]), int(
                    r[NP.B_SIZE])
                ur = inter.get_upright_available(y, x, size, size, W, H,
                                                 sb_size)
                dl = inter.get_downleft_available(y, x, size, size, W, H,
                                                  sb_size)
                segs[si, li] = (1, y, x, log2i(size),
                                int(r[NP.B_INTRA_MODE]), ur, dl)

        # ---- filter-stage host reads + masks (reference order) ----
        if h.deblocking:
            mv_, mh_ = OF.deblock_masks_y(dec.dd, W, H)
            cmv, cmh = OF.deblock_masks_uv(dec.dd, W, H)
        else:
            mv_ = mh_ = np.zeros((H, W), bool)
            cmv = cmh = np.zeros((Hc, Wc), bool)
        presets_y, presets_uv = dec._read_cdef_presets(s)
        cs = bd - 8
        lv0, sec0, m0 = OF.cdef_block_maps(dec.dd, presets_y, W, H, 0, 1)
        lv1, sec1, m1 = OF.cdef_block_maps(dec.dd, presets_uv, W, H, 1, 1)
        _, _, m2 = OF.cdef_block_maps(dec.dd, presets_uv, W, H, 2, 1)
        s_y = s_u = s_v = 0
        clpf_my = np.zeros((H, W), bool)
        clpf_mu = clpf_mv2 = np.zeros((Hc, Wc), bool)
        if h.clpf:
            s_y = s.get_flc(2)
            s_u = s.get_flc(2)
            s_v = s.get_flc(2)
            if s_y:
                fb_size_log2 = s.get_flc(2) + 4
                enable_fb = fb_size_log2 != 4
                if fb_size_log2 == 4:
                    fb_size_log2 = 7
                if enable_fb:
                    nbits = SF.count_clpf_decisions(dec.dd, W, H, 0,
                                                    fb_size_log2, 1)
                    bits = [s.get_flc(1) for _ in range(nbits)]
                else:
                    bits = None
                clpf_my, _ = OF.clpf_pixel_mask(dec.dd, W, H, 0,
                                                fb_size_log2, 1,
                                                decision_bits=bits)
            if s_u:
                clpf_mu, _ = OF.clpf_pixel_mask(dec.dd, W, H, 1, 4, 1)
            if s_v:
                clpf_mv2, _ = OF.clpf_pixel_mask(dec.dd, W, H, 2, 4, 1)

        # ---- reference stacks (resident ring) ----
        has_inter = fi.frame_type != I_FRAME and bool(plan.inter.any())
        up = self._upload
        if has_inter:
            if refs[0].pad != PADDING:
                raise RuntimeError("ref pad mismatch")
            rp = [self._ref_planes(dec, r) for r in refs]
            ystack, ustack, vstack = (torch.stack([p[i] for p in rp])
                                      for i in range(3))
        else:
            ystack = torch.zeros((1, 1, 1), dtype=torch.int16,
                                 device=self.device)
            ustack = vstack = ystack
        _check_bounds(plan, seg_list, recs, H, W, sizes, len(refs))

        gstack = np.stack([plan.ly[k].reshape(-1) for k in LY_KEYS])
        cstack = np.stack([plan.ch[k].reshape(-1) for k in CH_KEYS] +
                          [plan.avg.reshape(-1), plan.inter.reshape(-1)])
        q4y = np.stack([plan.qp4["y"], plan.ls4["y"]])
        q4c = np.stack([plan.qp4["c"], plan.ls4["c"]])
        coef_uv = np.stack([plan.coef["u"], plan.coef["v"]])

        yf, uf, vf = pixel_core(
            ystack, ustack, vstack, up(gstack), up(cstack),
            up(plan.coef["y"]), up(coef_uv), up(q4y), up(q4c), segs,
            segcls, H=H, W=W, bd=bd, pad=PADDING, pad_c=PADDING >> 1,
            has_inter=has_inter, has_avg=bool(plan.avg.any()),
            cfl=bool(h.cfl_intra))
        packed, ry, ru, rv = filter_pack(
            yf, uf, vf, up(mv_), up(mh_), up(cmv), up(cmh), up(lv0),
            up(sec0), up(m0), up(lv1), up(sec1), up(m1), up(m2),
            up(clpf_my), up(clpf_mu), up(clpf_mv2), bd=bd, pad=PADDING,
            pad_c=PADDING >> 1, qp=qp, qpc=qpc,
            deblocking=bool(h.deblocking), cdef_damping=dec.cdef_damping,
            cs=cs, s_y=s_y, s_u=s_u, s_v=s_v, qpclpf=qp >> 4,
            out8=(bd == 8))
        RUNS += 1

        # resident ring update (before the pull: both are queued)
        self.ring[dec.rec.frame_num] = (ry, ru, rv)
        while len(self.ring) > self.RING_CAP:
            self.ring.popitem(last=False)

        # pipelined: leave this frame's pull in flight, resolve the
        # previous one (its device work overlapped this frame's host
        # parse/plan)
        prev, self._pending = self._pending, (packed, dec.rec, H, W, Wc)
        if prev is not None:
            self._resolve(prev)
