"""Device finalization for the turbo encoder (torch port of
thor_tpu/enc/turbo_final.py).

  pass 1 (host, no pixels): walk the decided quadtree in coding order,
      derive the NORMATIVE elements that feed prediction - skip/merge
      candidate lists (mapped onto the decided MVs), MVP, deblock-data
      fills - and build the decoder-style dense MC plan grids plus intra
      wave segments (the C pass of enc/turbo_native.py, or the Python
      walk `plan_frame`).
  device (`finalize_core`): dense MC prediction for all inter/skip
      leaves through the CUDA kernels of ops/mc.py (the luma kernel once
      per list, the one-plane chroma kernel once per plane and list),
      per-size batched forward transform + adaptive-deadzone quantize of
      the residual planes, the decoder's own dense inverse path, then the
      intra wave loop that predicts from reconstructed neighbours,
      quantizes, reconstructs and applies CFL (enc/encode_block.c:
      1100-1338).  One packed int16 pull.
  pass 2 (host, no pixels): syntax emission (the C pass, or the Python
      walk `emit_nodes` through enc/writer.py) from the pulled
      coefficient planes.

The Python walks are the byte-exactness oracle of the C passes; a test
selects them with `NATIVE = False`.  Reference anchors: process_block
enc/encode_block.c:2401, encode_and_reconstruct_block_* :1100/:1275,
write_block enc/write_bits.c:360.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import trace as TR
from ..tables import CHROMA_QP, log2i
from ..ops.transform import fwd_transform_batch, _i16
from ..ops.quant import quantize_batch
from ..ops import intra_batch as IB
from ..dec import device_pixels as DP
from ..dec.device_pixels import FramePlan, plan_block_mc
from ..dec.device_frame import (_cfl_j, _slices, _write,
                                build_wave_segments, LY_KEYS, CH_KEYS)
from ..spec import inter

I32 = torch.int32
AP = 136
LANES = 32
INTRA_SIZES = (8, 16, 32, 64)
MODE_SKIP, MODE_INTRA, MODE_INTER, MODE_BIPRED = 0, 1, 2, 3
I_FRAME, P_FRAME, B_FRAME = 0, 1, 2

# plan and emit through the C passes (enc/turbo_native.py); False takes
# the Python walks, their byte-exactness oracle
NATIVE = True


def _fast_inter(size: int, speed: int) -> bool:
    """enc/encode_block.c:1298 (no tb-split leaf)."""
    return (size == 64 and speed > 0) or speed > 1


def _fast_intra(speed: int) -> bool:
    """enc/encode_block.c:1124."""
    return speed > 1


# ---------------------------------------------------------------------------
# dense forward path: residual plane -> quantized coefficient plane
# ---------------------------------------------------------------------------

def _coef_plane(res_pl, ls4, qp: int, is_i: bool, sizes, speed: int,
                bd: int, wm=None):
    """Transform+quantize every coded TB of a plane with static shapes.

    res_pl [hp,wp] int32 residual; ls4 [hp/4,wp/4] log2-TB-size grid (0 =
    not coded here).  The plane is tiled at every size and quantized;
    tiles whose ls4 matches are kept in the dense coefficient plane (the
    decoder's layout, dec/device_pixels.py:FramePlan)."""
    hp, wp = res_pl.shape
    coefq = torch.zeros((hp, wp), dtype=torch.int16, device=res_pl.device)
    for s in sizes:
        if s > hp or s > wp:
            continue
        qs = min(s, 16)
        nh, nw = hp // s, wp // s
        tiles = (res_pl.reshape(nh, s, nw, s).permute(0, 2, 1, 3)
                 .reshape(nh * nw, s, s))
        co = fwd_transform_batch(tiles, s, _fast_inter(s, speed), bd)
        if wm is None:
            cq, _ = quantize_batch(co.to(torch.int16), qp, s, int(is_i))
        else:
            cq, _ = quantize_batch(co.to(torch.int16), qp, s, int(is_i),
                                   wmatrix=wm[s], weighted=True)
        pl = torch.zeros((nh, nw, s, s), dtype=torch.int16,
                         device=res_pl.device)
        pl[:, :, :qs, :qs] = cq.reshape(nh, nw, qs, qs)
        pl = pl.permute(0, 2, 1, 3).reshape(hp, wp)
        m = ls4[::s // 4, ::s // 4] == log2i(s)
        pm = m.repeat_interleave(s, 0).repeat_interleave(s, 1)
        coefq = torch.where(pm, pl, coefq)
    return coefq


# ---------------------------------------------------------------------------
# intra wavefront: predict-from-recon + quantize + reconstruct + CFL
# ---------------------------------------------------------------------------

def _enc_intra_waves(y_pl, u_pl, v_pl, org_y, org_u, org_v, segs, segcls,
                     qp: int, qpc: int, is_i: bool, speed: int, bd: int,
                     cfl: bool, sizes, qm=None):
    """Encoder twin of dec/device_frame._intra_waves: a host loop over
    the wave segments (each <= LANES independent same-size intra blocks),
    each running the full encode loop of enc/encode_block.c:1100 -
    predict from reconstructed neighbours, residual, forward transform,
    quantize (with the FRAME's intra flag, as the reference), inverse
    path, CFL-corrected chroma.  segs [S,LANES,7] / segcls [S] are host
    arrays.  The planes are updated in place; returns the quantized
    coefficients [3,S,LANES,16,16] int16 and cbp [S,LANES,3] int32 per
    lane (zero in lanes without a block)."""
    maxv = (1 << bd) - 1
    WMAX = max(sizes)
    WC = max(WMAX // 2, 4)
    fast = _fast_intra(speed)
    dev = y_pl.device
    S = segs.shape[0]
    icq = torch.zeros((3, S, LANES, 16, 16), dtype=torch.int16, device=dev)
    icb = torch.zeros((S, LANES, 3), dtype=I32, device=dev)

    def _plane_enc(org_t, pred, n: int, q: int, wm=None, iw=None):
        """org/pred [L,n,n] -> (cq [L,qs,qs] i16, cbp [L], rec [L,n,n])."""
        res = _i16(org_t - pred)
        co = fwd_transform_batch(res, n, fast, bd)
        qvec = torch.full((co.shape[0],), q, dtype=I32, device=dev)
        if wm is None:
            cq, cbp = quantize_batch(co.to(torch.int16), q, n, int(is_i))
            rb = DP.residual_batch(cq.to(I32), qvec, n, bd)
        else:
            cq, cbp = quantize_batch(co.to(torch.int16), q, n, int(is_i),
                                     wmatrix=wm, weighted=True)
            iwb = iw[None].expand((cq.shape[0],) + tuple(iw.shape))
            rb = DP.residual_batch_w(cq.to(I32), qvec, iwb, n, bd)
        p16 = _i16(pred)
        rec = torch.where((cbp > 0)[:, None, None],
                          (p16 + rb).clamp(0, maxv), p16.clamp(0, maxv))
        return cq, cbp, rec

    def pred_mode(plane, yy, xx, n, ur, dl, mode):
        l, t, tl = IB.make_refs_batch(plane, yy, xx, n, ur, dl, bd)
        return IB.select_mode(
            IB.predict_all_modes(l, t, tl, yy, xx, n, bd, 10), mode)

    # one upload of every segment (a per-segment upload would
    # synchronise the stream each time); a segment's blocks fill its
    # first lanes
    active = segs[:, :, 0] > 0
    counts = active.sum(axis=1)
    assert (active == (np.arange(LANES)[None, :] < counts[:, None])).all()
    segs_dev = torch.from_numpy(np.ascontiguousarray(segs)).to(dev).long()
    with TR.span("enc.intra_waves"):
        for si in range(S):
            cls = int(segcls[si])
            L = int(counts[si])
            if cls == 0 or L == 0:
                continue
            n = sizes[cls - 1]
            nc = n >> 1
            qs, qsc = min(n, 16), min(nc, 16)
            nd = segs_dev[si, :L]
            yy, xx = nd[:, 1], nd[:, 2]
            mode = nd[:, 4]
            ur, dl = nd[:, 5] > 0, nd[:, 6] > 0
            pred = pred_mode(y_pl, yy, xx, n, ur, dl, mode)
            cqy, cby, rec = _plane_enc(
                _slices(org_y, yy, xx, n), pred, n, qp,
                wm=qm["fiy"][n] if qm else None,
                iw=qm["iiy"][n] if qm else None)
            yc, xc = yy >> 1, xx >> 1
            pu = pred_mode(u_pl, yc, xc, nc, ur, dl, mode)
            pv = pred_mode(v_pl, yc, xc, nc, ur, dl, mode)
            if cfl:
                pu, pv = _cfl_j(pred, pu, pv, rec, n, bd)
            wmc = qm["fic"][nc] if qm else None
            iwc = qm["iic"][nc] if qm else None
            cqu, cbu, recu = _plane_enc(_slices(org_u, yc, xc, nc), pu, nc,
                                        qpc, wm=wmc, iw=iwc)
            cqv, cbv, recv = _plane_enc(_slices(org_v, yc, xc, nc), pv, nc,
                                        qpc, wm=wmc, iw=iwc)
            _write(y_pl, rec.to(y_pl.dtype), yy, xx, WMAX)
            _write(u_pl, recu.to(u_pl.dtype), yc, xc, WC)
            _write(v_pl, recv.to(v_pl.dtype), yc, xc, WC)
            icq[0, si, :L, :qs, :qs] = cqy
            icq[1, si, :L, :qsc, :qsc] = cqu
            icq[2, si, :L, :qsc, :qsc] = cqv
            icb[si, :L] = torch.stack([cby, cbu, cbv], dim=1).to(I32)
    return icq, icb


def _qm_operands(enc, qp, device):
    """Per-frame qmtx weight operands for the finalizer.

    Fixed-QP turbo means ONE qlevel per frame; selection mirrors the
    exact host encoder (thor_tpu/enc/encoder.py:_wm/_iwm): inter is
    per-plane, intra chroma uses the U-plane matrix for BOTH chroma
    planes (enc/encode_block.c quantize calls with plane=1 for u and
    v)."""
    from ..tables import qp_to_qlevel
    p = enc.params
    ql = qp_to_qlevel(qp, p.qmtx_offset)
    wm, iwm = enc.wmatrix, enc.iwmatrix

    def fw(plane, intra, sizes):
        return {s: torch.as_tensor(
            np.asarray(wm[ql][plane][intra][log2i(s) - 2], np.int64),
            device=device) for s in sizes}

    def iv(plane, intra, sizes, bank=False):
        out = {}
        for s in sizes:
            m = torch.as_tensor(
                np.asarray(iwm[ql][plane][intra][log2i(s) - 2], np.int32),
                device=device)
            out[s] = m[None] if bank else m
        return out

    return {
        "fy": fw(0, 0, (4, 8, 16, 32, 64, 128)),
        "fu": fw(1, 0, (4, 8, 16, 32, 64)),
        "fv": fw(2, 0, (4, 8, 16, 32, 64)),
        "iy": iv(0, 0, (4, 8, 16, 32, 64, 128), bank=True),
        "iu": iv(1, 0, (4, 8, 16, 32, 64), bank=True),
        "iv": iv(2, 0, (4, 8, 16, 32, 64), bank=True),
        "fiy": fw(0, 1, (8, 16, 32, 64)),
        "fic": fw(1, 1, (4, 8, 16, 32)),
        "iiy": iv(0, 1, (8, 16, 32, 64)),
        "iic": iv(1, 1, (4, 8, 16, 32)),
    }


# ---------------------------------------------------------------------------
# device finalization
# ---------------------------------------------------------------------------

@TR.spanned("enc.turbo_final")
def finalize_core(org_y, org_u, org_v, ystack, ustack, vstack, gstack,
                  cstack, q4y, q4c, segs, segcls, qm, H: int, W: int,
                  bd: int, pad: int, pad_c: int, has_inter: bool,
                  has_avg: bool, cfl: bool, qp: int = 32, qpc: int = 32,
                  is_i: bool = False, speed: int = 2,
                  has_qm: bool = False, has_tb: bool = False):
    """MC pred + forward quantize + recon + intra waves of one frame.

    org_*: original planes (device, any integer dtype); *stack [R,Hp,Wp]
    int16 padded references; gstack/cstack the plan grids; q4y/q4c
    [2,*,*] (qp4, ls4); segs/segcls host arrays; qm the qmtx operands
    (`_qm_operands`) when has_qm.

    Returns (packed i16 [H+H/2+hp+hc, wp] holding rec_y, rec_u|rec_v,
    coefq_y, coefq_u|coefq_v; the intra coefficients [3,S,LANES,16,16];
    the intra cbp [S,LANES,3])."""
    dev = org_y.device
    gh, gw = H // 4, W // 4
    H2, W2 = H // 2, W // 2
    maxv = (1 << bd) - 1
    hp, wp = q4y.shape[1] * 4, q4y.shape[2] * 4
    hc, wc = q4c.shape[1] * 4, q4c.shape[2] * 4
    org_y, org_u, org_v = (o.to(I32) for o in (org_y, org_u, org_v))
    gstack = gstack.to(I32)
    cstack = cstack.to(I32)
    q4y = q4y.to(I32)
    q4c = q4c.to(I32)

    def zeros(h, w, dtype=I32):
        return torch.zeros((h, w), dtype=dtype, device=dev)

    # ---- inter MC + residual coding ----
    if has_inter:
        lg = {k: gstack[i] for i, k in enumerate(LY_KEYS)}
        cg = {k: cstack[i] for i, k in enumerate(CH_KEYS)}
        avg = cstack[10][:, None, None] == 1
        inter_m = cstack[11].reshape(gh, gw) == 1
        p0 = DP.mc_cells_luma(ystack, lg["r0"], lg["y0_0"] + pad,
                              lg["x0_0"] + pad, lg["op0"], lg["vf0"],
                              lg["hf0"], lg["fs0"], 4, bd)
        if has_avg:
            p1 = DP.mc_cells_luma(ystack, lg["r1"], lg["y0_1"] + pad,
                                  lg["x0_1"] + pad, lg["op1"], lg["vf1"],
                                  lg["hf1"], lg["fs1"], 4, bd)
            p0 = torch.where(avg, (p0 + p1) >> 1, p0)
        pred_y = p0.reshape(gh, gw, 4, 4).permute(0, 2, 1, 3).reshape(H, W)

        def chroma(stack, s):
            return DP.mc_cells_chroma(
                stack, lg["r" + s], cg["y0_" + s] + pad_c,
                cg["x0_" + s] + pad_c, cg["op" + s], cg["vf" + s],
                cg["hf" + s], 2, bd)

        pu0 = chroma(ustack, "0")
        pv0 = chroma(vstack, "0")
        if has_avg:
            pu1 = chroma(ustack, "1")
            pv1 = chroma(vstack, "1")
            pu0 = torch.where(avg, (pu0 + pu1) >> 1, pu0)
            pv0 = torch.where(avg, (pv0 + pv1) >> 1, pv0)
        pred_u = pu0.reshape(gh, gw, 2, 2).permute(0, 2, 1, 3).reshape(
            H2, W2)
        pred_v = pv0.reshape(gh, gw, 2, 2).permute(0, 2, 1, 3).reshape(
            H2, W2)

        # residual planes, padded to the dense-coef geometry
        ry = zeros(hp, wp)
        ry[:H, :W] = org_y - pred_y
        ru = zeros(hc, wc)
        ru[:H2, :W2] = org_u - pred_u
        rv = zeros(hc, wc)
        rv[:H2, :W2] = org_v - pred_v
        # tb-split halves the luma TB down to 4
        ly_sizes = ((4, 8, 16, 32, 64, 128) if has_tb
                    else (8, 16, 32, 64, 128))
        coefq_y = _coef_plane(ry, q4y[1], qp, is_i, ly_sizes, speed, bd,
                              qm["fy"] if has_qm else None)
        coefq_u = _coef_plane(ru, q4c[1], qpc, is_i, (4, 8, 16, 32, 64),
                              speed, bd, qm["fu"] if has_qm else None)
        coefq_v = _coef_plane(rv, q4c[1], qpc, is_i, (4, 8, 16, 32, 64),
                              speed, bd, qm["fv"] if has_qm else None)

        # decoder-exact inverse path over the quantized planes (one
        # qlevel per frame: the weight selector grids are constant zero)
        if has_qm:
            wsy = zeros(hp // 4, wp // 4)
            wsc = zeros(hc // 4, wc // 4)
            iby, ibu, ibv = qm["iy"], qm["iu"], qm["iv"]
        else:
            wsy = wsc = iby = ibu = ibv = None
        res_y = DP._dense_residual(coefq_y, q4y[0], q4y[1], bd,
                                   (4, 8, 16, 32, 64, 128),
                                   wsy, iby)[:H, :W]
        res_u = DP._dense_residual(coefq_u, q4c[0], q4c[1], bd,
                                   (4, 8, 16, 32, 64), wsc, ibu)[:H2, :W2]
        res_v = DP._dense_residual(coefq_v, q4c[0], q4c[1], bd,
                                   (4, 8, 16, 32, 64), wsc, ibv)[:H2, :W2]

        def recon(pred, res):
            return (_i16(pred) + res).clamp(0, maxv)

        im_y = inter_m.repeat_interleave(4, 0).repeat_interleave(4, 1)
        im_c = inter_m.repeat_interleave(2, 0).repeat_interleave(2, 1)
        base_y = torch.where(im_y, recon(pred_y, res_y), 0)
        base_u = torch.where(im_c, recon(pred_u, res_u), 0)
        base_v = torch.where(im_c, recon(pred_v, res_v), 0)
    else:
        coefq_y = zeros(hp, wp, torch.int16)
        coefq_u = zeros(hc, wc, torch.int16)
        coefq_v = zeros(hc, wc, torch.int16)
        base_y = zeros(H, W)
        base_u = zeros(H2, W2)
        base_v = zeros(H2, W2)

    # ---- intra waves over apron-extended planes ----
    def apron(x, h, w):
        pl = zeros(h + AP, w + AP)
        pl[:h, :w] = x
        return pl

    y_pl, u_pl, v_pl = (apron(base_y, H, W), apron(base_u, H2, W2),
                        apron(base_v, H2, W2))
    oyp, oup, ovp = (apron(org_y, H, W), apron(org_u, H2, W2),
                     apron(org_v, H2, W2))
    sizes = tuple(s for s in INTRA_SIZES if s <= min(H, W))
    icq, icb = _enc_intra_waves(
        y_pl, u_pl, v_pl, oyp, oup, ovp, segs, segcls, qp, qpc, is_i,
        speed, bd, cfl, sizes, qm if has_qm else None)
    rec_y = y_pl[:H, :W].to(torch.int16)
    rec_uv = torch.cat([u_pl[:H2, :W2], v_pl[:H2, :W2]],
                       dim=1).to(torch.int16)

    # one packed i16 buffer for all plane outputs (2wc == wp always:
    # both are 2*ceil(W/2 /64)*64)
    def row_pad(a):
        out = zeros(a.shape[0], wp, torch.int16)
        out[:, :a.shape[1]] = a
        return out

    packed = torch.cat(
        [row_pad(rec_y), row_pad(rec_uv), coefq_y,
         torch.cat([coefq_u, coefq_v], dim=1)], dim=0)
    return packed, icq, icb


# ---------------------------------------------------------------------------
# pass 1: host planning walk (no pixel math)
# ---------------------------------------------------------------------------

class _HView:
    """Header-ish adapter so dec/device_pixels.plan_block_mc can read
    the encoder's sequence parameters."""

    def __init__(self, p):
        self.interp_ref = p.interp_ref
        self.bipred = p.enable_bipred
        self.pb_split = p.enable_pb_split


class _DecView:
    """Decoder-shaped adapter over the encoder for plan_block_mc."""

    def __init__(self, enc):
        self.h = _HView(enc.params)
        self.fi = enc.fi
        self.rec = enc.rec
        self.stat_frame_type = enc.fi.frame_type
        self.width, self.height = enc.width, enc.height
        self.interp_frames = []
        self._enc = enc

    def _ref_frame(self, r):
        return self._enc._ref_frame(r)


def plan_frame(enc, dec):
    """Coding-order walk over the decided tree: derive normative
    candidates/MVP, fill deblock data (mode/mv geometry now; cbp in
    pass 2), build MC plan grids + intra wave segments.

    Returns (nodes, plan, intra_list) where nodes is the coding-order
    list of ('split', size, y, x) / ('leaf', leaf-dict) entries."""
    from .encoder import BlockInfo, SQUARED_LAMBDA_QP

    p = enc.params
    fi = enc.fi
    qp = fi.qp
    h, w = p.height, p.width
    sb = 1 << p.log2_sb_size
    is_p = fi.frame_type != I_FRAME
    is_b = fi.frame_type == B_FRAME
    # B uni/bipred list slots (enc/encode_block.c:1708: list 0 = nearest
    # past, list 1 = nearest future; interp_ref shifts both by one)
    r0i = 1 if (is_b and fi.interp_ref) else 0
    r1i = 2 if (is_b and fi.interp_ref) else 1
    view = _DecView(enc)
    if is_p:
        ref_slots = {r: i for i, r in enumerate(fi.ref_array)}
    plan = FramePlan(w, h)
    nodes = []
    intra_list = []

    def walk(size, ypos, xpos):
        if ypos + 8 > h or xpos + 8 > w:
            return
        encode_this = ypos + size <= h and xpos + size <= w
        ch = dec["choice"][size][ypos // size, xpos // size] \
            if encode_this else 3
        if ch == 3 and size > 8:
            nodes.append(("split", size, ypos, xpos))
            ns = size // 2
            walk(ns, ypos, xpos)
            walk(ns, ypos + ns, xpos)
            walk(ns, ypos, xpos + ns)
            walk(ns, ypos + ns, xpos + ns)
            return

        bi = BlockInfo()
        bi.size = size
        bi.ypos, bi.xpos = ypos, xpos
        bi.bwidth = min(size, w - xpos)
        bi.bheight = min(size, h - ypos)
        bi.sub = enc.sub
        bi.qp = qp
        bi.delta_qp = 0
        bi.max_num_tb_part = 2 if p.enable_tb_split == 1 else 1
        bi.max_num_pb_part = 4 if p.enable_pb_split else 1
        bi.lambda_ = fi.lambda_coeff * SQUARED_LAMBDA_QP[qp]
        bi.best = None
        bi.mvp = (0, 0)
        bi.final_encode = 0

        if is_p:
            bi.skip_candidates = inter.get_mv_skip(
                ypos, xpos, w, h, size, size, sb, enc.dd)
            bi.num_skip_vec = len(bi.skip_candidates)
            bi.merge_candidates = inter.get_mv_merge(
                ypos, xpos, w, h, size, size, sb, enc.dd)
            bi.num_merge_vec = len(bi.merge_candidates)
        else:
            bi.skip_candidates = []
            bi.merge_candidates = []
            bi.num_skip_vec = bi.num_merge_vec = 0

        gi = (ypos // size, xpos // size)
        meta = dec["meta"][size]
        mvs, mvc, imode = meta[0], meta[1], meta[2]
        flat = gi[0] * (dec["W"] // size) + gi[1]
        # decided tb_split flags (HE presets): bit0 inter(list0),
        # bit1 inter(list1), bit2 bipred
        tbc = int(meta[-1][flat]) if dec.get("tb_on") else 0

        if ch == 2 or not is_p:
            bp = {"mode": MODE_INTRA, "tb_param": 0, "tb_split": 0,
                  "pb_part": 0, "intra_mode": int(imode[flat]),
                  "ref_idx0": 0, "ref_idx1": 0, "dir": -1, "skip_idx": 0,
                  "mv_arr0": [(0, 0)] * 4, "mv_arr1": [(0, 0)] * 4}
            intra_list.append((ypos, xpos, size, int(imode[flat])))
        elif ch == 0:
            want = (int(mvs[flat, 0]), int(mvs[flat, 1]))
            bidx = 0
            bdist = 1 << 30
            for i, c in enumerate(bi.skip_candidates):
                d = abs(c[0] - want[0]) + abs(c[1] - want[1])
                if d < bdist:
                    bdist = d
                    bidx = i
            if bdist != 0:
                # the probe MV is absent from the true candidate list:
                # demote to inter with the probed MV (the prediction the
                # decision costed, plus residual coding); twin of
                # blockemit.c plan_walk
                bi.mvp = inter.get_mv_pred(ypos, xpos, w, h, size, size,
                                           sb, enc.dd)
                bp = {"mode": MODE_INTER, "tb_param": 0, "tb_split": 0,
                      "pb_part": 0, "ref_idx0": 0, "ref_idx1": 0,
                      "mv_arr0": [want] * 4, "mv_arr1": [want] * 4,
                      "dir": 0, "skip_idx": 0}
            else:
                c = bi.skip_candidates[bidx]
                bp = {"mode": MODE_SKIP, "tb_param": 0, "tb_split": 0,
                      "pb_part": 0, "skip_idx": bidx, "ref_idx0": c[4],
                      "ref_idx1": c[5], "mv_arr0": [(c[0], c[1])] * 4,
                      "mv_arr1": [(c[2], c[3])] * 4, "dir": c[6]}
        elif ch == 5:
            # bipred: list-0 MV direct, list-1 MV negated (future ref is
            # MC'd with sign=1, which negates the emitted vector)
            mvb = meta[3]
            mv0 = (int(mvc[flat, 0]), int(mvc[flat, 1]))
            mv1 = (-int(mvb[flat, 0]), -int(mvb[flat, 1]))
            bi.mvp = inter.get_mv_pred(ypos, xpos, w, h, size, size, sb,
                                       enc.dd)
            bp = {"mode": MODE_BIPRED, "tb_param": 0,
                  "tb_split": (tbc >> 2) & 1,
                  "pb_part": 0, "ref_idx0": r0i, "ref_idx1": r1i,
                  "mv_arr0": [mv0] * 4, "mv_arr1": [mv1] * 4, "dir": 2,
                  "skip_idx": 0}
        else:
            # uni inter: ch 1 = list 0 (past), ch 4 = list 1 (future,
            # emitted negated for sign=1 MC)
            if ch == 4:
                mvb = meta[3]
                mv = (-int(mvb[flat, 0]), -int(mvb[flat, 1]))
                ridx = r1i
                tbf = (tbc >> 1) & 1
            else:
                mv = (int(mvc[flat, 0]), int(mvc[flat, 1]))
                ridx = r0i if is_b else 0
                tbf = tbc & 1
            bi.mvp = inter.get_mv_pred(ypos, xpos, w, h, size, size, sb,
                                       enc.dd)
            # ref_idx1 mirrors ref_idx0 (read_block sets both to the
            # signalled ref) so the deblock-data state - and hence later
            # skip-candidate lists - stay in sync
            bp = {"mode": MODE_INTER, "tb_param": 0, "tb_split": tbf,
                  "pb_part": 0, "ref_idx0": ridx, "ref_idx1": ridx,
                  "mv_arr0": [mv] * 4, "mv_arr1": [mv] * 4, "dir": 0,
                  "skip_idx": 0}
        bi.best = bp

        if bp["mode"] in (MODE_SKIP, MODE_INTER, MODE_BIPRED):
            plan_block_mc(plan, view, bp, size, ypos, xpos, size, size,
                          ref_slots)
        if bp["mode"] in (MODE_INTER, MODE_BIPRED):
            # mark coded TBs for the dense fwd/inverse passes; tb_split
            # halves the TB size (luma always, chroma unless it would go
            # below 4 - enc/encode_block.c:1275, write_bits.c:540-560)
            tbf = bp["tb_split"]
            qpc = int(CHROMA_QP[qp])
            sC = size >> 1
            yC, xC = ypos >> 1, xpos >> 1
            plan.qp4["y"][ypos // 4:(ypos + size) // 4,
                          xpos // 4:(xpos + size) // 4] = qp
            plan.ls4["y"][ypos // 4:(ypos + size) // 4,
                          xpos // 4:(xpos + size) // 4] = \
                log2i(size // 2 if tbf else size)
            plan.qp4["c"][yC // 4:(yC + sC) // 4,
                          xC // 4:(xC + sC) // 4] = qpc
            plan.ls4["c"][yC // 4:(yC + sC) // 4,
                          xC // 4:(xC + sC) // 4] = \
                log2i(sC // 2 if (tbf and sC > 4) else sC)

        # geometry/mv deblock fill so later candidate derivation sees
        # the coded state (cbp corrected in pass 2)
        bp["cbp"] = (0, 0, 0)
        enc._copy_deblock(bi)
        nodes.append(("leaf", bi))

    nsh = (w + sb - 1) // sb
    nsv = (h + sb - 1) // sb
    for k in range(nsv):
        for sl in range(nsh):
            walk(sb, k * sb, sl * sb)
    return nodes, plan, intra_list


# ---------------------------------------------------------------------------
# pass 2: host syntax emission (no pixel math)
# ---------------------------------------------------------------------------

def emit_nodes(enc, nodes, coefq, icoef, ipos):
    """Write the frame syntax using the device-computed coefficients.

    coefq: dict plane -> dense quantized-coeff plane (np int16).
    icoef: dict with 'y'/'u'/'v' [S,L,16,16] + 'cb' [S,L,3] intra
    stacks; ipos maps (ypos,xpos) -> (si, li)."""
    from . import writer as W

    for nd in nodes:
        if nd[0] == "split":
            _, size, ypos, xpos = nd
            bi_s = _SplitBI(enc, size, ypos, xpos)
            W.write_super_mode(enc.writer, enc, bi_s, MODE_SKIP, 0, 1,
                               bi_s.encode_this)
            continue
        bi = nd[1]
        bp = bi.best
        size = bi.size
        ypos, xpos = bi.ypos, bi.xpos
        bi.ctx_split, bi.ctx_cbp, bi.ctx_index = \
            enc._find_block_context(ypos, xpos, size)
        mode = bp["mode"]
        if mode == MODE_SKIP:
            bp["cbp"] = (0, 0, 0)
        elif mode == MODE_INTRA:
            si, li = ipos[(ypos, xpos)]
            qs = min(size, 16)
            qsc = min(size >> 1, 16)
            bp["coeff_y"] = icoef["y"][si, li, :qs, :qs]
            bp["coeff_u"] = icoef["u"][si, li, :qsc, :qsc]
            bp["coeff_v"] = icoef["v"][si, li, :qsc, :qsc]
            cb = icoef["cb"][si, li]
            bp["cbp"] = (int(cb[0]), int(cb[1]), int(cb[2]))
        elif bp.get("tb_split"):
            # quadrant TBs: luma always splits; chroma splits unless it
            # would go below 4x4 (writer.py write_block tb branch)
            s2 = size // 2
            qs2 = min(s2, 16)
            sC = size >> 1
            yC, xC = ypos >> 1, xpos >> 1
            cbp_y = 0
            y4 = []
            for idx in range(4):
                oy = ypos + (idx >> 1) * s2
                ox = xpos + (idx & 1) * s2
                blk = coefq["y"][oy:oy + qs2, ox:ox + qs2]
                y4.append(blk)
                cbp_y = (cbp_y << 1) + int(blk.any())
            bp["coeff_y4"] = y4
            if sC > 4:
                sC2 = sC // 2
                qsc2 = min(sC2, 16)
                u4, v4 = [], []
                cbp_u = cbp_v = 0
                for idx in range(4):
                    oy = yC + (idx >> 1) * sC2
                    ox = xC + (idx & 1) * sC2
                    bu = coefq["u"][oy:oy + qsc2, ox:ox + qsc2]
                    bv = coefq["v"][oy:oy + qsc2, ox:ox + qsc2]
                    u4.append(bu)
                    v4.append(bv)
                    cbp_u = (cbp_u << 1) + int(bu.any())
                    cbp_v = (cbp_v << 1) + int(bv.any())
                bp["coeff_u4"], bp["coeff_v4"] = u4, v4
            else:
                qsc = min(sC, 16)
                cu = coefq["u"][yC:yC + qsc, xC:xC + qsc]
                cv = coefq["v"][yC:yC + qsc, xC:xC + qsc]
                bp["coeff_u"], bp["coeff_v"] = cu, cv
                cbp_u, cbp_v = int(cu.any()), int(cv.any())
            bp["cbp"] = (cbp_y, cbp_u, cbp_v)
        else:
            qs = min(size, 16)
            sC = size >> 1
            qsc = min(sC, 16)
            yC, xC = ypos >> 1, xpos >> 1
            cy = coefq["y"][ypos:ypos + qs, xpos:xpos + qs]
            cu = coefq["u"][yC:yC + qsc, xC:xC + qsc]
            cv = coefq["v"][yC:yC + qsc, xC:xC + qsc]
            bp["coeff_y"], bp["coeff_u"], bp["coeff_v"] = cy, cu, cv
            bp["cbp"] = (int(cy.any()), int(cu.any()), int(cv.any()))
        W.write_block(enc.writer, enc, bi, bp)
        enc._copy_deblock(bi)


class _SplitBI:
    def __init__(self, enc, size, ypos, xpos):
        self.size = size
        self.ypos, self.xpos = ypos, xpos
        self.encode_this = (ypos + size <= enc.height and
                            xpos + size <= enc.width)
        self.ctx_split, self.ctx_cbp, self.ctx_index = \
            enc._find_block_context(ypos, xpos, size)


# ---------------------------------------------------------------------------
# the frame: plan, finalize, emit
# ---------------------------------------------------------------------------

def _pull(outs):
    """The finalizer's outputs on the host (the frame's one pull)."""
    return [o.cpu().numpy() for o in outs]


def encode_frame_turbo_final(enc, dec):
    """Device finalization + host emission for one decided frame."""
    from . import turbo_native as TN

    p = enc.params
    fi = enc.fi
    dev = enc.device
    h, w = p.height, p.width
    qp = fi.qp
    qpc = int(CHROMA_QP[qp])
    is_p = fi.frame_type != I_FRAME
    bd = p.bitdepth

    # the C plan walk; the Python walk where NATIVE is off or the C walk
    # cannot hold the frame (its record buffer), as thor_tpu does
    nt = nodes = None
    with TR.span("enc.plan"):
        if NATIVE:
            plan = FramePlan(w, h)
            res = TN.plan_frame(enc, dec, plan)
            if res is not None:
                nt, _recs, intra_list = res
        if nt is None:
            nodes, plan, intra_list = plan_frame(enc, dec)

    # intra wave segments
    sizes = tuple(s for s in INTRA_SIZES if s <= min(h, w))
    recs = np.array([(y, x, s) for (y, x, s, _m) in intra_list],
                    np.int32).reshape(-1, 3)
    seg_list = build_wave_segments(recs, h, w, sizes, lanes=LANES)
    nseg = max(len(seg_list), 1)
    segs = np.zeros((nseg, LANES, 7), np.int32)
    segcls = np.zeros(nseg, np.int32)
    sb = 1 << p.log2_sb_size
    ipos = {}
    for si, (cls, idx) in enumerate(seg_list):
        segcls[si] = cls
        for li, ri in enumerate(idx):
            y, x, size, im = intra_list[ri]
            ur = inter.get_upright_available(y, x, size, size, w, h, sb)
            dl = inter.get_downleft_available(y, x, size, size, w, h, sb)
            segs[si, li] = (1, y, x, log2i(size), im, ur, dl)
            ipos[(y, x)] = (si, li)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    has_inter = is_p and bool(plan.inter.any())
    if has_inter:
        # stack only the reference slots the plan uses; slot ids in the
        # r0/r1 grids are remapped to the compacted stack order
        m0 = plan.ly["op0"] > 0
        m1 = plan.ly["op1"] > 0
        if m0.any() or m1.any():
            used = np.unique(np.concatenate(
                [plan.ly["r0"][m0].ravel(), plan.ly["r1"][m1].ravel()]))
        else:
            used = np.zeros(1, np.int64)
        remap = np.zeros(int(used.max()) + 1, plan.ly["r0"].dtype)
        for new, old in enumerate(used.tolist()):
            remap[int(old)] = new
        plan.ly["r0"][m0] = remap[plan.ly["r0"][m0]]
        plan.ly["r1"][m1] = remap[plan.ly["r1"][m1]]
        ref_frames = [enc._ref_frame(fi.ref_array[int(s)]) for s in used]

        def _planes(r):
            # resident ring hit: already-padded int16 device planes,
            # equal to r.*_full (same edge-replicate rule)
            d = enc._dev_ref_planes(r)
            if d is not None:
                return d
            return tuple(up(a.astype(np.int16))
                         for a in (r.y_full, r.u_full, r.v_full))

        trip = [_planes(r) for r in ref_frames]
        ystack, ustack, vstack = (torch.stack([t[i] for t in trip])
                                  for i in range(3))
        pad, pad_c = ref_frames[0].pad, ref_frames[0].pad_c
    else:
        ystack = torch.zeros((1, 1, 1), dtype=torch.int16, device=dev)
        ustack = vstack = ystack
        pad = pad_c = 0

    # int16/uint8 uploads (coords < 32k, qp <= 51); widened on the device
    gstack = np.stack([plan.ly[k].reshape(-1)
                       for k in LY_KEYS]).astype(np.int16)
    cstack = np.stack([plan.ch[k].reshape(-1) for k in CH_KEYS] +
                      [plan.avg.reshape(-1),
                       plan.inter.reshape(-1)]).astype(np.int16)
    q4y = np.stack([plan.qp4["y"], plan.ls4["y"]]).astype(np.uint8)
    q4c = np.stack([plan.qp4["c"], plan.ls4["c"]]).astype(np.uint8)

    def org(a):
        return up(a if a.dtype == np.uint8 else a.astype(np.int32))

    qmops = _qm_operands(enc, qp, dev) if p.qmtx else {}
    outs = finalize_core(
        org(enc.orig.y), org(enc.orig.u), org(enc.orig.v),
        ystack, ustack, vstack, up(gstack), up(cstack), up(q4y), up(q4c),
        segs, segcls, qmops,
        H=h, W=w, bd=bd, pad=pad, pad_c=pad_c, has_inter=has_inter,
        has_avg=bool(plan.avg.any()), cfl=bool(p.cfl_intra), qp=qp,
        qpc=qpc, is_i=not is_p, speed=p.encoder_speed,
        has_qm=bool(p.qmtx), has_tb=bool(dec.get("tb_on", False)))
    packed, icq, icb = _pull(outs)

    H2, W2 = h // 2, w // 2
    hp = ((h + 127) // 128) * 128
    rec_y = packed[:h, :w]
    rec_uv = packed[h:h + H2, :w]
    cq_y = packed[h + H2:h + H2 + hp]
    cq_uv = packed[h + H2 + hp:]
    enc.rec.y[:, :] = rec_y.astype(enc.rec.dtype)
    enc.rec.u[:, :] = rec_uv[:, :W2].astype(enc.rec.dtype)
    enc.rec.v[:, :] = rec_uv[:, W2:].astype(enc.rec.dtype)

    wc = cq_uv.shape[1] // 2
    coefq = {"y": cq_y, "u": cq_uv[:, :wc], "v": cq_uv[:, wc:]}
    with TR.span("enc.emit"):
        if nt is not None:
            TN.emit_frame(enc, nt, coefq, icq, icb, ipos)
        else:
            icoef = {"y": icq[0], "u": icq[1], "v": icq[2], "cb": icb}
            emit_nodes(enc, nodes, coefq, icoef, ipos)
